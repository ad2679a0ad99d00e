"""The sharded force over a device mesh (counterpart of
``oc_nbody_tpu/parallel``, the single-process half: ``mesh.py`` and the
f32 tier of ``force.py``)."""
