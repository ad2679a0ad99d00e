"""oc_nbody_tpu_torch.ops (see the package docstring)."""
