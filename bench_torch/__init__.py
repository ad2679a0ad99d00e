"""The benchmark of the PyTorch / CUDA port (``oc_nbody_tpu_torch``).

``run.py`` runs one cell of ``BENCHMARK.json`` once; see ``harness.py``.
"""
