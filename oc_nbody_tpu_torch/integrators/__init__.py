"""oc_nbody_tpu_torch.integrators (see the package docstring)."""
