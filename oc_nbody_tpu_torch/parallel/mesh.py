"""The device mesh of a sharded run (counterpart of
``oc_nbody_tpu/parallel/mesh.py``).

The JAX package runs one program over a 1-D ``jax.sharding.Mesh``; the port
is single-controller too: one process drives d shards, each on a
``torch.device``. ``make_mesh`` takes the first n visible cards (on the CPU
there is one device); ``Mesh.on_one_device`` puts d shards on one device,
the counterpart of the JAX tests' ``jax_num_cpu_devices = 8``, for the
tests and the smoke test. No config key reaches it: a config's
``mesh.n_devices`` counts devices.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

AXIS = "shard"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An ordered tuple of shard devices along one axis."""

    devices: tuple
    axis_name: str = AXIS

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one shard")
        object.__setattr__(self, "devices",
                           tuple(torch.device(d) for d in self.devices))

    @property
    def n_devices(self) -> int:
        """The number of shards (not of distinct devices)."""
        return len(self.devices)

    @classmethod
    def on_one_device(cls, d: int, device="cuda") -> "Mesh":
        """d shards on one device: the sharded schedule's copies and
        launches without a second device (tests, the smoke test)."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", 0)
        if d < 1:
            raise ValueError(f"a mesh needs at least one shard, got {d}")
        return cls(devices=(device,) * d)

    def describe(self) -> str:
        """'4 shards on cuda:0 (one device)' or '2 shards on cuda:0,
        cuda:1'."""
        if len(set(self.devices)) == 1:
            return (f"{self.n_devices} shard{'s' if self.n_devices > 1 else ''}"
                    f" on {self.devices[0]} (one device)")
        return (f"{self.n_devices} shards on "
                f"{', '.join(str(d) for d in self.devices)}")


def make_mesh(n_devices: Optional[int] = None, device="cuda") -> Mesh:
    """A 1-D mesh over the first ``n_devices`` visible devices of
    ``device``'s type, the CUDA cards or the one CPU (all of them if 0 or
    None); ValueError when more are requested than are visible."""
    device = torch.device(device)
    visible = torch.cuda.device_count() if device.type == "cuda" else 1
    if n_devices in (None, 0):
        n = visible
    else:
        if n_devices > visible:
            raise ValueError(f"requested {n_devices} devices, only {visible} "
                             f"visible ({device.type})")
        n = n_devices
    if n < 1:
        raise ValueError(f"no {device.type} device is visible")
    if device.type == "cuda":
        devices = tuple(torch.device("cuda", i) for i in range(n))
    else:
        devices = (torch.device("cpu"),)
    return Mesh(devices=devices)
