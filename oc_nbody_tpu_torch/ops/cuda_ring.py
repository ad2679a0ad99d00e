"""The sharded ring on the card: the source slabs of a d-shard mesh
circulate past every shard's rows, one hand-written CUDA kernel launch per
shard and ring step (counterpart of ``oc_nbody_tpu/ops/pallas_ring.py``).

  * K20 ``csrc/ring_accel.cu`` — one ring step of the accel, and as
    K20<phi> of the accel and the pair potential: a shard's rows against
    one circulating slab, the step's sum added into the shard's running
    sums by a Kahan step inside the kernel's last pass (stored at the first
    step). Replaces ``_ring_kernel`` and ``_ring_phi_kernel``
    (oc_nbody_tpu/ops/pallas_ring.py:135, :169).
  * K21 ``csrc/ring_jerk.cu`` — the same for accel + jerk, the slab
    carrying velocities too. Replaces ``_ring_jerk_kernel``
    (pallas_ring.py:202).

The TPU kernels hold the whole ring in one kernel: each chip sweeps slot
k % 2 of a double-buffered slab while a remote copy sends that slot into
its right neighbour's other slot, under a free-slot semaphore handshake
(``_ring_steps``, pallas_ring.py:100-132). Here the schedule is the host's,
over one compute and one copy stream per shard, and CUDA events do the
semaphores' work:

  * sweep (s, k) runs K20/K21 on shard s's slot k % 2 on its compute
    stream; at k > 0 it waits for the copy that filled that slot (the
    ``recv_sem``);
  * copy (s, k), for k < d - 1, sends slot k % 2 of shard s into slot
    1 - k % 2 of shard s + 1 on shard s's copy stream, overlapping the
    sweep. It waits for its own slot to have arrived, and for shard s + 1
    to have swept and sent on the slot it overwrites (the free-slot
    handshake: a slot is overwritten only once it is fully swept and fully
    sent);
  * so shard s accumulates the slabs of shards s, s - 1, ..., s - d + 1,
    the JAX order.

Each evaluation starts its streams after the current streams (where the
inputs and the slabs' first fill were enqueued) and ends by making the
current streams wait for every stream of the ring, so one evaluation's
first write into a slot comes after the previous evaluation's last sweep
and copy of it. The slabs, the running sums, their compensations, the
kernels' scratch and the streams live in a ``RingBuffers`` that the caller
keeps (a ShardedForce keeps one): allocated at the first evaluation of a
(kind, devices, shard size) and reused by the next; without one, each call
allocates its own. The results are returned as copies. Inputs used on a
side stream are marked with ``Tensor.record_stream``. With ``serial``
the host waits for the devices after every ring step: the same schedule
without overlap, which a run with overlap must match bitwise.

At d = 1 there is no slab, no copy and no compensation: one launch from
the shard's own planes (pallas_ring.py:142-151, :245). On the CPU the
schedule runs in order, with the plain twins ``ring_step_plain`` and
``ring_step_jerk_plain`` (``ops/gravity.py``'s rows sums, then the same
store or Kahan step as eager tensor ops); there is no fallback from the
kernel to a twin. ``cuda_gravity.LAUNCHES`` / ``PLAIN_CALLS`` count K20
under ``ring``, K20<phi> under ``ring_phi`` and K21 under ``ring_jerk``.

The public ``accel_ring``, ``accel_potential_ring`` and ``accel_jerk_ring``
take one tensor per shard, each on its shard's device: positions (and
velocities) centred in ONE frame for the whole set and cast to f32, and
the f32 masses; ``G m`` is formed in f32 here, as ``pallas_ring`` does.
They return one tensor per shard: f32 accel, the potential with the
softened self term kept (the caller adds ``gravity.self_phi``), and jerk.
"""
from __future__ import annotations

import dataclasses

import torch

from oc_nbody_tpu_torch.ops import cuda_gravity as cg
from oc_nbody_tpu_torch.ops import gravity
from oc_nbody_tpu_torch.utils.profiling import span

_F32 = torch.float32
# kind -> (planes per source in a slab slot: positions, [velocities], G m)
_CHANNELS = {"ring": 4, "ring_phi": 4, "ring_jerk": 7}


# --------------------------------------------------------------------------
# plain twins (the reference the kernels are held to; CPU path)
# --------------------------------------------------------------------------

def _accumulate(out, comp, part, first):
    """``_accumulate_t`` in place: store ``part`` (zeroing ``comp``) at the
    first step, else add it into (out, comp) by a Kahan step."""
    if first:
        out.copy_(part)
        if comp is not None:
            comp.zero_()
        return
    y = part - comp
    t = out + y
    comp.copy_((t - out) - y)
    out.copy_(t)


def ring_step_plain(rows, src, gm, eps, acc, acc_comp=None, phi=None,
                    phi_comp=None, *, first, dtype=_F32, chunk=1024):
    """K20's function in plain PyTorch, in place: the accel (and, with
    ``phi``, the potential, self term kept) of ``rows`` from the slab
    (``src``, ``gm`` = G m), summed in ``dtype`` (f64: the oracle the
    kernel is held to on the card), then stored into ``acc`` / ``phi`` at
    the ``first`` step or added into them by a Kahan step with
    ``acc_comp`` / ``phi_comp``."""
    with_phi = phi is not None
    cg.PLAIN_CALLS["ring_phi" if with_phi else "ring"] += 1
    args = (rows.to(dtype), src.to(dtype), gm.to(dtype), eps, 1.0, chunk)
    if with_phi:
        a, p = gravity.accel_potential_rows(*args)
        _accumulate(phi, phi_comp, p.to(phi.dtype), first)
    else:
        a = gravity.accel_rows(*args)
    _accumulate(acc, acc_comp, a.to(acc.dtype), first)


def ring_step_jerk_plain(rows, vrows, src, svel, gm, eps, acc, jerk,
                         acc_comp=None, jerk_comp=None, *, first,
                         dtype=_F32, chunk=1024):
    """K21's function in plain PyTorch, in place: the accel + jerk of
    ``rows`` moving at ``vrows`` from the slab (``src``, ``svel``, ``gm``),
    summed in ``dtype``, then stored or added by Kahan steps as in
    ``ring_step_plain``."""
    cg.PLAIN_CALLS["ring_jerk"] += 1
    a, j = gravity.accel_jerk_rows(
        *(t.to(dtype) for t in (rows, vrows, src, svel, gm)), eps, 1.0,
        chunk)
    _accumulate(acc, acc_comp, a.to(acc.dtype), first)
    _accumulate(jerk, jerk_comp, j.to(jerk.dtype), first)


# --------------------------------------------------------------------------
# kernel launches
# --------------------------------------------------------------------------

def _check_running(nr, first, **sums):
    """The running sums and compensations: f32, (nr, 3) or (nr,), on one
    device; a compensation may be None only at the first step."""
    for name, (t, shape) in sums.items():
        if t is None:
            if not first and name.endswith("_comp"):
                raise ValueError(f"{name} is needed past the first ring step")
            continue
        cg._check_f32(name, t, shape)


def _same_device(*tensors):
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1:
        raise ValueError(f"a ring step's tensors must share one device, got "
                         f"{sorted(map(str, devs))}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def ring_step_kernel(rows, src, gm, eps, acc, acc_comp=None, phi=None,
                     phi_comp=None, *, first, guarded=True, scratch=None):
    """Launch K20 (K20<phi> with ``phi``) on f32 CUDA tensors centred in
    one frame, in place; the same contract as ``ring_step_plain``.
    ``scratch``, if given, is a float32 buffer of at least
    ``ring_scratch_floats(nr, ns, with_phi)`` elements."""
    nr, ns = rows.shape[0], src.shape[0]
    with_phi = phi is not None
    cg._check_f32("rows", rows, (nr, 3))
    cg._check_f32("src", src, (ns, 3))
    cg._check_f32("gm", gm, (ns,))
    _check_running(nr, first, acc=(acc, (nr, 3)),
                   acc_comp=(acc_comp, (nr, 3)),
                   **({"phi": (phi, (nr,)), "phi_comp": (phi_comp, (nr,))}
                      if with_phi else {}))
    _same_device(rows, src, gm, acc, acc_comp, phi, phi_comp)
    lib = cg._library()
    scratch = cg._scratch(ring_scratch_floats(nr, ns, with_phi=with_phi),
                          rows.device, scratch)
    key = "ring_phi" if with_phi else "ring"
    code = lib.ocn_ring_accel(
        rows.data_ptr(), nr, src.data_ptr(), gm.data_ptr(), ns,
        cg._f32(cg._f32(eps) ** 2), int(guarded), int(first),
        scratch.data_ptr(), acc.data_ptr(), _ptr(acc_comp), _ptr(phi),
        _ptr(phi_comp), cg._stream(rows))
    cg.LAUNCHES[key] += 1
    cg._check_launch(lib, code, key)


def ring_step_jerk_kernel(rows, vrows, src, svel, gm, eps, acc, jerk,
                          acc_comp=None, jerk_comp=None, *, first,
                          guarded=True, scratch=None):
    """Launch K21 on f32 CUDA tensors centred in one frame, in place; the
    same contract as ``ring_step_jerk_plain``. ``scratch``, if given, is a
    float32 buffer of at least ``ring_scratch_floats(nr, ns, jerk=True)``
    elements."""
    nr, ns = rows.shape[0], src.shape[0]
    cg._check_planes(nr, rows=rows, vrows=vrows)
    cg._check_planes(ns, src=src, svel=svel)
    cg._check_f32("gm", gm, (ns,))
    _check_running(nr, first, acc=(acc, (nr, 3)), jerk=(jerk, (nr, 3)),
                   acc_comp=(acc_comp, (nr, 3)),
                   jerk_comp=(jerk_comp, (nr, 3)))
    _same_device(rows, vrows, src, svel, gm, acc, jerk, acc_comp, jerk_comp)
    lib = cg._library()
    scratch = cg._scratch(ring_scratch_floats(nr, ns, jerk=True),
                          rows.device, scratch)
    code = lib.ocn_ring_jerk(
        rows.data_ptr(), vrows.data_ptr(), nr, src.data_ptr(),
        svel.data_ptr(), gm.data_ptr(), ns, cg._f32(cg._f32(eps) ** 2),
        int(guarded), int(first), scratch.data_ptr(), acc.data_ptr(),
        _ptr(acc_comp), jerk.data_ptr(), _ptr(jerk_comp), cg._stream(rows))
    cg.LAUNCHES["ring_jerk"] += 1
    cg._check_launch(lib, code, "ring_jerk")


def ring_scratch_floats(nr: int, ns: int, with_phi: bool = False,
                        jerk: bool = False) -> int:
    """Floats of scratch K20 (K20<phi> with ``with_phi``, K21 with
    ``jerk``) needs on nr rows against ns slab sources."""
    lib = cg._library()
    if jerk:
        return lib.ocn_ring_jerk_scratch(nr, ns)
    return lib.ocn_ring_accel_scratch(nr, ns, int(with_phi))


def ring_step(rows, src, gm, eps, acc, acc_comp=None, phi=None,
              phi_comp=None, *, first, guarded=True, scratch=None):
    """One ring step of the accel (and potential): K20 for CUDA tensors,
    its plain twin for CPU tensors."""
    if cg._on_cuda(rows, src, gm, acc):
        ring_step_kernel(rows, src, gm, eps, acc, acc_comp, phi, phi_comp,
                         first=first, guarded=guarded, scratch=scratch)
    else:
        ring_step_plain(rows, src, gm, eps, acc, acc_comp, phi, phi_comp,
                        first=first)


def ring_step_jerk(rows, vrows, src, svel, gm, eps, acc, jerk, acc_comp=None,
                   jerk_comp=None, *, first, guarded=True, scratch=None):
    """One ring step of the accel + jerk: K21 for CUDA tensors, its plain
    twin for CPU tensors."""
    if cg._on_cuda(rows, vrows, src, svel, gm, acc, jerk):
        ring_step_jerk_kernel(rows, vrows, src, svel, gm, eps, acc, jerk,
                              acc_comp, jerk_comp, first=first,
                              guarded=guarded, scratch=scratch)
    else:
        ring_step_jerk_plain(rows, vrows, src, svel, gm, eps, acc, jerk,
                             acc_comp, jerk_comp, first=first)


# --------------------------------------------------------------------------
# the ring schedule
# --------------------------------------------------------------------------

@dataclasses.dataclass
class _Ring:
    """The buffers of one (kind, devices, shard size): per shard the
    double-buffered slab (2, channels * S), the running sums and their
    compensations, the kernel scratch, and on the card a compute and a
    copy stream."""
    key: tuple
    slabs: list
    sums: list
    comps: list
    scratch: list
    compute: list
    copy: list


class RingBuffers:
    """The ring buffers of one caller, one ``_Ring`` per kind: a ring of
    other devices or another shard size replaces the kind's last one."""

    def __init__(self):
        self.rings = {}

    def get(self, kind, devices, size) -> _Ring:
        key = (tuple(devices), size)
        ring = self.rings.get(kind)
        if ring is None or ring.key != key:
            self.rings.pop(kind, None)
            ring = self.rings[kind] = _new_ring(kind, devices, size, key)
        return ring


def _new_ring(kind, devices, size, key) -> _Ring:
    chans = _CHANNELS[kind]
    shapes = ((size, 3), (size,)) if kind == "ring_phi" else (
        ((size, 3), (size, 3)) if kind == "ring_jerk" else ((size, 3),))
    ring = _Ring(key=key, slabs=[], sums=[], comps=[], scratch=[],
                 compute=[], copy=[])
    for dev in devices:
        def buf(shape):
            return torch.empty(shape, dtype=_F32, device=dev)
        ring.slabs.append(buf((2, chans * size)))
        ring.sums.append(tuple(buf(sh) for sh in shapes))
        ring.comps.append(tuple(buf(sh) for sh in shapes))
        if dev.type == "cuda":
            ring.scratch.append(buf((ring_scratch_floats(
                size, size, with_phi=kind == "ring_phi",
                jerk=kind == "ring_jerk"),)))
            ring.compute.append(torch.cuda.Stream(dev))
            ring.copy.append(torch.cuda.Stream(dev))
        else:
            ring.scratch.append(None)
    return ring


def _record(stream):
    ev = torch.cuda.Event()
    ev.record(stream)
    return ev


def _circulate(ring: _Ring, sweep, d: int, serial: bool) -> None:
    """The d ring steps over the slabs of ``ring``: ``sweep(s, slot,
    first)`` sweeps shard s's rows against its slab slot, and each slot is
    handed on to the right neighbour's other slot while it is swept (the
    module docstring's schedule)."""
    slabs = ring.slabs
    if not ring.compute:                      # the CPU: in order
        for k in range(d):
            for s in range(d):
                sweep(s, k % 2, k == 0)
            if k < d - 1:
                for s in range(d):
                    src = slabs[s][k % 2]
                    with span("parallel.exchange", moves=src):
                        slabs[(s + 1) % d][1 - k % 2].copy_(src)
        return
    devices = [slab.device for slab in slabs]
    cur = [torch.cuda.current_stream(dev) for dev in devices]
    ready = [_record(stream) for stream in cur]
    for s in range(d):
        ring.compute[s].wait_event(ready[s])
        ring.copy[s].wait_event(ready[s])
    swept = [[None] * d for _ in range(d)]
    sent = [[None] * d for _ in range(d)]
    for k in range(d):
        slot = k % 2
        for s in range(d):
            stream = ring.compute[s]
            with torch.cuda.stream(stream):
                if k > 0:   # the slot arrived from the left neighbour
                    stream.wait_event(sent[(s - 1) % d][k - 1])
                sweep(s, slot, k == 0)
                swept[s][k] = _record(stream)
        if k < d - 1:
            for s in range(d):
                right = (s + 1) % d
                stream = ring.copy[s]
                with torch.cuda.stream(stream):
                    if k > 0:   # ours arrived; right's is swept and sent
                        for ev in (sent[(s - 1) % d][k - 1],
                                   swept[right][k - 1], sent[right][k - 1]):
                            stream.wait_event(ev)
                    src = slabs[s][slot]
                    with span("parallel.exchange", moves=src):
                        slabs[right][1 - slot].copy_(src, non_blocking=True)
                    sent[s][k] = _record(stream)
        if serial:
            for dev in set(devices):
                torch.cuda.synchronize(dev)
    for s in range(d):
        cur[s].wait_event(swept[s][d - 1])
        cur[s].wait_event(sent[s][d - 2])


def _fill(ring: _Ring, planes) -> None:
    """Slot 0 of every shard's slab from its own planes (flattened, in the
    slab's channel order), on the current streams."""
    for slab, parts in zip(ring.slabs, planes):
        torch.cat([p.reshape(-1) for p in parts], out=slab[0])


def _views(slot, size, jerk):
    """(src, [svel,] gm) views of one slab slot."""
    src = slot[:3 * size].view(size, 3)
    if not jerk:
        return src, slot[3 * size:]
    return src, slot[3 * size:6 * size].view(size, 3), slot[6 * size:]


def _gm(mass, G):
    return (mass.to(_F32) * cg._f32(G)).contiguous()


def _check_shards(*groups):
    """Each group holds one tensor per shard; every shard has the same
    size, and a shard's tensors share a device."""
    d = len(groups[0])
    if d == 0 or any(len(g) != d for g in groups):
        raise ValueError("one tensor per shard is needed in every group")
    size = groups[0][0].shape[0]
    for s in range(d):
        shard = [g[s] for g in groups]
        if any(t.shape[0] != size for t in shard):
            raise ValueError("every shard must hold the same number of rows")
        _same_device(*shard)
    return d, size


def _ring_accel(pos_shards, mass_shards, eps, G, guarded, serial, buffers,
                with_phi):
    d, size = _check_shards(pos_shards, mass_shards)
    kind = "ring_phi" if with_phi else "ring"
    rows = [p.to(_F32).contiguous() for p in pos_shards]
    gms = [_gm(m, G) for m in mass_shards]
    if d == 1:
        acc = torch.empty((size, 3), dtype=_F32, device=rows[0].device)
        phi = (torch.empty((size,), dtype=_F32, device=rows[0].device)
               if with_phi else None)
        with cg.on_device(rows[0].device):
            ring_step(rows[0], rows[0], gms[0], eps, acc, phi=phi,
                      first=True, guarded=guarded)
        return [(acc, phi)] if with_phi else [acc]
    ring = (buffers or RingBuffers()).get(kind, [r.device for r in rows],
                                          size)
    _fill(ring, [(r, g) for r, g in zip(rows, gms)])
    for s, r in enumerate(rows):
        if ring.compute:
            r.record_stream(ring.compute[s])

    def sweep(s, slot, first):
        src, gm = _views(ring.slabs[s][slot], size, False)
        sums, comps = ring.sums[s], ring.comps[s]
        ring_step(rows[s], src, gm, eps, sums[0], comps[0],
                  *((sums[1], comps[1]) if with_phi else ()), first=first,
                  guarded=guarded, scratch=ring.scratch[s])

    _circulate(ring, sweep, d, serial)
    out = [tuple(t.clone() for t in sums) for sums in ring.sums]
    return out if with_phi else [o[0] for o in out]


def accel_ring(pos_shards, mass_shards, eps, G=1.0, guarded: bool = True,
               serial: bool = False, buffers: RingBuffers = None):
    """The accel on every shard's rows from ALL shards, the slabs
    circulating around the ring (K20, d launches per shard); one f32 (S, 3)
    tensor per shard, on its device."""
    return _ring_accel(pos_shards, mass_shards, eps, G, guarded, serial,
                       buffers, False)


def accel_potential_ring(pos_shards, mass_shards, eps, G=1.0,
                         guarded: bool = True, serial: bool = False,
                         buffers: RingBuffers = None):
    """(accel, phi) per shard from ALL shards (K20<phi>): the sharded
    diagnostics evaluation. phi keeps the softened self term -G m/eps; the
    caller adds ``gravity.self_phi``, as with ``accel_potential_rows``."""
    return _ring_accel(pos_shards, mass_shards, eps, G, guarded, serial,
                       buffers, True)


def accel_jerk_ring(pos_shards, vel_shards, mass_shards, eps, G=1.0,
                    guarded: bool = True, serial: bool = False,
                    buffers: RingBuffers = None):
    """(accel, jerk) per shard from ALL shards (K21, d launches per shard):
    the Hermite force evaluation on the mesh."""
    d, size = _check_shards(pos_shards, vel_shards, mass_shards)
    rows = [p.to(_F32).contiguous() for p in pos_shards]
    vrows = [v.to(_F32).contiguous() for v in vel_shards]
    gms = [_gm(m, G) for m in mass_shards]
    if d == 1:
        acc, jerk = (torch.empty((size, 3), dtype=_F32,
                                 device=rows[0].device) for _ in range(2))
        with cg.on_device(rows[0].device):
            ring_step_jerk(rows[0], vrows[0], rows[0], vrows[0], gms[0], eps,
                           acc, jerk, first=True, guarded=guarded)
        return [(acc, jerk)]
    ring = (buffers or RingBuffers()).get("ring_jerk",
                                          [r.device for r in rows], size)
    _fill(ring, [(r, v, g) for r, v, g in zip(rows, vrows, gms)])
    for s in range(d):
        if ring.compute:
            rows[s].record_stream(ring.compute[s])
            vrows[s].record_stream(ring.compute[s])

    def sweep(s, slot, first):
        src, svel, gm = _views(ring.slabs[s][slot], size, True)
        (acc, jerk), (ca, cj) = ring.sums[s], ring.comps[s]
        ring_step_jerk(rows[s], vrows[s], src, svel, gm, eps, acc, jerk, ca,
                       cj, first=first, guarded=guarded,
                       scratch=ring.scratch[s])

    _circulate(ring, sweep, d, serial)
    return [tuple(t.clone() for t in sums) for sums in ring.sums]

