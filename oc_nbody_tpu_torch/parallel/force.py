"""The row-sharded force over a device mesh (counterpart of the f32 half of
``oc_nbody_tpu/parallel/force.py``).

Each of the mesh's d shards owns N/d target rows. The JAX package runs one
``shard_map`` program over its mesh; the port is single-controller: one
process drives the d shards, each on its ``torch.device`` (several shards
may share one device: ``Mesh.on_one_device``). Four source strategies, as
in the JAX package:

  * ``allgather`` — each shard sweeps its rows against all N sources, the
    rows-vs-sources route of ``ops/cuda_gravity.py`` (K18 / K5, or K1 / K4
    below their source thresholds);
  * ``ring`` — the sources stay sharded and circulate: d hops, one
    rows-vs-sources evaluation each, the hops' partial sums added by Kahan
    steps as eager tensor ops between the hops (``_two_sum``; the JAX
    package's force.py:711-739), then the slabs move one shard on;
  * ``rdma`` — the ring as kernels that carry the Kahan step inside: K20 /
    K21 with the slab copies overlapped on side streams
    (``ops/cuda_ring.py``; the JAX package's Pallas ring,
    ops/pallas_ring.py);
  * ``halfring`` — pair-symmetric: each unordered shard pair computed once
    by the cross-pair kernels K12 / K13 (action and reaction), ⌈(d-1)/2⌉
    hops, the reactions returned to their owners (``_halfring``; the JAX
    package's ``_halfring_sweep``, force.py:75-189).

The positions are centred and cast ONCE on the global state
(``gravity.prepare_f32``), padded with zero-mass particles to a multiple of
8 d and cut into d equal shards (``_pad``, force.py:294-304). The results
are gathered to the state's device, where the external field is added on
the global state; ``accel_potential`` adds ``self_phi`` in every mode but
``halfring``, whose diagonal potential comes self-corrected (force.py:
813-818). Every cross-shard sum runs in a fixed order with no float
atomics, so every mode is bitwise repeatable. A shard's kernels launch
with its card current (``cuda_gravity.on_device``), on that card's
current stream, which orders them after the copies that brought their
operands; the copies between cards are ``Tensor.to``.

The f32 tier only. The extended tier, block steps (``accel_jerk_on_rows``)
and escape pruning (``with_sources``) on a mesh are not ported yet and
raise NotImplementedError naming their ROADMAP items (A17b, A17a, A17c);
df32 on a mesh and ``rdma`` at the extended tier raise ValueError, as
``make_sharded_force`` does in the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from oc_nbody_tpu_torch.models.potentials import Potential
from oc_nbody_tpu_torch.ops import cuda_gravity as cg
from oc_nbody_tpu_torch.ops import cuda_ring, gravity
from oc_nbody_tpu_torch.parallel.mesh import Mesh
from oc_nbody_tpu_torch.utils.profiling import span

MODES = ("allgather", "ring", "rdma", "halfring")


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _two_sum(acc, comp, partial):
    """One Kahan step across ring hops, as eager tensor ops (each its own
    kernel on the card, so nothing contracts or reassociates them)."""
    y = partial - comp
    t = acc + y
    return t, (t - acc) - y


def check_sharded(mode: str, precision: str) -> None:
    """The JAX package's refusals of a sharded force (ValueError), then the
    port's: the extended tier on a mesh is not ported yet."""
    if mode not in MODES:
        raise ValueError(f"unknown sharded-force mode {mode!r}; the modes "
                         f"are {MODES}")
    if precision not in ("f32", "extended"):
        raise ValueError(
            f"sharded force precision {precision!r} not supported; use "
            "'f32' or 'extended' (df32 is single-device only)")
    if mode == "rdma" and precision == "extended":
        raise ValueError("mode='rdma' is f32-only (the extended tier rides "
                         "the ring and allgather collectives)")
    if precision == "extended":
        raise NotImplementedError(
            "the extended tier on a mesh is not ported yet (ROADMAP A17b); "
            "the port shards the f32 tier")


@dataclasses.dataclass(frozen=True)
class ShardedForce:
    """Row-sharded pairwise force plus the static external field, over
    ``mesh``; the public methods of ``forces.ForceModel`` that the KDK and
    Hermite steppers and the diagnostics call."""

    eps: float
    G: float
    external: Optional[Potential] = None
    mesh: Mesh = None
    mode: str = "allgather"
    softened: bool = False
    # the rdma mode's slabs, sums and streams, reused across evaluations
    buffers: cuda_ring.RingBuffers = dataclasses.field(
        default_factory=cuda_ring.RingBuffers, compare=False, repr=False)

    def at_time(self, t) -> "ShardedForce":
        """A no-op, as ``ForceModel.at_time``: only static fields are
        ported."""
        return self

    def with_sources(self, src_idx, src_wgt, src_mask):
        raise NotImplementedError("escape pruning on a mesh is not ported "
                                  "yet (ROADMAP A17c)")

    def accel_jerk_on_rows(self, *args, **kw):
        raise NotImplementedError("block steps on a mesh (the active rows "
                                  "against sharded sources) are not ported "
                                  "yet (ROADMAP A17a)")

    # ---- shards -----------------------------------------------------------
    @property
    def _guarded(self) -> bool:
        return not self.softened

    def _pad(self, arrays, n):
        """Each array padded with zeros (zero-mass particles at the centre)
        to a multiple of 8 d rows."""
        n_pad = _round_up(n, 8 * self.mesh.n_devices)
        if n_pad == n:
            return list(arrays)
        return [torch.cat([a, a.new_zeros((n_pad - n,) + a.shape[1:])])
                for a in arrays]

    def _split(self, a):
        """One padded global array cut into the mesh's d equal row shards,
        each on its device."""
        size = a.shape[0] // self.mesh.n_devices
        with span("parallel.exchange", moves=a):
            return [a[s * size:(s + 1) * size].to(dev).contiguous()
                    for s, dev in enumerate(self.mesh.devices)]

    @staticmethod
    def _gather(outs, n, device, dtype):
        """The shards' outputs concatenated on ``device``, unpadded."""
        with span("parallel.exchange", moves=outs):
            moved = [o.to(device) for o in outs]
        return torch.cat(moved)[:n].to(dtype)

    # ---- the four modes; each returns, per shard, a tuple of outputs --------
    def _allgather(self, want, planes, shards):
        full = {}
        for dev in self.mesh.devices:
            if dev not in full:
                with span("parallel.exchange", moves=planes):
                    full[dev] = tuple(p.to(dev) for p in planes)
        return [self._rows(want, shards[s], full[dev], dev)
                for s, dev in enumerate(self.mesh.devices)]

    def _rows(self, want, rows, src, dev):
        """One shard's rows against ``src`` (pos, [vel,] mass) through the
        rows-vs-sources route, launched on the shard's device: a tuple of
        outputs."""
        eps, G, g = self.eps, self.G, self._guarded
        with cg.on_device(dev):
            if want == "jerk":
                return cg.accel_jerk_rows(rows[0], rows[1], *src, eps, G, 0,
                                          g)
            if want == "phi":
                return cg.accel_potential_rows(rows[0], src[0], src[1], eps,
                                               G, 0, g)
            return (cg.accel_rows(rows[0], src[0], src[1], eps, G, 0, g),)

    def _ring(self, want, shards):
        devs, d = self.mesh.devices, self.mesh.n_devices
        acc = comp = None
        circ = list(shards)
        for hop in range(d):
            parts = [self._rows(want, shards[s], circ[s], devs[s])
                     for s in range(d)]
            if acc is None:
                acc = [tuple(torch.zeros_like(x) for x in p) for p in parts]
                comp = [tuple(torch.zeros_like(x) for x in p) for p in parts]
            for s in range(d):
                pairs = [_two_sum(a, c, x)
                         for a, c, x in zip(acc[s], comp[s], parts[s])]
                acc[s] = tuple(p[0] for p in pairs)
                comp[s] = tuple(p[1] for p in pairs)
            if hop < d - 1:   # shard s now holds what shard s - 1 held
                with span("parallel.exchange", moves=circ):
                    circ = [tuple(x.to(devs[s]) for x in circ[(s - 1) % d])
                            for s in range(d)]
        return acc

    def _rdma(self, want, shards):
        eps, G, g = self.eps, self.G, self._guarded
        pos = [sh[0] for sh in shards]
        mass = [sh[-1] for sh in shards]
        kw = dict(guarded=g, buffers=self.buffers)
        if want == "jerk":
            return cuda_ring.accel_jerk_ring(pos, [sh[1] for sh in shards],
                                             mass, eps, G, **kw)
        if want == "phi":
            return cuda_ring.accel_potential_ring(pos, mass, eps, G, **kw)
        return [(a,) for a in cuda_ring.accel_ring(pos, mass, eps, G, **kw)]

    def _halfring_fns(self, want):
        """(diag, cross): a shard's pair-symmetric self-interaction through
        the public dispatchers (K2 / K3 or K1 / K4 by size; the potential
        self-corrected) and the cross-pair kernels on two shards (K12 /
        K13), ``cross(rows, circ) -> (outputs on rows, outputs on circ)``."""
        eps, G, g = self.eps, self.G, self._guarded
        if want == "jerk":
            def diag(p, v, m):
                return cg.accel_jerk(p, v, m, eps, G, g)

            def cross(rows, circ):
                aA, jA, aB, jB = cg.accel_jerk_cross_pair(
                    rows[0], rows[1], circ[0], circ[1], rows[2], circ[2], eps,
                    G, g)
                return (aA, jA), (aB, jB)
        elif want == "phi":
            def diag(p, m):
                return cg.accel_potential(p, m, eps, G, g)

            def cross(rows, circ):
                aA, pA, aB, pB = cg.accel_potential_cross_pair(
                    rows[0], circ[0], rows[1], circ[1], eps, G, g)
                return (aA, pA), (aB, pB)
        else:
            def diag(p, m):
                return (cg.accel(p, m, eps, G, g),)

            def cross(rows, circ):
                aA, aB = cg.accel_cross_pair(rows[0], circ[0], rows[1],
                                             circ[1], eps, G, g)
                return (aA,), (aB,)
        return diag, cross

    def _halfring(self, want, shards):
        """Each unordered shard pair once (the JAX package's
        ``_halfring_sweep``): at hop t = 1 .. (d-1)//2 shard s meets shard
        s + t, taking the action on its rows and keeping the reaction for
        shard s + t; for even d, shard s meets shard s + d/2 in two
        half-by-half quadrants (shard s < d/2 takes (first, first) and
        (second, second), its partner the two others), so all four are
        computed once. The actions are added by Kahan steps; each owner
        receives its reactions summed in the order of the shards that
        computed them, then added by one more Kahan step."""
        devs, d = self.mesh.devices, self.mesh.n_devices
        diag_fn, cross_fn = self._halfring_fns(want)

        def diag(s):
            with cg.on_device(devs[s]):
                return diag_fn(*shards[s])

        def cross(s, rows, circ):
            with cg.on_device(devs[s]):
                return cross_fn(rows, circ)

        acc = [diag(s) for s in range(d)]
        if d == 1:
            return acc
        comp = [tuple(torch.zeros_like(a) for a in acc_s) for acc_s in acc]
        react = [{} for _ in range(d)]     # react[s][owner]: on s's device

        def add(s, outs):
            pairs = [_two_sum(a, c, x) for a, c, x in zip(acc[s], comp[s],
                                                           outs)]
            acc[s] = tuple(p[0] for p in pairs)
            comp[s] = tuple(p[1] for p in pairs)

        def visit(s, k):
            with span("parallel.exchange", moves=shards[k]):
                return tuple(x.to(devs[s]) for x in shards[k])

        for t in range(1, (d - 1) // 2 + 1):
            for s in range(d):
                k = (s + t) % d
                outs_a, outs_b = cross(s, shards[s], visit(s, k))
                add(s, outs_a)
                react[s][k] = outs_b
        if d % 2 == 0:
            size = shards[0][0].shape[0]
            h = size // 2
            for s in range(d):
                k = (s + d // 2) % d
                circ = visit(s, k)
                s1 = 0 if s < d // 2 else h
                o1a, o1b = cross(s, tuple(x[:h] for x in shards[s]),
                                 tuple(x[s1:s1 + h] for x in circ))
                o2a, o2b = cross(s, tuple(x[h:] for x in shards[s]),
                                 tuple(x[h - s1:2 * h - s1] for x in circ))
                add(s, tuple(torch.cat([a1, a2])
                             for a1, a2 in zip(o1a, o2a)))
                bufs = []
                for b1, b2 in zip(o1b, o2b):
                    buf = b1.new_zeros((size,) + b1.shape[1:])
                    buf[s1:s1 + h] = b1
                    buf[h - s1:2 * h - s1] = b2
                    bufs.append(buf)
                react[s][k] = tuple(bufs)
        out = []
        for s in range(d):
            recv = None
            for j in range(d):
                if s in react[j]:
                    with span("parallel.exchange", moves=react[j][s]):
                        r = tuple(x.to(devs[s]) for x in react[j][s])
                    recv = r if recv is None else tuple(
                        a + b for a, b in zip(recv, r))
            out.append(tuple(_two_sum(a, c, x)[0]
                             for a, c, x in zip(acc[s], comp[s], recv)))
        return out

    def _sharded(self, want, pos, mass, vel=None):
        """Centre and cast once, pad, split, run the mode, gather: the
        pairwise outputs on the state's device, unpadded, in pos.dtype,
        plus the f32 masses (for ``self_phi``)."""
        n = pos.shape[0]
        if want == "jerk":
            pos_c, mass_c, vel_c = gravity.prepare_f32(pos, mass, vel=vel)
            planes = self._pad([pos_c, vel_c, mass_c], n)
        else:
            pos_c, mass_c = gravity.prepare_f32(pos, mass)
            planes = self._pad([pos_c, mass_c], n)
        cut = [self._split(p) for p in planes]
        shards = [tuple(c[s] for c in cut)
                  for s in range(self.mesh.n_devices)]
        if self.mode == "allgather":
            outs = self._allgather(want, planes, shards)
        elif self.mode == "ring":
            outs = self._ring(want, shards)
        elif self.mode == "rdma":
            outs = self._rdma(want, shards)
        else:
            outs = self._halfring(want, shards)
        return [self._gather([o[i] for o in outs], n, pos.device, pos.dtype)
                for i in range(len(outs[0]))], mass_c

    # ---- the public evaluations (ForceModel's contracts) --------------------
    def accel(self, pos, mass):
        """Total acceleration, pairwise + external; (N, 3) in pos.dtype."""
        (acc,), _ = self._sharded("accel", pos, mass)
        if self.external is not None:
            acc = acc + self.external.accel(pos)
        return acc

    def accel_potential(self, pos, mass):
        """(accel, phi_pair, phi_ext) per particle, the self term removed
        from phi_pair."""
        (acc, phi), mass_c = self._sharded("phi", pos, mass)
        if self.mode != "halfring":
            phi = (phi.to(torch.float32) + gravity.self_phi(
                mass_c, self.eps, cg._f32(self.G))).to(pos.dtype)
        if self.external is not None:
            acc = acc + self.external.accel(pos)
            phi_ext = self.external.phi(pos)
        else:
            phi_ext = torch.zeros_like(phi)
        return acc, phi, phi_ext

    def accel_jerk(self, pos, vel, mass):
        """(accel, jerk), pairwise + external, in pos.dtype."""
        (acc, jerk), _ = self._sharded("jerk", pos, mass, vel=vel)
        if self.external is not None:
            a_ext, da_ext = self.external.accel_jerk_ext(pos, vel)
            acc = acc + a_ext
            jerk = jerk + da_ext
        return acc, jerk


def make_sharded_force(eps, G=1.0, external: Optional[Potential] = None,
                       mesh: Mesh = None, mode: str = "allgather",
                       precision: str = "f32") -> ShardedForce:
    """A ShardedForce over ``mesh``; ``precision`` is checked (the port
    shards the f32 tier) and not stored."""
    check_sharded(mode, precision)
    if mesh is None:
        raise ValueError("make_sharded_force needs a mesh (parallel.mesh."
                         "make_mesh or Mesh.on_one_device)")
    return ShardedForce(eps=float(eps), G=float(G), external=external,
                        mesh=mesh, mode=mode, softened=float(eps) > 0)


def route(n: int, d: int, mode: str, kind: str = "kdk") -> str:
    """The kernels of one sharded force evaluation at N = n on d shards:
    the accel (and the diagnostics potential, its potential form) under
    KDK, the accel + jerk under Hermite."""
    size = _round_up(n, 8 * d) // d
    jerk = kind != "kdk"
    if mode == "rdma":
        k = "K21" if jerk else "K20 (K20<phi> for the potential)"
        return (f"{k}: {d} launches per shard, {d * d} in all, of {size} x "
                f"{size} pairs, the slabs handed on by {d * (d - 1)} copies")
    if mode == "allgather":
        k = cg.KERNEL_LABEL[cg.rows_route(size, size * d, jerk)]
        return f"{k}: one launch per shard of {size} x {size * d} pairs"
    if mode == "ring":
        k = cg.KERNEL_LABEL[cg.rows_route(size, size, jerk)]
        return (f"{k}: {d} hops per shard, {d * d} launches in all, of "
                f"{size} x {size} pairs, with Kahan steps between hops")
    diag = ("K3" if size >= cg.RT_MIN_JERK else "K4") if jerk else (
        "K2" if size >= cg.SYM_MIN else "K1")
    cross = "K13" if jerk else "K12"
    n_cross = d * ((d - 1) // 2) + (2 * d if d % 2 == 0 and d > 1 else 0)
    return (f"{diag} on each shard's {size} rows, {cross} on {n_cross} "
            "shard-pair launches (each unordered pair once)")
