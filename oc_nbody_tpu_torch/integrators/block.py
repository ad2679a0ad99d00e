"""Block (individual power-of-two) timesteps, Hermite-4 scheme.

Counterpart of ``BlockHermite`` in ``oc_nbody_tpu/integrators/block.py``.
Every particle carries its own (t_i, dt_i) with dt_i = dt_max / 2^k,
k < n_levels; each micro-step advances the system to t_next = min(t_i +
dt_i), predicts ALL particles there (O(N)), evaluates forces only for the
ACTIVE rows (t_i + dt_i == t_next) against all predicted sources, corrects
and re-rungs the active rows.

Integer time grid. t_i and dt_i are int64 tensors on the device in units of
dt_min = dt_max / 2^(n_levels-1): activity is exact integer equality,
growth alignment is ``(t_next % (2 dt_i)) == 0``, and physical times are
``t_origin + t_int * dt_min`` only where needed.

Host and device. Each micro-step enqueues t_next = min(t_i + dt_i), the
active mask and the compaction order ``argsort(~active, stable)`` (the
active rows first, in their original order) on the device, then reads
(t_next, n_active) to the host in one two-element copy: the micro-step's
one sync, which the loop bound of ``advance_to`` needs anyway. The force is
then launched on exactly ``idx[:n_active]``. Time, the micro-step count and
the active-row total live on the host; every f64 operation the JAX package
does on the device is a device op here on the same dtype.

Compaction. The JAX package compacts with ``lax.top_k`` into a ladder of
power-of-two buffer sizes under ``lax.switch``: static shapes for XLA and a
bound on the TPU's scoped VMEM. Eager PyTorch launches on the exact count,
so the ladder is not ported. ``n_buckets = 0`` keeps the masked full-row
evaluation (every row evaluated, the inactive results discarded); any
other value compacts.

Escape pruning. Under a pruned force model (``ForceModel.with_sources``)
the active rows keep the JAX package's contract (its ``_eval_active`` with
the membership, ``ForceModel.accel_jerk_on_rows`` with ``rows_mask``):
cluster rows against all sources, tail rows against the cluster bucket.
The JAX package chooses among all-cluster, all-tail and mixed steps with a
``lax.switch`` and pays both sweeps on every row of a mixed step. Here the
micro-step's one read carries the active cluster count too, the compaction
orders the active cluster rows first and the active tail rows after them,
and each group is launched on exactly its own rows: a step pays rows x N for
its cluster rows and rows x B for its tail rows, never both for one row. A
row's force does not depend on the other rows of its launch, so the result
is the JAX package's. The bucket and the rows in its frame are formed in
``_pre`` with the sources; under CUDA graphs the partition lives in buffers
of the graphs (``_StepGraphs.load_sources``), so a re-partition of the same
bucket size replays the same graphs and a new bucket size captures new
ones.

Rung selector. ``_rung_from_float`` picks the largest power of two <= x
exactly (``torch.frexp``). The JAX package takes floor(jnp.log2(x)), which
rounds down at some exact powers of two (floor(log2(8.0)) is 2 on
XLA:CPU); the two differ only there, and a dt from f32-derived forces
does not land on one.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from oc_nbody_tpu_torch.forces import ForceModel
from oc_nbody_tpu_torch.state import ParticleState
from oc_nbody_tpu_torch.utils.profiling import span

_TINY = torch.finfo(torch.float64).tiny
# what checkpoint_aux writes and restore requires
_AUX_KEYS = ("acc", "jerk", "a_ext", "j_ext", "t_i", "dt_i", "t_origin",
             "n_steps", "n_active_sum", "dt_max", "n_levels")


def _read(sched) -> list:
    """The micro-step's one read: (t_next, n_active[, n_active_cluster])
    to the host."""
    with span("integrator.wait", site="block.schedule"):
        return sched.tolist()


def _norm(x):
    return torch.sqrt(torch.sum(x * x, dim=-1))


def _pruned(force) -> bool:
    """Whether ``force`` carries an escape-pruning partition (a force
    model without the attribute, as the tests' direct sums, does not)."""
    return getattr(force, "pruned", False)


def _interp_derivs(a0, j0, a1, j1, h, inv_h2, inv_h3):
    """Hermite-interpolated (a2 at t1, a3) from endpoint (a, j) pairs."""
    a2_0 = (-6.0 * (a0 - a1) - h * (4.0 * j0 + 2.0 * j1)) * inv_h2
    a3 = (12.0 * (a0 - a1) + 6.0 * h * (j0 + j1)) * inv_h3
    return a2_0 + h * a3, a3


@dataclasses.dataclass(frozen=True)
class BlockCarry:
    state: ParticleState     # pos/vel at per-particle times; time = last t_next
    acc: torch.Tensor        # (N, 3) TOTAL acceleration at t_i
    jerk: torch.Tensor       # (N, 3) TOTAL jerk at t_i
    # external-field parts of acc/jerk at t_i: the rung criterion is applied
    # to the pairwise and external components separately (a total-force
    # Aarseth dt is inflated by the smooth galactic field); zero without one
    a_ext: torch.Tensor      # (N, 3)
    j_ext: torch.Tensor      # (N, 3)
    t_i: torch.Tensor        # (N,) int64, units of dt_min, relative to t_origin
    dt_i: torch.Tensor       # (N,) int64 rung length in dt_min units
    t_origin: float          # physical time at t_int == 0 (host)
    n_steps: int             # micro-steps (host)
    n_active_sum: int        # active-row evaluations (host; work metric)

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class BlockHermite:
    """Individual block-timestep Hermite-4 stepper (integer time grid)."""

    force: ForceModel
    eta: float = 0.02
    eta_init: float = 0.01
    dt_max: float = 1.0 / 16.0
    n_levels: int = 8
    # 0: masked full-row evaluation; otherwise compact to the active rows
    n_buckets: int = 4
    # PEC²: a second (evaluate, correct) pass on the active rows at their
    # corrected state; doubles the active-row force work
    pec2: bool = False
    _graph_cache: dict = dataclasses.field(default_factory=dict, init=False,
                                           repr=False, compare=False)

    @property
    def dt_min(self) -> float:
        return self.dt_max / (1 << (self.n_levels - 1))

    @property
    def _dt_int_max(self) -> int:
        return 1 << (self.n_levels - 1)

    # ---- rung helpers (integer dt in dt_min units) ---------------------
    def _rung_from_float(self, dt_raw):
        """Largest power-of-two dt_int with dt_int*dt_min <= dt_raw, clamped
        to [1, 2^(n_levels-1)]; exact (frexp gives floor(log2 x) + 1)."""
        x = torch.clamp(dt_raw / self.dt_min, min=1.0,
                        max=float(self._dt_int_max))
        _, e = torch.frexp(x)
        p = torch.clamp(e.to(torch.int64) - 1, min=0)   # NaN -> rung 1
        return torch.ones_like(p) << p

    def _aarseth_dt(self, a, j, a2, a3):
        na, nj, n2, n3 = _norm(a), _norm(j), _norm(a2), _norm(a3)
        num = na * n2 + nj * nj
        den = nj * n3 + n2 * n2
        dt = torch.sqrt(self.eta * num / torch.clamp(den, min=_TINY))
        return torch.where(den > 0, dt, math.inf)

    @staticmethod
    def _ext_parts(force, pos, vel, like):
        """(a_ext, j_ext) of the (static) external field, O(N)."""
        if force.external is None:
            return torch.zeros_like(like), torch.zeros_like(like)
        a_ext, j_ext = force.external.accel_jerk_ext(pos, vel)
        return a_ext.to(like.dtype), j_ext.to(like.dtype)

    # ---- lifecycle ----------------------------------------------------
    def init(self, state: ParticleState) -> BlockCarry:
        force = self.force.at_time(state.time)
        acc, jerk = force.accel_jerk(state.pos, state.vel, state.mass)
        acc = acc.to(state.pos.dtype)
        jerk = jerk.to(state.pos.dtype)
        a_ext, j_ext = self._ext_parts(force, state.pos, state.vel, acc)

        def aj_dt(a_vec, j_vec):
            a, j = _norm(a_vec), _norm(j_vec)
            return torch.where(j > 0, a / torch.clamp(j, min=_TINY),
                               math.inf)

        # startup rung: per-component a/|j| timescales, pairwise and external
        dt_raw = self.eta_init * torch.minimum(
            aj_dt(acc - a_ext, jerk - j_ext), aj_dt(a_ext, j_ext))
        return BlockCarry(
            state=state, acc=acc, jerk=jerk, a_ext=a_ext, j_ext=j_ext,
            t_i=torch.zeros((state.n,), dtype=torch.int64,
                            device=state.device),
            dt_i=self._rung_from_float(dt_raw), t_origin=float(state.time),
            n_steps=0, n_active_sum=0)

    # ---- the micro-step -----------------------------------------------
    # A micro-step is three parts: _pre (schedule and predict; static
    # shapes), the pairwise force on the active rows (its shape is the
    # active count, known only after the read), and _finish (external
    # field, corrector, re-rung; static shapes); with pec2 a fourth,
    # _recorrect (static shapes), and a second pairwise force lie between.
    # On a CUDA device the static parts replay as CUDA graphs
    # (_StepGraphs): the micro-step is some three hundred small O(N)
    # kernels, bound by launching them.

    def _pre(self, force, t_i, dt_i, pos, vel, acc, jerk, mass):
        """Enqueued without a sync: (sched = [t_next, n_active] int64, with
        the active cluster count appended under pruning, t_next 0-d, active
        mask, compaction order or None when masked, predicted xp and vp of
        every particle, the centred sources as the force model's pair
        kernels take them: f32 casts, at the extended tier the eight hi/lo
        planes, split here once per micro-step, at the df32 tier the f64
        predictions themselves; under pruning also ``_sources``' pruned
        operands, else None)."""
        tn = t_i + dt_i
        t_next = torch.min(tn)
        active = tn == t_next
        if _pruned(force):
            # active cluster rows first, then active tail rows, then the rest
            member = force.src_mask >= 0.5
            sched = torch.stack([t_next, torch.sum(active),
                                 torch.sum(active & member)])
            key = ((~active).to(torch.uint8) * 2
                   + (active & ~member).to(torch.uint8))
        else:
            sched = torch.stack([t_next, torch.sum(active)])
            key = (~active).to(torch.uint8)
        idx = torch.argsort(key, stable=True) if self.n_buckets else None
        # predict ALL particles to t_next (O(N))
        d = ((t_next - t_i).to(torch.float64) * self.dt_min)[:, None]
        d2, d3 = d * d, d * d * d
        xp = pos + d * vel + (d2 / 2) * acc + (d3 / 6) * jerk
        vp = vel + d * acc + (d2 / 2) * jerk
        sources, psrc = self._sources(force, xp, vp, mass)
        return sched, t_next, active, idx, xp, vp, sources, psrc

    @staticmethod
    def _sources(force, xp, vp, mass):
        """(sources, psrc): the sources as ``centred_sources`` gives them,
        without the centres, and under pruning (rows, bucket, member) — every
        particle's planes in the bucket's frame, the bucket's sources
        (``ForceModel.pruned_row_sources``) and the cluster membership as a
        bool mask — else None."""
        sources = force.centred_sources(xp, vp, mass)[:-2]
        if not _pruned(force):
            return sources, None
        rows, bucket = force.pruned_row_sources(xp, vp, mass)
        return sources, (rows, bucket, force.src_mask >= 0.5)

    @staticmethod
    def _pair(force, sources, idx, n_active, out=None, psrc=None,
              n_cluster=None):
        """Pairwise (a, j) as one (2, N, 3) tensor in the pair sum's dtype
        (f32; f64 at the df32 tier): of the active rows and zero elsewhere
        (compacted), or of every row (masked, ``idx`` None). ``out``, if
        given, is that tensor, zero outside the active rows. ``sources``
        are the particles' planes (position and velocity; hi and lo of each
        at the extended tier) and, last, their masses. A row centred (and
        split) by its gather from the sources' planes is the row centred on
        its own, bit for bit.

        Under pruning ``psrc`` is ``_sources``' (rows, bucket, member) and
        ``n_cluster`` the count of active cluster rows, which ``idx`` puts
        first: they take the sources, the active tail rows after them the
        bucket (the masked form evaluates every row both ways and keeps
        each row's own)."""
        planes = sources[:-1]
        if out is None:
            out = torch.zeros((2,) + tuple(planes[0].shape),
                              dtype=planes[0].dtype, device=planes[0].device)
        if idx is None:
            a, j = force.pair_accel_jerk_rows(*planes, *sources)
            if psrc is not None:
                brows, bucket, member = psrc
                a_t, j_t = force.pair_accel_jerk_rows(*brows, *bucket)
                a = torch.where(member[:, None], a, a_t)
                j = torch.where(member[:, None], j, j_t)
            out[0].copy_(a)
            out[1].copy_(j)
            return out
        groups = [(idx[:n_active], planes, sources)]
        if psrc is not None:
            brows, bucket, _ = psrc
            groups = [(idx[:n_cluster], planes, sources),
                      (idx[n_cluster:n_active], brows, bucket)]
        for rows, rplanes, srcs in groups:
            if rows.shape[0] == 0:
                continue
            a_r, j_r = force.pair_accel_jerk_rows(
                *(p[rows] for p in rplanes), *srcs)
            out[0].index_copy_(0, rows, a_r)
            out[1].index_copy_(0, rows, j_r)
        return out

    def _corrector(self, h, pos, vel, a0, j0, a1, j1):
        h2 = h * h
        v1 = vel + (h / 2) * (a0 + a1) + (h2 / 12) * (j0 - j1)
        x1 = pos + (h / 2) * (vel + v1) + (h2 / 12) * (a0 - a1)
        return x1, v1

    def _recorrect(self, force, active, xp, vp, pair, pos, vel, acc, jerk,
                   dt_i, mass):
        """PEC²'s part between the two force evaluations: correct the
        active rows with the first evaluation and return (xe, ve, sources,
        psrc), the state the second evaluation sees (inactive particles
        keep their prediction) and its sources as ``_pre`` gives them."""
        h = (dt_i.to(torch.float64) * self.dt_min)[:, None]
        a1, j1, _, _ = self._total(force, xp, vp, pair)
        x1, v1 = self._corrector(h, pos, vel, acc, jerk, a1, j1)
        am = active[:, None]
        xe, ve = torch.where(am, x1, xp), torch.where(am, v1, vp)
        return (xe, ve, *self._sources(force, xe, ve, mass))

    def _total(self, force, xe, ve, pair):
        """(a1, j1, a_ext1, j_ext1): total force at the evaluation state,
        the pairwise part (``_pair``'s tensor, cast to xe's dtype) plus the
        external field at the raw positions."""
        a_pair, j_pair = pair.to(xe.dtype).unbind(0)
        a_ext1, j_ext1 = self._ext_parts(force, xe, ve, a_pair)
        if force.external is None:
            return a_pair, j_pair, a_ext1, j_ext1
        return a_pair + a_ext1, j_pair + j_ext1, a_ext1, j_ext1

    def _finish(self, force, t_next, active, xe, ve, pair, pos, vel, acc,
                jerk, a_ext, j_ext, t_i, dt_i):
        """Correct the active rows over their own step and re-rung them;
        the carry's eight tensors, new."""
        h = (dt_i.to(torch.float64) * self.dt_min)[:, None]
        a1, j1, a_ext1, j_ext1 = self._total(force, xe, ve, pair)
        x1, v1 = self._corrector(h, pos, vel, acc, jerk, a1, j1)

        # new rung: the Aarseth criterion on the pairwise and external
        # components separately, rung = min; the two are stacked on a
        # leading axis (the same elementwise arithmetic, half the launches)
        inv_h2 = 1.0 / (h * h)
        inv_h3 = inv_h2 / h
        a0s = torch.stack([acc - a_ext, a_ext])
        j0s = torch.stack([jerk - j_ext, j_ext])
        a1s = torch.stack([a1 - a_ext1, a_ext1])
        j1s = torch.stack([j1 - j_ext1, j_ext1])
        a2_1, a3 = _interp_derivs(a0s, j0s, a1s, j1s, h, inv_h2, inv_h3)
        dt_raw = torch.amin(self._aarseth_dt(a1s, j1s, a2_1, a3), dim=0)
        dt_want = self._rung_from_float(dt_raw)
        # grow at most one rung, only when aligned with the block grid
        dt_grow = 2 * dt_i
        aligned = torch.remainder(t_next, dt_grow) == 0
        dt_new = torch.where(
            dt_want >= dt_grow,
            torch.where(aligned, torch.clamp(dt_grow, max=self._dt_int_max),
                        dt_i),
            torch.minimum(dt_want, dt_i))
        am = active[:, None]
        return (torch.where(am, x1, pos), torch.where(am, v1, vel),
                torch.where(am, a1, acc), torch.where(am, j1, jerk),
                torch.where(am, a_ext1, a_ext), torch.where(am, j_ext1, j_ext),
                torch.where(active, t_next, t_i),
                torch.where(active, dt_new, dt_i))

    def _use_graphs(self, carry: BlockCarry) -> bool:
        """CUDA graphs on a CUDA device."""
        return carry.t_i.device.type == "cuda"

    def _graphs(self, carry: BlockCarry) -> "_StepGraphs":
        """The graphs of this carry's shape and, under pruning, bucket size
        (captured on first use; a new key drops the old graphs), loaded
        with the force model's partition."""
        bucket = (self.force.src_idx.shape[0] if _pruned(self.force)
                  else None)
        key = (carry.t_i.device, carry.state.n, bucket)
        g = self._graph_cache.get(key)
        if g is None:
            self._graph_cache.clear()
            g = self._graph_cache[key] = _StepGraphs(self, carry)
        g.load_sources(self.force)
        return g

    def with_force(self, force: ForceModel) -> "BlockHermite":
        """This stepper with another force model (a re-partition of escape
        pruning), sharing the captured graphs: a partition of the same
        bucket size replays them."""
        new = dataclasses.replace(self, force=force)
        object.__setattr__(new, "_graph_cache", self._graph_cache)
        return new

    def _micro_step(self, carry: BlockCarry, t_end_int=None):
        """One micro-step, or None when ``t_end_int`` is given and the next
        t_next lies past it."""
        with span("integrator.step"):
            s = carry.state
            if self._use_graphs(carry):
                g = self._graphs(carry)
                g.load(carry)
                g.pre.replay()
                sched, _, _, idx, xp, _, sources, psrc = g.pre_out
                t_next, n_active, *n_cl = _read(sched)
                if t_end_int is not None and t_next > t_end_int:
                    return None
                n_cl = n_cl[0] if n_cl else None
                force = self.force.at_time(carry.t_origin
                                           + t_next * self.dt_min)
                self._pair(force, sources, idx, n_active, out=g.pair,
                           psrc=psrc, n_cluster=n_cl)
                if self.pec2:
                    g.mid.replay()
                    self._pair(force, g.mid_out[2], idx, n_active, out=g.pair,
                               psrc=g.mid_out[3], n_cluster=n_cl)
                g.post.replay()
                f, i = g.f64.clone(), g.i64.clone()
                pos, vel, acc, jerk, a_ext, j_ext = f.unbind(0)
                t_i, dt_i = i.unbind(0)
                g.last = self._carry(carry, t_next, n_active, pos, vel, acc,
                                     jerk, a_ext, j_ext, t_i, dt_i)
                return g.last
            sched, t_dev, active, idx, xp, vp, sources, psrc = self._pre(
                self.force, carry.t_i, carry.dt_i, s.pos, s.vel, carry.acc,
                carry.jerk, s.mass)
            t_next, n_active, *n_cl = _read(sched)
            if t_end_int is not None and t_next > t_end_int:
                return None
            n_cl = n_cl[0] if n_cl else None
            # every evaluation of this micro-step happens at physical t_next
            force = self.force.at_time(carry.t_origin + t_next * self.dt_min)
            pair = self._pair(force, sources, idx, n_active, psrc=psrc,
                              n_cluster=n_cl)
            xe, ve = xp, vp
            if self.pec2:
                # re-evaluate at the corrected active rows (inactive
                # sources keep their prediction, as pass 1 saw them),
                # correct once more
                xe, ve, sources, psrc = self._recorrect(
                    force, active, xp, vp, pair, s.pos, s.vel, carry.acc,
                    carry.jerk, carry.dt_i, s.mass)
                pair = self._pair(force, sources, idx, n_active, psrc=psrc,
                                  n_cluster=n_cl)
            out = self._finish(force, t_dev, active, xe, ve, pair, s.pos,
                               s.vel, carry.acc, carry.jerk, carry.a_ext,
                               carry.j_ext, carry.t_i, carry.dt_i)
            return self._carry(carry, t_next, n_active, *out)

    def _carry(self, carry, t_next, n_active, pos, vel, acc, jerk, a_ext,
               j_ext, t_i, dt_i) -> BlockCarry:
        time = carry.t_origin + float(t_next) * self.dt_min
        return carry.replace(
            state=carry.state.replace(pos=pos, vel=vel, time=time),
            acc=acc, jerk=jerk, a_ext=a_ext, j_ext=j_ext, t_i=t_i, dt_i=dt_i,
            n_steps=carry.n_steps + 1,
            n_active_sum=carry.n_active_sum + n_active)

    def step(self, carry: BlockCarry) -> BlockCarry:
        return self._micro_step(carry)

    # ---- driving ------------------------------------------------------
    def _t_end_int(self, carry: BlockCarry, t_end) -> int:
        return round((float(t_end) - carry.t_origin) / self.dt_min)

    def advance_to(self, carry: BlockCarry, t_end) -> BlockCarry:
        """Micro-step until every particle reaches t_end. ``t_end`` must lie
        on the dt_max block grid so the system synchronises there."""
        te = self._t_end_int(carry, t_end)
        while True:
            nxt = self._micro_step(carry, t_end_int=te)
            if nxt is None:
                return carry
            carry = nxt

    def reached(self, carry: BlockCarry, t_end) -> bool:
        te = self._t_end_int(carry, t_end)
        return int(torch.min(carry.t_i + carry.dt_i)) > te

    def advance(self, carry: BlockCarry, n: int) -> BlockCarry:
        """n micro-steps."""
        for _ in range(n):
            carry = self.step(carry)
        return carry

    def rung_occupancy(self, carry: BlockCarry) -> torch.Tensor:
        """Particle count per rung k (dt = dt_max/2^k), shape (n_levels,),
        on the device. Force work per dt_max block is sum_k occ[k] * 2^k
        row evaluations."""
        dt_ints = torch.ones((self.n_levels,), dtype=torch.int64,
                             device=carry.dt_i.device) << torch.arange(
            self.n_levels - 1, -1, -1, dtype=torch.int64,
            device=carry.dt_i.device)
        return torch.sum(carry.dt_i[None, :] == dt_ints[:, None], dim=1)

    def checkpoint_aux(self, carry: BlockCarry) -> dict:
        """What a checkpoint must hold for a bitwise resume."""
        return {"acc": carry.acc, "jerk": carry.jerk,
                "a_ext": carry.a_ext, "j_ext": carry.j_ext,
                "t_i": carry.t_i, "dt_i": carry.dt_i,
                "t_origin": carry.t_origin, "n_steps": carry.n_steps,
                "n_active_sum": carry.n_active_sum,
                "dt_max": float(self.dt_max), "n_levels": int(self.n_levels)}

    def restore(self, state: ParticleState, aux: dict) -> BlockCarry:
        """The carry of a checkpoint. t_i and dt_i are integers in units of
        the checkpoint's dt_min: a checkpoint grid that embeds exactly in
        this one (old dt_min a power-of-two multiple of the new) is rescaled
        by that factor, dt_i clamped at the new dt_max; coarsening is
        refused. Every key of ``checkpoint_aux`` is required (the JAX package
        re-initialises, recomputes the ext parts or skips the grid check on
        a partial aux)."""
        missing = [k for k in _AUX_KEYS if k not in aux]
        if missing:
            raise ValueError(f"block checkpoint aux lacks {missing}: a "
                             "partial aux is refused, not re-initialised")
        old_dt_min = float(aux["dt_max"]) / (1 << (int(aux["n_levels"]) - 1))
        ratio = old_dt_min / self.dt_min
        r = round(ratio)
        if not (abs(ratio - r) < 1e-9 and r >= 1 and (r & (r - 1)) == 0):
            raise ValueError(
                f"checkpoint block grid (dt_max={float(aux['dt_max'])}, "
                f"n_levels={int(aux['n_levels'])}, dt_min={old_dt_min}) "
                f"does not embed in the configured grid (dt_max="
                f"{self.dt_max}, n_levels={self.n_levels}, dt_min="
                f"{self.dt_min}): old dt_min must be a power-of-two "
                "multiple of the new (refining is exact; coarsening "
                "would corrupt per-particle times)")

        def dev(key, dtype):
            return torch.as_tensor(aux[key]).to(device=state.device,
                                                dtype=dtype)

        f64, i64 = torch.float64, torch.int64
        return BlockCarry(
            state=state, acc=dev("acc", f64), jerk=dev("jerk", f64),
            a_ext=dev("a_ext", f64), j_ext=dev("j_ext", f64),
            t_i=dev("t_i", i64) * r,
            dt_i=torch.clamp(dev("dt_i", i64) * r, max=self._dt_int_max),
            t_origin=float(aux["t_origin"]), n_steps=int(aux["n_steps"]),
            n_active_sum=int(aux["n_active_sum"]))


class _StepGraphs:
    """The micro-step's static-shape parts (``_pre`` and ``_finish``, and
    with pec2 ``_recorrect`` between them) captured as CUDA graphs over
    buffers of one carry shape. The carry's six f64 (N, 3) fields live in
    one (6, N, 3) buffer and t_i, dt_i in one (2, N) int64 buffer; ``post``
    writes the new carry back into them, so a run of micro-steps loads its
    carry once and clones two buffers per micro-step for the carry it
    returns. ``pair`` is the (2, N, 3) buffer, in the pair sum's dtype, that
    the eager pairwise force fills between the replays; ``pre`` zeroes it,
    and pec2's second evaluation overwrites the same active rows. Under
    pruning the partition (the bucket's indices and weights, the
    membership) lives in three more buffers, which the captured force model
    reads; ``load_sources`` copies a new partition of the same bucket size
    into them."""

    def __init__(self, stepper: BlockHermite, carry: BlockCarry):
        s = carry.state
        dev = carry.t_i.device
        force = stepper.force.at_time(s.time)   # static fields only
        self.partition = None
        self._partition_of = None
        if _pruned(force):
            self.partition = tuple(torch.empty_like(t) for t in (
                force.src_idx, force.src_wgt, force.src_mask))
            self.load_sources(force)
            force = force.with_sources(*self.partition)
        self.f64 = torch.empty((6, s.n, 3), dtype=torch.float64, device=dev)
        self.i64 = torch.empty((2, s.n), dtype=torch.int64, device=dev)
        self.mass = torch.empty_like(s.mass)
        self.pair = torch.zeros((2, s.n, 3), dtype=force.pair_dtype,
                                device=dev)
        self.last = None
        self.load(carry)
        pos, vel, acc, jerk, a_ext, j_ext = self.f64.unbind(0)
        t_i, dt_i = self.i64.unbind(0)

        def pre():
            self.pair.zero_()
            return stepper._pre(force, t_i, dt_i, pos, vel, acc, jerk,
                                self.mass)

        def mid(pre_out):
            if not stepper.pec2:
                return None
            _, _, active, _, xp, vp, _, _ = pre_out
            return stepper._recorrect(force, active, xp, vp, self.pair, pos,
                                      vel, acc, jerk, dt_i, self.mass)

        def post(pre_out, mid_out):
            _, t_next, active, _, xe, ve, _, _ = pre_out
            if mid_out is not None:
                xe, ve, _, _ = mid_out
            out = stepper._finish(force, t_next, active, xe, ve, self.pair,
                                  pos, vel, acc, jerk, a_ext, j_ext, t_i,
                                  dt_i)
            self.f64.copy_(torch.stack(out[:6]))
            self.i64.copy_(torch.stack(out[6:]))

        # warm up on a side stream (lazy initialisation stays out of the
        # capture); the buffers are reloaded after it
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(2):
                pre_out = pre()
                post(pre_out, mid(pre_out))
        torch.cuda.current_stream(dev).wait_stream(side)
        self.load(carry, force=True)
        self.pre, self.post = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.pre):
            self.pre_out = pre()
        self.mid, self.mid_out = None, None
        if stepper.pec2:
            self.mid = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.mid, pool=self.pre.pool()):
                self.mid_out = mid(self.pre_out)
        with torch.cuda.graph(self.post, pool=self.pre.pool()):
            post(self.pre_out, self.mid_out)

    def load_sources(self, force) -> None:
        """Copy ``force``'s partition into the graphs' buffers unless they
        hold it already."""
        if self.partition is None or force.src_idx is self._partition_of:
            return
        for buf, t in zip(self.partition, (force.src_idx, force.src_wgt,
                                           force.src_mask)):
            buf.copy_(t)
        self._partition_of = force.src_idx

    def load(self, carry: BlockCarry, force: bool = False) -> None:
        """Copy the carry into the buffers unless they hold it already."""
        if carry is self.last and not force:
            return
        s = carry.state
        self.f64.copy_(torch.stack([s.pos, s.vel, carry.acc, carry.jerk,
                                    carry.a_ext, carry.j_ext]))
        self.i64.copy_(torch.stack([carry.t_i, carry.dt_i]))
        self.mass.copy_(s.mass)
        self.last = None
