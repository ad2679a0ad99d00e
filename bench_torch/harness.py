"""One run of one cell of ``BENCHMARK.json``.

A cell is a configuration (``configs/<config>.toml``, a copy of the repo's
TOML with its source) under a traffic: a fixed stretch of simulated time,
``segment`` in the cell's file ``workloads/<cell>.toml``, replayed again
and again. That file also states the cell's limits (``[limits]``) and its
small stand-in for the CPU tests (``[stand_in]``: stars, segment and,
where the stand-in needs its own, a drift limit). What differs between
the stepper kinds (``kdk``, ``hermite``, ``block``) is looked up by the
kind that the configuration's ``integrator.kind`` names (``kinds.py``),
never by a cell's name: a new cell is its files and its entries alone.

Set-up builds the scene from the seed (``scene.build_scene``), makes the
stepper (``scene.make_stepper``) and runs ``stepper.init``; that carry is
every segment's start. A segment is what ``run.run`` does per
diagnostics interval: ``stepper.advance_to`` to the segment's end, one
``diagnostics.compute_all`` row and its one host copy. Every run and every
commit thus does the same work, whatever its speed.

Set-up then warms the cell's own shapes (a few steps, or one dt_max block
of block steps with its CUDA-graph capture, and one row, all discarded).
The window replays whole segments and ends at the first segment end past
``--seconds``. A CUDA event goes on the driving stream at every step
boundary (a block micro-step is a step), with no host sync.

With ``--trace 1`` the run makes one fenced segment (for the row's host
time, and the segment's untraced length) and then one segment under
torch.profiler, tracing the cards alone, with the harness's spans
(``step``, ``row``, ``restore``) marked on the cards (``trace.py``); the
per-layer readers in ``metrics/<name>.py`` read that window.

Then, with the program's state freed, the last segment's end is held to
the float64 reference (``check.py``). A plain twin on the card
(``cuda_gravity.PLAIN_CALLS`` moving in the window), a segment that ends
in other bits than the first, or a saved carry changed in place make the
run incorrect too. A run that finds JAX or the JAX package loaded in its
process gives no result (``JaxLoaded``).
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import importlib.util
import json
import subprocess
import sys
import time
import tomllib
from pathlib import Path

import torch

from bench_torch import check, kinds, timeline, trace as trace_mod, units

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
_META = ("source", "reduced", "assumed")
# the warm-up: a few steps, or the first dt_max blocks of block steps
WARM_STEPS = 3
WARM_BLOCKS = 1
# top-level names of JAX and of the JAX package, none of which a run loads
JAX_MODULES = ("jax", "jaxlib", "flax", "oc_nbody_tpu")


class JaxLoaded(RuntimeError):
    """The run's process holds JAX or the JAX package: no result."""


def jax_loaded() -> list:
    """The loaded modules whose top-level name is one of ``JAX_MODULES``,
    compared whole (``oc_nbody_tpu_torch`` is not ``oc_nbody_tpu``)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in JAX_MODULES)


@dataclasses.dataclass
class Cell:
    name: str
    config: str
    chips: int
    segment: float            # simulated time of one segment, code units
    limits: dict              # compared number -> limit
    sim: dict                 # the configuration, as its file states it
    end_to_end: dict          # end-to-end metrics it reports: name -> unit
    per_layer: list           # names of the per-layer metrics it reports
    stand_in: dict | None = None  # the CPU tests' stand-in: n, segment
                                  # and, where it states one, drift


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_cell(name: str, bench: dict, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``bench``, its workload file and its
    configuration (the file its entry in ``bench`` names), both read under
    ``root``, the checkout that holds ``bench``."""
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise ValueError(f"no workload {name!r} in BENCHMARK.json")
    with open(root / HERE.name / "workloads" / f"{name}.toml", "rb") as f:
        spec = tomllib.load(f)
    if spec["config"] != entry["config"]:
        raise ValueError(f"{name}: BENCHMARK.json and the workload file "
                         "name different configurations")
    conf = next((c for c in bench["configs"] if c["name"] == entry["config"]),
                None)
    if conf is None:
        raise ValueError(f"{name}: no configuration {entry['config']!r} in "
                         "BENCHMARK.json")
    with open(root / conf["file"], "rb") as f:
        sim = tomllib.load(f)
    kind = sim["integrator"]["kind"]
    if (not kinds.of(kind).field
            and sim.get("potential", {}).get("kind", "none") != "none"):
        raise ValueError(f"{name}: {kind} under an external field cannot be "
                         "checked: its carry's jerk holds the field's, and "
                         "the reference has no field jerk")
    reports = {m["name"]: m["unit"] for m in bench["end_to_end"]
               if name in m.get("workloads", [name])}
    per_layer = [m["name"] for m in bench["per_layer"]
                 if name in m.get("workloads", [name])
                 and m["moves"] in reports]
    stand_in = spec.get("stand_in")
    if stand_in is not None:
        stand_in = dict(stand_in, n=int(stand_in["n"]),
                        segment=float(stand_in["segment"]))
    return Cell(name=name, config=entry["config"], chips=int(entry["chips"]),
                segment=float(spec["segment"]), limits=dict(spec["limits"]),
                sim=sim, end_to_end=reports, per_layer=per_layer,
                stand_in=stand_in)


def sim_config(cell: Cell, seed: int, n: int | None = None):
    """The program's SimConfig of ``cell`` with the run's seed (and, for
    the CPU rehearsal and the tests, another star count)."""
    from oc_nbody_tpu_torch.config import SimConfig
    d = copy.deepcopy({k: v for k, v in cell.sim.items() if k not in _META})
    d["ic"]["seed"] = int(seed)
    if n is not None:
        d["ic"]["n"] = int(n)
    d["output"]["stdout"] = False
    return SimConfig.from_dict(d)


def reader(name: str):
    """The per-layer metric reader ``metrics/<name>.py``."""
    spec = importlib.util.spec_from_file_location(
        f"bench_torch.metrics.{name}", HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Marks:
    """Step boundaries: CUDA events on the driving stream, or host clock
    readings on the CPU."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.marks = []

    def __call__(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def intervals_ms(self) -> list:
        m = self.marks
        if self.cuda:
            return [a.elapsed_time(b) for a, b in zip(m, m[1:])]
        return [(b - a) * 1e3 for a, b in zip(m, m[1:])]


def _hook_steps(stepper, kind: str, mark) -> None:
    """Call ``mark`` after every step ``advance_to`` takes: the kind's
    per-step method (``Kind.step_method``) wrapped on this instance."""
    name = kinds.of(kind).step_method
    inner = getattr(stepper, name)

    def counted(*args, **kw):
        out = inner(*args, **kw)
        if out is not None:
            mark()
        return out

    object.__setattr__(stepper, name, counted)


def _carry_tensors(carry, kind: str) -> list:
    s = carry.state
    return [s.pos, s.vel, carry.acc] + [
        getattr(carry, a) for a in kinds.of(kind).carry_tensors]


def _carry_host(carry, kind: str) -> tuple:
    return (carry.state.time, carry.n_steps) + tuple(
        getattr(carry, a) for a in kinds.of(kind).carry_host)


def _bits(t):
    return t.view({8: torch.int64, 4: torch.int32}[t.element_size()])


def _same_bits(a: list, b: list):
    """A device bool: every tensor of ``a`` equal to ``b``'s, bit for bit
    (no host sync)."""
    return torch.stack([(_bits(x) == _bits(y)).all()
                        for x, y in zip(a, b)]).all()


def _sync(devices) -> None:
    for d in devices:
        torch.cuda.synchronize(d)


def _clocks(cuda: bool) -> list:
    """One nvidia-smi reading of each card's name, power limit, SM clock
    and power draw; taken just before and just after the window, not in
    it (a query holds the driver for milliseconds)."""
    if not cuda:
        return []
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=index,name,power.limit,clocks.sm,"
             "power.draw", "--format=csv,noheader"], capture_output=True,
            text=True, timeout=30).stdout
    except (OSError, subprocess.TimeoutExpired):
        return []
    return [line.strip() for line in out.splitlines() if line.strip()]


@dataclasses.dataclass
class TracedRun:
    """What the per-layer readers read."""
    kind: str
    n: int
    steps: int              # steps (micro-steps) in the traced segment
    n_active_sum: int       # active rows they evaluated (block steps)
    scene_build_s: float
    row_ms: float
    untraced_s: float       # the fenced, untraced segment's host seconds
    trace: object           # trace.Trace, or None
    busy_s: list | None     # per card, inside the traced window
    evaluations: int = 1    # force evaluations a step (``Kind.evaluations``)


def run(cell: Cell, seed: int, seconds: float, traced: bool,
        t_start: float, device: str = "cuda", n: int | None = None,
        mesh=None, out=print) -> dict:
    """Run ``cell`` once; returns the result object (the last line).
    ``device``, ``n`` and ``mesh`` are for the CPU rehearsal and tests:
    the benchmark's own runs pass none of them."""
    from oc_nbody_tpu_torch import diagnostics as diag_mod
    from oc_nbody_tpu_torch import run as run_mod
    from oc_nbody_tpu_torch.ops import cuda_gravity
    from oc_nbody_tpu_torch.scene import build_scene, make_stepper

    cfg = sim_config(cell, seed, n)
    cuda = torch.device(device).type == "cuda"
    devices = list(range(cell.chips)) if cuda else []
    _, time_myr = units.henon(cell.sim["units"])

    _sync(devices)
    t = time.perf_counter()
    t_enter = t - t_start
    scene = build_scene(cfg, device, mesh=mesh)
    _sync(devices)
    scene_build_s = time.perf_counter() - t
    stepper, kind = make_stepper(cfg, scene.force)
    carry0 = stepper.init(scene.state)
    _sync(devices)
    t_init = time.perf_counter()
    t0 = scene.state.time
    t_end = t0 + cell.segment
    saved = [x.clone() for x in _carry_tensors(carry0, kind)]
    if kinds.of(kind).warm_blocks:
        grid = cell.segment / float(cfg.integrator.dt_max)
        if abs(grid - round(grid)) > 1e-9:
            raise ValueError(f"{cell.name}: a segment of block steps must "
                             "be a whole number of dt_max")
        warm = stepper.advance_to(
            carry0, t0 + WARM_BLOCKS * float(cfg.integrator.dt_max))
    else:
        warm = stepper.advance(carry0, WARM_STEPS)
    o = cfg.output

    def row_of(c):
        return run_mod._to_host(diag_mod.compute_all(
            c.state, scene.force, o.fractions, f64_pairwise=o.diag_f64,
            core=o.core_diag))

    row_of(warm)
    _same_bits(_carry_tensors(warm, kind), _carry_tensors(warm, kind))
    del warm
    marks = _Marks(cuda)
    _hook_steps(stepper, kind, marks)
    plain0 = sum(cuda_gravity.PLAIN_CALLS.values())
    _sync(devices)
    setup_s = time.perf_counter() - t_start

    segs, same, same_host = 0, [], []
    first = last = row = None
    prof = traced_run = None
    clocks = _clocks(cuda and not traced)
    seg_ends = []
    row_ms = []
    marker = trace_mod.Marker(devices)

    def segment(span, fenced=False):
        nonlocal first, last, row, segs
        with span("step"):
            c = stepper.advance_to(carry0, t_end)
        with span("restore"):
            tensors = _carry_tensors(c, kind)
            ends = _carry_host(c, kind)
            if first is None:
                first = (tensors, ends)
            else:
                same.append(_same_bits(first[0], tensors))
                same_host.append(ends == first[1])
        if fenced:
            _sync(devices)
            t_row = time.perf_counter()
        with span("row"):
            row = row_of(c)
        if fenced:
            _sync(devices)
            row_ms.append((time.perf_counter() - t_row) * 1e3)
        last = c
        segs += 1
        seg_ends.append(time.perf_counter())

    def no_span(_):
        return contextlib.nullcontext()

    def window():
        nonlocal prof
        if traced:
            # one fenced segment for the row's host time, then one profiled
            segment(no_span, fenced=True)
            prof = trace_mod.profiler(cuda)
            with prof:
                segment(marker.span)
                marker.mark(trace_mod.END)
                _sync(devices)
        else:
            while True:
                segment(no_span)
                if time.perf_counter() - w0 >= seconds:
                    break

    marks()
    w0 = time.perf_counter()
    window()
    _sync(devices)
    window_s = time.perf_counter() - w0
    clocks += _clocks(cuda and not traced)
    intervals = marks.intervals_ms()
    # a plain twin on the card; on the CPU the twins are the path
    plain = (sum(cuda_gravity.PLAIN_CALLS.values()) - plain0) if cuda else 0
    peak = (max(torch.cuda.max_memory_allocated(d) for d in devices)
            if cuda else 0)

    steps = last.n_steps - carry0.n_steps
    active = getattr(last, "n_active_sum", 0) - getattr(carry0,
                                                        "n_active_sum", 0)
    sim_t = last.state.time - t0
    evaluations = kinds.of(kind).evaluations(cfg.integrator)
    differ = sum(1 for x, h in zip(same, same_host)
                 if not (bool(x) and h))
    changed = int(not bool(_same_bits(saved, _carry_tensors(carry0, kind))))
    if traced:
        t_read = time.perf_counter()
        tr = trace_mod.read(prof, cell.chips if cuda else 1, marker.names)
        t_read = time.perf_counter() - t_read
        busy = trace_mod.busy_seconds(tr) if tr is not None else None
        traced_run = TracedRun(kind=kind, n=scene.state.n, steps=steps,
                               n_active_sum=active,
                               scene_build_s=scene_build_s,
                               row_ms=row_ms[0],
                               untraced_s=seg_ends[0] - w0, trace=tr,
                               busy_s=busy, evaluations=evaluations)
    out(f"cell {cell.name}: N = {scene.state.n}, {kind}, seed {seed}, "
        f"segment {cell.segment:g} ({sim_t * time_myr:.6g} Myr, {steps} "
        f"steps" + (f", {active} active rows" if active else "")
        + f"), {segs} segments in {window_s:.3f} s, every segment in the "
        f"same bits: {'yes' if differ == 0 else 'NO'}, saved carry "
        f"unchanged: {'yes' if not changed else 'NO'}")
    out(f"set-up {setup_s:.3f} s: process start to the scene "
        f"{t_enter:.3f} s, scene {scene_build_s:.3f} s, stepper.init "
        f"{t_init - t - scene_build_s:.3f} s, warm-up "
        f"{setup_s - (t_init - t_start):.3f} s")
    out(f"device: {_device_line(cuda, cell.chips)}")
    for i, line in enumerate(clocks):
        out(f"nvidia-smi {'after' if i >= len(clocks) // 2 else 'before'} "
            f"the window: {line}")
    if not traced:
        t_seg = [b - a for a, b in zip([w0] + seg_ends, seg_ends)]
        out("segment seconds: " + " ".join(f"{x:.4f}" for x in t_seg))

    # the program's state goes before the reference runs on the card
    start_state = carry0.state
    del stepper, scene, first, saved, same
    if cuda:
        torch.cuda.empty_cache()
    phys = check.Physics.of(cell.sim)
    values = check.readings(kind, phys, start_state, last, row, sim_t)
    values["plain_calls"] = float(plain)
    values["segments_differ"] = float(differ)
    values["carry_changed"] = float(changed)
    ok, compared = check.judge(values, cell.limits)
    # every segment ends in the checked segment's bits, or is counted apart
    result = {"correct": bool(ok), "attempted": segs,
              "failed": 0 if ok else segs}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": (torch.cuda.get_device_name(0) if cuda
                            else "cpu"),
                   "count": cell.chips if cuda else 1,
                   "memory_peak_bytes": int(peak)}
    if traced:
        metrics = {}
        for name in cell.per_layer:
            mod = reader(name)
            v = mod.read(traced_run)
            if v is not None:
                metrics[name] = {"value": float(v), "unit": mod.UNIT}
        tr = traced_run.trace
        host_s = [b - a for a, b in zip([w0] + seg_ends, seg_ends)]
        if tr is not None:
            lo, hi = tr.window
            busy_mean = sum(traced_run.busy_s) / len(traced_run.busy_s)
            device_info["busy_s"] = busy_mean
            device_info["window_s"] = hi - lo
            waits = sum(1 for o in tr.ops if o.span == "step"
                        and o.kind == "memcpy" and "DtoH" in o.name)
            idle_traced = 100 * (1 - busy_mean / (hi - lo))
            idle_untraced = 100 * (1 - busy_mean / host_s[0])
            out(f"trace: {len(tr.ops)} device operations, "
                f"{len(tr.kernels('step'))} kernels in step spans over "
                f"{steps} steps; host waits per step "
                f"{waits / max(steps, 1):.4g} (device-to-host copies in "
                f"step spans); traced window {hi - lo:.4f} s (host "
                f"{host_s[1]:.4f} s), the fenced untraced segment "
                f"{host_s[0]:.4f} s: idle {idle_traced:.3f}% of the traced "
                f"window, {idle_untraced:.3f}% of the untraced segment; row "
                f"{row_ms[0]:.3f} ms (fenced segment); trace read in "
                f"{t_read:.1f} s")
        else:
            out(f"trace: no device operation (segments {host_s[0]:.4f} s "
                f"fenced, {host_s[1]:.4f} s profiled); row {row_ms[0]:.3f} "
                f"ms (fenced segment)")
    else:
        # a metric named <quantity>.<group> is that quantity, reported
        # apart for a group of cells with a bound of its own
        value = {"sim_myr_per_s": segs * sim_t * time_myr / window_s,
                 "step_ms_p95": timeline.percentile(intervals, 95.0),
                 "setup_s": setup_s}
        metrics = {name: {"value": value[name.split(".")[0]], "unit": unit}
                   for name, unit in cell.end_to_end.items()}
        out(f"step intervals: {len(intervals)}, median "
            f"{timeline.percentile(intervals, 50.0):.6g} ms, p95 "
            f"{value['step_ms_p95']:.6g} ms, max {max(intervals):.6g} ms")
    result["metrics"] = metrics
    result["device"] = device_info
    if traced and traced_run.trace is not None:
        result["breakdown"] = trace_mod.breakdown(traced_run.trace)
    result["compared"] = {name: {"value": v, "limit": lim}
                          for name, v, lim in compared}
    found = jax_loaded()
    if found:
        raise JaxLoaded("JAX or the JAX package is loaded in the run's "
                        "process, so it gives no result: " + ", ".join(found))
    for name, v, lim in compared:
        print(f"{name} {v:.6g} limit {lim:.6g}", file=sys.stderr)
    return result


def _device_line(cuda: bool, chips: int) -> str:
    if not cuda:
        return "cpu (rehearsal: the plain twins, no device metric)"
    names = [torch.cuda.get_device_name(d) for d in range(chips)]
    return (f"{chips} x {names[0]}" if len(set(names)) == 1
            else ", ".join(names))
