"""The benchmark's readers of the program's spans (``bench_torch/metrics``
through ``bench_torch/program_spans.py``) on a hand-made traced run: device
operations built by ``trace.build`` and span records put in the program's
recorder. Each reader gets the value worked out by hand, and None, without
raising, where a program has no spans to read: no trace, no recorder (a
program older than its spans), no span in the window."""
import dataclasses
import statistics
import sys

import pytest

from bench_torch import harness, program_spans, trace as trace_mod
from oc_nbody_tpu_torch.utils import profiling
from oc_nbody_tpu_torch.utils.profiling import SpanRecord

NEW = ["device.idle_in_wait_pct", "device.idle_in_wait_pct.block",
       "device.idle_in_wait_pct.sharded",
       "integrator.wait_us_per_step.block",
       "diagnostics.pair_phi_ms", "diagnostics.pair_phi_ms.block",
       "diagnostics.pair_phi_ms.sharded",
       "diagnostics.core_ms", "diagnostics.core_ms.block",
       "diagnostics.core_ms.sharded",
       "force.exchange_bytes_per_step.sharded"]

T0 = 1000.0
MS = 1e-3


def _t(ms):
    return T0 + ms * MS


def _trace():
    """Two cards, the harness's marks (step, restore, row, end) at 0, 10,
    12 and 20 ms. Card 0 runs operations at [1, 3], [5, 9], [13, 18] ms,
    idle 1 + 2 + 4 + 2.001 = 9.001 ms of the window [0, 20.001]; card 1 at
    [0.001, 10] and [12.001, 20], idle 0.001 + 2.001 + 0.001 = 2.003 ms."""
    names = ["step", "restore", "row", trace_mod.END]
    raw = []
    for dev in (0, 1):
        for ms in (0, 10, 12, 20):
            raw.append((dev, trace_mod.MARK, _t(ms), 0.001 * MS))
    for a, b in ((1, 3), (5, 9), (13, 18)):
        raw.append((0, "k0", _t(a), (b - a) * MS))
    raw.append((0, "Memcpy DtoH (Device -> Pageable)", _t(9), 0.0))
    for a, b in ((0.001, 10), (12.001, 20)):
        raw.append((1, "k1", _t(a), (b - a) * MS))
    tr = trace_mod.build(raw, 2, names)
    assert tr is not None
    return tr


def _ns(ms):
    return round(_t(ms) * 1e9)


def _rec(i, name, parent, a, b, nbytes=None, site=None, device_ms=None):
    return SpanRecord(i, name, parent, _ns(a), _ns(b), nbytes, site,
                      device_ms)


RECORDS = [
    # before the window: another row, not read
    _rec(1, "diagnostics.row", None, -9000, -8000),
    _rec(2, "diagnostics.pair_phi", 1, -9000, -8500, device_ms=100.0),
    # two steps: each hands bytes between shards and waits on one read
    _rec(3, "integrator.step", None, 0.5, 4.6),
    _rec(4, "parallel.exchange", 3, 0.6, 0.7, nbytes=1000),
    _rec(5, "parallel.exchange", 3, 0.7, 0.8, nbytes=24),
    _rec(6, "integrator.wait", 3, 2.5, 4.5, site="block.schedule"),
    _rec(7, "integrator.step", None, 5.0, 9.0),
    _rec(8, "parallel.exchange", 7, 5.1, 5.2, nbytes=1000),
    _rec(9, "integrator.wait", 7, 8.0, 8.5, site="block.schedule"),
    # the row: its parts' device time, an exchange outside any step
    _rec(10, "diagnostics.row", None, 12.0, 16.0),
    _rec(11, "diagnostics.pair_phi", 10, 12.0, 12.5, device_ms=3.5),
    _rec(12, "diagnostics.core", 10, 12.5, 15.0, device_ms=7.0),
    _rec(13, "diagnostics.core", 10, 15.0, 15.5, device_ms=7.5),
    _rec(14, "parallel.exchange", 10, 15.5, 15.6, nbytes=5000),
    _rec(15, "diagnostics.wait", None, 17.0, 19.0, site="run.row"),
]

# idle under a wait: card 0's gap [3, 5] under [2.5, 4.5] (1.5 ms) and its
# gap [18, 20.001] under [17, 19] (1 ms); card 1 runs through both waits
IDLE_IN_WAIT = 100.0 * 2.5 / (9.001 + 2.003)
EXPECTED = {
    "device.idle_in_wait_pct": IDLE_IN_WAIT,
    "integrator.wait_us_per_step": (2000.0 + 500.0) / 2,
    "diagnostics.pair_phi_ms": 3.5,
    "diagnostics.core_ms": 7.25,
    "force.exchange_bytes_per_step": (1000 + 24 + 1000) / 2,
}


def _run(tr):
    return harness.TracedRun(kind="block", n=1024, steps=2, n_active_sum=0,
                             scene_build_s=0.0, row_ms=20.0, untraced_s=0.02,
                             trace=tr, busy_s=None)


def _expected(name):
    return EXPECTED[name.replace(".block", "").replace(".sharded", "")]


@pytest.fixture
def recorded(monkeypatch):
    """Put ``records`` in the program's recorder."""
    def put(records):
        monkeypatch.setattr(profiling, "spans", lambda: list(records))
    return put


@pytest.mark.parametrize("name", NEW)
def test_reader_reads_the_hand_made_spans(name, recorded):
    recorded(RECORDS)
    mod = harness.reader(name)
    assert mod.read(_run(_trace())) == pytest.approx(_expected(name),
                                                     rel=1e-9)


@pytest.mark.parametrize("name", NEW)
def test_reader_aligns_a_recorder_on_another_clock(name, recorded):
    """Records 7.5 s behind the trace's clock: the first integrator.step
    is moved to the device's first step mark (0 ms), 0.5 ms earlier than
    the records put it, and every span with it."""
    late = 7.5e9
    recorded([dataclasses.replace(r, start_ns=r.start_ns - round(late),
                                  end_ns=r.end_ns - round(late))
              for r in RECORDS])
    spans = program_spans.read(_run(_trace()))
    assert spans.shift == pytest.approx(7.5 - 0.5 * MS, abs=1e-6)
    got = harness.reader(name).read(_run(_trace()))
    if name.startswith("device."):
        # the waits 0.5 ms earlier: card 0's gap [3, 5] under [2, 4] (1 ms)
        # and [18, 20.001] under [16.5, 18.5] (0.5 ms)
        assert got == pytest.approx(100.0 * 1.5 / (9.001 + 2.003), rel=1e-6)
    else:
        assert got == pytest.approx(_expected(name), rel=1e-6)


@pytest.mark.parametrize("name", NEW)
def test_reader_is_silent_without_a_trace(name, recorded):
    recorded(RECORDS)
    assert harness.reader(name).read(_run(None)) is None


@pytest.mark.parametrize("name", NEW)
def test_reader_is_silent_on_a_program_without_the_recorder(name,
                                                            monkeypatch):
    """As on the commit before the spans: the module is there, its reading
    function is not."""
    monkeypatch.delattr(profiling, "spans")
    assert harness.reader(name).read(_run(_trace())) is None


@pytest.mark.parametrize("name", NEW)
def test_reader_is_silent_on_a_program_without_the_module(name,
                                                          monkeypatch):
    import oc_nbody_tpu_torch.utils as utils
    monkeypatch.delattr(utils, "profiling")
    monkeypatch.setitem(sys.modules, "oc_nbody_tpu_torch.utils.profiling",
                        None)
    with pytest.raises(ImportError):
        from oc_nbody_tpu_torch.utils import profiling  # noqa: F401
    assert harness.reader(name).read(_run(_trace())) is None


@pytest.mark.parametrize("name", NEW)
def test_reader_is_silent_with_no_span_in_the_window(name, recorded):
    recorded(RECORDS[:2])
    assert harness.reader(name).read(_run(_trace())) is None
    recorded([])
    assert harness.reader(name).read(_run(_trace())) is None


def test_every_new_entry_has_its_reader_and_cells():
    bench = harness.load_benchmark()
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in NEW:
        mod = harness.reader(name)
        m = entries[name]
        assert (m["layer"], m["moves"], m["unit"]) == (mod.LAYER, mod.MOVES,
                                                       mod.UNIT)
        assert m["source"] == "program_span"
        for cell in m["workloads"]:
            assert name in harness.load_cell(cell, bench).per_layer


def test_overlap_of_interval_lists():
    a = [(0.0, 2.0), (3.0, 5.0), (7.0, 8.0)]
    b = [(1.0, 4.0), (4.5, 7.5)]
    assert program_spans.overlap(a, b) == pytest.approx(1 + 1 + 0.5 + 0.5)
    assert program_spans.overlap(a, []) == 0.0


def test_reads_anchor_the_clocks_through_the_device_s_wander(recorded):
    """200 micro-steps 4 ms apart, each read ending 15 us after its copy,
    on a device clock that drifts by +100 us/s and jumps back 60 us after
    the 100th step: the raw lags reach -25 us; aligned, every lag sits at
    their common median (off it by a few us only beside the jump and at
    the ends, where a window of neighbours is cut)."""
    names = ["step", "restore", "row", trace_mod.END]
    raw, records = [], []
    for ms in (0, 900, 901, 902):
        raw.append((0, trace_mod.MARK, _t(ms), 0.001 * MS))
    for k in range(200):
        true_end = 1 + 4 * k + 0.5          # ms
        e = 100e-6 * (true_end * MS) - (60e-6 if k >= 100 else 0.0)
        raw.append((0, "fill", _t(true_end - 0.5) + e, 0.4 * MS))
        raw.append((0, "Memcpy DtoH (Device -> Pageable)",
                    _t(true_end) - 0.005 * MS + e, 0.005 * MS))
        step = 2 * k + 1
        records.append(_rec(step, "integrator.step", None, true_end - 0.6,
                            true_end + 0.1))
        records.append(_rec(step + 1, "integrator.wait", step,
                            true_end - 0.2, true_end + 0.015,
                            site="block.schedule"))
    tr = trace_mod.build(raw, 1, names)
    recorded(records)
    spans = program_spans.read(_run(tr))
    assert len(spans.anchors) == 200
    raw_lags = [lag * 1e6 for _, lag in spans.anchors]
    assert min(raw_lags) < -20
    copies = sorted(o.end for o in tr.ops if o.kind == "memcpy")
    lags = [(w.end - c) * 1e6
            for w, c in zip(spans.named("integrator.wait"), copies)]
    mid = statistics.median(raw_lags)
    # whole windows of neighbours, away from the jump and the ends
    assert max(abs(x - mid) for x in lags[16:84] + lags[116:184]) < 0.5
    assert max(abs(x - mid) for x in lags) < 10.0
    assert min(lags) > -20
    assert harness.reader("integrator.wait_us_per_step.block").read(
        _run(tr)) == pytest.approx(215.0, rel=1e-6)
