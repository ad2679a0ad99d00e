"""The readers of the chunked schedule's tiles (``metrics/kernels.
cross_roofline_pct.py``, ``kernels.diag_roofline_pct.py``, through
``tiles.py``) on a hand-made traced run: the harness's marks on one card
and span records put in the program's recorder. Each reader gives the
least time of its tiles' pair work over their device time, counting only
tiles inside ``integrator.step`` spans; and None, without raising, where
the program records no tiles or no counters (the commit before them), or
where there is no trace."""
import dataclasses

import pytest

from bench_torch import harness, trace as trace_mod
from oc_nbody_tpu_torch.utils import profiling
from oc_nbody_tpu_torch.utils.profiling import SpanRecord

T0 = 2000.0
MS = 1e-3
K = 131072
DIAG_PAIRS = K * (K - 1) // 2
CROSS_PAIRS = K * K
# the least time of a tile, worked out by hand: 25 flops a pair at 66.9
# TFLOP/s binds (one rsqrt a pair at 4.2e12/s, and 28 bytes a particle at
# 3.35 TB/s, take less)
DIAG_S = DIAG_PAIRS * 25 / 66.9e12
CROSS_S = CROSS_PAIRS * 25 / 66.9e12
EXPECTED = {
    # two steps: diagonal tiles of 6.8 and 7.0 ms, chunk pairs of 12.0 and
    # 12.5 ms; the row's tiles (under diagnostics.pair_phi) not counted
    "kernels.diag_roofline_pct": 100.0 * 2 * DIAG_S / (13.8 * MS),
    "kernels.cross_roofline_pct": 100.0 * 2 * CROSS_S / (24.5 * MS),
}
NAMES = list(EXPECTED)


def _t(ms):
    return T0 + ms * MS


def _ns(ms):
    return round(_t(ms) * 1e9)


def _trace():
    """One card, the harness's marks (step, restore, row, end) at 0, 40,
    41 and 80 ms, a kernel running through the steps and the row."""
    names = ["step", "restore", "row", trace_mod.END]
    raw = [(0, trace_mod.MARK, _t(ms), 0.001 * MS) for ms in (0, 40, 41, 80)]
    raw += [(0, "k", _t(0.01), 39.9 * MS), (0, "k", _t(41.01), 38.0 * MS)]
    tr = trace_mod.build(raw, 1, names)
    assert tr is not None
    return tr


def _rec(i, name, parent, a, b, device_ms=None, pairs=None, form=None,
         particles=None):
    return SpanRecord(i, name, parent, _ns(a), _ns(b), None, None, device_ms,
                      pairs, form, particles)


def _step(first_id, t, diag_ms, cross_ms, form="sym"):
    """An integrator.step span at ``t`` ms holding one chunked evaluation:
    a diagonal tile and a chunk pair of 131,072-star chunks."""
    s, c = first_id, first_id + 1
    return [
        _rec(s, "integrator.step", None, t, t + 19.9),
        _rec(c, "force.chunked", s, t + 0.1, t + 19.8, device_ms=19.6),
        _rec(c + 1, "force.diag", c, t + 0.2, t + 7.0, device_ms=diag_ms,
             pairs=DIAG_PAIRS, form=form, particles=K),
        _rec(c + 2, "force.cross", c, t + 7.1, t + 19.6, device_ms=cross_ms,
             pairs=CROSS_PAIRS, form=form, particles=2 * K),
    ]


RECORDS = (_step(1, 0.5, 6.8, 12.0) + _step(5, 20.0, 7.0, 12.5) + [
    # the row: its pair potential's tiles, slower, not read
    _rec(9, "diagnostics.row", None, 41.0, 79.0),
    _rec(10, "diagnostics.pair_phi", 9, 41.1, 78.0, device_ms=36.0),
    _rec(11, "force.chunked", 10, 41.2, 77.9, device_ms=35.9),
    _rec(12, "force.diag", 11, 41.3, 50.0, device_ms=100.0,
         pairs=DIAG_PAIRS, form="sym_phi", particles=K),
    _rec(13, "force.cross", 11, 50.1, 77.8, device_ms=100.0,
         pairs=CROSS_PAIRS, form="sym_phi", particles=2 * K),
])


def _run(tr):
    return harness.TracedRun(kind="kdk", n=2 * K, steps=2, n_active_sum=0,
                             scene_build_s=0.0, row_ms=38.0,
                             untraced_s=0.08, trace=tr, busy_s=None)


@pytest.fixture
def recorded(monkeypatch):
    """Put ``records`` in the program's recorder."""
    def put(records):
        monkeypatch.setattr(profiling, "spans", lambda: list(records))
    return put


@pytest.mark.parametrize("name", NAMES)
def test_reader_gives_the_tiles_share_of_their_roofline(name, recorded):
    recorded(RECORDS)
    got = harness.reader(name).read(_run(_trace()))
    assert got == pytest.approx(EXPECTED[name], rel=1e-9)
    assert 0 < got < 100


@pytest.mark.parametrize("name", NAMES)
def test_reader_is_silent_without_a_trace(name, recorded):
    recorded(RECORDS)
    assert harness.reader(name).read(_run(None)) is None


@pytest.mark.parametrize("name", NAMES)
def test_reader_is_silent_on_tiles_without_counters(name, recorded):
    """A program whose records have no counters (a SpanRecord of eight
    fields, as before them): no value, rather than a guess."""
    recorded([dataclasses.replace(r, pairs=None, form=None, particles=None)
              for r in RECORDS])
    assert harness.reader(name).read(_run(_trace())) is None


@pytest.mark.parametrize("name", NAMES)
def test_reader_is_silent_on_a_program_without_tile_spans(name, recorded):
    """The commit before the tiles: its steps open no ``force.*`` span."""
    recorded([r for r in RECORDS if not r.name.startswith("force.")])
    assert harness.reader(name).read(_run(_trace())) is None


@pytest.mark.parametrize("name", NAMES)
def test_reader_is_silent_on_a_program_without_the_recorder(name,
                                                            monkeypatch):
    monkeypatch.delattr(profiling, "spans")
    assert harness.reader(name).read(_run(_trace())) is None


@pytest.mark.parametrize("name", NAMES)
def test_reader_is_silent_on_a_form_the_roofline_does_not_count(name,
                                                                 recorded):
    recorded([dataclasses.replace(r, form="sym_phi_x") if r.form else r
              for r in RECORDS])
    assert harness.reader(name).read(_run(_trace())) is None


def test_entries_and_cells():
    bench = harness.load_benchmark()
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in NAMES:
        mod = harness.reader(name)
        m = entries[name]
        assert (m["layer"], m["moves"], m["unit"]) == (mod.LAYER, mod.MOVES,
                                                       mod.UNIT)
        assert m["source"] == "program_span"
        assert m["workloads"] == ["c6_1m.kdk"]
        assert name in harness.load_cell("c6_1m.kdk", bench).per_layer
