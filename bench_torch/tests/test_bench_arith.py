"""The harness's own arithmetic against hand counts."""
import pytest

from bench_torch import kinds, roofline, timeline


def test_self_interaction_counts_each_pair_once():
    pairs, flops, nbytes = roofline.self_interaction(4, 3)
    assert pairs == 6 * 3                 # 4 stars: 6 unordered pairs
    assert flops == 25
    assert nbytes == 28 * 4 * 3           # 16 B read + 12 B written a star


def test_self_interaction_jerk_counts_each_pair_once():
    pairs, flops, nbytes = roofline.self_interaction_jerk(4, 3)
    assert pairs == 6 * 3
    assert flops == 53
    assert nbytes == 52 * 4 * 3           # 28 B read + 24 B written a star
    # a Hermite step with two evaluations (pec2) counts both
    assert kinds.least_seconds("hermite", 4, 3, evaluations=2) == \
        roofline.bound(*roofline.self_interaction_jerk(4, 6))


def test_active_rows_counts():
    pairs, flops, nbytes = roofline.active_rows(1000, 7, 350)
    assert pairs == 350 * 1000
    assert flops == 41
    assert nbytes == 28 * 1000 * 7 + 48 * 350


def test_bound_takes_the_larger_limit():
    # 65,536 stars: 2,147,450,880 pairs x 25 flops over 66.9 TFLOP/s
    t, by = kinds.least_seconds("kdk", 65536, 1)
    assert by == "operations"
    assert t == pytest.approx(65536 * 65535 / 2 * 25 / 66.9e12, rel=1e-12)
    # one pair and many bytes: bound by the bytes
    t, by = roofline.bound(1, 25, 3.35e12)
    assert (t, by) == (1.0, "bytes")
    # few flops a pair: the rsqrt pipe binds
    t, by = roofline.bound(4.2e12, 1, 0)
    assert (t, by) == (pytest.approx(1.0), "operations")


def test_least_seconds_refuses_unknown_kind():
    with pytest.raises(ValueError):
        kinds.least_seconds("yoshida4", 10, 1)


@pytest.mark.parametrize("q,want", [(50, 3.0), (95, 4.8), (100, 5.0),
                                    (0, 1.0), (25, 2.0)])
def test_percentile_over_known_intervals(q, want):
    assert timeline.percentile([5.0, 1.0, 3.0, 2.0, 4.0], q) == \
        pytest.approx(want)


def test_percentile_of_a_tail():
    # 95 intervals of 1 ms and 5 of 10 ms: the p95 lies at the step between
    xs = [1.0] * 95 + [10.0] * 5
    assert timeline.percentile(xs, 95) == pytest.approx(1.0 + 9.0 * 0.05)


def test_union_merges_overlaps_and_drops_empty():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6), (5.0, 5.0)]
    assert timeline.union(iv) == [(0.0, 2.0), (3.0, 4.0)]
    assert timeline.covered(timeline.union(iv)) == pytest.approx(3.0)


def test_idle_gaps_inside_a_window():
    busy = timeline.union([(1.0, 2.0), (1.5, 3.0), (4.0, 6.0)])
    assert timeline.gaps(busy, 0.0, 5.0) == [(0.0, 1.0), (3.0, 4.0)]
    assert timeline.clip(busy, 0.0, 5.0) == [(1.0, 3.0), (4.0, 5.0)]
    assert timeline.gaps([], 0.0, 2.0) == [(0.0, 2.0)]


def _marks(dev, starts):
    return [(dev, "spin_kernel(long)", t, 1e-6) for t in starts]


def test_marks_divide_each_card_into_spans():
    from bench_torch import trace
    names = ["step", "restore", "row", "end"]
    raw = (_marks(0, [0.0, 1.0, 1.1, 2.0]) + _marks(1, [0.1, 1.2, 1.3, 2.1])
           + [(0, "k2", 0.1, 0.8), (0, "fill", 1.05, 0.01),
              (0, "Memcpy DtoH", 1.5, 0.2), (1, "k18", 0.2, 0.9),
              (1, "k18", 1.35, 0.5), (0, "late", 2.5, 0.1)])
    tr = trace.build(raw, 2, names)
    assert [(o.name, o.span) for o in tr.ops] == [
        ("k2", "step"), ("fill", "restore"), ("Memcpy DtoH", "row"),
        ("k18", "step"), ("k18", "row"), ("late", "other")]
    assert tr.window == (0.0, pytest.approx(2.1 + 1e-6))
    # busy inside the window: card 0 0.8 + 0.01 + 0.2, card 1 0.9 + 0.5
    assert trace.busy_seconds(tr) == [pytest.approx(1.01),
                                      pytest.approx(1.4)]
    assert [o.name for o in tr.kernels("step")] == ["k2", "k18"]
    # card 0's gaps, cut at its marks (step 0-1, restore 1-1.1, row 1.1-2)
    gaps = trace.breakdown(tr)["idle_gaps"]
    assert gaps == [["row", pytest.approx(0.4)], ["row", pytest.approx(0.3)],
                    ["step", pytest.approx(0.1)], ["step", pytest.approx(0.1)],
                    ["restore", pytest.approx(0.05)],
                    ["restore", pytest.approx(0.04)]]


def test_marks_that_miss_a_card_or_a_span_give_no_trace():
    from bench_torch import trace
    names = ["step", "row", "end"]
    ops = [(0, "k2", 0.1, 0.1)]
    assert trace.build(_marks(0, [0.0, 1.0, 2.0]) + ops, 2, names) is None
    assert trace.build(_marks(0, [0.0, 2.0]) + ops, 1, names) is None
    assert trace.build(_marks(0, [0.0, 1.0, 2.0]) + ops, 1, names) \
        is not None
