"""A new cell goes in as data files alone: in a copy of the benchmark, a
KDK cell (a copy of configs/c6_1m_streamed.toml, under a name that starts
like another cell's) and a shared-dt Hermite-4 cell (a copy of
configs/c3_hermite_16k_kroupa.toml) are added as a configuration file, a
workload file and their entries in BENCHMARK.json. Both load, run on the
CPU correct and replay bit for bit, and fail under their stepper kind's
faults; no file the benchmark had is changed."""
import filecmp
import json
import re
import shutil

import pytest

from bench_torch import harness, kinds
from conftest import ROOT

LIMITS = """[limits]
accel_err = {accel_err}
{jerk}energy_err = 1e-6
bound_mass_err = 5e-6
tidal_r_err = 1e-7
lagr_r_err = 1e-5
core_err = 5e-5
com_err = 5e-5
drift = 1e-4
plain_calls = 0
segments_differ = 0
carry_changed = 0
"""
NEW = {
    "c5_1m_kdk.orbit": dict(
        config="c5_1m_kdk", copy_of="c6_1m_streamed.toml", chips=1, n=512,
        segment=1 / 64, limits=LIMITS.format(accel_err="3e-4", jerk="")),
    # an adaptive step's stand-in drifts far less than a fixed step's
    # (sound 4e-10, the first-order fault 2.4e-5): its own drift limit
    "c3_16k.hermite": dict(
        config="c3_16k", copy_of="c3_hermite_16k_kroupa.toml", chips=1,
        n=512, segment=1 / 32, drift="1e-6",
        limits=LIMITS.format(accel_err="1e-4", jerk="jerk_err = 2e-4\n")),
}


def _add_cell(root, name, spec):
    """The cell ``name`` as data: its configuration's file, its workload
    file and its entries in ``root``'s BENCHMARK.json."""
    bench = harness.load_benchmark(root)
    conf = f"bench_torch/configs/{spec['config']}.toml"
    text = (ROOT / "configs" / spec["copy_of"]).read_text() + spec.get(
        "extra", "")
    (root / conf).write_text(
        f'source = "configs/{spec["copy_of"]}"\nreduced = []\n' + text)
    (root / "bench_torch" / "workloads" / f"{name}.toml").write_text(
        f'config = "{spec["config"]}"\nchips = {spec["chips"]}\n'
        f'segment = {spec["segment"]!r}\nwhy = "{name}"\n\n'
        f'{spec["limits"]}\n[stand_in]\nn = {spec["n"]}\n'
        f'segment = {spec["segment"]!r}\n'
        + (f'drift = {spec["drift"]}\n' if "drift" in spec else ""))
    bench["configs"].append({"name": spec["config"], "source": spec["copy_of"],
                             "file": conf, "reduced": [], "why": name})
    bench["workloads"].append({"name": name, "config": spec["config"],
                               "traffic": name.split(".")[1],
                               "chips": spec["chips"], "why": name})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "north_star_65k.orbit" in m.get("workloads", []):
            m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=2))


def _copy(root):
    shutil.copytree(ROOT / "bench_torch", root / "bench_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")


@pytest.fixture(scope="module")
def copy_root(tmp_path_factory):
    """A copy of the benchmark with the two cells added as data files."""
    root = tmp_path_factory.mktemp("checkout")
    _copy(root)
    for name, spec in NEW.items():
        _add_cell(root, name, spec)
    return root


def test_no_file_of_the_benchmark_changes(copy_root):
    originals = [p for p in (ROOT / "bench_torch").rglob("*")
                 if p.is_file() and "__pycache__" not in p.parts]
    for p in originals:
        copy = copy_root / p.relative_to(ROOT)
        assert filecmp.cmp(p, copy, shallow=False), p
    old = harness.load_benchmark(ROOT)
    new = harness.load_benchmark(copy_root)
    for group in ("configs", "workloads"):
        assert new[group][:len(old[group])] == old[group]
    for group in ("end_to_end", "per_layer"):
        for a, b in zip(old[group], new[group], strict=True):
            added = set(b.get("workloads", [])) - set(a.get("workloads", []))
            assert added <= set(NEW)
            assert {**b, "workloads": a.get("workloads")} == {
                **a, "workloads": a.get("workloads")}


@pytest.mark.parametrize("name", list(NEW))
def test_new_cell_loads_runs_and_replays(run_cpu, copy_root, name):
    cell = harness.load_cell(name, harness.load_benchmark(copy_root),
                             copy_root)
    assert (cell.stand_in["n"], cell.stand_in["segment"]) == (
        NEW[name]["n"], NEW[name]["segment"])
    lines = []
    r = run_cpu(name, seconds=0.2, root=copy_root, out=lines.append)
    assert r["correct"], r["compared"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert r["compared"]["carry_changed"]["value"] == 0
    assert set(r["metrics"]) == set(cell.end_to_end)
    # one step mark after each step: as many intervals as the window's steps
    text = "\n".join(lines)
    steps = int(re.search(r"Myr, (\d+) steps", text).group(1))
    marks = int(re.search(r"step intervals: (\d+)", text).group(1))
    assert steps > 0 and marks == steps * r["attempted"]
    if cell.sim["integrator"]["kind"] == "hermite":
        assert "jerk_err" in r["compared"]
    # a traced run replays two segments from the saved carry
    t = run_cpu(name, traced=True, root=copy_root)
    assert t["correct"], t["compared"]
    assert t["attempted"] == 2
    assert t["compared"]["segments_differ"]["value"] == 0


def test_hermite_under_a_field_is_refused_at_load(tmp_path):
    _copy(tmp_path)
    spec = dict(NEW["c3_16k.hermite"], config="c3_16k_field",
                extra='\n[potential]\nkind = "milky_way"\n')
    _add_cell(tmp_path, "c3_16k_field.hermite", spec)
    with pytest.raises(ValueError, match="no field jerk"):
        harness.load_cell("c3_16k_field.hermite",
                          harness.load_benchmark(tmp_path), tmp_path)


@pytest.mark.parametrize("fault", ["first_order", "unchanged_state"])
@pytest.mark.parametrize("name", list(NEW))
def test_new_cell_fails_under_its_kinds_faults(run_cpu, copy_root,
                                               monkeypatch, name, fault):
    kind = kinds.of(harness.load_cell(
        name, harness.load_benchmark(copy_root),
        copy_root).sim["integrator"]["kind"])
    {"first_order": kind.fault,
     "unchanged_state": kind.frozen}[fault](monkeypatch.setattr)
    r = run_cpu(name, root=copy_root)
    assert not r["correct"]
    over = [k for k, v in r["compared"].items() if v["value"] > v["limit"]]
    assert over, r["compared"]
