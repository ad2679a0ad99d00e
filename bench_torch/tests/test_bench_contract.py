"""BENCHMARK.json and the files it names: the shape the benchmark's runs
rely on, and the yardstick's independence from the program."""
import json
import re
import sys
import types
from pathlib import Path

import pytest

from bench_torch import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench_torch"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end",
                                   "per_layer"])
def test_names_and_units(group):
    names = [e["name"] for e in BENCH[group]]
    assert len(names) == len(set(names))
    for e in BENCH[group]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")


def test_every_cell_has_its_files_and_limits():
    for w in BENCH["workloads"]:
        cell = harness.load_cell(w["name"], BENCH)
        assert cell.limits and all(v >= 0 for v in cell.limits.values())
        assert cell.stand_in, (f"{w['name']}: the workload file has no "
                               "[stand_in] table (n, segment) for the CPU "
                               "tests")
        assert cell.stand_in["n"] > 0 and cell.stand_in["segment"] > 0
        assert cell.per_layer
        assert w["chips"] in (1, 4)


def test_every_config_file_is_under_paths():
    for c in BENCH["configs"]:
        assert c["file"].startswith("bench_torch/configs/")
        assert (ROOT / c["file"]).is_file()
        assert len(c["source"]) <= 200


def test_every_per_layer_metric_has_its_reader():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        mod = harness.reader(m["name"])
        assert (mod.LAYER, mod.MOVES, mod.UNIT) == (m["layer"], m["moves"],
                                                    m["unit"])
        assert m["moves"] in e2e


def test_the_yardstick_imports_neither_jax_nor_the_program():
    for path in (ROOT / "bench_torch").rglob("*.py"):
        if path == Path(__file__).resolve():
            continue
        text = path.read_text()
        assert not re.search(r"^\s*(import|from)\s+jax", text, re.M), path
        assert "oc_nbody_tpu." not in text and "import oc_nbody_tpu\n" \
            not in text, path
        for other in ("chip_smoke", "bench.py", "'bench/", '"bench/'):
            assert other not in text, (path, other)
    for path in (ROOT / "bench_torch" / "reference").rglob("*.py"):
        assert "oc_nbody_tpu_torch" not in path.read_text(), path


@pytest.mark.parametrize("name,loaded", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True),
    ("flax.linen", True), ("oc_nbody_tpu", True),
    ("oc_nbody_tpu.forces", True), ("oc_nbody_tpu_torch", False),
    ("jaxtyping", False), ("flaxen.x", False)])
def test_jax_loaded_compares_whole_top_level_names(monkeypatch, name,
                                                   loaded):
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert (name in harness.jax_loaded()) == loaded


def test_a_run_with_jax_loaded_gives_no_result(run_cpu, monkeypatch):
    """A stub ``jax`` in the run's process: the run refuses, naming it."""
    assert harness.jax_loaded() == []
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    with pytest.raises(harness.JaxLoaded, match=r": jax$"):
        run_cpu(BENCH["workloads"][0]["name"])
