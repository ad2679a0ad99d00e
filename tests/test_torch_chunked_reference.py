"""The f32 chunked self-interaction against the benchmark's plain float64
reference (``bench_torch/reference/direct.py``), which decides the
``c6_1m.kdk`` cell's ``correct`` on the card; this file imports no JAX.

``STREAM_N`` and ``CHUNK_SYM`` are lowered to 256 and 128, so that n = 600
takes the chunked route in five chunks, the last one ragged (88 stars):
five diagonal tiles and ten chunk pairs, through the plain twins of K2 and
K12. Tolerances are those ``tests/test_torch_chunked.py`` takes from the
JAX package for f32 sums of N terms (accel within 5e-6 of max|a|, phi
within 3e-5 relative); the same comparison with the positions cast to
bfloat16 fails both. Then the cell itself, at 600 stars with the same
lowered caps, through the harness's path in a process of its own (the
test process holds JAX, which a benchmark run refuses).
"""
import json
import os
import subprocess
import sys

import pytest
import torch

from bench_torch.reference import direct
from oc_nbody_tpu_torch.models.plummer import plummer
from oc_nbody_tpu_torch.ops import cuda_gravity as cg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 600
EPS = 1.0 / 256
G = 1.0
ACC_TOL = 5e-6      # of max|a|
PHI_RTOL = 3e-5


@pytest.fixture
def chunked(monkeypatch):
    monkeypatch.setattr(cg, "STREAM_N", 256)
    monkeypatch.setattr(cg, "CHUNK_SYM", 128)


def _cluster(seed=2718319001):
    s = plummer(N, torch.Generator().manual_seed(seed))
    return s.pos.to(torch.float64), s.mass


def _errors(pos_in, pos, mass):
    """(accel error over max|a|, largest relative phi error) of the port's
    chunked forms on ``pos_in`` against the float64 reference on ``pos``."""
    ref_acc, ref_phi, _ = direct.pair_sums(pos, mass, EPS, G)
    acc = cg.accel_sym_chunked(pos_in, mass, EPS, G).to(torch.float64)
    acc_p, phi = cg.accel_potential_sym_chunked(pos_in, mass, EPS, G)
    assert torch.equal(acc_p.to(torch.float64), acc)
    a_err = float((acc - ref_acc).abs().max() / ref_acc.abs().max())
    p_err = float(((phi.to(torch.float64) - ref_phi) / ref_phi).abs().max())
    return a_err, p_err


def test_chunked_route_is_taken(chunked):
    pos, mass = _cluster()
    before = dict(cg.PLAIN_CALLS)
    cg.accel(pos, mass, EPS, G)
    assert cg.PLAIN_CALLS["sym"] - before["sym"] == 5
    assert cg.PLAIN_CALLS["cross"] - before["cross"] == 10


@pytest.mark.parametrize("seed", [2718319001, 3141592653])
def test_chunked_forms_hold_to_the_float64_reference(chunked, seed):
    pos, mass = _cluster(seed)
    a_err, p_err = _errors(pos, pos, mass)
    assert a_err <= ACC_TOL, a_err
    assert p_err <= PHI_RTOL, p_err


def test_bfloat16_positions_fail_both_tolerances(chunked):
    pos, mass = _cluster()
    low = pos.to(torch.bfloat16).to(torch.float64)
    a_err, p_err = _errors(low, pos, mass)
    assert a_err > ACC_TOL, a_err
    assert p_err > PHI_RTOL, p_err


CELL_RUN = """
import dataclasses, json, sys, time
sys.path.insert(0, {repo!r})
from oc_nbody_tpu_torch.ops import cuda_gravity as cg
cg.STREAM_N, cg.CHUNK_SYM = 256, 128
from bench_torch import harness
cell = harness.load_cell("c6_1m.kdk", harness.load_benchmark())
# the stand-in's segment and drift limit, as bench_torch/tests run every
# cell (bench_torch/tests/conftest.py): 600 stars under the cell's dt and
# eps (the spacing of a million stars) drift by their close pairs, 3e-8 to
# 2e-5 over the stand-in's 8 steps on most seeds, and up to 2.4e-4 on a
# seed whose pair meets within eps, an encounter the step cannot resolve
limits = dict(cell.limits, drift=cell.stand_in.get("drift", 1e-4))
cell = dataclasses.replace(cell, segment=cell.stand_in["segment"],
                           limits=limits)
before = dict(cg.PLAIN_CALLS)
r = harness.run(cell, {seed}, 0.05, False, time.perf_counter(),
                device="cpu", n={n}, out=lambda *a, **k: None)
r["tiles"] = [cg.PLAIN_CALLS[k] - before[k] for k in ("sym", "cross")]
print(json.dumps(r))
"""


def test_the_c6_cell_is_correct_at_600_stars_on_the_chunked_route():
    """The configuration as the benchmark runs it (KDK steps, the f32 row
    with CH85), every step and row chunked, held by ``check.py`` to the
    cell's own limits over its stand-in's segment (drift the stand-in's)."""
    code = CELL_RUN.format(repo=REPO, seed=7, n=N)   # run_cpu's seed
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"], r["compared"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    # every evaluation, steps and rows, five diagonal tiles and ten pairs
    sym, cross = r["tiles"]
    assert sym > 0 and sym % 5 == 0 and cross == 2 * sym
    assert r["compared"]["accel_err"]["value"] <= ACC_TOL
