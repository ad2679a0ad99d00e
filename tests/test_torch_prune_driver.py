"""The escape-pruning driver of the port (``oc_nbody_tpu_torch/run.py``)
against the JAX package's (``oc_nbody_tpu/run.py``), on the CPU: the
over-tidal scenario of tests/unit/test_escape_prune.py (N = 256, 500 Msun
at 8 pc on a 4 kpc orbit, ``r_cut`` = 1.5 tidal radii, ``min_bucket`` = 32)
under KDK and Hermite steps (block steps: test_torch_prune_block.py), both
runs from the JAX package's IC, carried across with
``interop.state_from_numpy``.

The cluster dissolves: pruning switches on at t = 5.75, where the cluster
first fits a bucket under N/2, and both drivers re-partition every 0.25.
Two f32 force sums in different orders part trajectories of this violent
run from t of about 6.5 on (the cluster is down to some sixty stars), so
the runs end at t = 6.25: three re-partitions with pruning on. Checked: the
``N_cluster`` series equal row for row; ``E_prune_cum`` and
``dE_cons_over_E_int`` the JAX run's within LEDGER_TOL of |E_int(0)|, one
bound for each stepper: 1e-5 under KDK (measured against the JAX package:
2.4e-6 and 1.4e-6), 3e-4 under Hermite (7.6e-5 and 2.3e-5: its adaptive
steps already differ by a few) and 1e-4 under block steps (3.2e-5 and
4.7e-6: rungs flip with the f32 force rounding); the column identity
dE_over_E_int = dE_cons_over_E_int + E_prune_cum / |E_int(0)| to 1e-9; and
the ledger bound of the JAX test, |dE_cons_over_E_int| < 5e-3.
"""
import numpy as np
import pytest
import torch

from oc_nbody_tpu import scene as jscene
from oc_nbody_tpu.config import SimConfig as JConfig
from oc_nbody_tpu.run import run as jrun
from oc_nbody_tpu_torch import run as trun
from oc_nbody_tpu_torch.config import SimConfig as TConfig
from oc_nbody_tpu_torch.interop import state_from_numpy

T_END = 6.25
DIAG_EVERY = 0.25
LEDGER_TOL = {"kdk": 1e-5, "hermite": 3e-4, "block": 1e-4}


def scenario(kind, t_end, out_dir, diag_every=DIAG_EVERY):
    """The config dict of the JAX test's over-tidal run."""
    integ = {"kind": kind, "dt": 1.0 / 256, "eps": 1.0 / 64}
    if kind == "block":
        integ = {"kind": "block", "eta": 0.02, "eps": 1.0 / 64,
                 "dt_max": 1.0 / 16, "n_levels": 5}
    return {"units": {"kind": "henon", "mass_msun": 500.0, "length_pc": 8.0},
            "ic": {"kind": "plummer", "n": 256, "seed": 3},
            "potential": {"kind": "milky_way"},
            "orbit": {"kind": "circular", "R0_pc": 4000.0},
            "escape": {"prune": True, "r_cut": 1.5, "min_bucket": 32},
            "integrator": integ,
            "output": {"out_dir": str(out_dir), "t_end": t_end,
                       "diag_every": diag_every, "snap_every": t_end,
                       "stdout": False}}


def run_jax(kind, t_end, out_dir):
    cfg = JConfig.from_dict(scenario(kind, t_end, out_dir))
    cfg.backend = "jnp"
    return jrun(cfg), jscene.build_scene(cfg).state


def run_port(kind, t_end, jax_ic, monkeypatch, diag_every=DIAG_EVERY):
    """The port's driver on the CPU from the JAX package's IC."""
    real = trun.build_scene

    def from_jax_ic(cfg, device):
        scene = real(cfg, device)
        scene.state = state_from_numpy(
            np.asarray(jax_ic.pos), np.asarray(jax_ic.vel),
            np.asarray(jax_ic.mass), np.asarray(jax_ic.ids),
            float(jax_ic.time), "cpu")
        return scene

    monkeypatch.setattr(trun, "build_scene", from_jax_ic)
    cfg = TConfig.from_dict(scenario(kind, t_end, "unused", diag_every))
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        return trun.run(cfg, device="cpu")
    finally:
        torch.set_num_threads(threads)


def check_against_jax(kind, res_t, res_j, rows=None):
    """The shared checks of the pruned drivers under the stepper ``kind``
    over the first ``rows`` rows (all by default)."""
    dt, dj = res_t.diagnostics, res_j.diagnostics
    n = len(dj["time"]) if rows is None else rows
    np.testing.assert_allclose(dt["time"][:n], dj["time"][:n], rtol=0,
                               atol=1e-12)
    np.testing.assert_array_equal(dt["N_cluster"][:n], dj["N_cluster"][:n])
    assert dt["N_cluster"].min() < 256, "pruning never activated"
    assert np.abs(dt["E_prune_cum"]).max() > 0, "no re-partition ledgered"
    e_int0 = abs(dt["E_int"][0])
    np.testing.assert_allclose(dt["E_prune_cum"][:n] / e_int0,
                               dj["E_prune_cum"][:n] / e_int0, rtol=0,
                               atol=LEDGER_TOL[kind])
    np.testing.assert_allclose(dt["dE_cons_over_E_int"][:n],
                               dj["dE_cons_over_E_int"][:n], rtol=0,
                               atol=LEDGER_TOL[kind])
    np.testing.assert_allclose(
        dt["dE_over_E_int"],
        dt["dE_cons_over_E_int"] + dt["E_prune_cum"] / e_int0, atol=1e-9)


@pytest.mark.parametrize("kind", ["kdk", "hermite"])
def test_pruned_driver_matches_jax(kind, tmp_path, monkeypatch):
    res_j, ic = run_jax(kind, T_END, tmp_path)
    res_t = run_port(kind, T_END, ic, monkeypatch)
    check_against_jax(kind, res_t, res_j)
    assert np.abs(res_t.diagnostics["dE_cons_over_E_int"]).max() < 5e-3
    assert res_t.state.time == pytest.approx(T_END, abs=1e-12)
    assert "escape_prune" in res_t.phase_s
    if kind == "kdk":
        assert res_t.n_steps == int(res_j.n_steps) == 1600
