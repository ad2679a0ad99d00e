"""The escape-pruning driver of the port under block timesteps against the
JAX package's, on the CPU: the over-tidal scenario of
tests/unit/test_escape_prune.py (test_torch_prune_driver.py states it and
the checks) with the JAX test's block stepper (eta = 0.02, dt_max = 1/16,
5 rungs), both runs from the JAX package's IC. The port's run goes on to
the JAX test's t = 8, which it must finish inside that test's bound,
|dE_cons_over_E_int| < 1e-2; the rows to t = 6.25 are held to the JAX
run's. Under pruning the micro-step's one read carries the active cluster
count, and the active cluster and tail rows are launched apart (against
all sources and against the bucket): the stepper's eager form, on CPU
tensors, is the one checked here; its CUDA-graph form on the card is held
to the eager one by tests/test_torch_cuda_kernels.py.
"""
import numpy as np

from test_torch_prune_driver import T_END, check_against_jax, run_jax, \
    run_port


def test_pruned_block_driver_matches_jax(tmp_path, monkeypatch):
    res_j, ic = run_jax("block", T_END, tmp_path)
    res_t = run_port("block", 8.0, ic, monkeypatch)
    rows = len(res_j.diagnostics["time"])
    check_against_jax("block", res_t, res_j, rows=rows)
    d = res_t.diagnostics
    assert d["time"][-1] == 8.0 and len(d["time"]) == 33
    assert np.abs(d["dE_cons_over_E_int"]).max() < 1e-2
    # the block rungs survive each re-partition: micro-steps are counted on
    # and at most every dt_min slot is taken
    assert 0 < res_t.n_steps <= 8.0 * 16 * 16
    assert res_t.n_active_sum >= res_t.n_steps
