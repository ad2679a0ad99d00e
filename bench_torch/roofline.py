"""The least time one H100 SXM could take for the pair work of a step.

Peaks of one card: the f32 FMA pipe (66.9 TFLOP/s), the MUFU rsqrt (16 a
clock per SM x 132 SMs x 1.98 GHz = 4.2e12/s) and HBM3 (3.35 TB/s).

Flops per pair are counted from the port's pair functions, an FMA as 2 and
the rsqrt apart (one per pair), taking the least formulation the port has
for the work: the pair-symmetric accel (``csrc/sym_rows.cuh:sym_pair_rb``,
25 flops per unordered pair) for a whole self-interaction, the
pair-symmetric accel + jerk (53) for each force evaluation of a shared-dt
Hermite step, and the one-sided accel + jerk (``csrc/pair.cuh:
row_jerk_pair``, 41 per ordered pair) for the active rows of a block
micro-step. The other entries are the port's other formulations, kept for
the readers that later cells and per-kernel rooflines add (they may add
files, not edit this one): one-sided accel 18 (19 with the potential), and
at the extended tier one-sided accel 36, pair-symmetric accel 44,
one-sided accel + jerk 65, pair-symmetric accel + jerk 77.

Bytes count each input read once and each output written once: a
self-interaction reads positions and masses (16 B a particle, f32) and
writes the accel (12 B); with the jerk it reads the velocities too and
writes accel and jerk (28 + 24 B a particle); a rows sweep with jerk reads
the sources' positions, velocities and masses (28 B each) and the rows'
positions and velocities, and writes their accel and jerk (48 B a row).
"""
from __future__ import annotations

PEAK_FLOPS = 66.9e12
PEAK_RSQRT = 4.2e12
PEAK_BYTES = 3.35e12

FLOPS_PER_PAIR = {"rows": 18, "rows_phi": 19, "rows_jerk": 41,
                  "sym": 25, "sym_phi": 28, "sym_jerk": 53,
                  "rows_x": 36, "sym_x": 44, "rows_jerk_x": 65,
                  "sym_jerk_x": 77}


def bound(pairs: float, flops_per_pair: float, nbytes: float):
    """(seconds, 'operations' or 'bytes'): the larger of the operations
    (flops and one rsqrt per pair) over their peaks and the bytes over the
    memory bandwidth."""
    t_ops = max(pairs * flops_per_pair / PEAK_FLOPS, pairs / PEAK_RSQRT)
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def self_interaction(n: int, evaluations: int):
    """Work of ``evaluations`` whole f32 self-interactions (accel) of n
    particles: (pairs, flops per pair, bytes)."""
    return (n * (n - 1) // 2 * evaluations, FLOPS_PER_PAIR["sym"],
            28 * n * evaluations)


def self_interaction_jerk(n: int, evaluations: int):
    """Work of ``evaluations`` whole f32 self-interactions (accel + jerk)
    of n particles: (pairs, flops per pair, bytes)."""
    return (n * (n - 1) // 2 * evaluations, FLOPS_PER_PAIR["sym_jerk"],
            52 * n * evaluations)


def active_rows(n: int, micro_steps: int, n_active_sum: int):
    """Work of ``micro_steps`` block micro-steps that evaluated
    ``n_active_sum`` active rows in all, each against n sources (accel +
    jerk): (pairs, flops per pair, bytes)."""
    return (n_active_sum * n, FLOPS_PER_PAIR["rows_jerk"],
            28 * n * micro_steps + 48 * n_active_sum)

