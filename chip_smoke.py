#!/usr/bin/env python3
"""Smoke test of the PyTorch port (oc_nbody_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --sharded   # the build and the sharded phase alone
    python3 chip_smoke.py --phi64     # the build and K23's check alone

With ``--sharded`` on a machine with several cards, the sharded phase also
runs every mode, the race check and c5 (rdma) on a mesh of up to 4 cards.

Phases, in order; any failure raises and the script exits non-zero:

1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build the CUDA kernels from the sources in the checkout (one nvcc per
   source, all at once);
3. each kernel (K1 rows_accel, K2 sym_accel, K3 sym_jerk, K4 rows_jerk,
   K5 rows_jerk_t; K6-K17 below) against its plain PyTorch twin in f64 on
   the same inputs, with max error, tolerance and times (CUDA events,
   median of 5) for the kernel and the f32 plain twin (K5 and K4 beside it as CUDA-graph
   replays of 20 calls); K2 at N = 8,191, 8,192, 32,768, 65,536, 131,072
   and 262,144 beside its bound, its tile geometry and its shared-memory
   bytes a pair (its plain twin timed at 65,536 only; K12 likewise below);
   K2, K3 and K5 are launched twice
   and must be bitwise equal, and K5 must give a row the same bits alone,
   in a subset and among all rows; K5 is timed beside K4 at the same
   shapes. K22 knn_density (the diagnostics row's CH85 sweep) against its
   plain twin on the same card tensors at 32,768, 65,536 and 131,072
   strided by 2 (Plummer spheres, centred, strided and cast as
   local_density does): rk2 bitwise, mnb within 1e-6 relative, two
   launches bitwise, timed beside its issue-rate bound (its twin at 65,536
   only). K23 phi_f64 (the f64 row's pair potential) against its plain twin
   on the same card tensors at 4,097 (eps = 0, coincident stars) and
   131,072 (c5's eps) and, on 4,096 sampled rows, at 1,048,576: the largest
   gap over max|phi| at most 1e-13, two launches bitwise equal, timed
   beside its FP64 bound and the twin
   (``--phi64``: the build and this check alone). Then the extended (hi/lo) tier the same way: K6 sym_accel_x at
   N = 131,072 (beside K2, its tile geometry and its shared bytes a pair),
   K7 sym_jerk_x at 16,384 (beside K3), K8
   rows_accel_x at 1,024², K9 rows_jerk_x on K5's row counts against
   32,768 sources (beside K5) and as a self-interaction at 4,096, eps > 0
   and eps = 0, each against the f64 evaluation of the same (hi, lo)
   planes; K6, K7 and K9 launched twice and bitwise equal, K9 row-set
   independent; and the close-pair case (50 pairs at 1e-5 of the scale,
   eps = 1e-4), where the extended kernels must stay inside 2e-5 of max|a|
   and 5e-5 of max|j| of the f64 oracle and the f32 kernels must err past
   1e-3. Then the two-float (df32) tier: the device's two_sum and two_prod
   exact and its df_rsqrt inside 1e-13 on 1e5 values; K10 rows_accel_df at
   N = 1,024, 16,384 and 131,072 (beside K8/K6 and K1/K2) and K11
   rows_jerk_df at 4,096, 8,192 and 16,384 (beside K9/K7 and K4/K3), eps >
   0 and eps = 0, each against the f64 evaluation of the same planes inside
   1e-9 of max|a| and 1e-8 of max|j|, launched twice and bitwise equal;
   eager f64 PyTorch (the blocked accel + jerk sum) timed beside K11 at
   8,192 and 16,384; and K10 and K11 on the close-pair case inside 1e-9 /
   1e-8 of the f64 oracle. Then the f32 tier past STREAM_N: K12
   cross_accel (with and without the potential) at a full chunk pair
   (131,072²) and a ragged one (131,072 x 82,496), K13 cross_jerk at
   98,304² and 98,304 x 65,536 (beside its tile geometry, its shared bytes
   a pair and the first design's time; K3 timed at 98,304, the diagonal
   chunk of the same route), and K14 (K5 compensated) on 1 to 4,096
   rows against 1,048,576 sources, each against its f64 twin inside 2e-5
   of max (phi rtol 3e-5), launched twice and bitwise equal, K14 row-set
   independent; the chunked evaluation at N = 1,048,576 (accel, accel +
   phi, accel + jerk) against the f64 oracle rows sum on 4,096 sampled
   rows against all sources inside 2e-5 of max (phi rtol 3e-5), bitwise
   repeatable, timed at 1M and 2,097,152 beside K1 as a one-sided
   self-interaction at 1M. Then the extended tier past STREAM_N: K15
   cross_accel_x (with and without the raw potential) at a full chunk pair
   (98,304²) and a ragged one (98,304 x 65,536) beside its tile geometry,
   its shared bytes a pair and the first design's time, K16 cross_jerk_x at
   73,728² and 73,728 x 16,384 (as K13; K7 timed at 73,728), and K17 (K9
   compensated) on 1 to 4,096
   rows against 1,048,576 sources and on all 131,072 rows of a set of that
   size (the row cap), each against the f64 evaluation of the same (hi, lo)
   planes inside 2e-5 of max (phi rtol 3e-5), launched twice and bitwise
   equal, K17 row-set independent; the close-pair case at N = 1M with each
   of its 50 pairs across two chunks (the extended chunked route inside
   2e-5 / 5e-5 of the f64 oracle, the f32 chunked route past 1e-3); and the
   chunked extended evaluation at 1M (accel, accel + raw phi, accel +
   jerk) against the f64 oracle on 4,096 sampled rows inside 2e-5,
   bitwise repeatable, timed beside the f32 chunked route; K13 and K16 in
   every compiled tile geometry (csrc/jerk_rows.cuh) on ragged sets against
   their f64 twins, bitwise on NaN-filled scratch; and the zero guard at eps
   = 0: a pair 1e-20 apart (u below the least normal f32) through every
   guarded kernel K1-K21, which must give it nothing, as its f32 twin and
   the JAX package do (every output finite, within tolerance of the
   twin);
4. the paths, each through ``python -m oc_nbody_tpu_torch run`` (via
   ``__main__.main``) with the launch counters set to 0 just before it and
   read just after: c1 (KDK, K1), the north star (KDK, K2), c2 (King IC,
   KDK, K2) and c3 (Kroupa IMF, Hermite, K3) at full N and full length,
   c3 cut to N = 4,096 and t_end = 1 (Hermite, K4), c4 (eccentric
   inclined orbit, block timesteps, K5) at full N, and c4 cut to N = 4,096
   and t_end = 0.25 (block timesteps, K4); then the extended tier: c5x as
   committed at full N = 131,072 (KDK, K6 once per step, f64 diagnostics
   rows) to t = 2, and c1, c3 and c4 with ``integrator.precision=extended``
   (c1x: K8; c3x at N = 16,384: K7 per step, K6 with the potential per row;
   c4x at N = 32,768: K9 once per micro-step, K7 at init; c3x and c4x at
   N = 4,096: K9), each to t of about 1. Before those, at fixed lengths,
   the df32 tier: c5d (c5x with ``integrator.precision=df32`` at full N =
   131,072, 64 KDK steps, K10 once per step, f64 diagnostics rows), c1d
   (K10), c3d (N = 16,384 to t = 0.25, K11 per Hermite step) and c4d (N =
   32,768 to t = 0.25: K11 at init, the active rows as f64 sums, no K5 or
   K9); and ``configs/binaries_8k.toml`` as committed but for its length
   (t = 0.125: 10,650 stars, block + extended + pec2 on 12 rungs, K9 twice
   per micro-step, K7 at init), which must hold |dE/E_int| <= 1e-3 and
   keep at least 95% of its pairs bound, then the same run at the f32 and
   the df32 tier, the three drifts and micro-step times side by side;
   and past STREAM_N, at fixed lengths: c6 (N = 1,048,576) and c7 (N =
   2,097,152) as committed but cut to four KDK steps (chunked K2 + K12
   every step, K12<phi> every diagnostics row), c3 at N = 1,048,576
   (Hermite, chunked K3 + K13 every step) and c4 at N = 1,048,576 (block
   steps to t = one dt_max: chunked K3 + K13 at init, K14 once per
   micro-step), each with its kernels' exact launch counts, no K1, K4 or
   K5, and |dE/E_int| <= 1e-6; the same at the extended tier: c6x (c6
   with ``integrator.precision=extended``, four steps: 11 K6 + 55 K15 per
   step and per diagnostics row), c3x_1m (15 K7 + 105 K16 per step), c4x_1m
   (chunked K7 + K16 at init, K17 once per micro-step) and c4x_131k (c4 at
   N = 131,072 to t = 1/32: K9 on most micro-steps, K17 on those with
   every row active), no f32-tier, df32 or K8/K9 kernel past STREAM_N, no
   plain twin, |dE/E_int| <= 1e-6 (c4x_131k: c4's 2e-5). If
   the runs would not fit the time budget, c4's t_end is cut first (to the longest whole multiple of
   dt_max that fits, at least t = 8), then c1's and the north star's, and
   c5x's last, each cut printed. Each path must launch its kernel, the plain twins must
   not run, no diagnostic may be NaN, and the drift must stay inside its
   bound; c2 must strip 5-40% of its bound mass, and c4, when it runs its
   full length, 5-30%; under block steps the active-row kernel launches
   once per micro-step;
5. the steps of c2 (KDK), c3 (Hermite), c4 (block), c5x (KDK at the
   extended tier, N = 131,072) and c5d (the same at the df32 tier) alone:
   ms/step, for
   Hermite and block also without the per-step read (the shared dt; t_next
   and the active count), i.e. the cost of that device sync, and the
   device's busy time per step under torch.profiler over the unprofiled
   step time.

Between phases 4 and 5: K5, K9, K14 and K17 timed at the mean active rows
of c4, c4x, c4 at 1M and c4x_1m. Then escape pruning: K18 rows_accel_t on
4,096, 8,192, 16,384 and 10,650 rows against 65,536 sources, K18<comp> (its
compensated form) on 65,536, 131,072 and 2,048 rows against 1,048,576, and
K19 rows_accel_xs at 1,048,576 x 131,072, 131,072 x 1,048,576 and 2,048 x
1,048,576, each with and without the potential against its f64 twin inside
2e-5 of max|a| (phi rtol 3e-5, large launches on 2,048 sampled rows),
launched twice and bitwise equal, row-set independent; K1 against
K18<comp> at 65,536 x 1M, and K1 beside K18 at 65,536 sources; the pruned
evaluation at N = 65,536 with buckets of 4,096, 8,192 and 16,384 at the f32
and the extended tier, timed beside the unpruned one and held to the f64
oracle of the reduced Hamiltonian on sampled rows; then the pruned paths
through the CLI at fixed lengths: c10p as committed but on the plain
stepper (``integrator.macro_batches=0``, 1,048,576 stars, 32 KDK steps:
K1 and K18<comp> per step), its unpruned control and its extended form (8
steps; K19 for both sweeps), and escape_prune_65k with ``escape.r_cut``
lowered to 0.3 (active from t = 0) under KDK at both tiers, Hermite and
block steps (their King IC, an O(N^2) host sum, built once, on a host
thread while the kernel checks run), each with its ledger (|dE_cons_over_E_int| <= 1e-3 for c10p,
1e-5 for escape_prune_65k, 2e-5 under block steps; the column identity to
1e-9), no self-interaction kernel while pruned, and the N_cluster series
printed; then K18, K18<comp> and K19 timed at the buckets those paths
built. Then the sharded force (``run_sharded_phase``): K20 (ring_accel),
K20<phi> and K21 (ring_jerk) at c5's ring step on 4 shards (32,768 rows
against a 32,768-source slab), ragged (2,664 a shard: 10,650 stars split 4
ways) and, for K21, at c3's step on 4 shards (4,096²), each a first step (a
store) and a step onto non-zero incoming sums against its f64 twin inside
2e-5 of max (phi rtol 3e-5), bitwise repeatable, timed beside its f32
twin; every mode (allgather, ring, rdma, halfring) x accel / accel + phi /
accel + jerk at N = 131,072 on 4 shards of this card (and, with more
cards visible, on a mesh of up to 4 cards), against the unsharded
ForceModel and the f64 oracle on 4,096 sampled rows inside 2e-5, each
timed beside the unsharded evaluation; rdma at d = 1 (one launch) and d =
8 (no worse than the unsharded evaluation against the oracle); the race
check (the three ring evaluations with overlap bitwise equal to the same
schedule synchronised after every ring step, 5 repeats); then through
``run.run`` with ``Mesh.on_one_device(4)``: c5_131k_sharded as committed
but for length (64 KDK steps) in mode ring (K18 per hop, diag_f64 rows)
and rdma (K20, f32 rows through K20<phi>), c3 on the mesh (rdma, K21) to
t = 1/16, each beside its unsharded run on the same card, with the drift
class of c5x (c3: 1e-6 of E) and exactly 4² launches per force evaluation
and per f32 row. A mesh of shards on one card measures the cost of
sharding, never a multi-card speed. Then the card's name and power limit,
one JSON line with the kernels' numbers (K1-K21), and as the last line
``{"ok": true,
"device": {...}}``. Without a CUDA device, or without the package beside
it, the script exits non-zero and prints no result.
"""
import functools
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
C3 = "configs/c3_hermite_16k_kroupa.toml"
C4 = "configs/c4_block_32k_eccentric.toml"
C5X = "configs/c5x_131k_extended.toml"
BIN = "configs/binaries_8k.toml"
EXT = "integrator.precision=extended"
DF = "integrator.precision=df32"
# binaries_8k's length here (its own t_end is 8)
BIN_T = ["output.t_end=0.125", "output.diag_every=0.125"]
# path name -> (config, overrides, the kernel it must launch)
PATHS = {
    "c1": ("configs/c1_plummer_1k.toml", [], "rows"),
    "north_star": ("configs/north_star_65k_orbit.toml", [], "sym"),
    "c2": ("configs/c2_king_8k_circular.toml", [], "sym"),
    "c3": (C3, [], "sym_jerk"),
    "c3_n4096": (C3, ["ic.n=4096", "output.t_end=1.0"], "rows_jerk"),
    "c4": (C4, [], "rows_jerk_t"),
    "c4_n4096": (C4, ["ic.n=4096", "output.t_end=0.25"], "rows_jerk"),
    # the extended (hi/lo) tier: c5x as committed but for its length
    "c5x": (C5X, ["output.t_end=2.0"], "sym_x"),
    "c1x": ("configs/c1_plummer_1k.toml",
            [EXT, "output.t_end=2.8284271247"], "rows_x"),
    "c3x": (C3, [EXT, "output.t_end=1.0"], "sym_jerk_x"),
    "c4x": (C4, [EXT, "output.t_end=1.0"], "rows_jerk_x"),
    "c3x_n4096": (C3, [EXT, "ic.n=4096", "output.t_end=1.0"], "rows_jerk_x"),
    "c4x_n4096": (C4, [EXT, "ic.n=4096", "output.t_end=0.25"],
                  "rows_jerk_x"),
}
# the df32 tier and the binaries config, at fixed lengths, run first
PATHS_DF = {
    "c5d": (C5X, [DF, "output.t_end=0.0625", "output.diag_every=0.0625"],
            "rows_df"),
    "c1d": ("configs/c1_plummer_1k.toml", [DF, "output.t_end=2.8284271247"],
            "rows_df"),
    "c3d": (C3, [DF, "output.t_end=0.25"], "rows_jerk_df"),
    "c4d": (C4, [DF, "output.t_end=0.25"], "rows_jerk_df"),
    "binaries_8k": (BIN, BIN_T, "rows_jerk_x"),
    "binaries_8k_f32": (BIN, BIN_T + ["integrator.precision=f32"],
                        "rows_jerk"),
    "binaries_8k_df32": (BIN, BIN_T + [DF], "rows_jerk_df"),
}
# if the runs would not fit the budget, c4's t_end is cut first, to a whole
# multiple of dt_max, but not below this
C4_MIN_T = 8.0
# then these paths' t_end
CUTTABLE = ("c1", "north_star")
# and c5x's last, to whole diagnostics intervals
# the script must finish in 1200 s with the build included; the paths are
# cut to this so that the whole run ends in about half of that (640 s less
# the sharded phase's 30 s, measured on an H100)
BUDGET_S = 610.0
DRIFT_BOUND = {"c1": ("dE_over_E", 1e-6),
               "north_star": ("dE_over_E_int", 1e-5),
               "c2": ("dE_over_E_int", 1e-5),
               "c3": ("dE_over_E", 1e-6),
               "c3_n4096": ("dE_over_E", 1e-6),
               "c4": ("dE_over_E_int", 2e-5),
               "c4_n4096": ("dE_over_E_int", 2e-5),
               # the JAX package's c5x: <= 1.0e-7 over t = 0 -> 1
               # (RESULTS.md:590-593)
               "c5x": ("dE_over_E_int", 1e-6),
               "c1x": ("dE_over_E", 1e-6),
               "c3x": ("dE_over_E", 1e-6),
               "c3x_n4096": ("dE_over_E", 1e-6),
               "c4x": ("dE_over_E_int", 2e-5),
               "c4x_n4096": ("dE_over_E_int", 2e-5),
               "c5d": ("dE_over_E_int", 1e-6),
               "c1d": ("dE_over_E", 1e-6),
               "c3d": ("dE_over_E", 1e-6),
               "c4d": ("dE_over_E_int", 2e-5),
               # the config's header: -3.9e-4 by t = 1 is its honest
               # envelope; the f32 tier's drift is printed, not bounded
               "binaries_8k": ("dE_over_E_int", 1e-3),
               "binaries_8k_f32": ("dE_over_E_int", math.inf),
               "binaries_8k_df32": ("dE_over_E_int", 1e-3),
               # past STREAM_N: the JAX package's c6 held 2.61e-7 over 256
               # steps and c7 2.0e-9 over 16 (RESULTS.md:522-537)
               "c6": ("dE_over_E_int", 1e-6),
               "c7": ("dE_over_E_int", 1e-6),
               "c3_1m": ("dE_over_E_int", 1e-6),
               "c4_1m": ("dE_over_E_int", 1e-6),
               "c6x": ("dE_over_E_int", 1e-6),
               "c3x_1m": ("dE_over_E_int", 1e-6),
               "c4x_1m": ("dE_over_E_int", 1e-6),
               # c4's class: its drift is the block stepper's, not the
               # tier's (at 1M over the same 128 micro-steps the extended
               # and f32 tiers drift 2.489e-7 and 2.492e-7 on an H100),
               # and it reaches 1.071e-6 by t = 1/32 at this N
               "c4x_131k": ("dE_over_E_int", 2e-5),
               # escape pruning: E_tot less the ledger. The JAX package's
               # c10p recorded 6.17e-4 pruned and 4.49e-4 unpruned over 32
               # steps on the TPU (RESULTS.md:237-250), a reference and no
               # target; escape_prune_65k in the north star's class, block
               # steps in c4's
               "c10p": ("dE_cons_over_E_int", 1e-3),
               "c10p_ctl": ("dE_over_E_int", 1e-3),
               "c10p_x": ("dE_cons_over_E_int", 1e-3),
               "escape_65k": ("dE_cons_over_E_int", 1e-5),
               "escape_65k_x": ("dE_cons_over_E_int", 1e-5),
               "escape_65k_hermite": ("dE_cons_over_E_int", 1e-5),
               "escape_65k_block": ("dE_cons_over_E_int", 2e-5),
               # the sharded phase: c5_131k_sharded in the c5x class
               # (BASELINE.json:11's accuracy, RESULTS.md:590-593), c3 in
               # its own
               "c5_ring": ("dE_over_E_int", 1e-6),
               "c5_rdma": ("dE_over_E_int", 1e-6),
               "c5_single": ("dE_over_E_int", 1e-6),
               "c3_mesh": ("dE_over_E", 1e-6),
               "c3_single": ("dE_over_E", 1e-6),
               "c5_cards": ("dE_over_E_int", 1e-6)}
# pairs of binaries_8k still mutually bound at the end of its run
BOUND_PAIRS_MIN = 0.95
# c2's bound mass stripped over the run: the JAX package's recorded run
# stripped 18.3% (RESULTS.md:713); outside this range the tide is broken
STRIP_RANGE = (0.05, 0.40)
# c4's over its full length (the JAX package's run at dt_max = 1/64: 14.3%,
# RESULTS.md:623)
C4_STRIP_RANGE = (0.05, 0.30)
# steps the JAX package's c3 run took to t = 10 (RESULTS.md:714): the
# Hermite run-time estimate scales 50 timed steps by this rate
HERMITE_STEPS_PER_TIME = 60516 / 10.0
# H100 SXM peaks for the kernels' bounds: f32 FMA pipe, MUFU rsqrt
# (16/clk/SM x 132 SMs x 1.98 GHz), HBM3
PEAK_FLOPS = 66.9e12
PEAK_RSQRT = 4.2e12
PEAK_BYTES = 3.35e12
# f32 flops per pair for the bounds, counted from the kernels' pair
# functions (an FMA as 2, the rsqrt apart): one-sided accel 18 and 19 with
# phi (pair.cuh:row_pair), accel+jerk 41 (pair.cuh:row_jerk_pair);
# pair-symmetric, per unique pair, accel+jerk 53
# (sym_jerk.cu:sym_jerk_pair)
# the extended tier: the shared separation and Newton-refined inverse 27
# (pair.cuh:hilo_sep_inv), so one-sided accel 36 and 37 with phi
# (row_pair_x), accel+jerk 65 (row_jerk_pair_x); pair-symmetric accel 44
# and 46 with phi (pair.cuh:sym_pair_x; counted in sym_rows.cuh:Ext),
# accel+jerk 77 (sym_jerk_x.cu:sym_jerk_pair_x)
# the df32 tier, counted in df.cuh's header from its functions (two_sum 6,
# two_prod 3, df_add 11, df_mul 10, df_sqr 9, df_rsqrt 39 without its
# seed): accel 233 (df_accel_pair), accel+jerk 481 (df_jerk_pair)
# pair-symmetric K2 and the cross kernel K12 run their own pair
# (sym_rows.cuh:sym_pair_rb): 25 flops, 28 with phi;
# the cross kernel K13 runs K3's pair function, respelled for the issue
# rate (jerk_rows.cuh:sym_jerk_pair_rb), on every pair of two sets (53);
# K14 is K5's pair (41) plus a Kahan
# step of 4 flops per component and stage of 32 pairs (24 / 32 = 0.75); at
# the extended tier K15 and K16 run K6's and K7's pair functions (44, 46
# with phi, 77; pair.cuh:sym_pair_x, sym_jerk_pair_x) and K17 is K9's pair
# (65) plus the same Kahan steps
FLOPS_PER_PAIR = {"rows": 18, "rows_phi": 19, "rows_jerk": 41,
                  "rows_jerk_t": 41, "sym": 25, "sym_phi": 28,
                  "sym_jerk": 53, "rows_x": 36, "rows_x_phi": 37,
                  "rows_jerk_x": 65, "sym_x": 44, "sym_x_phi": 46,
                  "sym_jerk_x": 77, "rows_df": 233, "rows_jerk_df": 481,
                  "cross": 25, "cross_phi": 28, "cross_jerk": 53,
                  "rows_jerk_stream": 41.75, "cross_x": 44,
                  "cross_x_phi": 46, "cross_jerk_x": 77,
                  "rows_jerk_x_stream": 65.75,
                  # K18 runs K1's pair (18, 19 with phi); K18<comp> adds a
                  # Kahan step of 4 flops per component and stage of 32
                  # pairs (3 or 4 components); K19 is K8's pair (36, 37)
                  # plus the same Kahan steps
                  "rows_t": 18, "rows_t_phi": 19, "rows_stream": 18.375,
                  "rows_stream_phi": 19.5, "rows_x_stream": 36.375,
                  "rows_x_stream_phi": 37.5,
                  # K20 runs K18's pair (18, 19 with phi) and K21 K5's (41);
                  # their Kahan step across ring steps is per row, counted
                  # apart (RING_KAHAN_FLOPS)
                  "ring": 18, "ring_phi": 19, "ring_jerk": 41}
# K5's shapes: c4's 32,768 sources against these active-row counts
K5_ROWS = (1, 64, 1024, 8192, 32768)
K5_NS = 32768
# the shapes of the extended kernels: c5x's N (K6), c3's (K7), c1's (K8),
# and K9 as a self-interaction below SYM_MIN
K6_N = 131072
K7_N = 16384
K8_N = 1024
K9_SELF_N = 4096
# the df32 kernels: c1's, c3's and c5x's N (K10); below and at c3's N (K11)
K10_NS = (1024, 16384, 131072)
K11_NS = (4096, 8192, 16384)
# past STREAM_N (the f32 tier's chunked self-interaction, K12-K14): c6's N,
# c7's, a full chunk pair of each op and a ragged one (1,000,000 stars end
# in a chunk of 82,496; c6's jerk chunks in one of 65,536), the sample of
# rows the chunked evaluation is held to the f64 oracle on, and K14's row
# counts against c6's 1M sources
BIG_N = 1048576
BIG_N2 = 2097152
K12_PAIRS = ((131072, 131072), (131072, 82496))
K13_PAIRS = ((98304, 98304), (98304, 65536))
BIG_SAMPLE = 4096
K14_ROWS = (1, 64, 1024, 4096)
C6 = "configs/c6_1m_streamed.toml"
C7 = "configs/c7_2m_chunked.toml"
# c3 at 1M: its Hermite run to this t. The Aarseth criterion sets the
# shared dt by the closest pair, 2.66e-6 at t = 0 at this N (measured on
# an H100), so 2^-16 is about five steps
C3_1M_T = 2.0 ** -16
# the extended tier past STREAM_N (K15-K17): a full chunk pair of the accel
# route and a ragged one (1,048,576 particles end in a chunk of 65,536), of
# the jerk route (its last chunk holds 16,384), K17's row counts against
# c6's 1M sources, and the row cap: all rows of a set of K17_CAP_N active
# (c4 at N = 131,072 at each multiple of dt_max). A K17 launch on more rows
# than K17_CHECK_ROWS is held to the f64 twin on a sample of that many (a
# row's bits do not depend on the other rows of its launch)
K15_PAIRS = ((98304, 98304), (98304, 65536))
K16_PAIRS = ((73728, 73728), (73728, 16384))
# K13's and K16's tile geometries (csrc/jerk_rows.cuh) held to their f64
# twins on ragged sets, every compiled one; and the diagonal chunks of their
# routes at 1M, K3 at CHUNK_SYMJ and K7 at CHUNK_SYMXJ, timed once each
JERK_GEOMETRY_SETS = ((1000, 3001), (2900, 700))
K3_CHUNK_N = 98304
K7_CHUNK_N = 73728
# the first designs of K13, K16, K6 and K15 (one row a thread), timed on an
# NVIDIA H100 80GB HBM3 at 700 W by sym_kernel_times.py --tree on the
# parent checkout (K13, K16) and by this script (K6 at 131,072, K15 at
# 98,304²; PERF.md §6), printed beside this run's times
FIRST_DESIGN_MS = {"cross_jerk": 25.45, "cross_jerk_x": 19.79,
                   "sym_x": 18.08, "sym_x_phi": 18.02, "cross_x": 20.20,
                   "cross_x_phi": 20.39}
K17_ROWS = (1, 64, 1024, 4096)
K17_CAP_N = 131072
K17_CHECK_ROWS = 8192
# the close-pair case at N = 1M: pairs of this many stars, each partner
# this far down the set, so that every pair straddles two chunks of either
# extended route and of the f32 route
BIG_CLOSE_PAIRS = 50
BIG_CLOSE_OFFSET = 500000
# the paths past STREAM_N, at fixed lengths, run before the main paths: c6
# and c7 as committed but cut to four KDK steps; c3 and c4 at N = 1M, c4
# to t = one dt_max; the same at the extended tier (c6x, c3x_1m, c4x_1m),
# and c4 at N = 131,072 and the extended tier to t = 2 dt_max (c4x_131k:
# every row active at t = 1/64 and 1/32, past RT_MAX_ROWS)
PATHS_BIG = {
    "c6": (C6, ["output.t_end=0.015625", "output.diag_every=0.0078125"],
           "cross"),
    "c7": (C7, ["output.t_end=0.015625", "output.diag_every=0.015625"],
           "cross"),
    "c3_1m": (C3, ["ic.n=1048576", f"output.t_end={C3_1M_T!r}",
                   f"output.diag_every={C3_1M_T!r}"], "cross_jerk"),
    "c4_1m": (C4, ["ic.n=1048576", "output.t_end=0.015625",
                   "output.diag_every=0.015625"], "rows_jerk_stream"),
    "c6x": (C6, [EXT, "output.t_end=0.015625", "output.diag_every=0.0078125"],
            "cross_x"),
    "c3x_1m": (C3, [EXT, "ic.n=1048576", f"output.t_end={C3_1M_T!r}",
                    f"output.diag_every={C3_1M_T!r}"], "cross_jerk_x"),
    "c4x_1m": (C4, [EXT, "ic.n=1048576", "output.t_end=0.015625",
                    "output.diag_every=0.015625"], "rows_jerk_x_stream"),
    "c4x_131k": (C4, [EXT, "ic.n=131072", "output.t_end=0.03125",
                      "output.diag_every=0.015625"], "rows_jerk_x_stream"),
}

# the extended tier's kernels, by their launch-counter keys
EXTENDED_KERNELS = ("sym_x", "sym_jerk_x", "rows_x", "rows_jerk_x",
                    "cross_x", "cross_jerk_x", "rows_jerk_x_stream",
                    "rows_x_stream")
# the diagnostics row's CH85 sweep (K22) and f64 pair potential (K23), which
# run at every tier
TIERLESS_KERNELS = ("knn_density", "phi_f64")
# the self-interaction kernels, which a path pruned from t = 0 never runs
SELF_KERNELS = ("sym", "cross", "sym_jerk", "cross_jerk", "sym_x", "cross_x",
                "sym_jerk_x", "cross_jerk_x")

# escape pruning (K18, K18<comp>, K19). K18 at #7/#8's shapes: a bucket's
# rows against escape_prune_65k's 65,536 sources (the JAX bench's buckets,
# bench/escape_prune.json, and a ragged 10,650); K18<comp> at #4/#5's:
# rows against c10p's 1,048,576 sources; K19 at #13/#14's: c10p's sweep 1
# (every star against a bucket of 131,072), its sweep 2 (that bucket
# against every star) and a small bucket. A launch on more rows than
# PRUNE_CHECK_ROWS is held to the f64 twin on a sample of that many (a
# row's bits do not depend on the other rows of its launch)
PRUNE_N = 65536
K18_ROWS = (4096, 8192, 16384, 10650)
K18C_CASES = ((65536, True), (131072, False), (2048, True))
K19_CASES = ((1048576, 131072, True), (131072, 1048576, False),
             (2048, 1048576, True))
PRUNE_CHECK_ROWS = 2048
PRUNE_BUCKETS = (4096, 8192, 16384)
# the compensated sums past STREAM_N (#4, #5, #13, #14): against the f64
# twin, K18<comp> and K19 err at most COMP_BOUND of max|a|, and at most
# 1 / COMP_RATIO of what their layout errs without its Kahan steps (K18;
# K9's accel) on the same operands
COMP_BOUND = 5e-7
COMP_RATIO = 3.0
C10P = "configs/c10p_1m_macro_prune.toml"
E65 = "configs/escape_prune_65k.toml"
MB0 = "integrator.macro_batches=0"
# escape_prune_65k's committed r_cut = 2 keeps 61,118 of its 65,536 stars
# inside 2 tidal radii at t = 0 (r_t = 1.048): the bucket would pass N/2,
# so pruning stays off until the cluster has dissolved (the JAX run at N =
# 16,384 switched it on at t = 56, RESULTS.md:343-345). At r_cut = 0.3,
# 6,649 stars are members at t = 0: a bucket of 8,192, active from the
# first boundary. Each path runs a fixed segment with a few re-partitions.
E65_RCUT = "escape.r_cut=0.3"
E65_SEG = ["output.t_end=0.0625", "output.diag_every=0.015625"]
# the pruned paths, at fixed lengths: c10p as committed but on the plain
# stepper (32 KDK steps to t = 0.125, the JAX record's segment), its
# unpruned control and its extended form (8 steps each); escape_prune_65k
# under KDK at both tiers, Hermite and block steps
PATHS_PRUNE = {
    "c10p": (C10P, [MB0], "rows_stream"),
    "c10p_ctl": (C10P, [MB0, "escape.prune=false", "output.t_end=0.03125",
                        "output.diag_every=0.03125"], "cross"),
    "c10p_x": (C10P, [MB0, EXT, "output.t_end=0.03125",
                      "output.diag_every=0.015625"], "rows_x_stream"),
    "escape_65k": (E65, [E65_RCUT] + E65_SEG, "rows_t"),
    "escape_65k_x": (E65, [E65_RCUT, EXT] + E65_SEG, "rows_x"),
    "escape_65k_hermite": (E65, [E65_RCUT, "integrator.kind=hermite",
                                 "output.t_end=0.0078125",
                                 "output.diag_every=0.00390625"],
                           "rows_jerk_t"),
    "escape_65k_block": (E65, [E65_RCUT, "integrator.kind=block",
                               "integrator.dt_max=0.00390625",
                               "output.t_end=0.0078125",
                               "output.diag_every=0.00390625"],
                         "rows_jerk_t"),
}

# the sharded phase: c5_131k_sharded as committed but for length (64 KDK
# steps) on a mesh of MESH_D shards on one card (mode "ring" as committed,
# and "rdma" with f32 diagnostics rows, through K20<phi>), its unsharded
# control on the same card, and c3 on the mesh (Hermite, rdma: K21) beside
# its unsharded control, to a fixed t. Run through run.run with the API's
# mesh (a config's mesh.n_devices counts cards; this card is one)
C5S = "configs/c5_131k_sharded.toml"
C3 = "configs/c3_hermite_16k_kroupa.toml"
MESH_D = 4
MESH_N = 131072
PATHS_MESH = {
    "c5_ring": (C5S, ["output.t_end=0.0625"], "rows_t"),
    "c5_rdma": (C5S, ["output.t_end=0.0625", "mesh.mode=rdma",
                      "output.diag_f64=false"], "ring"),
    # the unsharded control: mesh.n_devices = 0 is every card visible
    "c5_single": (C5S, ["output.t_end=0.0625", "mesh.n_devices=1"], "sym"),
    "c3_mesh": (C3, ["output.t_end=0.0625", "mesh.mode=rdma"], "ring_jerk"),
    "c3_single": (C3, ["output.t_end=0.0625"], "sym_jerk"),
    # c5_rdma on a mesh of up to MESH_D cards, where more than one is visible
    "c5_cards": (C5S, ["output.t_end=0.0625", "mesh.mode=rdma",
                       "output.diag_f64=false"], "ring"),
}
# the runs of PATHS_MESH that shard on this card's MESH_D shards
MESH_RUNS = ("c5_ring", "c5_rdma", "c3_mesh")
# flops per row and ring step of K20 / K20<phi> / K21's Kahan add: 4 per
# component (y = x - c, t = s + y, c = (t - s) - y)
RING_KAHAN_FLOPS = {"ring": 12, "ring_phi": 16, "ring_jerk": 24}


def _fail(msg):
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


def _median_ms(fn, reps=5):
    import torch
    fn()  # warm-up
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def _once_ms(fn):
    """ms of one call, no warm-up: for a plain twin that takes seconds."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop)


def _graph_ms(fn, calls=20, reps=5):
    """Median ms of one call, timed (CUDA events) over replays of a CUDA
    graph of ``calls`` back-to-back calls: no host launch cost enters, so
    a kernel shorter than its Python wrapper is timed on the device."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / calls)
    del graph
    torch.cuda.empty_cache()
    return statistics.median(times)


def _cluster(n, seed, device):
    """Centred f32 positions and masses of a Hénon-unit Plummer sphere."""
    import torch
    from oc_nbody_tpu_torch.models.plummer import plummer
    from oc_nbody_tpu_torch.ops.gravity import prepare_f32
    state = plummer(n, torch.Generator().manual_seed(seed), device=device)
    return prepare_f32(state.pos, state.mass)


def _compare(out, ref, with_phi, tol_a):
    """(max |da|, max |da| / max |a|, max rel phi error) against the f64
    reference; raises past the tolerances."""
    acc, ref_acc = (out[0], ref[0]) if with_phi else (out, ref)
    err = float((acc.double() - ref_acc).abs().max())
    scale = float(ref_acc.abs().max())
    if not err <= tol_a * scale:
        raise AssertionError(f"accel error {err:.3e} > {tol_a:g} * "
                             f"max|a| = {tol_a * scale:.3e}")
    phi_rel = 0.0
    if with_phi:
        phi_rel = float(((out[1].double() - ref[1]).abs()
                         / ref[1].abs()).max())
        if not phi_rel <= 3e-5:
            raise AssertionError(f"phi relative error {phi_rel:.3e} > 3e-5")
    return err, err / scale, phi_rel


def _moving_cluster(n, seed, device):
    """Centred f32 positions, masses and velocities of a Hénon-unit Plummer
    sphere."""
    import torch
    from oc_nbody_tpu_torch.models.plummer import plummer
    from oc_nbody_tpu_torch.ops.gravity import prepare_f32
    state = plummer(n, torch.Generator().manual_seed(seed), device=device)
    return prepare_f32(state.pos, state.mass, vel=state.vel)


def _compare_jerk(out, ref, tol_a, tol_j):
    """(max |da|, max |da| / max |a|, max |dj| / max |j|) against the f64
    reference; raises past the tolerances."""
    errs = []
    for got, want, tol, name in ((out[0], ref[0], tol_a, "accel"),
                                 (out[1], ref[1], tol_j, "jerk")):
        err = float((got.double() - want).abs().max())
        scale = float(want.abs().max())
        if not err <= tol * scale:
            raise AssertionError(f"{name} error {err:.3e} > {tol:g} * "
                                 f"max = {tol * scale:.3e}")
        errs.append((err, err / scale))
    return errs[0][0], errs[0][1], errs[1][1]


def _bound(pairs, flops_per_pair, nbytes):
    """(ms, 'bytes' or 'operations'): the least time an H100 SXM could take
    for the work — the larger of the bytes moved over HBM bandwidth and
    the operations (f32 flops, one rsqrt per pair) over their peaks."""
    t_ops = max(pairs * flops_per_pair / PEAK_FLOPS, pairs / PEAK_RSQRT)
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def check_kernels(cg, device):
    """Phase 3; returns {kernel: dict(max_abs_err, ms, plain_ms, shape,
    bound_ms, bound_by)} at the main paths' shapes (K1: c1's N = 1024, K2:
    the north star's 65,536, K3: c3's 16,384, K4: the N = 4,096 Hermite
    run), and the potential forms of K1 and K2 at their kernels' shapes.
    Work per call for the bounds: FLOPS_PER_PAIR and one rsqrt per pair;
    inputs read and outputs written once."""
    import torch
    main = {}
    print("kernel      shape            phi  eps        max|da|    "
          "rel      phi_rel    ms        plain_ms")
    # (65536, 65536): K1 on the north star's self-interaction, the time
    # K2 is measured against (the H100 SYM_MIN crossover is unmeasured)
    for nr, ns in ((1000, 1000), (1024, 1024), (4096, 65536),
                   (65536, 65536)):
        src, mass = _cluster(ns, 11, device)
        rows = src[:nr].contiguous()
        tol = 2e-5 if ns >= 65536 else 5e-6
        for with_phi in (False, True):
            for eps in (0.0, 1.0 / 512):
                kw = dict(with_phi=with_phi, guarded=eps == 0.0)
                out = cg.rows_kernel(rows, src, mass, eps, **kw)
                ref = cg.rows_plain(rows, src, mass, eps, with_phi=with_phi,
                                    dtype=torch.float64)
                err, rel, prel = _compare(out, ref, with_phi, tol)
                ms = _median_ms(lambda: cg.rows_kernel(rows, src, mass, eps,
                                                       **kw))
                pms = _median_ms(lambda: cg.rows_plain(
                    rows, src, mass, eps, with_phi=with_phi))
                print(f"rows_accel  ({nr},{ns}){'':<{13 - len(str(nr)) - len(str(ns))}}"
                      f"{int(with_phi):<5}{eps:<11.6g}{err:<11.3e}"
                      f"{rel:<9.2e}{prel:<11.2e}{ms:<10.4f}{pms:.4f}")
                if (nr, ns, eps) == (1024, 1024, 1.0 / 512):
                    key = "rows_phi" if with_phi else "rows"
                    main[key] = dict(
                        max_abs_err=err, ms=ms, plain_ms=pms, shape=[nr, ns],
                        bound=_bound(nr * ns, FLOPS_PER_PAIR[key],
                                     16 * ns + (28 if with_phi else 24) * nr))
    # K2 at SYM_MIN (c2), a halfring shard (32,768), the north star, c5 and
    # c6's diagonal chunk (131,072) and STREAM_N; its plain twin is timed at
    # the north star's N only
    print("sym_accel: bound and share of it at each N, the tile geometry "
          "(R rows a thread, S column parts) and its shared-memory bytes a "
          "pair, 48 / R")
    for n in (8191, 8192, 32768, 65536, 131072, 262144):
        pos, mass = _cluster(n, 12, device)
        tol = 2e-5 if n >= 65536 else 5e-6
        eps = 1.0 / 512
        chunk = 256 if n > 65536 else 1024
        geo = cg.sym_geometry(n)
        for with_phi in (False, True):
            out = cg.sym_kernel(pos, mass, eps, with_phi=with_phi,
                                guarded=False)
            again = cg.sym_kernel(pos, mass, eps, with_phi=with_phi,
                                  guarded=False)
            same = (torch.equal(out[0], again[0])
                    and torch.equal(out[1], again[1])) if with_phi \
                else torch.equal(out, again)
            if not same:
                raise AssertionError(f"sym_accel N={n} phi={with_phi}: two "
                                     "launches differ bitwise")
            ref = cg.sym_plain(pos, mass, eps, with_phi=with_phi,
                               dtype=torch.float64, chunk=chunk)
            err, rel, prel = _compare(out, ref, with_phi, tol)
            del ref
            ms = _median_ms(lambda: cg.sym_kernel(pos, mass, eps,
                                                  with_phi=with_phi,
                                                  guarded=False))
            pms = (_median_ms(lambda: cg.sym_plain(pos, mass, eps,
                                                   with_phi=with_phi,
                                                   chunk=chunk))
                   if n == 65536 else None)
            key = "sym_phi" if with_phi else "sym"
            bound = _bound(n * (n - 1) // 2, FLOPS_PER_PAIR[key],
                           (32 if with_phi else 28) * n)
            print(f"sym_accel   ({n}){'':<{13 - len(str(n))}}"
                  f"{int(with_phi):<5}{eps:<11.6g}{err:<11.3e}{rel:<9.2e}"
                  f"{prel:<11.2e}{ms:<10.4f}"
                  f"{'-' if pms is None else f'{pms:.4f}'}   "
                  f"bound {bound[0]:.4f} ({bound[0] / ms:.1%}), R,S = "
                  f"{geo[0]},{geo[1]}, {48 / geo[0]:g} B/pair shared   "
                  "bitwise-repeatable", flush=True)
            if n == 65536:
                main[key] = dict(max_abs_err=err, ms=ms, plain_ms=pms,
                                 shape=[n], bound=bound, smem=48 / geo[0])
            torch.cuda.empty_cache()

    print("kernel      shape            eps        max|da|    rel_a    "
          "rel_j    ms        plain_ms")
    # K3: accel 5e-6 and jerk 1e-5 of max at N <= 16,384, 2e-5 at 65,536
    for n in (8191, 16384, 65536):
        pos, mass, vel = _moving_cluster(n, 13, device)
        tol_a, tol_j = (2e-5, 2e-5) if n >= 65536 else (5e-6, 1e-5)
        for eps in (0.0, 1.0 / 256):
            guarded = eps == 0.0
            out = cg.sym_jerk_kernel(pos, vel, mass, eps, guarded=guarded)
            again = cg.sym_jerk_kernel(pos, vel, mass, eps, guarded=guarded)
            if not all(torch.equal(a, b) for a, b in zip(out, again)):
                raise AssertionError(f"sym_jerk N={n} eps={eps}: two "
                                     "launches differ bitwise")
            ref = cg.sym_jerk_plain(pos, vel, mass, eps, dtype=torch.float64)
            err, rel_a, rel_j = _compare_jerk(out, ref, tol_a, tol_j)
            del ref
            ms = _median_ms(lambda: cg.sym_jerk_kernel(pos, vel, mass, eps,
                                                       guarded=guarded))
            pms = _median_ms(lambda: cg.sym_jerk_plain(pos, vel, mass, eps))
            print(f"sym_jerk    ({n}){'':<{13 - len(str(n))}}"
                  f"{eps:<11.6g}{err:<11.3e}{rel_a:<9.2e}{rel_j:<9.2e}"
                  f"{ms:<10.4f}{pms:.4f}   bitwise-repeatable", flush=True)
            if (n, eps) == (16384, 1.0 / 256):
                main["sym_jerk"] = dict(
                    max_abs_err=err, ms=ms, plain_ms=pms, shape=[n],
                    bound=_bound(n * (n - 1) // 2,
                                 FLOPS_PER_PAIR["sym_jerk"], 52 * n))
            torch.cuda.empty_cache()
    # K4: the same tolerances by source count
    for nr, ns in ((1000, 1000), (4096, 4096), (4096, 65536)):
        src, mass, svel = _moving_cluster(ns, 14, device)
        rows, vrows = src[:nr].contiguous(), svel[:nr].contiguous()
        tol_a, tol_j = (2e-5, 2e-5) if ns >= 65536 else (5e-6, 1e-5)
        for eps in (0.0, 1.0 / 256):
            guarded = eps == 0.0
            out = cg.rows_jerk_kernel(rows, vrows, src, svel, mass, eps,
                                      guarded=guarded)
            ref = cg.rows_jerk_plain(rows, vrows, src, svel, mass, eps,
                                     dtype=torch.float64)
            err, rel_a, rel_j = _compare_jerk(out, ref, tol_a, tol_j)
            del ref
            ms = _median_ms(lambda: cg.rows_jerk_kernel(
                rows, vrows, src, svel, mass, eps, guarded=guarded))
            pms = _median_ms(lambda: cg.rows_jerk_plain(rows, vrows, src,
                                                        svel, mass, eps))
            print(f"rows_jerk   ({nr},{ns}){'':<{13 - len(str(nr)) - len(str(ns))}}"
                  f"{eps:<11.6g}{err:<11.3e}{rel_a:<9.2e}{rel_j:<9.2e}"
                  f"{ms:<10.4f}{pms:.4f}", flush=True)
            if (nr, ns, eps) == (4096, 4096, 1.0 / 256):
                main["rows_jerk"] = dict(
                    max_abs_err=err, ms=ms, plain_ms=pms, shape=[nr, ns],
                    bound=_bound(nr * ns, FLOPS_PER_PAIR["rows_jerk"],
                                 28 * ns + 48 * nr))
    # K5 beside K4 at c4's source count, 2e-5 of max past 16,384 sources
    print("kernel      shape            eps        max|da|    rel_a    "
          "rel_j    ms        K4_ms     plain_ms  bound_ms")
    src, mass, svel = _moving_cluster(K5_NS, 15, device)
    for nr in K5_ROWS:
        for eps in (0.0, 1.0 / 256):
            k5_case(cg, src, svel, mass, nr, eps)
    check_row_independence(cg, src, svel, mass)
    print("kernel     shape           ms        bound_ms   bound_by    "
          "share of bound  shared B/pair")
    for key, m in main.items():
        b_ms, b_by = m["bound"]
        print(f"{key:<11}{str(m['shape']):<16}{m['ms']:<10.4f}{b_ms:<11.5f}"
              f"{b_by:<12}{b_ms / m['ms']:<16.1%}{m.get('smem', '-')}")
    return main


def k5_case(cg, src, svel, mass, nr, eps):
    """K5 on nr rows (the first nr sources, shifted) against the f64 twin
    and launched twice (bitwise), timed beside K4 (both as CUDA-graph
    replays, ``_graph_ms``: at few rows the kernels are shorter than their
    wrappers) and the f32 twin; prints one line and returns
    dict(max_abs_err, ms, plain_ms, k4_ms, shape, bound)."""
    import torch
    ns = src.shape[0]
    rows = (src[:nr] + 1e-3).contiguous()
    vrows = (svel[:nr] - 1e-3).contiguous()
    guarded = eps == 0.0
    tol = 2e-5 if ns > 16384 else 5e-6
    tol_j = 2e-5 if ns > 16384 else 1e-5
    out = cg.rows_jerk_t_kernel(rows, vrows, src, svel, mass, eps,
                                guarded=guarded)
    again = cg.rows_jerk_t_kernel(rows, vrows, src, svel, mass, eps,
                                  guarded=guarded)
    if not all(torch.equal(a, b) for a, b in zip(out, again)):
        raise AssertionError(f"rows_jerk_t ({nr},{ns}) eps={eps}: two "
                             "launches differ bitwise")
    ref = cg.rows_jerk_t_plain(rows, vrows, src, svel, mass, eps,
                               dtype=torch.float64)
    err, rel_a, rel_j = _compare_jerk(out, ref, tol, tol_j)
    del ref
    ms = _graph_ms(lambda: cg.rows_jerk_t_kernel(
        rows, vrows, src, svel, mass, eps, guarded=guarded))
    k4_ms = _graph_ms(lambda: cg.rows_jerk_kernel(
        rows, vrows, src, svel, mass, eps, guarded=guarded))
    pms = _median_ms(lambda: cg.rows_jerk_t_plain(rows, vrows, src, svel,
                                                  mass, eps))
    bound = _bound(nr * ns, FLOPS_PER_PAIR["rows_jerk_t"], 28 * ns + 48 * nr)
    print(f"rows_jerk_t ({nr},{ns}){'':<{13 - len(str(nr)) - len(str(ns))}}"
          f"{eps:<11.6g}{err:<11.3e}{rel_a:<9.2e}{rel_j:<9.2e}"
          f"{ms:<10.4f}{k4_ms:<10.4f}{pms:<10.4f}{bound[0]:.5f}", flush=True)
    torch.cuda.empty_cache()
    return dict(max_abs_err=err, ms=ms, plain_ms=pms, k4_ms=k4_ms,
                shape=[nr, ns], bound=bound)


def check_row_independence(cg, src, svel, mass, kernel=None,
                           name="rows_jerk_t", rows_of=None):
    """K5 (or ``kernel``) gives a row the same bits alone, in a random
    subset and among all rows (what makes compacted and masked block steps
    agree); the rows are the first ``rows_of`` sources (all by default)."""
    import torch
    kernel = kernel or cg.rows_jerk_t_kernel
    ns = src.shape[0]
    nr = rows_of or ns
    gen = torch.Generator().manual_seed(16)
    for guarded, eps in ((True, 0.0), (False, 1.0 / 256)):
        full = kernel(src[:nr], svel[:nr], src, svel, mass, eps,
                      guarded=guarded)
        for k in (1, 64, 1024, 8191):
            rows = torch.randperm(nr, generator=gen)[:k].to(src.device)
            sub = kernel(src[rows].contiguous(), svel[rows].contiguous(), src,
                         svel, mass, eps, guarded=guarded)
            if not all(torch.equal(a, b[rows]) for a, b in zip(sub, full)):
                raise AssertionError(f"{name}: {k} rows launched apart "
                                     "differ bitwise from the same rows "
                                     "among all")
    print(f"{name}: rows of 1, 64, 1024 and 8191 launched apart are bitwise "
          f"equal to the same rows among {nr} against {ns} sources (eps 0 "
          "and 1/256)")


def _planes(n, seed, device):
    """(hi, lo, gm, vhi, vlo) of a Hénon-unit Plummer sphere: the operands
    of the extended tier."""
    import torch
    from oc_nbody_tpu_torch.models.plummer import plummer
    from oc_nbody_tpu_torch.ops.gravity import prepare_x
    state = plummer(n, torch.Generator().manual_seed(seed), device=device)
    return prepare_x(state.pos, state.mass, 1.0, vel=state.vel)


def _same_bits(a, b):
    import torch
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    return all(torch.equal(x, y) for x, y in zip(a, b))


# K22 (csrc/knn_density.cu) is bound by its issue rate, not by a pipe's
# flops: ~10 instructions a pair (three subtractions, three
# multiplications, two additions, the compare and its branch) at 132 SMs x
# 128 lanes x 1.98 GHz
KNN_INSTR_PER_PAIR = 10
PEAK_ISSUE = 132 * 128 * 1.98e9


def check_knn(cg, device):
    """K22 against its plain twin on the same card tensors, at the CH85
    sweep's shapes on the main paths: c4's 32,768 stars, the north star's
    65,536 and c5's 131,072 strided by 2 to 65,536 probes and sources, each
    a Plummer sphere centred on its density centre and strided and cast as
    diagnostics.local_density does. rk2 bitwise, mnb within 1e-6 relative,
    two launches bitwise; returns the north star's dict(max_abs_err (of
    mnb), ms, plain_ms, shape, bound)."""
    import torch
    from oc_nbody_tpu_torch import diagnostics as tdiag
    from oc_nbody_tpu_torch.models.plummer import plummer
    from oc_nbody_tpu_torch.ops import cuda_knn
    print("knn_density (K22): n, probes = sources, mnb max rel, ms, "
          "plain_ms, bound_ms")
    main = None
    for n in (32768, 65536, 131072):
        st = plummer(n, torch.Generator().manual_seed(n + 22), device=device)
        c = st.pos - tdiag.density_center(st)
        s = -(-n // 65536)
        probes = c[::s].float().contiguous()
        src = probes
        msrc = (st.mass[::s].float() * float(s)).contiguous()
        rk2, mnb = cuda_knn.knn_density_kernel(probes, src, msrc, 6)
        again = cuda_knn.knn_density_kernel(probes, src, msrc, 6)
        if not (torch.equal(rk2, again[0]) and torch.equal(mnb, again[1])):
            raise AssertionError(f"knn_density n={n}: two launches differ "
                                 "bitwise")
        want_rk2, want_mnb = cuda_knn.knn_density_plain(probes, src, msrc, 6)
        if not torch.equal(rk2, want_rk2):
            raise AssertionError(
                f"knn_density n={n}: rk2 differs from the twin's on "
                f"{int((rk2 != want_rk2).sum())} probes")
        err = float((mnb.double() - want_mnb.double()).abs().max())
        rel = float(((mnb.double() - want_mnb.double()).abs()
                     / want_mnb.double().abs()).max())
        if not rel <= 1e-6:
            raise AssertionError(f"knn_density n={n}: mnb relative error "
                                 f"{rel:.3e} > 1e-6")
        ms = _median_ms(lambda: cuda_knn.knn_density_kernel(probes, src,
                                                            msrc, 6))
        pms = (_median_ms(lambda: cuda_knn.knn_density_plain(
            probes, src, msrc, 6), reps=3) if n == 65536 else None)
        np_ = probes.shape[0]
        bound = (np_ * np_ * KNN_INSTR_PER_PAIR / PEAK_ISSUE * 1e3,
                 "operations")
        print(f"knn_density {n:<7}{np_:<7}{rel:<11.3e}{ms:<10.4f}"
              f"{'' if pms is None else f'{pms:.4f}':<10}{bound[0]:.4f}",
              flush=True)
        if n == 65536:
            main = dict(max_abs_err=err, ms=ms, plain_ms=pms,
                        shape=[np_, np_], bound=bound)
        del st, c, probes, src, msrc, rk2, mnb, again, want_rk2, want_mnb
        torch.cuda.empty_cache()
    return main


# K23 (csrc/phi_f64.cu) is bound by the FP64 pipe: 64 lanes an SM, each
# DADD, DMUL or DFMA one issue slot, 33.5e12 flops a second with an FMA
# counted twice. A pair is 3 DADD, 3 DFMA for u, rsqrt(double)'s Newton
# refinement (DMUL, DFMA; its seed MUFU.RSQ64H runs on the special-function
# unit) and one DFMA into the sum: PHI64_SLOTS_PER_PAIR FP64 instructions
# in the compiled inner loop (cuobjdump -sass of phi_f64_partial<4,false>)
PHI64_SLOTS_PER_PAIR = 12
PEAK_FP64_FLOPS = 33.5e12
# c5's softening (configs/c5_131k_sharded.toml) and the sizes of the f64
# rows: c5's 131,072 stars and a million (ROADMAP C5's check)
PHI64_EPS = 0.001953125
PHI64_NS = (131072, 1048576)
PHI64_SAMPLE = 4096


def _phi64_bound_ms(n):
    return n * n * 2 * PHI64_SLOTS_PER_PAIR / PEAK_FP64_FLOPS * 1e3


def check_phi64(cg, device):
    """K23 against its plain twin on the same card tensors (Plummer
    spheres): at 4,097 stars with eps = 0 and coincident stars (the guard)
    and at c5's 131,072 with c5's eps, the whole twin, the largest gap over
    max|phi| at most 1e-13; at 1,048,576 against the plain f64 rows sum on
    PHI64_SAMPLE sampled rows (the whole twin would take ~75 s); two
    launches bitwise equal; each timed beside its FP64 bound. Returns the
    131,072 case's dict(max_abs_err, ms, plain_ms, shape, bound)."""
    import torch
    from oc_nbody_tpu_torch.models.plummer import plummer
    from oc_nbody_tpu_torch.ops import cuda_phi64, gravity
    print(f"phi_f64 (K23): n, eps, max gap / max|phi|, ms, plain_ms, "
          f"bound_ms ({PHI64_SLOTS_PER_PAIR} FP64 slots a pair)")
    main = None
    for n, eps in ((4097, 0.0),) + tuple((n, PHI64_EPS) for n in PHI64_NS):
        st = plummer(n, torch.Generator().manual_seed(n + 23), device=device)
        pos, mass = st.pos, st.mass
        if eps == 0.0:   # coincident stars: u = 0 off the diagonal
            pos = pos.clone()
            pos[1:4] = pos[0]
        phi = cuda_phi64.potential_kernel(pos, mass, eps)
        if not torch.equal(phi, cuda_phi64.potential_kernel(pos, mass, eps)):
            raise AssertionError(f"phi_f64 n={n}: two launches differ "
                                 "bitwise")
        if not bool(torch.isfinite(phi).all()):
            raise AssertionError(f"phi_f64 n={n}: non-finite phi")
        if n <= PHI64_NS[0]:
            pms = _once_ms(lambda: cuda_phi64.potential_plain(pos, mass,
                                                              eps))
            got, want = phi, cuda_phi64.potential_plain(pos, mass, eps)
        else:
            idx = torch.randperm(n, generator=torch.Generator().manual_seed(
                n), device="cpu")[:PHI64_SAMPLE].to(device)
            pos_c, mass_c = gravity.prepare_f32(pos, mass,
                                                compute_dtype=torch.float64)
            t = time.perf_counter()
            want = (gravity.accel_potential_rows(
                pos_c[idx], pos_c, mass_c, eps, 1.0, chunk=64)[1]
                + gravity.self_phi(mass_c[idx], eps, 1.0))
            torch.cuda.synchronize()
            print(f"phi_f64 {n}: the plain f64 rows sum on {PHI64_SAMPLE} "
                  f"rows {time.perf_counter() - t:.2f} s", flush=True)
            got, pms = phi[idx], None
        err = float((got - want).abs().max())
        rel = err / float(want.abs().max())
        if not rel <= 1e-13:
            raise AssertionError(f"phi_f64 n={n}: max gap / max|phi| "
                                 f"{rel:.3e} > 1e-13")
        bound = (_phi64_bound_ms(n), "operations")
        ms = _median_ms(lambda: cuda_phi64.potential_kernel(pos, mass, eps),
                        reps=3)
        print(f"phi_f64 {n:<8}{eps:<12g}{rel:<11.3e}{ms:<11.4f}"
              f"{'' if pms is None else f'{pms:.1f}':<11}{bound[0]:.4f}"
              f"  ({bound[0] / ms:.1%} of the bound)", flush=True)
        if n == PHI64_NS[0]:
            main = dict(max_abs_err=err, ms=ms, plain_ms=pms,
                        shape=[n, n], bound=bound)
        del st, pos, mass, phi, got, want
        torch.cuda.empty_cache()
    return main


def check_kernels_x(cg, device, main):
    """Phase 3, the extended tier: K6-K9 against the f64 evaluation of the
    same (hi, lo) planes at the paths' shapes; adds their entries to
    ``main``. Tolerances as for K1-K5: 5e-6·max|a| and 1e-5·max|j| up to
    16,384 sources, 2e-5 beyond; phi rtol 3e-5."""
    import torch
    f64 = torch.float64
    print("kernel        shape            phi  eps        max|da|    "
          "rel      phi_rel    ms        plain_ms  f32-tier ms")
    # K8 at c1's N, beside K1
    hi, lo, gm, _, _ = _planes(K8_N, 21, device)
    pos_c, mass_c = _cluster(K8_N, 21, device)
    for with_phi in (False, True):
        for eps in (0.0, 1.0 / 512):
            kw = dict(with_phi=with_phi, guarded=eps == 0.0)
            out = cg.rows_x_kernel(hi, lo, hi, lo, gm, eps, **kw)
            ref = cg.rows_x_plain(hi, lo, hi, lo, gm, eps, dtype=f64, **kw)
            err, rel, prel = _compare(out, ref, with_phi, 5e-6)
            ms = _median_ms(lambda: cg.rows_x_kernel(hi, lo, hi, lo, gm, eps,
                                                     **kw))
            pms = _median_ms(lambda: cg.rows_x_plain(hi, lo, hi, lo, gm, eps,
                                                     **kw))
            k1 = _median_ms(lambda: cg.rows_kernel(pos_c, pos_c, mass_c, eps,
                                                   **kw))
            print(f"rows_accel_x  ({K8_N},{K8_N})    {int(with_phi):<5}"
                  f"{eps:<11.6g}{err:<11.3e}{rel:<9.2e}{prel:<11.2e}"
                  f"{ms:<10.4f}{pms:<10.4f}{k1:.4f} (K1)")
            if eps > 0:
                key = "rows_x_phi" if with_phi else "rows_x"
                main[key] = dict(
                    max_abs_err=err, ms=ms, plain_ms=pms, f32_ms=k1,
                    shape=[K8_N, K8_N],
                    bound=_bound(K8_N * K8_N, FLOPS_PER_PAIR[key],
                                 (64 + (4 if with_phi else 0)) * K8_N))
    # K6 at c5x's N, beside K2, its tile geometry (csrc/sym_rows.cuh) and
    # its shared bytes a pair (64 / R); the f64 evaluation once per eps
    # (with the potential: its accelerations are those of the form without)
    hi, lo, gm, _, _ = _planes(K6_N, 22, device)
    pos_c, mass_c = _cluster(K6_N, 22, device)
    geo = cg.sym_geometry(K6_N, "sym_x")
    for eps in (1.0 / 512, 0.0):
        guarded = eps == 0.0
        ref = cg.sym_x_plain(hi, lo, gm, eps, with_phi=True, dtype=f64,
                             guarded=guarded)
        for with_phi in (False, True) if eps > 0 else (False,):
            kw = dict(with_phi=with_phi, guarded=guarded)
            out = cg.sym_x_kernel(hi, lo, gm, eps, **kw)
            if not _same_bits(out, cg.sym_x_kernel(hi, lo, gm, eps, **kw)):
                raise AssertionError(f"sym_accel_x N={K6_N} phi={with_phi} "
                                     f"eps={eps}: two launches differ "
                                     "bitwise")
            err, rel, prel = _compare(out, ref if with_phi else ref[0],
                                      with_phi, 2e-5)
            ms = _median_ms(lambda: cg.sym_x_kernel(hi, lo, gm, eps, **kw))
            k2 = _median_ms(lambda: cg.sym_kernel(pos_c, mass_c, eps, **kw))
            pms = (_median_ms(lambda: cg.sym_x_plain(hi, lo, gm, eps, **kw),
                              reps=1) if eps > 0 else float("nan"))
            key = "sym_x_phi" if with_phi else "sym_x"
            bound = _bound(K6_N * (K6_N - 1) // 2, FLOPS_PER_PAIR[key],
                           (40 + (4 if with_phi else 0)) * K6_N)
            print(f"sym_accel_x   ({K6_N})         {int(with_phi):<5}"
                  f"{eps:<11.6g}{err:<11.3e}{rel:<9.2e}{prel:<11.2e}"
                  f"{ms:<10.4f}{pms:<10.4f}{k2:.4f} (K2)   bound "
                  f"{bound[0]:.4f} ({bound[0] / ms:.1%}; first design "
                  f"{FIRST_DESIGN_MS[key]} ms), R,S = {geo[0]},{geo[1]}, "
                  f"{64 / geo[0]:g} B/pair shared   bitwise-repeatable",
                  flush=True)
            if eps > 0:
                main[key] = dict(
                    max_abs_err=err, ms=ms, plain_ms=pms, f32_ms=k2,
                    shape=[K6_N], bound=bound, smem=64 / geo[0])
        del ref
        torch.cuda.empty_cache()
    # the f64 evaluation of K6's planes, timed once: the first data point
    # for this tier against a native-f64 pair sum on this card
    f64_ms = _median_ms(lambda: cg.sym_x_plain(hi, lo, gm, 1.0 / 512,
                                               dtype=f64), reps=1)
    print(f"the f64 plain evaluation of the same planes at N={K6_N}: "
          f"{f64_ms:.1f} ms (eager PyTorch, chunks of 256 rows)")
    main["sym_x"]["f64_plain_ms"] = f64_ms
    del hi, lo, gm, pos_c, mass_c
    torch.cuda.empty_cache()

    print("kernel        shape            eps        max|da|    rel_a    "
          "rel_j    ms        plain_ms  f32-tier ms")
    # K7 at c3's N, beside K3
    hi, lo, gm, vhi, vlo = _planes(K7_N, 23, device)
    pos_c, mass_c, vel_c = _moving_cluster(K7_N, 23, device)
    for eps in (0.0, 1.0 / 256):
        guarded = eps == 0.0
        out = cg.sym_jerk_x_kernel(hi, lo, vhi, vlo, gm, eps, guarded=guarded)
        if not _same_bits(out, cg.sym_jerk_x_kernel(hi, lo, vhi, vlo, gm, eps,
                                                    guarded=guarded)):
            raise AssertionError(f"sym_jerk_x N={K7_N} eps={eps}: two "
                                 "launches differ bitwise")
        ref = cg.sym_jerk_x_plain(hi, lo, vhi, vlo, gm, eps, dtype=f64,
                                  guarded=guarded)
        err, rel_a, rel_j = _compare_jerk(out, ref, 5e-6, 1e-5)
        del ref
        ms = _median_ms(lambda: cg.sym_jerk_x_kernel(hi, lo, vhi, vlo, gm,
                                                     eps, guarded=guarded))
        pms = _median_ms(lambda: cg.sym_jerk_x_plain(hi, lo, vhi, vlo, gm,
                                                     eps, guarded=guarded))
        k3 = _median_ms(lambda: cg.sym_jerk_kernel(pos_c, vel_c, mass_c, eps,
                                                   guarded=guarded))
        print(f"sym_jerk_x    ({K7_N})          {eps:<11.6g}{err:<11.3e}"
              f"{rel_a:<9.2e}{rel_j:<9.2e}{ms:<10.4f}{pms:<10.4f}{k3:.4f} "
              "(K3)   bitwise-repeatable", flush=True)
        if eps > 0:
            main["sym_jerk_x"] = dict(
                max_abs_err=err, ms=ms, plain_ms=pms, f32_ms=k3,
                shape=[K7_N],
                bound=_bound(K7_N * (K7_N - 1) // 2,
                             FLOPS_PER_PAIR["sym_jerk_x"], 76 * K7_N))
    torch.cuda.empty_cache()
    # K9: a self-interaction below SYM_MIN, then K5's row counts against
    # c4's source count, beside K5
    src = _planes(K9_SELF_N, 24, device)
    for eps in (0.0, 1.0 / 256):
        k9_case(cg, src, K9_SELF_N, eps, shift=False)
    src = _planes(K5_NS, 25, device)
    for nr in K5_ROWS:
        for eps in (0.0, 1.0 / 256):
            k9_case(cg, src, nr, eps)
    check_row_independence_x(cg, src)


def k9_case(cg, src, nr, eps, shift=True):
    """K9 on nr rows (the first nr sources, shifted unless ``shift`` is
    False: then a self-interaction) against the f64 evaluation of the same
    planes and launched twice (bitwise), timed beside K5 on the planes'
    hi parts (both as CUDA-graph replays) and the f32 twin; prints one line
    and returns dict(max_abs_err, ms, plain_ms, f32_ms, shape, bound)."""
    import torch
    hi, lo, gm, vhi, vlo = src
    ns = hi.shape[0]
    if shift:
        rows = ((hi[:nr] + 1e-3).contiguous(), lo[:nr].contiguous(),
                (vhi[:nr] - 1e-3).contiguous(), vlo[:nr].contiguous())
    else:
        rows = tuple(p[:nr].contiguous() for p in (hi, lo, vhi, vlo))
    planes = (*rows, hi, lo, vhi, vlo, gm)
    guarded = eps == 0.0
    tol = 2e-5 if ns > 16384 else 5e-6
    tol_j = 2e-5 if ns > 16384 else 1e-5
    out = cg.rows_jerk_x_kernel(*planes, eps, guarded=guarded)
    if not _same_bits(out, cg.rows_jerk_x_kernel(*planes, eps,
                                                 guarded=guarded)):
        raise AssertionError(f"rows_jerk_x ({nr},{ns}) eps={eps}: two "
                             "launches differ bitwise")
    ref = cg.rows_jerk_x_plain(*planes, eps, dtype=torch.float64,
                               guarded=guarded)
    err, rel_a, rel_j = _compare_jerk(out, ref, tol, tol_j)
    del ref
    ms = _graph_ms(lambda: cg.rows_jerk_x_kernel(*planes, eps,
                                                 guarded=guarded))
    # the f32 tier on the same sizes: K5 from RT_MIN_JERK sources, K4 below
    f32_kernel = (cg.rows_jerk_t_kernel if ns >= cg.RT_MIN_JERK
                  else cg.rows_jerk_kernel)
    f32_ms = _graph_ms(lambda: f32_kernel(rows[0], rows[2], hi, vhi, gm, eps,
                                          guarded=guarded))
    pms = _median_ms(lambda: cg.rows_jerk_x_plain(*planes, eps,
                                                  guarded=guarded))
    bound = _bound(nr * ns, FLOPS_PER_PAIR["rows_jerk_x"], 52 * ns + 72 * nr)
    name = "K5" if ns >= cg.RT_MIN_JERK else "K4"
    print(f"rows_jerk_x   ({nr},{ns}){'':<{13 - len(str(nr)) - len(str(ns))}}"
          f"{eps:<11.6g}{err:<11.3e}{rel_a:<9.2e}{rel_j:<9.2e}"
          f"{ms:<10.4f}{pms:<10.4f}{f32_ms:.4f} ({name})  bound "
          f"{bound[0]:.5f}", flush=True)
    torch.cuda.empty_cache()
    return dict(max_abs_err=err, ms=ms, plain_ms=pms, f32_ms=f32_ms,
                shape=[nr, ns], bound=bound)


def check_row_independence_x(cg, src, kernel=None, name="rows_jerk_x",
                             rows_of=None):
    """K9 (or ``kernel``) gives a row the same bits alone, in a random
    subset and among all rows (what makes compacted and masked block steps
    agree); the rows are the first ``rows_of`` sources (all by default)."""
    import torch
    kernel = kernel or cg.rows_jerk_x_kernel
    hi, lo, gm, vhi, vlo = src
    planes = (hi, lo, vhi, vlo)
    ns = hi.shape[0]
    nr = min(rows_of or ns, ns)
    gen = torch.Generator().manual_seed(17)
    for guarded, eps in ((True, 0.0), (False, 1.0 / 256)):
        full = kernel(*(p[:nr] for p in planes), *planes, gm, eps,
                      guarded=guarded)
        for k in (1, 64, 1024, 8191):
            rows = torch.randperm(nr, generator=gen)[:k].to(hi.device)
            sub = kernel(*(p[rows] for p in planes), *planes, gm, eps,
                         guarded=guarded)
            if not all(torch.equal(a, b[rows]) for a, b in zip(sub, full)):
                raise AssertionError(f"{name}: {k} rows launched apart "
                                     "differ bitwise from the same rows "
                                     "among all")
    print(f"{name}: rows of 1, 64, 1024 and 8191 launched apart are bitwise "
          f"equal to the same rows among {nr} against {ns} sources (eps 0 "
          "and 1/256)")


def check_close_pairs(cg, device):
    """The case that tells the tiers apart (the JAX package's, from a numpy
    seed): 600 particles, 50 of them 1e-5 of the coordinate scale from a
    partner, eps = 1e-4, against the f64 oracle of the unsplit state. The
    df32 kernels must stay inside 1e-9·max|a| and 1e-8·max|j|, the extended
    kernels inside 2e-5·max|a| and 5e-5·max|j|; the f32 kernels must err
    past 1e-3·max|a| (a kernel that ignored lo would). Returns the worst
    accel error of each tier."""
    import numpy as np
    import torch
    from oc_nbody_tpu_torch.ops import gravity
    rng = np.random.default_rng(7)
    n, eps = 600, 1e-4
    pos = rng.normal(size=(n, 3))
    pos[50:100] = pos[:50] + 1e-5 * rng.normal(size=(50, 3))
    pos = torch.from_numpy(pos).to(device)
    vel = torch.from_numpy(0.3 * rng.normal(size=(n, 3))).to(device)
    mass = torch.from_numpy(rng.uniform(0.5, 1.5, n) / n).to(device)
    a_ref, j_ref = gravity.accel_jerk_direct(pos, vel, mass, eps)

    def rel(got, want):
        return float(torch.linalg.norm(got.double() - want, dim=1).max()
                     / torch.linalg.norm(want, dim=1).max())

    hi, lo, gm, vhi, vlo = gravity.prepare_x(pos, mass, 1.0, vel=vel)
    src = (hi, lo, vhi, vlo)
    pos_c, mass_c, vel_c = gravity.prepare_f32(pos, mass, vel=vel)
    f32 = {"K1": rel(cg.rows_kernel(pos_c, pos_c, mass_c, eps), a_ref),
           "K2": rel(cg.sym_kernel(pos_c, mass_c, eps), a_ref),
           "K4": rel(cg.rows_jerk_kernel(pos_c, vel_c, pos_c, vel_c, mass_c,
                                         eps)[0], a_ref)}
    a9, j9 = cg.rows_jerk_x_kernel(*src, *src, gm, eps)
    a7, j7 = cg.sym_jerk_x_kernel(*src, gm, eps)
    ext_a = {"K6": rel(cg.sym_x_kernel(hi, lo, gm, eps), a_ref),
             "K7": rel(a7, a_ref),
             "K8": rel(cg.rows_x_kernel(hi, lo, hi, lo, gm, eps), a_ref),
             "K9": rel(a9, a_ref)}
    ext_j = {"K7": rel(j7, j_ref), "K9": rel(j9, j_ref)}
    from oc_nbody_tpu_torch.ops import cuda_df
    a11, j11 = cuda_df.accel_jerk_df(pos, vel, mass, eps, guarded=False)
    df_a = {"K10": rel(cuda_df.accel_df(pos, mass, eps, guarded=False),
                       a_ref), "K11": rel(a11, a_ref)}
    df_j = {"K11": rel(j11, j_ref)}
    print("close pairs (N=600, 50 pairs at 1e-5, eps=1e-4), max row error "
          "over max row size against the f64 oracle: f32 kernels accel "
          + ", ".join(f"{k} {v:.3e}" for k, v in f32.items())
          + "; extended kernels accel "
          + ", ".join(f"{k} {v:.3e}" for k, v in ext_a.items())
          + "; jerk " + ", ".join(f"{k} {v:.3e}" for k, v in ext_j.items())
          + "; df32 kernels accel "
          + ", ".join(f"{k} {v:.3e}" for k, v in df_a.items())
          + "; jerk " + ", ".join(f"{k} {v:.3e}" for k, v in df_j.items()))
    if not all(v > 1e-3 for v in f32.values()):
        raise AssertionError(f"close pairs: an f32 kernel is inside 1e-3: "
                             f"{f32}; the case does not tell the tiers apart")
    if not all(v < 2e-5 for v in ext_a.values()):
        raise AssertionError(f"close pairs: extended accel past 2e-5: {ext_a}")
    if not all(v < 5e-5 for v in ext_j.values()):
        raise AssertionError(f"close pairs: extended jerk past 5e-5: {ext_j}")
    if not all(v < 1e-9 for v in df_a.values()):
        raise AssertionError(f"close pairs: df32 accel past 1e-9: {df_a}")
    if not all(v < 1e-8 for v in df_j.values()):
        raise AssertionError(f"close pairs: df32 jerk past 1e-8: {df_j}")
    return {"f32": max(f32.values()), "extended": max(ext_a.values()),
            "df32": max(df_a.values())}


def check_eft(cdf, device):
    """The device's error-free transforms (csrc/df.cuh, through
    csrc/df_selftest.cu): s + e == a + b and p + e == a·b exactly in f64 on
    1e5 f32 pairs of magnitudes 2^-12 .. 2^12 (so both f64 checks are
    exact), and df_rsqrt inside 1e-13 relative on 1e5 values over nine
    decades."""
    import numpy as np
    import torch
    from oc_nbody_tpu_torch.ops.df32 import df_from_f64
    rng = np.random.default_rng(3)
    n = 100_000
    a, b = (torch.from_numpy(
        (rng.normal(size=n) * np.exp2(rng.integers(-12, 13, n)))
        .astype(np.float32)).to(device) for _ in range(2))
    x = torch.from_numpy(np.exp(rng.uniform(-14.0, 7.0, n))).to(device)
    s, se, p, pe, yh, yl = (t.double() for t in cdf.eft_selftest_kernel(
        a, b, *df_from_f64(x)))
    bad_sum = int((s + se != a.double() + b.double()).sum())
    bad_prod = int((p + pe != a.double() * b.double()).sum())
    rs_err = float((((yh + yl) - x ** -0.5) * x ** 0.5).abs().max())
    print(f"error-free transforms on the card, {n} f32 pairs: two_sum "
          f"inexact on {bad_sum}, two_prod inexact on {bad_prod}; df_rsqrt "
          f"max relative error {rs_err:.3e} (bound 1e-13)")
    if bad_sum or bad_prod or not rs_err < 1e-13:
        raise AssertionError("the device's error-free transforms are not "
                             "exact")


def _df_planes(n, seed, device, eps):
    """((hi, lo, vhi, vlo), (gm_hi, gm_lo, eps2_hi, eps2_lo)) of a
    Hénon-unit Plummer sphere: the operands of the df32 tier."""
    import torch
    from oc_nbody_tpu_torch.models.plummer import plummer
    from oc_nbody_tpu_torch.ops.df32 import _df_prepare
    state = plummer(n, torch.Generator().manual_seed(seed), device=device)
    hi, lo, gm_hi, gm_lo, e2h, e2l, vhi, vlo = _df_prepare(
        state.pos, state.mass, eps, 1.0, vel=state.vel)
    return (hi, lo, vhi, vlo), (gm_hi, gm_lo, e2h, e2l)


def check_kernels_df(cg, cdf, device, main):
    """Phase 3, the two-float tier: the EFT self-test, then K10 and K11
    against the f64 evaluation of the same planes (1e-9·max|a|, 1e-8·max|j|),
    launched twice and bitwise equal, timed beside the extended and the f32
    kernel of the same self-interaction (the hi planes and gm_hi are those
    tiers' operands), the df twin and eager f64 PyTorch; adds their entries
    to ``main``."""
    import torch
    from oc_nbody_tpu_torch.ops import gravity
    f64 = torch.float64
    check_eft(cdf, device)
    print("kernel        shape      eps        max|da|    rel_a     ms        "
          "twin_ms     extended ms     f32 ms          eager f64 ms")
    for n in K10_NS:
        for eps in (1.0 / 512, 0.0):
            (hi, lo, _, _), rest = _df_planes(n, 31, device, eps)
            guarded = eps == 0.0
            args = (hi, lo, hi, lo, *rest)
            out = cdf.rows_df_kernel(*args, guarded=guarded)
            if not torch.equal(out, cdf.rows_df_kernel(*args,
                                                       guarded=guarded)):
                raise AssertionError(f"rows_accel_df N={n} eps={eps}: two "
                                     "launches differ bitwise")
            ref = cdf.rows_df_plain(*args, dtype=f64, guarded=guarded)
            err, rel, _ = _compare(out, ref, False, 1e-9)
            del ref
            ms = _median_ms(lambda: cdf.rows_df_kernel(*args,
                                                       guarded=guarded))
            line = (f"rows_accel_df ({n}){'':<{9 - len(str(n))}}{eps:<11.6g}"
                    f"{err:<11.3e}{rel:<10.2e}{ms:<10.4f}")
            if eps > 0:
                gm = rest[0]
                timer = _once_ms if n > 16384 else _median_ms
                pms = timer(lambda: cdf.rows_df_plain(*args, guarded=False))
                if n >= cg.SYM_MIN:
                    ext = _median_ms(lambda: cg.sym_x_kernel(hi, lo, gm, eps))
                    f32 = _median_ms(lambda: cg.sym_kernel(hi, gm, eps))
                    names = ("K6", "K2")
                else:
                    ext = _median_ms(lambda: cg.rows_x_kernel(hi, lo, hi, lo,
                                                              gm, eps))
                    f32 = _median_ms(lambda: cg.rows_kernel(hi, hi, gm, eps))
                    names = ("K8", "K1")
                pos64 = hi.to(f64) + lo.to(f64)
                e64 = timer(lambda: gravity.accel(pos64, gm, eps,
                                                  compute_dtype=f64,
                                                  chunk=256))
                line += (f"{pms:<12.4f}{ext:<9.4f}({names[0]})   {f32:<9.4f}"
                         f"({names[1]})   {e64:.4f}")
                entry = dict(max_abs_err=err, ms=ms, plain_ms=pms, ext_ms=ext,
                             f32_ms=f32, f64_eager_ms=e64, shape=[n],
                             bound=_bound(n * n, FLOPS_PER_PAIR["rows_df"],
                                          80 * n))
                main[f"rows_df_{n}"] = entry
                if n == K10_NS[-1]:
                    main["rows_df"] = entry
            print(line + "   bitwise-repeatable", flush=True)
            torch.cuda.empty_cache()
    print("kernel        shape      eps        max|da|    rel_a     rel_j     "
          "ms        twin_ms     extended ms     f32 ms          "
          "eager f64 ms")
    for n in K11_NS:
        for eps in (1.0 / 256, 0.0):
            planes, rest = _df_planes(n, 32, device, eps)
            hi, lo, vhi, vlo = planes
            guarded = eps == 0.0
            args = (*planes, *planes, *rest)
            out = cdf.rows_jerk_df_kernel(*args, guarded=guarded)
            if not _same_bits(out, cdf.rows_jerk_df_kernel(*args,
                                                           guarded=guarded)):
                raise AssertionError(f"rows_jerk_df N={n} eps={eps}: two "
                                     "launches differ bitwise")
            ref = cdf.rows_jerk_df_plain(*args, dtype=f64, guarded=guarded)
            err, rel_a, rel_j = _compare_jerk(out, ref, 1e-9, 1e-8)
            del ref
            ms = _median_ms(lambda: cdf.rows_jerk_df_kernel(*args,
                                                            guarded=guarded))
            line = (f"rows_jerk_df  ({n}){'':<{9 - len(str(n))}}{eps:<11.6g}"
                    f"{err:<11.3e}{rel_a:<10.2e}{rel_j:<10.2e}{ms:<10.4f}")
            if eps > 0:
                gm = rest[0]
                pms = _median_ms(lambda: cdf.rows_jerk_df_plain(
                    *args, guarded=False), reps=2)
                if n >= cg.SYM_MIN:
                    ext = _median_ms(lambda: cg.sym_jerk_x_kernel(*planes, gm,
                                                                  eps))
                    xname = "K7"
                else:
                    ext = _median_ms(lambda: cg.rows_jerk_x_kernel(
                        *planes, *planes, gm, eps))
                    xname = "K9"
                if n >= cg.RT_MIN_JERK:
                    f32 = _median_ms(lambda: cg.sym_jerk_kernel(hi, vhi, gm,
                                                                eps))
                    fname = "K3"
                else:
                    f32 = _median_ms(lambda: cg.rows_jerk_kernel(
                        hi, vhi, hi, vhi, gm, eps))
                    fname = "K4"
                pos64, vel64 = hi.to(f64) + lo.to(f64), vhi.to(f64) + vlo.to(f64)
                e64 = _median_ms(lambda: gravity.accel_jerk(
                    pos64, vel64, gm, eps, compute_dtype=f64, chunk=256),
                    reps=2)
                line += (f"{pms:<12.4f}{ext:<9.4f}({xname})   {f32:<9.4f}"
                         f"({fname})   {e64:.4f}")
                entry = dict(max_abs_err=err, ms=ms, plain_ms=pms, ext_ms=ext,
                             f32_ms=f32, f64_eager_ms=e64, shape=[n],
                             bound=_bound(n * n,
                                          FLOPS_PER_PAIR["rows_jerk_df"],
                                          152 * n))
                main[f"rows_jerk_df_{n}"] = entry
                if n == K11_NS[-1]:
                    main["rows_jerk_df"] = entry
            print(line + "   bitwise-repeatable", flush=True)
            torch.cuda.empty_cache()
    close = check_close_pairs(cg, device)
    print("the precision tiers on this card (self-interaction kernel ms; "
          "close-pair accel error against the f64 oracle):")
    for n in (16384, 131072):
        m = main[f"rows_df_{n}"]
        print(f"  accel N={n}: f32 {m['f32_ms']:.4f}, extended "
              f"{m['ext_ms']:.4f}, df32 (K10) {m['ms']:.4f}, eager f64 "
              f"PyTorch {m['f64_eager_ms']:.4f}")
    for n in (8192, 16384):
        m = main[f"rows_jerk_df_{n}"]
        print(f"  accel+jerk N={n}: f32 {m['f32_ms']:.4f}, extended "
              f"{m['ext_ms']:.4f}, df32 (K11) {m['ms']:.4f}, eager f64 "
              f"PyTorch {m['f64_eager_ms']:.4f}")
    print(f"  close pairs: f32 {close['f32']:.3e}, extended "
          f"{close['extended']:.3e}, df32 {close['df32']:.3e}, f64 exact",
          flush=True)


def check_kernels_big(cg, device, main):
    """Phase 3, past STREAM_N: K12 (with and without the potential) and K13
    at a full chunk pair and a ragged one, K14 on K5's row counts against
    1M sources, each against its f64 twin (2e-5 of max, phi rtol 3e-5),
    launched twice and bitwise equal, K14 row-set independent; then the
    chunked evaluation at N = 1M against the f64 oracle rows sum on a
    sample of rows against all sources (accel and jerk 2e-5 of max, phi
    rtol 3e-5) and bitwise repeatable, timed at 1M and 2M beside K1 as a
    one-sided self-interaction at 1M. Adds K12's and K13's entries to
    ``main`` (K14's comes at c4_1m's mean active rows, after the paths)."""
    import torch
    from oc_nbody_tpu_torch.models.plummer import plummer
    from oc_nbody_tpu_torch.ops import gravity
    f64 = torch.float64
    eps = 1.0 / 256
    print("kernel      shape            phi  max|da| A  max|da| B  rel      "
          "phi_rel    ms        plain_ms  bound_ms  (R,S, shared B/pair)")
    pos, mass = _cluster(sum(K12_PAIRS[0]), 41, device)
    for nA, nB in K12_PAIRS:
        geo = cg.cross_geometry(nA, nB)
        pA, pB = pos[:nA].contiguous(), pos[nA:nA + nB].contiguous()
        mA, mB = mass[:nA].contiguous(), mass[nA:nA + nB].contiguous()
        for with_phi in (False, True):
            kw = dict(with_phi=with_phi, guarded=False)
            out = cg.cross_kernel(pA, pB, mA, mB, eps, **kw)
            if not _same_bits(out, cg.cross_kernel(pA, pB, mA, mB, eps,
                                                   **kw)):
                raise AssertionError(f"cross_accel ({nA},{nB}) phi="
                                     f"{with_phi}: two launches differ "
                                     "bitwise")
            ref = cg.cross_plain(pA, pB, mA, mB, eps, with_phi=with_phi,
                                 dtype=f64, chunk=256)
            h = len(out) // 2
            errs = [_compare(out[:h] if with_phi else out[0],
                             ref[:h] if with_phi else ref[0], with_phi, 2e-5),
                    _compare(out[h:] if with_phi else out[1],
                             ref[h:] if with_phi else ref[1], with_phi, 2e-5)]
            del ref
            line = (f"cross_accel ({nA},{nB}){'':<{13 - len(str(nA)) - len(str(nB))}}"
                    f"{int(with_phi):<5}{errs[0][0]:<11.3e}{errs[1][0]:<11.3e}"
                    f"{max(e[1] for e in errs):<9.2e}"
                    f"{max(e[2] for e in errs):<11.2e}")
            if nA == nB:
                key = "cross_phi" if with_phi else "cross"
                ms = _median_ms(lambda: cg.cross_kernel(pA, pB, mA, mB, eps,
                                                        **kw))
                pms = _once_ms(lambda: cg.cross_plain(pA, pB, mA, mB, eps,
                                                      with_phi=with_phi))
                bound = _bound(nA * nB, FLOPS_PER_PAIR[key],
                               (32 if with_phi else 28) * (nA + nB))
                main[key] = dict(max_abs_err=max(e[0] for e in errs), ms=ms,
                                 plain_ms=pms, shape=[nA, nB], bound=bound,
                                 smem=48 / geo[0])
                line += (f"{ms:<10.4f}{pms:<10.1f}{bound[0]:.4f} "
                         f"({bound[0] / ms:.1%})")
            print(line + f"   ({geo[0]},{geo[1]}, {48 / geo[0]:g})   "
                  "bitwise-repeatable", flush=True)
            torch.cuda.empty_cache()
    del pos, mass
    print("kernel      shape            max|da| A  max|da| B  rel_a    "
          "rel_j    ms        plain_ms  bound_ms  (R,S, shared B/pair)")
    pos, mass, vel = _moving_cluster(sum(K13_PAIRS[0]), 42, device)
    for nA, nB in K13_PAIRS:
        args = tuple(t[a:b].contiguous() for t, (a, b) in zip(
            (pos, vel, pos, vel, mass, mass),
            ((0, nA), (0, nA), (nA, nA + nB), (nA, nA + nB), (0, nA),
             (nA, nA + nB))))
        out = cg.cross_jerk_kernel(*args, eps, guarded=False)
        if not _same_bits(out, cg.cross_jerk_kernel(*args, eps,
                                                    guarded=False)):
            raise AssertionError(f"cross_jerk ({nA},{nB}): two launches "
                                 "differ bitwise")
        ref = cg.cross_jerk_plain(*args, eps, dtype=f64, chunk=256)
        ea = _compare_jerk(out[:2], ref[:2], 2e-5, 2e-5)
        eb = _compare_jerk(out[2:], ref[2:], 2e-5, 2e-5)
        del ref
        geo = cg.cross_geometry(nA, nB, "cross_jerk")
        line = (f"cross_jerk  ({nA},{nB}){'':<{13 - len(str(nA)) - len(str(nB))}}"
                f"{ea[0]:<11.3e}{eb[0]:<11.3e}{max(ea[1], eb[1]):<9.2e}"
                f"{max(ea[2], eb[2]):<9.2e}")
        ms = _median_ms(lambda: cg.cross_jerk_kernel(*args, eps,
                                                     guarded=False))
        bound = _bound(nA * nB, FLOPS_PER_PAIR["cross_jerk"], 52 * (nA + nB))
        if nA == nB:
            pms = _once_ms(lambda: cg.cross_jerk_plain(*args, eps))
            main["cross_jerk"] = dict(max_abs_err=max(ea[0], eb[0]), ms=ms,
                                      plain_ms=pms, shape=[nA, nB],
                                      bound=bound, smem=80 / geo[0])
            line += (f"{ms:<10.4f}{pms:<10.1f}{bound[0]:.4f} "
                     f"({bound[0] / ms:.1%}; first design "
                     f"{FIRST_DESIGN_MS['cross_jerk']} ms)")
        else:
            line += f"{ms:<10.4f}{'-':<10}{bound[0]:.4f} ({bound[0] / ms:.1%})"
        print(line + f"   ({geo[0]},{geo[1]}, {80 / geo[0]:g})   "
              "bitwise-repeatable", flush=True)
        torch.cuda.empty_cache()
    # K3 on the diagonal chunk of the same route (CHUNK_SYMJ), timed once
    p, v, m = (t[:K3_CHUNK_N].contiguous() for t in (pos, vel, mass))
    ms = _median_ms(lambda: cg.sym_jerk_kernel(p, v, m, eps, guarded=False))
    bound = _bound(K3_CHUNK_N * (K3_CHUNK_N - 1) // 2,
                   FLOPS_PER_PAIR["sym_jerk"], 52 * K3_CHUNK_N)
    print(f"sym_jerk    ({K3_CHUNK_N}) at CHUNK_SYMJ: {ms:.4f} ms, bound "
          f"{bound[0]:.4f} ({bound[0] / ms:.1%})", flush=True)
    del p, v, m, pos, mass, vel
    torch.cuda.empty_cache()
    # K14 against c6's 1M sources
    print("kernel           shape            eps        max|da|    rel_a    "
          "rel_j    ms        plain_ms  bound_ms")
    src, mass, svel = _moving_cluster(BIG_N, 43, device)
    for nr in K14_ROWS:
        for e in (0.0, eps):
            k14_case(cg, src, svel, mass, nr, e, plain=e > 0)
    check_row_independence(cg, src, svel, mass, cg.rows_jerk_stream_kernel,
                           "rows_jerk_stream", rows_of=131072)
    del src, mass, svel
    torch.cuda.empty_cache()

    # the chunked evaluation at 1M against the f64 oracle on sampled rows
    state = plummer(BIG_N, torch.Generator().manual_seed(44), device=device)
    pos, mass, vel = state.pos, state.mass, state.vel
    pos_c, mass_c, vel_c = gravity.prepare_f32(pos, mass, vel=vel)
    rows = torch.randperm(BIG_N, generator=torch.Generator().manual_seed(45))[
        :BIG_SAMPLE].to(device)
    acc, phi = cg.accel_potential_sym_chunked(pos, mass, eps, guarded=False)
    ref_a, ref_phi = cg.rows_plain(pos_c[rows], pos_c, mass_c, eps,
                                   with_phi=True, dtype=f64, chunk=256)
    ref_phi = ref_phi + gravity.self_phi(mass_c[rows].to(f64), eps, 1.0)
    err_p = _compare((acc[rows], phi[rows]), (ref_a, ref_phi), True, 2e-5)
    a1 = cg.accel_sym_chunked(pos, mass, eps, guarded=False)
    if not torch.equal(a1, cg.accel_sym_chunked(pos, mass, eps,
                                                guarded=False)):
        raise AssertionError("the chunked accel at 1M: two evaluations "
                             "differ bitwise")
    err_a = _compare(a1[rows], ref_a, False, 2e-5)
    aj, jk = cg.accel_jerk_sym_chunked(pos, vel, mass, eps, guarded=False)
    if not _same_bits((aj, jk), cg.accel_jerk_sym_chunked(pos, vel, mass, eps,
                                                          guarded=False)):
        raise AssertionError("the chunked accel + jerk at 1M: two "
                             "evaluations differ bitwise")
    ref_j = cg.rows_jerk_plain(pos_c[rows], vel_c[rows], pos_c, vel_c,
                               mass_c, eps, dtype=f64, chunk=256)
    err_j = _compare_jerk((aj[rows], jk[rows]), ref_j, 2e-5, 2e-5)
    k1 = cg.rows_kernel(pos_c, pos_c, mass_c, eps, guarded=False)
    err_k1 = _compare(k1[rows], ref_a, False, 2e-5)
    del acc, phi, a1, aj, jk, k1, ref_a, ref_phi, ref_j
    torch.cuda.empty_cache()
    t = {"accel": _median_ms(lambda: cg.accel_sym_chunked(
             pos, mass, eps, guarded=False), reps=2),
         "accel+phi": _median_ms(lambda: cg.accel_potential_sym_chunked(
             pos, mass, eps, guarded=False), reps=1),
         "accel+jerk": _median_ms(lambda: cg.accel_jerk_sym_chunked(
             pos, vel, mass, eps, guarded=False), reps=1),
         "K1": _median_ms(lambda: cg.rows_kernel(pos_c, pos_c, mass_c, eps,
                                                 guarded=False), reps=2)}
    print(f"chunked self-interaction at N={BIG_N} (eps 1/256) against the f64 "
          f"oracle on {BIG_SAMPLE} sampled rows: accel {err_a[1]:.3e} of "
          f"max|a| (K2 + K12 with phi: {err_p[1]:.3e}, phi rel "
          f"{err_p[2]:.3e}), accel + jerk {err_j[1]:.3e} / {err_j[2]:.3e} of "
          f"max|a| / max|j| (K3 + K13); K1 one-sided {err_k1[1]:.3e}; "
          "each chunked form bitwise repeatable", flush=True)
    del state, pos, mass, vel, pos_c, mass_c, vel_c
    torch.cuda.empty_cache()
    state = plummer(BIG_N2, torch.Generator().manual_seed(46), device=device)
    t["accel 2M"] = _median_ms(lambda: cg.accel_sym_chunked(
        state.pos, state.mass, 0.003, guarded=False), reps=1)
    del state
    torch.cuda.empty_cache()
    for name, ms in t.items():
        n = BIG_N2 if name.endswith("2M") else BIG_N
        print(f"  {name:<11} at N={n}: {ms:.2f} ms, "
              f"{n * n / (ms * 1e-3):.4e} N^2-equivalent interactions/s",
              flush=True)


def k14_case(cg, src, svel, mass, nr, eps, plain=True):
    """K14 on nr rows (the first nr sources, shifted) against the f64 twin
    and launched twice (bitwise); timed (CUDA-graph replays below 4,096
    rows, where the kernel is shorter than its wrapper) beside its f32 twin
    (once, unless ``plain`` is False); prints one line and returns
    dict(max_abs_err, ms, plain_ms, shape, bound)."""
    import torch
    ns = src.shape[0]
    rows = (src[:nr] + 1e-3).contiguous()
    vrows = (svel[:nr] - 1e-3).contiguous()
    guarded = eps == 0.0
    args = (rows, vrows, src, svel, mass, eps)
    out = cg.rows_jerk_stream_kernel(*args, guarded=guarded)
    if not _same_bits(out, cg.rows_jerk_stream_kernel(*args,
                                                      guarded=guarded)):
        raise AssertionError(f"rows_jerk_stream ({nr},{ns}) eps={eps}: two "
                             "launches differ bitwise")
    ref = cg.rows_jerk_stream_plain(*args, dtype=torch.float64, chunk=256)
    err, rel_a, rel_j = _compare_jerk(out, ref, 2e-5, 2e-5)
    del ref, out
    timer = _graph_ms if nr < 4096 else _median_ms
    ms = timer(lambda: cg.rows_jerk_stream_kernel(*args, guarded=guarded))
    pms = (_once_ms(lambda: cg.rows_jerk_stream_plain(*args, chunk=256))
           if plain else float("nan"))
    bound = _bound(nr * ns, FLOPS_PER_PAIR["rows_jerk_stream"],
                   28 * ns + 48 * nr)
    print(f"rows_jerk_stream ({nr},{ns}){'':<{13 - len(str(nr)) - len(str(ns))}}"
          f"{eps:<11.6g}{err:<11.3e}{rel_a:<9.2e}{rel_j:<9.2e}"
          f"{ms:<10.4f}{pms:<10.1f}{bound[0]:.5f}", flush=True)
    torch.cuda.empty_cache()
    return dict(max_abs_err=err, ms=ms, plain_ms=pms, shape=[nr, ns],
                bound=bound)


def check_kernels_big_x(cg, device, main):
    """Phase 3, the extended tier past STREAM_N: K15 (with and without the
    raw potential) and K16 at a full chunk pair and a ragged one, K17 on
    K17_ROWS rows against 1M sources and on all K17_CAP_N rows of a set of
    that size (the row cap), each against the f64 evaluation of the same
    (hi, lo) planes (2e-5 of max, phi rtol 3e-5), launched twice and
    bitwise equal, K17 row-set independent; then the close-pair case at N
    = 1M with every pair across two chunks, and the chunked extended
    evaluation at 1M against the f64 oracle. Adds K15's and K16's entries
    to ``main`` (K17's comes at c4x_1m's mean active rows, after the
    paths)."""
    import torch
    f64 = torch.float64
    eps = 1.0 / 256
    print("kernel        shape            phi  max|da| A  max|da| B  rel      "
          "phi_rel    ms        plain_ms  bound_ms  (R,S, shared B/pair)")
    hi, lo, gm, _, _ = _planes(sum(K15_PAIRS[0]), 47, device)
    for nA, nB in K15_PAIRS:
        geo = cg.cross_geometry(nA, nB, "cross_x")
        A = (hi[:nA].contiguous(), lo[:nA].contiguous())
        B = (hi[nA:nA + nB].contiguous(), lo[nA:nA + nB].contiguous())
        args = (*A, *B, gm[:nA].contiguous(), gm[nA:nA + nB].contiguous())
        # the f64 evaluation once, with the potential (its accelerations
        # are those of the form without)
        ref = cg.cross_x_plain(*args, eps, with_phi=True, dtype=f64)
        for with_phi in (False, True):
            kw = dict(with_phi=with_phi, guarded=False)
            out = cg.cross_x_kernel(*args, eps, **kw)
            if not _same_bits(out, cg.cross_x_kernel(*args, eps, **kw)):
                raise AssertionError(f"cross_accel_x ({nA},{nB}) phi="
                                     f"{with_phi}: two launches differ "
                                     "bitwise")
            h = len(out) // 2
            errs = [_compare(out[:h] if with_phi else out[0],
                             ref[:2] if with_phi else ref[0], with_phi, 2e-5),
                    _compare(out[h:] if with_phi else out[1],
                             ref[2:] if with_phi else ref[2], with_phi, 2e-5)]
            key = "cross_x_phi" if with_phi else "cross_x"
            ms = _median_ms(lambda: cg.cross_x_kernel(*args, eps, **kw))
            pms = _once_ms(lambda: cg.cross_x_plain(*args, eps,
                                                    with_phi=with_phi))
            bound = _bound(nA * nB, FLOPS_PER_PAIR[key],
                           (44 if with_phi else 40) * (nA + nB))
            first = ""
            if nA == nB:
                main[key] = dict(max_abs_err=max(e[0] for e in errs), ms=ms,
                                 plain_ms=pms, shape=[nA, nB], bound=bound,
                                 smem=64 / geo[0])
                first = f"; first design {FIRST_DESIGN_MS[key]} ms"
            print(f"cross_accel_x ({nA},{nB}){'':<{13 - len(str(nA)) - len(str(nB))}}"
                  f"{int(with_phi):<5}{errs[0][0]:<11.3e}{errs[1][0]:<11.3e}"
                  f"{max(e[1] for e in errs):<9.2e}"
                  f"{max(e[2] for e in errs):<11.2e}"
                  f"{ms:<10.4f}{pms:<10.1f}{bound[0]:.4f} "
                  f"({bound[0] / ms:.1%}{first})   ({geo[0]},{geo[1]}, "
                  f"{64 / geo[0]:g})   bitwise-repeatable", flush=True)
            del out
            torch.cuda.empty_cache()
        del ref
    del hi, lo, gm
    print("kernel        shape            max|da| A  max|da| B  rel_a    "
          "rel_j    ms        plain_ms  bound_ms  (R,S, shared B/pair)")
    hi, lo, gm, vhi, vlo = _planes(sum(K16_PAIRS[0]), 48, device)
    for nA, nB in K16_PAIRS:
        sets = [tuple(p[a:b].contiguous() for p in (hi, lo, vhi, vlo))
                for a, b in ((0, nA), (nA, nA + nB))]
        args = (*sets[0], *sets[1], gm[:nA].contiguous(),
                gm[nA:nA + nB].contiguous())
        out = cg.cross_jerk_x_kernel(*args, eps, guarded=False)
        if not _same_bits(out, cg.cross_jerk_x_kernel(*args, eps,
                                                      guarded=False)):
            raise AssertionError(f"cross_jerk_x ({nA},{nB}): two launches "
                                 "differ bitwise")
        ref = cg.cross_jerk_x_plain(*args, eps, dtype=f64)
        ea = _compare_jerk(out[:2], ref[:2], 2e-5, 2e-5)
        eb = _compare_jerk(out[2:], ref[2:], 2e-5, 2e-5)
        del ref, out
        geo = cg.cross_geometry(nA, nB, "cross_jerk_x")
        ms = _median_ms(lambda: cg.cross_jerk_x_kernel(*args, eps,
                                                       guarded=False))
        pms = _once_ms(lambda: cg.cross_jerk_x_plain(*args, eps))
        bound = _bound(nA * nB, FLOPS_PER_PAIR["cross_jerk_x"],
                       76 * (nA + nB))
        first = ""
        if nA == nB:
            main["cross_jerk_x"] = dict(max_abs_err=max(ea[0], eb[0]), ms=ms,
                                        plain_ms=pms, shape=[nA, nB],
                                        bound=bound, smem=112 / geo[0])
            first = f"; first design {FIRST_DESIGN_MS['cross_jerk_x']} ms"
        print(f"cross_jerk_x  ({nA},{nB}){'':<{13 - len(str(nA)) - len(str(nB))}}"
              f"{ea[0]:<11.3e}{eb[0]:<11.3e}{max(ea[1], eb[1]):<9.2e}"
              f"{max(ea[2], eb[2]):<9.2e}{ms:<10.4f}{pms:<10.1f}"
              f"{bound[0]:.4f} ({bound[0] / ms:.1%}{first})   ({geo[0]},"
              f"{geo[1]}, {112 / geo[0]:g})   bitwise-repeatable", flush=True)
        torch.cuda.empty_cache()
    # K7 on the diagonal chunk of the same route (CHUNK_SYMXJ), timed once
    planes = tuple(t[:K7_CHUNK_N].contiguous() for t in (hi, lo, vhi, vlo,
                                                         gm))
    ms = _median_ms(lambda: cg.sym_jerk_x_kernel(*planes, eps,
                                                 guarded=False))
    bound = _bound(K7_CHUNK_N * (K7_CHUNK_N - 1) // 2,
                   FLOPS_PER_PAIR["sym_jerk_x"], 76 * K7_CHUNK_N)
    print(f"sym_jerk_x    ({K7_CHUNK_N}) at CHUNK_SYMXJ: {ms:.4f} ms, bound "
          f"{bound[0]:.4f} ({bound[0] / ms:.1%})", flush=True)
    del planes, hi, lo, gm, vhi, vlo
    # K17 against c6's 1M sources, then the row cap
    print("kernel             shape            eps        max|da|    rel_a    "
          "rel_j    ms        plain_ms  bound_ms")
    src = _planes(BIG_N, 49, device)
    for nr in K17_ROWS:
        for e in (0.0, eps):
            k17_case(cg, src, nr, e, plain=e > 0)
    check_row_independence_x(cg, src, cg.rows_jerk_x_stream_kernel,
                             "rows_jerk_x_stream", rows_of=131072)
    del src
    torch.cuda.empty_cache()
    src = _planes(K17_CAP_N, 50, device)
    for e in (0.0, eps):
        k17_case(cg, src, K17_CAP_N, e, plain=e > 0, shift=False)
    del src
    torch.cuda.empty_cache()
    check_close_pairs_big(cg, device)
    check_chunked_big_x(cg, device)


def k17_case(cg, src, nr, eps, plain=True, shift=True):
    """K17 on nr rows (the first nr sources, shifted unless ``shift`` is
    False: then the all-active self-interaction) against the f64
    evaluation of the same planes on up to K17_CHECK_ROWS of them, and
    launched twice (bitwise); timed (CUDA-graph replays below 4,096 rows,
    where the kernel is shorter than its wrapper) beside its f32 twin
    (once, unless ``plain`` is False); prints one line and returns
    dict(max_abs_err, ms, plain_ms, shape, bound)."""
    import torch
    hi, lo, gm, vhi, vlo = src
    ns = hi.shape[0]
    if shift:
        rows = ((hi[:nr] + 1e-3).contiguous(), lo[:nr].contiguous(),
                (vhi[:nr] - 1e-3).contiguous(), vlo[:nr].contiguous())
    else:
        rows = tuple(p[:nr].contiguous() for p in (hi, lo, vhi, vlo))
    guarded = eps == 0.0
    args = (*rows, hi, lo, vhi, vlo, gm, eps)
    out = cg.rows_jerk_x_stream_kernel(*args, guarded=guarded)
    if not _same_bits(out, cg.rows_jerk_x_stream_kernel(*args,
                                                        guarded=guarded)):
        raise AssertionError(f"rows_jerk_x_stream ({nr},{ns}) eps={eps}: two "
                             "launches differ bitwise")
    pick = torch.randperm(nr, generator=torch.Generator().manual_seed(nr))[
        :K17_CHECK_ROWS].to(hi.device)
    ref = cg.rows_jerk_x_stream_plain(*(p[pick] for p in rows), hi, lo, vhi,
                                      vlo, gm, eps, dtype=torch.float64,
                                      chunk=64, guarded=guarded)
    err, rel_a, rel_j = _compare_jerk((out[0][pick], out[1][pick]), ref,
                                      2e-5, 2e-5)
    del ref, out
    timer = _graph_ms if nr < 4096 else _median_ms
    ms = timer(lambda: cg.rows_jerk_x_stream_kernel(*args, guarded=guarded))
    pms = (_once_ms(lambda: cg.rows_jerk_x_stream_plain(*args,
                                                        guarded=guarded))
           if plain else float("nan"))
    bound = _bound(nr * ns, FLOPS_PER_PAIR["rows_jerk_x_stream"],
                   52 * ns + 72 * nr)
    checked = "" if nr <= K17_CHECK_ROWS else f"  ({K17_CHECK_ROWS} rows checked)"
    print(f"rows_jerk_x_stream ({nr},{ns}){'':<{13 - len(str(nr)) - len(str(ns))}}"
          f"{eps:<11.6g}{err:<11.3e}{rel_a:<9.2e}{rel_j:<9.2e}"
          f"{ms:<10.4f}{pms:<10.1f}{bound[0]:.5f}{checked}", flush=True)
    torch.cuda.empty_cache()
    return dict(max_abs_err=err, ms=ms, plain_ms=pms, shape=[nr, ns],
                bound=bound)


def _big_close_pairs(device):
    """A Plummer sphere of BIG_N stars in which star BIG_CLOSE_OFFSET + k
    sits 1e-5 of the scale from star k, k < BIG_CLOSE_PAIRS: each pair
    straddles chunk 0 and a later chunk of every chunked route (98,304,
    73,728 and 131,072 stars a chunk). Returns (pos, vel, mass, the pairs'
    stars)."""
    import torch
    from oc_nbody_tpu_torch.models.plummer import plummer
    state = plummer(BIG_N, torch.Generator().manual_seed(51), device=device)
    pos = state.pos.clone()
    gen = torch.Generator().manual_seed(52)
    k = BIG_CLOSE_PAIRS
    kick = 1e-5 * torch.randn((k, 3), generator=gen, dtype=torch.float64)
    pos[BIG_CLOSE_OFFSET:BIG_CLOSE_OFFSET + k] = pos[:k] + kick.to(device)
    stars = torch.cat([torch.arange(k),
                       torch.arange(BIG_CLOSE_OFFSET,
                                    BIG_CLOSE_OFFSET + k)]).to(device)
    return pos, state.vel, state.mass, stars


def check_close_pairs_big(cg, device):
    """The close-pair case through the chunked routes at N = 1M: 50 pairs
    at 1e-5 of the scale, each across two chunks so that K15 and K16 carry
    it, eps = 1e-4, against the f64 oracle rows sum on the pairs' 100 stars
    and 3,996 others. The extended chunked accel and accel + jerk must stay
    inside 2e-5 of max|a| and 5e-5 of max|j|, the f32 chunked accel must
    err past 1e-3 (a K15 that ignored lo would)."""
    import torch
    from oc_nbody_tpu_torch.ops import gravity
    eps = 1e-4
    pos, vel, mass, stars = _big_close_pairs(device)
    others = torch.randperm(BIG_N, generator=torch.Generator().manual_seed(53))
    others = others[(others >= BIG_CLOSE_PAIRS)
                    & ((others < BIG_CLOSE_OFFSET)
                       | (others >= BIG_CLOSE_OFFSET + BIG_CLOSE_PAIRS))]
    rows = torch.cat([stars, others[:BIG_SAMPLE - len(stars)].to(device)])
    c, vc = pos.mean(dim=0), vel.mean(dim=0)
    a_ref, j_ref = gravity.accel_jerk_rows(pos[rows] - c, vel[rows] - vc,
                                           pos - c, vel - vc, mass, eps,
                                           chunk=128)

    def rel(got, want):
        return float(torch.linalg.norm(got[rows].double() - want, dim=1).max()
                     / torch.linalg.norm(want, dim=1).max())

    launches = dict(cg.LAUNCHES)
    a32 = rel(cg.accel(pos, mass, eps, guarded=False), a_ref)
    ax = rel(cg.accel_x(pos, mass, eps, guarded=False), a_ref)
    axj, jx = cg.accel_jerk_x(pos, vel, mass, eps, guarded=False)
    axj, jx = rel(axj, a_ref), rel(jx, j_ref)
    torch.cuda.synchronize()
    ran = {k: cg.LAUNCHES[k] - launches[k] for k in ("cross", "cross_x",
                                                      "cross_jerk_x")}
    print(f"close pairs at N={BIG_N} ({BIG_CLOSE_PAIRS} pairs at 1e-5, each "
          f"across two chunks, eps=1e-4), max row error over max row size "
          f"on {BIG_SAMPLE} rows against the f64 oracle: f32 chunked accel "
          f"{a32:.3e}; extended chunked accel {ax:.3e} (K6 + K15), accel + "
          f"jerk {axj:.3e} / {jx:.3e} (K7 + K16); cross launches {ran}",
          flush=True)
    if not a32 > 1e-3:
        raise AssertionError(f"close pairs at 1M: the f32 chunked route is "
                             f"inside 1e-3 ({a32:.3e}); the case does not "
                             "tell the tiers apart")
    if not (ax < 2e-5 and axj < 2e-5 and jx < 5e-5):
        raise AssertionError(f"close pairs at 1M: the extended chunked route "
                             f"errs past its bounds: accel {ax:.3e}, "
                             f"{axj:.3e}, jerk {jx:.3e}")
    if not all(ran.values()):
        raise AssertionError(f"close pairs at 1M: a cross kernel did not "
                             f"launch: {ran}")
    del pos, vel, mass, a_ref, j_ref
    torch.cuda.empty_cache()


def check_chunked_big_x(cg, device):
    """The chunked extended evaluation at N = 1M (accel, accel + raw phi,
    accel + jerk) against the f64 oracle rows sum on BIG_SAMPLE sampled
    rows against all sources (2e-5 of max, phi rtol 3e-5 once self_phi is
    added), each bitwise repeatable, timed beside the f32 chunked route on
    the same state."""
    import torch
    from oc_nbody_tpu_torch.models.plummer import plummer
    from oc_nbody_tpu_torch.ops import gravity
    f64 = torch.float64
    eps = 1.0 / 256
    state = plummer(BIG_N, torch.Generator().manual_seed(44), device=device)
    pos, mass, vel = state.pos, state.mass, state.vel
    rows = torch.randperm(BIG_N, generator=torch.Generator().manual_seed(45))[
        :BIG_SAMPLE].to(device)
    c, vc = pos.mean(dim=0), vel.mean(dim=0)
    ref_a, ref_phi = cg.rows_plain(pos[rows] - c, pos - c, mass, eps,
                                   with_phi=True, dtype=f64, chunk=256)
    ref_phi = ref_phi + gravity.self_phi(mass[rows].to(f64), eps, 1.0)
    ref_j = cg.rows_jerk_plain(pos[rows] - c, vel[rows] - vc, pos - c,
                               vel - vc, mass, eps, dtype=f64, chunk=256)
    acc, phi = cg.accel_potential_x(pos, mass, eps, guarded=False)
    phi = phi + gravity.self_phi(mass.to(f64), eps, 1.0)
    err_p = _compare((acc[rows], phi[rows]), (ref_a, ref_phi), True, 2e-5)
    a1 = cg.accel_x(pos, mass, eps, guarded=False)
    if not torch.equal(a1, cg.accel_x(pos, mass, eps, guarded=False)):
        raise AssertionError("the chunked extended accel at 1M: two "
                             "evaluations differ bitwise")
    err_a = _compare(a1[rows], ref_a, False, 2e-5)
    aj, jk = cg.accel_jerk_x(pos, vel, mass, eps, guarded=False)
    if not _same_bits((aj, jk), cg.accel_jerk_x(pos, vel, mass, eps,
                                                guarded=False)):
        raise AssertionError("the chunked extended accel + jerk at 1M: two "
                             "evaluations differ bitwise")
    err_j = _compare_jerk((aj[rows], jk[rows]), ref_j, 2e-5, 2e-5)
    del acc, phi, a1, aj, jk, ref_a, ref_phi, ref_j
    torch.cuda.empty_cache()
    t = {"accel": _median_ms(lambda: cg.accel_x(pos, mass, eps,
                                                guarded=False), reps=2),
         "accel+phi": _median_ms(lambda: cg.accel_potential_x(
             pos, mass, eps, guarded=False), reps=1),
         "accel+jerk": _median_ms(lambda: cg.accel_jerk_x(
             pos, vel, mass, eps, guarded=False), reps=1),
         "f32 accel": _median_ms(lambda: cg.accel(pos, mass, eps,
                                                  guarded=False), reps=1),
         "f32 accel+jerk": _median_ms(lambda: cg.accel_jerk(
             pos, vel, mass, eps, guarded=False), reps=1)}
    print(f"chunked extended self-interaction at N={BIG_N} (eps 1/256) "
          f"against the f64 oracle on {BIG_SAMPLE} sampled rows: accel "
          f"{err_a[1]:.3e} of max|a| (K6 + K15 with phi: {err_p[1]:.3e}, phi "
          f"rel {err_p[2]:.3e}), accel + jerk {err_j[1]:.3e} / {err_j[2]:.3e} "
          "of max|a| / max|j| (K7 + K16); each chunked form bitwise "
          "repeatable", flush=True)
    for name, ms in t.items():
        print(f"  {name:<14} at N={BIG_N}: {ms:.2f} ms, "
              f"{BIG_N * BIG_N / (ms * 1e-3):.4e} N^2-equivalent "
              "interactions/s", flush=True)
    del state, pos, mass, vel
    torch.cuda.empty_cache()


def check_jerk_geometries(cg, device):
    """K13 and K16 in every compiled tile geometry (R rows a thread, S
    column parts; csrc/jerk_rows.cuh) on ragged sets (JERK_GEOMETRY_SETS),
    eps = 0 and 1/64, against their f64 twins (5e-6 of max|a|, 1e-5 of
    max|j|), both sets' outputs; a second launch on a NaN-filled scratch
    must give the same bits (every slot the reduces read was written)."""
    import torch
    f64 = torch.float64
    t = time.perf_counter()
    worst = {}
    for key in ("cross_jerk", "cross_jerk_x"):
        for nA, nB in JERK_GEOMETRY_SETS:
            if key == "cross_jerk":
                pos, mass, vel = _moving_cluster(nA + nB, nA + 61, device)
                args = tuple(x[a:b].contiguous() for x, (a, b) in zip(
                    (pos, vel, pos, vel, mass, mass),
                    ((0, nA), (0, nA), (nA, nA + nB), (nA, nA + nB),
                     (0, nA), (nA, nA + nB))))
                kernel, twin = cg.cross_jerk_kernel, cg.cross_jerk_plain
            else:
                hi, lo, gm, vhi, vlo = _planes(nA + nB, nA + 62, device)
                sets = [tuple(x[a:b].contiguous() for x in (hi, lo, vhi, vlo))
                        for a, b in ((0, nA), (nA, nA + nB))]
                args = (*sets[0], *sets[1], gm[:nA].contiguous(),
                        gm[nA:].contiguous())
                kernel, twin = cg.cross_jerk_x_kernel, cg.cross_jerk_x_plain
            for eps in (0.0, 1.0 / 64):
                guarded = eps == 0.0
                tw = {} if key == "cross_jerk" else dict(guarded=guarded)
                ref = twin(*args, eps, dtype=f64, **tw)
                for g in cg.GEOMETRIES:
                    out = kernel(*args, eps, guarded=guarded, geometry=g)
                    nan = torch.full((cg.cross_scratch_floats(nA, nB, key,
                                                              g),),
                                     float("nan"), device=device)
                    if not _same_bits(out, kernel(*args, eps,
                                                  guarded=guarded,
                                                  scratch=nan, geometry=g)):
                        raise AssertionError(f"{key} ({nA},{nB}) geometry "
                                             f"{g}: a launch on NaN scratch "
                                             "differs bitwise")
                    ea = _compare_jerk(out[:2], ref[:2], 5e-6, 1e-5)
                    eb = _compare_jerk(out[2:], ref[2:], 5e-6, 1e-5)
                    worst[key] = max(worst.get(key, 0.0), ea[1], eb[1],
                                     ea[2], eb[2])
    print(f"jerk geometries: K13 and K16 in each of the {len(cg.GEOMETRIES)}"
          f" compiled (R, S) on {JERK_GEOMETRY_SETS}, eps 0 and 1/64, within "
          "5e-6 / 1e-5 of their "
          "f64 twins (worst relative error "
          + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
          + f"), bitwise on NaN-filled scratch; {time.perf_counter() - t:.1f}"
          " s", flush=True)
    torch.cuda.empty_cache()


def check_guard(cg, cdf, cr, device):
    """The zero guard at eps = 0 (ROADMAP C6): 64 stars, the last two 1e-20
    apart on each axis (u = 3e-40, below the least normal f32), through
    every guarded kernel K1-K21 and its f32 plain twin on the card. The pair
    must add nothing, as in the JAX package (whose f32 arithmetic flushes
    that u to 0): every output finite, the kernel's within 5e-6 of max|a|
    and 1e-5 of max|j| (K10, K11: 1e-9, 1e-8; phi rtol 3e-5) of its
    twin's."""
    import numpy as np
    import torch
    rng = np.random.default_rng(61)
    pos = rng.normal(size=(64, 3))
    pos[-2], pos[-1] = 0.0, 1e-20
    pos, vel, mass = (torch.from_numpy(a).to(device=device,
                                             dtype=torch.float32)
                      for a in (pos, rng.normal(size=(64, 3)) * 0.5,
                                rng.uniform(0.5, 1.5, 64) / 64))
    z, gz, e = torch.zeros_like(pos), torch.zeros_like(mass), 0.0
    A, B = (pos[:40].contiguous(), vel[:40].contiguous()), \
        (pos[40:].contiguous(), vel[40:].contiguous())
    mA, mB = mass[:40].contiguous(), mass[40:].contiguous()
    zA, zB = torch.zeros_like(A[0]), torch.zeros_like(B[0])
    pv, phi = (pos, z, vel, z), dict(with_phi=True)
    cases = {
        "K1": (cg.rows_kernel(pos, pos, mass, e, **phi),
               cg.rows_plain(pos, pos, mass, e, **phi)),
        "K2": (cg.sym_kernel(pos, mass, e, **phi),
               cg.sym_plain(pos, mass, e, **phi)),
        "K3": (cg.sym_jerk_kernel(pos, vel, mass, e),
               cg.sym_jerk_plain(pos, vel, mass, e)),
        "K4": (cg.rows_jerk_kernel(pos, vel, pos, vel, mass, e),
               cg.rows_jerk_plain(pos, vel, pos, vel, mass, e)),
        "K5": (cg.rows_jerk_t_kernel(pos, vel, pos, vel, mass, e),
               cg.rows_jerk_t_plain(pos, vel, pos, vel, mass, e)),
        "K6": (cg.sym_x_kernel(pos, z, mass, e, **phi),
               cg.sym_x_plain(pos, z, mass, e, **phi)),
        "K7": (cg.sym_jerk_x_kernel(*pv, mass, e),
               cg.sym_jerk_x_plain(*pv, mass, e)),
        "K8": (cg.rows_x_kernel(pos, z, pos, z, mass, e, **phi),
               cg.rows_x_plain(pos, z, pos, z, mass, e, **phi)),
        "K9": (cg.rows_jerk_x_kernel(*pv, *pv, mass, e),
               cg.rows_jerk_x_plain(*pv, *pv, mass, e)),
        "K10": (cdf.rows_df_kernel(pos, z, pos, z, mass, gz, e, e),
                cdf.rows_df_plain(pos, z, pos, z, mass, gz, e, e)),
        "K11": (cdf.rows_jerk_df_kernel(*pv, *pv, mass, gz, e, e),
                cdf.rows_jerk_df_plain(*pv, *pv, mass, gz, e, e)),
        "K12": (cg.cross_kernel(A[0], B[0], mA, mB, e, **phi),
                cg.cross_plain(A[0], B[0], mA, mB, e, **phi)),
        "K13": (cg.cross_jerk_kernel(*A, *B, mA, mB, e),
                cg.cross_jerk_plain(*A, *B, mA, mB, e)),
        "K14": (cg.rows_jerk_stream_kernel(pos, vel, pos, vel, mass, e),
                cg.rows_jerk_stream_plain(pos, vel, pos, vel, mass, e)),
        "K15": (cg.cross_x_kernel(A[0], zA, B[0], zB, mA, mB, e, **phi),
                cg.cross_x_plain(A[0], zA, B[0], zB, mA, mB, e, **phi)),
        "K16": (cg.cross_jerk_x_kernel(A[0], zA, A[1], zA, B[0], zB, B[1],
                                       zB, mA, mB, e),
                cg.cross_jerk_x_plain(A[0], zA, A[1], zA, B[0], zB, B[1],
                                      zB, mA, mB, e)),
        "K17": (cg.rows_jerk_x_stream_kernel(*pv, *pv, mass, e),
                cg.rows_jerk_x_stream_plain(*pv, *pv, mass, e)),
        "K18": (cg.rows_t_kernel(pos, pos, mass, e, **phi),
                cg.rows_plain(pos, pos, mass, e, **phi)),
        "K18<comp>": (cg.rows_stream_kernel(pos, pos, mass, e, **phi),
                      cg.rows_plain(pos, pos, mass, e, **phi)),
        "K19": (cg.rows_x_stream_kernel(pos, z, pos, z, mass, e, **phi),
                cg.rows_x_stream_plain(pos, z, pos, z, mass, e, **phi)),
    }

    # K20 (K20<phi>) and K21 at a first ring step: (sums, compensations)
    f32 = dict(dtype=torch.float32)
    vec, sca = (lambda: torch.zeros((64, 3), device=device),
                lambda: torch.zeros((64,), device=device))
    for label, phi_on in (("K20", False), ("K20<phi>", True)):
        outs = []
        for fn, kw in ((cr.ring_step_kernel, {}), (cr.ring_step_plain, f32)):
            acc, acc_c = vec(), vec()
            ph = (sca(), sca()) if phi_on else ()
            fn(pos, pos, mass, e, acc, acc_c, *ph, first=True, **kw)
            outs.append((acc, ph[0]) if phi_on else (acc,))
        cases[label] = tuple(outs)
    outs = []
    for fn, kw in ((cr.ring_step_jerk_kernel, {}),
                   (cr.ring_step_jerk_plain, f32)):
        sums = [vec() for _ in range(4)]  # acc, jerk and their compensations
        fn(pos, vel, pos, vel, mass, e, *sums, first=True, **kw)
        outs.append(tuple(sums[:2]))
    cases["K21"] = tuple(outs)
    torch.cuda.synchronize()
    jerk_kernels = ("K3", "K4", "K5", "K7", "K9", "K11", "K13", "K14",
                    "K16", "K17", "K21")
    for label, (got, want) in cases.items():
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for k, (g, w) in enumerate(zip(got, want)):
            g, w = g.double(), w.double()
            if not (bool(torch.isfinite(w).all())
                    and bool(torch.isfinite(g).all())):
                raise AssertionError(f"guard: {label} output {k}: the pair "
                                     "1e-20 apart gave a non-finite entry")
            if w.dim() == 1:
                rel = float(((g - w).abs() / w.abs()).max())
                ok = rel <= 3e-5
            else:
                tol = ((1e-9, 1e-8) if label in ("K10", "K11")
                       else (5e-6, 1e-5))[label in jerk_kernels and k % 2]
                rel = float((g - w).abs().max() / w.abs().max())
                ok = rel <= tol
            if not ok:
                raise AssertionError(f"guard: {label} output {k} differs "
                                     f"from its twin: {rel:.3e}")
    print(f"guard (eps = 0, a pair 1e-20 apart): {len(cases)} kernels "
          "(K1-K21, K18<comp>) give the pair nothing, as their f32 twins "
          "and the JAX package do; every output finite and within its "
          "tolerance of the twin", flush=True)


def run_big_paths(cg, device):
    """Phase 4, past STREAM_N: c6 and c7 as committed but cut to four KDK
    steps, c3 at N = 1M (Hermite, chunked K3 + K13 every step) and c4 at N
    = 1M (block steps: chunked K3 + K13 at init, K14 once per micro-step)
    to t = one dt_max; the same three at the extended tier (c6x: chunked K6
    + K15; c3x_1m: chunked K7 + K16; c4x_1m: chunked K7 + K16 at init, K17
    once per micro-step), and c4x_131k (K9 on most micro-steps, K17 on
    those with every row active), through the CLI; returns ({name:
    RunResult}, {name: launches})."""
    runs, launches = _drive(cg, PATHS_BIG,
                            {k: over for k, (_, over, _) in PATHS_BIG.items()})
    for k, res in runs.items():
        per = {key: n / max(1, res.n_steps) for key, n in launches[k].items()
               if n and key in ("sym", "cross", "sym_jerk", "cross_jerk",
                                "rows_jerk_stream") + EXTENDED_KERNELS}
        print(f"{k}: launches per step, diagnostics rows included: "
              + ", ".join(f"{key} {v:.2f}" for key, v in per.items())
              + f"; set-up and run {res.wall_time_s:.1f} s, init "
              f"{res.phase_s['init']:.2f} s, diagnostics "
              f"{res.phase_s['diagnostics']:.2f} s over "
              f"{len(res.diagnostics['time'])} rows", flush=True)
    return runs, launches


def _load(name):
    from oc_nbody_tpu_torch.config import apply_overrides, load_config
    path, over, _ = {**PATHS, **PATHS_DF, **PATHS_BIG, **PATHS_PRUNE,
                     **PATHS_MESH}[name]
    return apply_overrides(load_config(os.path.join(ROOT, path)), over)


def _estimate_s(cfg, device):
    """Seconds one full run of cfg should take: 50 timed steps and one
    timed diagnostics row, scaled to the run's step and row counts (for
    Hermite, the JAX package's c3 step rate)."""
    import torch
    from oc_nbody_tpu_torch import diagnostics
    from oc_nbody_tpu_torch.scene import build_scene, make_stepper
    scene = build_scene(cfg, device)
    stepper, kind = make_stepper(cfg, scene.force)
    carry = stepper.advance(stepper.init(scene.state), 5)
    torch.cuda.synchronize()
    t = time.perf_counter()
    carry = stepper.advance(carry, 50)
    torch.cuda.synchronize()
    per_step = (time.perf_counter() - t) / 50
    t = time.perf_counter()
    diagnostics.compute_all(carry.state, scene.force, cfg.output.fractions,
                            f64_pairwise=cfg.output.diag_f64)
    torch.cuda.synchronize()
    per_row = time.perf_counter() - t
    dt_min = getattr(stepper, "dt_min", None)
    del scene, stepper, carry
    torch.cuda.empty_cache()
    out = cfg.output
    n_rows = math.ceil(out.t_end / out.diag_every) + 1
    if kind == "hermite":
        steps = out.t_end * HERMITE_STEPS_PER_TIME
    elif kind == "block":   # the upper bound: every dt_min slot active
        steps = out.t_end / dt_min
    else:
        steps = out.t_end / cfg.integrator.dt
    return steps * per_step + n_rows * per_row


def _drive(cg, paths, overrides):
    """The CLI on each of ``paths`` with ``overrides``, the launch counters
    set to 0 just before each and read just after; checks the launches and
    the results; returns ({name: RunResult}, {name: launches})."""
    import oc_nbody_tpu_torch.run as run_mod
    from oc_nbody_tpu_torch.__main__ import main as cli_main

    # record the RunResult that the CLI's run() returns
    results = []
    real_run = run_mod.run

    def recording_run(*args, **kw):
        res = real_run(*args, **kw)
        results.append(res)
        return res

    run_mod.run = recording_run
    runs, launches = {}, {}
    try:
        for k, (path, _, want) in paths.items():
            print(f"--- main path: python -m oc_nbody_tpu_torch run {path} "
                  f"--device cuda "
                  f"{' '.join('--set ' + o for o in overrides[k])}",
                  flush=True)
            argv = ["run", os.path.join(ROOT, path), "--device", "cuda"]
            for o in overrides[k]:
                argv += ["--set", o]
            for key in cg.LAUNCHES:
                cg.LAUNCHES[key] = 0
            for key in cg.PLAIN_CALLS:
                cg.PLAIN_CALLS[key] = 0
            if cli_main(argv) != 0:
                raise AssertionError(f"{k}: the CLI returned non-zero")
            launches[k] = dict(cg.LAUNCHES)
            runs[k] = results[-1]
            print(f"{k}: kernel launches {launches[k]}, plain-twin calls "
                  f"{cg.PLAIN_CALLS}", flush=True)
            if launches[k][want] <= 0:
                raise AssertionError(f"{k}: the {want} kernel never launched")
            if any(cg.PLAIN_CALLS.values()):
                raise AssertionError(f"{k}: plain twins ran on the path: "
                                     f"{cg.PLAIN_CALLS}")
            integ = _load(k).integrator
            pruned = _load(k).escape.prune
            if pruned:
                _check_prune_launches(cg, k, results[-1], launches[k])
            elif integ.kind == "block":
                _check_block_launches(cg, k, results[-1], launches[k])
            if results[-1].state.n > cg.STREAM_N and not pruned:
                _check_big_launches(cg, k, results[-1], launches[k])
            if integ.precision == "extended":
                _check_extended_launches(cg, k, results[-1], launches[k])
            if integ.precision == "df32":
                _check_df_launches(k, results[-1], launches[k])
    finally:
        run_mod.run = real_run
    for k, res in runs.items():
        _check_run(k, res)
    return runs, launches


def _check_run(k, res):
    """A path's result: finite state, no NaN diagnostic, the drift inside
    its bound; prints its line."""
    import numpy as np
    n = res.state.n
    for name in ("pos", "vel"):
        t = getattr(res.state, name)
        if tuple(t.shape) != (n, 3) or not bool(t.isfinite().all()):
            raise AssertionError(f"{k}: final {name} not finite (n, 3)")
    nan_cols = [c for c, v in res.diagnostics.items() if np.isnan(v).any()]
    if nan_cols:
        raise AssertionError(f"{k}: NaN in diagnostics {nan_cols}")
    col, bound = DRIFT_BOUND[k]
    drift = float(np.abs(res.diagnostics[col]).max())
    advance_s = res.phase_s["advance"]
    print(f"{k}: N={n} steps={res.n_steps} t={res.state.time:.6g} "
          f"max|{col}|={drift:.3e} (bound {bound:g})  "
          f"{advance_s / res.n_steps * 1e3:.4f} ms/step  "
          f"run {res.wall_time_s:.1f} s", flush=True)
    if not drift <= bound:
        raise AssertionError(f"{k}: max|{col}| = {drift:.3e} > {bound:g}")
    cfg = _load(k)
    if cfg.integrator.kind == "block":
        _report_block(k, res, advance_s)
    if cfg.output.diag_f64:
        rows = len(res.diagnostics["time"])
        print(f"{k}: f64 diagnostics potential (K23): "
              f"{res.phase_s['diagnostics'] / rows:.3f} s per row over "
              f"{rows} rows (the whole row, N={n})", flush=True)


def run_df_paths(cg, device):
    """Phase 4, first part: the df32 paths and the binaries config at their
    fixed lengths; returns ({name: RunResult}, {name: launches})."""
    import numpy as np
    import torch
    from oc_nbody_tpu_torch import scene
    from oc_nbody_tpu_torch.models.binaries import orbital_elements
    runs, launches = _drive(cg, PATHS_DF,
                            {k: over for k, (_, over, _) in PATHS_DF.items()})
    # binaries_8k: the pairs that the IC made, still bound at the end?
    cfg = _load("binaries_8k")
    us = scene.build_units(cfg)
    pop = scene.build_binaries(cfg, us, scene.build_singles(cfg, us))
    p1 = pop.primary_idx.to(device=device, dtype=torch.int64)
    p2 = pop.secondary_idx.to(device=device, dtype=torch.int64)
    if runs["binaries_8k"].state.n != 10650 or len(p1) != 2458:
        raise AssertionError("binaries_8k: expected 10,650 stars in 2,458 "
                             f"pairs, got {runs['binaries_8k'].state.n} and "
                             f"{len(p1)}")
    n_levels = cfg.integrator.n_levels
    print("binaries_8k at the three tiers to t = "
          f"{runs['binaries_8k'].state.time:g} (10,650 stars, 2,458 pairs):")
    for k in ("binaries_8k_f32", "binaries_8k", "binaries_8k_df32"):
        res = runs[k]
        st = res.state
        gm = us.G * (st.mass[p1] + st.mass[p2]).to(torch.float64)
        a, e = orbital_elements(st.pos[p1] - st.pos[p2],
                                st.vel[p1] - st.vel[p2], gm)
        bound = float(((a > 0) & (e < 1)).to(torch.float64).mean())
        drift = float(np.abs(res.diagnostics["dE_over_E_int"]).max())
        rungs = [int(res.diagnostics[f"rung_{i:02d}"][-1])
                 for i in range(n_levels)]
        print(f"  {_load(k).integrator.precision:<9} max|dE/E_int| "
              f"{drift:.3e}  {res.n_steps} micro-steps  "
              f"{res.phase_s['advance'] / res.n_steps * 1e3:.4f} ms each  "
              f"{res.n_active_sum / res.n_steps:.1f} active rows each  "
              f"pairs still bound {bound:.2%}  rungs (dt_max/2^k, k = 0..) "
              f"{rungs}", flush=True)
        if bound < BOUND_PAIRS_MIN:
            raise AssertionError(f"{k}: only {bound:.2%} of the pairs are "
                                 "still bound")
    return runs, launches


def run_main_path(cg, device, budget_s):
    """Phase 4, second part: the CLI on the paths of ``PATHS``, their
    lengths cut to the budget; returns ({name: RunResult}, {name:
    launches})."""
    est = {k: _estimate_s(_load(k), device) for k in PATHS}
    print("estimated full-length run time: "
          + ", ".join(f"{k} {v:.1f} s" for k, v in est.items())
          + f" (budget {budget_s:.0f} s)")
    overrides = {k: list(over) for k, (_, over, _) in PATHS.items()}
    # the cut order: c4's length first (the later ones counted in full
    # while it is sized), then c1's and the north star's, c5x's last
    fixed = sum(v for k, v in est.items()
                if k not in CUTTABLE + ("c4", "c5x"))
    c4_out = _load("c4").output
    room = budget_s - fixed - sum(est[k] for k in CUTTABLE) - est["c5x"]
    if est["c4"] > room:
        g = _load("c4").integrator.dt_max
        cut = max(C4_MIN_T, g * math.floor(max(0.0, room) * c4_out.t_end
                                           / est["c4"] / g))
        overrides["c4"].append(f"output.t_end={cut!r}")
        print(f"CUT: c4 output.t_end {c4_out.t_end} -> {cut} to fit the "
              "time budget (N unchanged)")
        est["c4"] *= cut / c4_out.t_end
    fixed += est["c4"]
    scale = min(1.0, max(0.0, budget_s - fixed - est["c5x"])
                / sum(est[k] for k in CUTTABLE))
    if scale < 1.0:
        for k in CUTTABLE:
            out = _load(k).output
            cut = out.diag_every * max(1, math.floor(
                out.t_end * scale / out.diag_every))
            overrides[k].append(f"output.t_end={cut!r}")
            print(f"CUT: {k} output.t_end {out.t_end} -> {cut} to fit the "
                  "time budget (N unchanged)")
            est[k] *= cut / out.t_end
    fixed += sum(est[k] for k in CUTTABLE)
    if est["c5x"] > budget_s - fixed:
        out = _load("c5x").output
        cut = out.diag_every * max(1, math.floor(
            out.t_end * max(0.0, budget_s - fixed) / est["c5x"]
            / out.diag_every))
        overrides["c5x"].append(f"output.t_end={cut!r}")
        print(f"CUT: c5x output.t_end {out.t_end} -> {cut} to fit the time "
              "budget (N unchanged)")

    runs, launches = _drive(cg, PATHS, overrides)
    mb = runs["c2"].diagnostics["M_bound"]
    stripped = 1.0 - mb[-1] / mb[0]
    print(f"c2: bound mass {mb[0]:.6g} -> {mb[-1]:.6g}: {stripped:.2%} "
          f"stripped (of the total mass: "
          f"{1.0 - mb[-1] / float(runs['c2'].state.total_mass):.2%}; the "
          "JAX package's recorded run: 18.3%)", flush=True)
    if not STRIP_RANGE[0] <= stripped <= STRIP_RANGE[1]:
        raise AssertionError(f"c2: stripped {stripped:.2%} outside "
                             f"{STRIP_RANGE}: the tide is broken")
    if runs["c4"].state.time == _load("c4").output.t_end:
        mb = runs["c4"].diagnostics["M_bound"]
        stripped = 1.0 - mb[-1] / mb[0]
        print(f"c4: bound mass {mb[0]:.6g} -> {mb[-1]:.6g}: {stripped:.2%} "
              "stripped (the JAX package's run at dt_max = 1/64: 14.3%)",
              flush=True)
        if not C4_STRIP_RANGE[0] <= stripped <= C4_STRIP_RANGE[1]:
            raise AssertionError(f"c4: stripped {stripped:.2%} outside "
                                 f"{C4_STRIP_RANGE}: the tide is broken")
    else:
        print("c4: cut short of its full length, so no strip check")
    return runs, launches


def _check_extended_launches(cg, k, res, launches):
    """On a path of the extended tier no f32-tier or df32 kernel launches;
    up to STREAM_N, under KDK the self-interaction kernel launches once per
    step and once at init, plus once per diagnostics row unless the rows
    are f64 sums (``output.diag_f64``), and under Hermite at least once per
    step (past STREAM_N ``_check_big_launches`` counts them)."""
    stray = {key: n for key, n in launches.items()
             if n and key not in EXTENDED_KERNELS + TIERLESS_KERNELS}
    if stray:
        raise AssertionError(f"{k}: other tiers' kernels launched on an "
                             f"extended path: {stray}")
    cfg = _load(k)
    if res.state.n > cg.STREAM_N or cfg.escape.prune:
        return
    want = {**PATHS, **PATHS_DF, **PATHS_BIG}[k][2]
    if cfg.integrator.kind == "kdk":
        rows = 0 if cfg.output.diag_f64 else len(res.diagnostics["time"])
        if launches[want] != res.n_steps + 1 + rows:
            raise AssertionError(
                f"{k}: {want} launched {launches[want]} times, expected "
                f"{res.n_steps} steps + 1 (init) + {rows} rows")
    elif cfg.integrator.kind == "hermite":
        if launches[want] < res.n_steps + 1:
            raise AssertionError(f"{k}: {want} launched {launches[want]} "
                                 f"times in {res.n_steps} steps")


def _check_df_launches(k, res, launches):
    """On a path of the df32 tier only the two-float kernels launch (the
    potential and the block stepper's active rows are f64 sums outside any
    kernel): K10 once per KDK step and once at init, K11 at least once per
    Hermite step; the block path's count is ``_check_block_launches``'s."""
    stray = {key: n for key, n in launches.items()
             if n and not key.endswith("_df") and key not in TIERLESS_KERNELS}
    if stray:
        raise AssertionError(f"{k}: other tiers' kernels launched on a df32 "
                             f"path: {stray}")
    kind = _load(k).integrator.kind
    if kind == "kdk" and launches["rows_df"] != res.n_steps + 1:
        raise AssertionError(
            f"{k}: rows_df launched {launches['rows_df']} times, expected "
            f"{res.n_steps} steps + 1 (init)")
    if kind == "hermite" and launches["rows_jerk_df"] < res.n_steps + 1:
        raise AssertionError(f"{k}: rows_jerk_df launched "
                             f"{launches['rows_jerk_df']} times in "
                             f"{res.n_steps} steps")


def _check_block_launches(cg, k, res, launches):
    """Under block steps the active-row kernel launches once per micro-step
    (twice with pec2) and the self-interaction kernel once, at init; at the
    df32 tier the active rows are f64 sums and only K11 launches, at init.
    At the extended tier up to STREAM_N, K9 takes a micro-step of at most
    RT_MAX_ROWS active rows and K17 one of more: past RT_MAX_ROWS particles
    K17 launches at least at each multiple of dt_max (every row active
    there), below it never."""
    ic = _load(k).integrator
    want = {**PATHS, **PATHS_DF, **PATHS_BIG}[k][2]
    per = 2 if ic.pec2 else 1
    if ic.precision == "df32":
        expect = {"rows_jerk_df": 1, "rows_jerk": 0, "rows_jerk_t": 0,
                  "rows_jerk_x": 0}
        for key, n in expect.items():
            if launches[key] != n:
                raise AssertionError(f"{k}: {key} launched {launches[key]} "
                                     f"times, expected {n}")
        return
    n = res.state.n
    extended = ic.precision == "extended"
    init = _self_launches(cg, n, jerk=True, extended=extended)
    if extended and n <= cg.STREAM_N:
        stream = launches["rows_jerk_x_stream"]
        full = round(res.state.time / ic.dt_max)
        if (stream < full) if n > cg.RT_MAX_ROWS else stream:
            raise AssertionError(
                f"{k}: rows_jerk_x_stream launched {stream} times at N = "
                f"{n} over {full} multiples of dt_max")
        if launches["rows_jerk_x"] + stream != per * res.n_steps + \
                init.get("rows_jerk_x", 0):
            raise AssertionError(
                f"{k}: rows_jerk_x and rows_jerk_x_stream launched "
                f"{launches['rows_jerk_x']} + {stream} times in "
                f"{res.n_steps} micro-steps")
        init.pop("rows_jerk_x", None)
        expect = {}
    else:
        expect = {want: per * res.n_steps}
    for key, n in init.items():
        expect[key] = expect.get(key, 0) + n
    for key, n in expect.items():
        if launches[key] != n:
            raise AssertionError(f"{k}: {key} launched {launches[key]} times, "
                                 f"expected {n} ({res.n_steps} micro-steps)")


def _self_launches(cg, n, jerk=False, extended=False):
    """{kernel: launches} of one self-interaction evaluation at N = n, at
    the f32 or the ``extended`` tier: past STREAM_N one K2 (K3) per chunk
    and one K12 (K13) per chunk pair, at the extended tier K6 (K7) and K15
    (K16)."""
    if n > cg.STREAM_N:
        if extended:
            c = -(-n // (cg.CHUNK_SYMXJ if jerk else cg.CHUNK_SYMX))
            return ({"sym_jerk_x": c, "cross_jerk_x": c * (c - 1) // 2}
                    if jerk else {"sym_x": c, "cross_x": c * (c - 1) // 2})
        c = -(-n // (cg.CHUNK_SYMJ if jerk else cg.CHUNK_SYM))
        return ({"sym_jerk": c, "cross_jerk": c * (c - 1) // 2} if jerk
                else {"sym": c, "cross": c * (c - 1) // 2})
    if extended:
        if n >= cg.SYM_MIN:
            return {"sym_jerk_x" if jerk else "sym_x": 1}
        return {"rows_jerk_x" if jerk else "rows_x": 1}
    if jerk:
        return {"sym_jerk" if n >= cg.RT_MIN_JERK else "rows_jerk": 1}
    return {"sym" if n >= cg.SYM_MIN else "rows": 1}


def _check_big_launches(cg, k, res, launches):
    """Past STREAM_N: every evaluation is chunked. Under KDK the accel form
    runs once at init and once per step, the potential form once per
    diagnostics row, each with the same K2 and K12 counts (K6 and K15 at
    the extended tier); under Hermite the accel + jerk form at least once
    per step and at init. No K1, K4 or K5 launches, nor K8 or K9 at the
    extended tier (their routes end at STREAM_N)."""
    integ = _load(k).integrator
    kind, ext = integ.kind, integ.precision == "extended"
    rows = len(res.diagnostics["time"])
    n = res.state.n
    self_acc = _self_launches(cg, n, extended=ext)
    if kind == "kdk":
        expect = {key: v * (res.n_steps + 1 + rows)
                  for key, v in self_acc.items()}
    else:
        expect = {key: v * rows for key, v in self_acc.items()}
        if kind == "hermite":
            per = _self_launches(cg, n, jerk=True, extended=ext)
            for key, v in per.items():
                if launches[key] < v * (res.n_steps + 1):
                    raise AssertionError(
                        f"{k}: {key} launched {launches[key]} times in "
                        f"{res.n_steps} steps, expected at least "
                        f"{v * (res.n_steps + 1)}")
    stray = {key: launches[key] for key in ("rows", "rows_jerk",
                                            "rows_jerk_t", "rows_x",
                                            "rows_jerk_x")
             if launches[key]}
    if stray:
        raise AssertionError(f"{k}: resident-route kernels launched past "
                             f"STREAM_N: {stray}")
    for key, v in expect.items():
        if launches[key] != v:
            raise AssertionError(f"{k}: {key} launched {launches[key]} "
                                 f"times, expected {v}")


def _report_block(k, res, advance_s):
    """Micro-steps against their bound, active rows, and the rates."""
    ic = _load(k).integrator
    t = res.state.time
    most = round(t * (1 << (ic.n_levels - 1)) / ic.dt_max)
    n = res.state.n
    print(f"{k}: {res.n_steps} micro-steps to t={t:.6g} (at most {most}: "
          f"every dt_min slot), n_active_sum={res.n_active_sum} "
          f"({res.n_active_sum / res.n_steps:.1f} active rows per "
          f"micro-step), {advance_s / res.n_steps * 1e3:.4f} ms/micro-step, "
          f"{res.n_active_sum * n / advance_s:.4e} active-row interactions/s",
          flush=True)
    if res.n_steps > most:
        raise AssertionError(f"{k}: {res.n_steps} micro-steps > {most}")


def measure_steps(device, n_steps=200):
    """Phase 5, off the main path: the step of c2 (KDK), c3 (Hermite), c4
    (block), c5x and c5d (KDK at the extended and the df32 tier) on the
    card. Times n_steps steps on the host clock; for
    Hermite also without the per-step read of the shared dt (the same device
    work through ``Hermite4.propose`` at the carried dt, one sync at the
    end), in turns. The device's busy time per step comes from
    torch.profiler over 100 steps; its busy share is that over the
    unprofiled step time (the profiler slows the host). The host's time
    blocked on the step's read (Hermite's dt, block steps' (t_next,
    n_active)) is the program's ``integrator.wait`` spans in those
    profiled steps."""
    import torch
    from oc_nbody_tpu_torch.integrators.hermite import HermiteCarry
    from oc_nbody_tpu_torch.scene import build_scene, make_stepper
    from oc_nbody_tpu_torch.utils import profiling
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    out = {}
    full_steps = n_steps
    for name in ("c2", "c3", "c4", "c5x", "c5d"):
        # c5x's step is some twenty times the others' and c5d's some two
        # hundred times: fewer of them (timed steps, profiled, warm-up)
        n_steps, n_prof, n_warm = {
            "c5x": (full_steps // 5, 20, 20),
            "c5d": (full_steps // 20, 5, 2)}.get(name, (full_steps, 100, 20))
        cfg = _load(name)
        scene = build_scene(cfg, device)
        stepper, kind = make_stepper(cfg, scene.force)
        carry = stepper.advance(stepper.init(scene.state), n_warm)

        def no_read(c, i):
            x1, v1, a1, j1, _ = stepper.propose(c, c.dt)
            return HermiteCarry(
                state=c.state.replace(pos=x1, vel=v1,
                                      time=c.state.time + c.dt),
                acc=a1, jerk=j1, dt=c.dt, n_steps=c.n_steps + 1)

        def read_step(c, i):
            return stepper.step(c)

        def timed(step):
            c = carry
            torch.cuda.synchronize()
            t = time.perf_counter()
            for i in range(n_steps):
                c = step(c, i)
            torch.cuda.synchronize()
            return (time.perf_counter() - t) / n_steps * 1e3

        if kind == "hermite":  # in turns: read, no, no, read
            read = [timed(read_step)]
            free = [timed(no_read), timed(no_read)]
            read.append(timed(read_step))
        else:
            read, free = [timed(read_step), timed(read_step)], []
        ms = statistics.mean(read)
        c = carry
        torch.cuda.synchronize()
        t_prof = profiling.clock_ns()
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(n_prof):
                c = stepper.step(c)
            torch.cuda.synchronize()
        spans = [r for r in profiling.spans() if r.start_ns >= t_prof]
        waited = sum(r.end_ns - r.start_ns for r in spans
                     if r.name == "integrator.wait")
        active = (getattr(c, "n_active_sum", 0)
                  - getattr(carry, "n_active_sum", 0)) / n_prof
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_ms = sum(e.self_device_time_total
                      for e in kernels) / n_prof / 1e3
        top = sorted(kernels, key=lambda e: e.self_device_time_total,
                     reverse=True)[:4]
        line = (f"{name} {kind} step (N={scene.state.n}, {n_steps} steps per "
                f"timing): {ms:.4f} ms/step "
                f"({', '.join(f'{x:.4f}' for x in read)})")
        if free:
            ms_free = statistics.mean(free)
            line += (f" with the per-step dt read, {ms_free:.4f} ms/step "
                     f"without it ({', '.join(f'{x:.4f}' for x in free)}): "
                     f"the read costs {ms - ms_free:.4f} ms/step")
            out[name + "_read_ms"] = ms - ms_free
        if kind in ("hermite", "block"):
            line += (f"; the host blocked on the read "
                     f"{waited / 1e3 / n_prof:.1f} us/step (integrator.wait "
                     f"spans, {n_prof} profiled steps)")
        print(line)
        print(f"{name} device busy {busy_ms:.4f} ms/step (profiler, {n_prof} "
              f"steps) = {busy_ms / ms:.1%} of the step, idle "
              f"{1 - busy_ms / ms:.1%}; kernels per step "
              f"{sum(e.count for e in kernels) / n_prof:.1f}; top: "
              + "; ".join(f"{e.key[:40]} "
                          f"{e.self_device_time_total / n_prof:.1f}"
                          f" us/step" for e in top), flush=True)
        out[name + "_busy"] = busy_ms / ms
        if kind == "block":
            print(f"{name}: {active:.1f} active rows per micro-step over "
                  f"the {n_prof} profiled")
        del scene, stepper, carry, c
        torch.cuda.empty_cache()
    return out


def _bucket(cfg, n_cluster):
    """The bucket escape.build_sources builds for n_cluster members."""
    from oc_nbody_tpu_torch.escape import next_pow2
    return max(int(cfg.escape.min_bucket), next_pow2(int(n_cluster)))


def _check_prune_launches(cg, k, res, launches):
    """A pruned path whose partition is active from t = 0 runs no
    self-interaction kernel: every force evaluation is the two sweeps, all
    stars against the bucket and the bucket against all stars, each one
    launch of the kernel ``rows_route`` names (the accel form under KDK and
    for the rows' potential, the accel + jerk form under Hermite; under
    block steps the active cluster rows take sweep 2's jerk kernel and the
    active tail rows the bucket's). Also the ledger's column identity:
    dE_over_E_int = dE_cons_over_E_int + E_prune_cum / |E_int(0)| to
    1e-9."""
    import numpy as np
    cfg = _load(k)
    d = res.diagnostics
    n = res.state.n
    bucket = _bucket(cfg, d["N_cluster"][0])
    if not 2 * bucket < n:
        raise AssertionError(f"{k}: the partition is not active at t = 0 "
                             f"({int(d['N_cluster'][0])} members)")
    stray = {key: launches[key] for key in SELF_KERNELS if launches[key]}
    if stray:
        raise AssertionError(f"{k}: self-interaction kernels launched on a "
                             f"path pruned from t = 0: {stray}")
    ext = cfg.integrator.precision == "extended"
    kind = cfg.integrator.kind
    one = cg.rows_route(n, bucket, False, ext)
    two = cg.rows_route(bucket, n, False, ext)
    acc = (launches[one], launches[two]) if one != two else (
        launches[one] // 2, launches[one] - launches[one] // 2)
    if kind == "kdk" and not (acc[0] == acc[1] >= res.n_steps + 1):
        raise AssertionError(f"{k}: sweeps {one} / {two} launched {acc} "
                             f"times in {res.n_steps} steps")
    if kind == "hermite":
        one_j = cg.rows_route(n, bucket, True, ext)
        two_j = cg.rows_route(bucket, n, True, ext)
        if min(launches[one_j], launches[two_j]) < res.n_steps + 1:
            raise AssertionError(f"{k}: sweeps {one_j} / {two_j} launched "
                                 f"{launches[one_j]} / {launches[two_j]} "
                                 f"times in {res.n_steps} steps")
    if kind == "block":
        rows = sum(launches[key] for key in ("rows_jerk", "rows_jerk_t",
                                             "rows_jerk_stream",
                                             "rows_jerk_x",
                                             "rows_jerk_x_stream"))
        if rows < res.n_steps:
            raise AssertionError(f"{k}: {rows} active-row launches in "
                                 f"{res.n_steps} micro-steps")
    e_int0 = abs(d["E_int"][0])
    gap = float(np.abs(d["dE_over_E_int"] - d["dE_cons_over_E_int"]
                       - d["E_prune_cum"] / e_int0).max())
    if not gap <= 1e-9:
        raise AssertionError(f"{k}: the ledger's column identity is off by "
                             f"{gap:.3e}")
    print(f"{k}: bucket {bucket} at t = 0, sweeps {cg.KERNEL_LABEL[one]} "
          f"and {cg.KERNEL_LABEL[two]}; N_cluster "
          f"{[int(x) for x in d['N_cluster']]}; E_prune_cum "
          f"{[float(x) for x in d['E_prune_cum']]}; max|dE_cons_over_E_int| "
          f"{float(np.abs(d['dE_cons_over_E_int']).max()):.3e}; the column "
          f"identity to {gap:.1e}", flush=True)


def _prune_operands(key, nr, ns, device, seed):
    """Rows and sources in one frame for a rows kernel: the first nr and
    the first ns stars of one Plummer sphere of max(nr, ns) (centred f32,
    or (hi, lo) planes and gm for K19), so rows overlap sources as in the
    pruned sweeps. Returns (rows, sources) tuples."""
    n = max(nr, ns)
    if key == "rows_x_stream":
        hi, lo, gm = _planes(n, seed, device)[:3]
        cut = (hi[:nr], lo[:nr], hi[:ns], lo[:ns], gm[:ns])
    else:
        pos, mass = _cluster(n, seed, device)
        cut = (pos[:nr], pos[:ns], mass[:ns])
    cut = tuple(t.contiguous() for t in cut)
    split = 2 if key == "rows_x_stream" else 1
    return cut[:split], cut[split:]


def prune_case(cg, key, nr, ns, eps, device, with_phi=False, plain=False,
               seed=61):
    """K18 (``rows_t``), K18<comp> (``rows_stream``) or K19
    (``rows_x_stream``) on nr rows against ns sources, eps > 0: against the
    f64 twin on up to PRUNE_CHECK_ROWS rows (2e-5 of max|a|, phi rtol
    3e-5), launched twice (bitwise); timed (CUDA-graph replays up to 2^31
    pairs, which no busy host slows) beside its f32 twin (once, with ``plain``); prints one line and
    returns dict(max_abs_err, ms, plain_ms, shape, bound, rows, srcs)."""
    import torch
    launch = {"rows_t": cg.rows_t_kernel, "rows_stream": cg.rows_stream_kernel,
              "rows_x_stream": cg.rows_x_stream_kernel}[key]
    twin = (cg.rows_x_stream_plain if key == "rows_x_stream" else
            functools.partial(cg.rows_plain, key=key))
    rows, srcs = _prune_operands(key, nr, ns, device, seed)
    kw = dict(with_phi=with_phi, guarded=False)
    out = launch(*rows, *srcs, eps, **kw)
    if not _same_bits(out, launch(*rows, *srcs, eps, **kw)):
        raise AssertionError(f"{key} ({nr},{ns}) phi={with_phi}: two launches "
                             "differ bitwise")
    pick = torch.randperm(nr, generator=torch.Generator().manual_seed(nr))[
        :PRUNE_CHECK_ROWS].to(device)
    twin_kw = dict(with_phi=with_phi, dtype=torch.float64, chunk=64)
    if key == "rows_x_stream":
        twin_kw["guarded"] = False
    ref = twin(*(r[pick] for r in rows), *srcs, eps, **twin_kw)
    got = (out[0][pick], out[1][pick]) if with_phi else out[pick]
    err, rel, phi_rel = _compare(got, ref, with_phi, 2e-5)
    del ref, out
    timer = _graph_ms if nr * ns <= 2 ** 31 else _median_ms
    ms = timer(lambda: launch(*rows, *srcs, eps, **kw))
    pms = float("nan")
    if plain:
        pkw = {"guarded": False} if key == "rows_x_stream" else {}
        pms = _once_ms(lambda: twin(*rows, *srcs, eps, with_phi=with_phi,
                                    **pkw))
    x = key == "rows_x_stream"
    nbytes = ((28 if x else 16) * ns + (36 if x else 24) * nr
              + (4 * nr if with_phi else 0))
    bound = _bound(nr * ns, FLOPS_PER_PAIR[key + ("_phi" if with_phi
                                                  else "")], nbytes)
    checked = "" if nr <= PRUNE_CHECK_ROWS else \
        f"  ({PRUNE_CHECK_ROWS} rows checked)"
    print(f"{cg.KERNEL_LABEL[key]:<10}({nr},{ns}){'':<{15 - len(str(nr)) - len(str(ns))}}"
          f"{int(with_phi):<5}{err:<11.3e}{rel:<9.2e}{phi_rel:<10.2e}"
          f"{ms:<10.4f}{pms:<10.1f}{bound[0]:<9.5f}"
          f"{bound[0] / ms:.0%}{checked}", flush=True)
    torch.cuda.empty_cache()
    return dict(max_abs_err=err, ms=ms, plain_ms=pms, shape=[nr, ns],
                bound=bound)


def check_prune_rows_independent(cg, key, nr, ns, device):
    """A row's bits alone, in a subset, or among all nr rows of a launch
    (with the potential): the pruned scatter writes the bucket's padding
    rows twice and needs them equal."""
    import torch
    launch = {"rows_t": cg.rows_t_kernel, "rows_stream": cg.rows_stream_kernel,
              "rows_x_stream": cg.rows_x_stream_kernel}[key]
    rows, srcs = _prune_operands(key, nr, ns, device, 62)
    full = launch(*rows, *srcs, 1.0 / 256, with_phi=True, guarded=False)
    gen = torch.Generator().manual_seed(8)
    for k in (1, 64, 4095):
        pick = torch.randperm(nr, generator=gen)[:k].to(device)
        sub = launch(*(r[pick].contiguous() for r in rows), *srcs, 1.0 / 256,
                     with_phi=True, guarded=False)
        for got, want in zip(sub, full):
            if not torch.equal(got, want[pick]):
                raise AssertionError(f"{key} ({nr},{ns}): a row's bits depend "
                                     "on the other rows of its launch")
    torch.cuda.empty_cache()


def check_kernels_prune(cg, device):
    """Escape pruning's kernels at their Pallas rows' shapes: K18 on
    K18_ROWS rows against 65,536 sources (eps 1/512, escape_prune_65k's),
    K18<comp> and K19 at K18C_CASES and K19_CASES against or of 1,048,576
    (eps 1/256, c10p's), each against its f64 twin, bitwise repeatable,
    row-set independent; then K1 against K18<comp> at 65,536 x 1M, the
    divergence that sending every rows shape to K1 had past STREAM_N; and
    K1 beside K18 at #7's shapes (the H100's RT_MIN_ACCEL crossover is not
    measured: an input for ROADMAP B1)."""
    import torch
    print("kernel    shape              phi  max|da|    rel      phi_rel   "
          "ms        plain_ms  bound_ms share")
    for nr in K18_ROWS:
        for with_phi in (False, True):
            prune_case(cg, "rows_t", nr, PRUNE_N, 1.0 / 512, device, with_phi)
    check_prune_rows_independent(cg, "rows_t", 16384, PRUNE_N, device)
    for nr, both in K18C_CASES:
        for with_phi in ((False, True) if both else (False,)):
            prune_case(cg, "rows_stream", nr, BIG_N, 1.0 / 256, device,
                       with_phi)
    check_prune_rows_independent(cg, "rows_stream", 65536, BIG_N, device)
    for nr, ns, both in K19_CASES:
        for with_phi in ((False, True) if both else (False,)):
            prune_case(cg, "rows_x_stream", nr, ns, 1.0 / 256, device,
                       with_phi)
    check_prune_rows_independent(cg, "rows_x_stream", 131072, 4096, device)
    check_compensation(cg, device)
    pos, mass = _cluster(PRUNE_N, 64, device)
    for nr in PRUNE_BUCKETS:
        rows = pos[:nr].contiguous()
        t1 = _graph_ms(lambda: cg.rows_kernel(rows, pos, mass, 1.0 / 512,
                                              guarded=False))
        t18 = _graph_ms(lambda: cg.rows_t_kernel(rows, pos, mass, 1.0 / 512,
                                                 guarded=False))
        print(f"  K1 {t1:.4f} ms, K18 {t18:.4f} ms at {nr} x {PRUNE_N} "
              f"(K1 / K18 {t1 / t18:.2f})", flush=True)
    del pos, mass
    torch.cuda.empty_cache()


def check_compensation(cg, device):
    """The repaired divergence and the compensation itself, each against
    the f64 twin (eps 1/256). At 65,536 rows x 1M sources, on
    PRUNE_CHECK_ROWS rows: K1 (one serial sum per row, which every f32 rows
    shape took before K18) and K18 (the source-split layout without its
    Kahan steps) beside K18<comp>. At 2,048 x 1M: K9's accel (the extended
    tier's split layout without them) beside K19. Fails unless K18<comp>
    and K19 err at most COMP_BOUND of max|a| and at most 1 / COMP_RATIO of
    their uncompensated layout's error."""
    import torch
    errs = {}
    rows, (src, mass) = _prune_operands("rows_stream", 65536, BIG_N, device,
                                        61)
    pick = torch.randperm(65536, generator=torch.Generator().manual_seed(
        65536))[:PRUNE_CHECK_ROWS].to(device)
    ref = cg.rows_plain(rows[0][pick], src, mass, 1.0 / 256,
                        dtype=torch.float64, chunk=64)
    scale = float(ref.abs().max())
    for name, fn in (("K1", cg.rows_kernel), ("K18", cg.rows_t_kernel),
                     ("K18<comp>", cg.rows_stream_kernel)):
        out = fn(rows[0], src, mass, 1.0 / 256, guarded=False)
        errs[name] = float((out[pick].double() - ref).abs().max()) / scale
    del rows, src, mass, ref, out
    nr = 2048
    hi, lo, gm, vhi, vlo = _planes(BIG_N, 62, device)
    rows = [t[:nr].contiguous() for t in (hi, lo, vhi, vlo)]
    ref = cg.rows_x_stream_plain(*rows[:2], hi, lo, gm, 1.0 / 256,
                                 dtype=torch.float64, chunk=64,
                                 guarded=False)
    scale = float(ref.abs().max())
    for name, out in (
            ("K9 accel", cg.rows_jerk_x_kernel(*rows, hi, lo, vhi, vlo, gm,
                                               1.0 / 256, guarded=False)[0]),
            ("K19", cg.rows_x_stream_kernel(*rows[:2], hi, lo, gm, 1.0 / 256,
                                            guarded=False))):
        errs[name] = float((out.double() - ref).abs().max()) / scale
    del hi, lo, gm, vhi, vlo, rows, ref, out
    torch.cuda.empty_cache()
    print(f"compensation against the f64 twin (of max|a|): at 65536 x {BIG_N}"
          f" K1 {errs['K1']:.3e}, K18 {errs['K18']:.3e}, K18<comp> "
          f"{errs['K18<comp>']:.3e} (the JAX package compensates here; the "
          f"port now does too); at {nr} x {BIG_N} K9's accel "
          f"{errs['K9 accel']:.3e}, K19 {errs['K19']:.3e}", flush=True)
    for comp, plain in (("K18<comp>", "K18"), ("K19", "K9 accel")):
        if not (errs[comp] <= COMP_BOUND
                and errs[comp] * COMP_RATIO <= errs[plain]):
            raise AssertionError(
                f"{comp} errs {errs[comp]:.3e} of max|a|: above {COMP_BOUND:g}"
                f" or not {COMP_RATIO:g}x below {plain}'s {errs[plain]:.3e}")


def check_pruned_evals(cg, device):
    """The pruned evaluation at N = 65,536 (a Plummer sphere, eps 1/512):
    for each of PRUNE_BUCKETS, the innermost 7/8 of the bucket as the
    cluster; the pruned accel at the f32 and the extended tier timed beside
    the unpruned one (K2; K6), and held within 2e-5 of max|a| to the f64
    oracle of the reduced Hamiltonian (cluster rows against all stars, tail
    rows against the cluster) on 512 cluster and 512 tail rows."""
    import numpy as np
    import torch
    from oc_nbody_tpu_torch import escape
    from oc_nbody_tpu_torch.forces import make_force_model
    from oc_nbody_tpu_torch.models.plummer import plummer
    from oc_nbody_tpu_torch.ops import gravity
    eps = 1.0 / 512
    state = plummer(PRUNE_N, torch.Generator().manual_seed(63),
                    device=device)
    pos, mass = state.pos, state.mass
    r = torch.linalg.vector_norm(pos - pos.mean(dim=0), dim=1)
    order = torch.argsort(r).cpu().numpy()
    m64 = mass.double()
    unpruned = {p: make_force_model(eps, precision=p)
                for p in ("f32", "extended")}
    t_full = {p: _median_ms(lambda: f.accel(pos, mass))
              for p, f in unpruned.items()}
    gen = torch.Generator().manual_seed(9)
    for bucket in PRUNE_BUCKETS:
        n_c = bucket - bucket // 8
        mask = np.zeros(PRUNE_N, bool)
        mask[order[:n_c]] = True
        idx, wgt, _ = escape.build_sources(mask, bucket)
        members = torch.from_numpy(order[:n_c]).to(device)
        tails = torch.from_numpy(order[n_c:]).to(device)
        sample = (members[torch.randperm(n_c, generator=gen)[:512].to(
            device)], tails[torch.randperm(PRUNE_N - n_c, generator=gen)[
            :512].to(device)])
        cl_mass = m64 * torch.from_numpy(mask).to(device)
        ref = [gravity.accel_rows(pos[rows], pos, m, eps, 1.0, 64)
               for rows, m in zip(sample, (m64, cl_mass))]
        scale = max(float(a.abs().max()) for a in ref)
        line = []
        for p, base in unpruned.items():
            force = base.with_sources(
                torch.from_numpy(idx).to(device),
                torch.from_numpy(wgt).to(device),
                torch.from_numpy(mask.astype(np.float64)).to(device))
            acc = force.accel(pos, mass)
            if not torch.equal(acc, force.accel(pos, mass)):
                raise AssertionError(f"pruned accel ({p}, B = {bucket}): two "
                                     "evaluations differ bitwise")
            err = max(float((acc[rows] - a).abs().max())
                      for rows, a in zip(sample, ref)) / scale
            if not err <= 2e-5:
                raise AssertionError(f"pruned accel ({p}, B = {bucket}): "
                                     f"{err:.3e} of max|a| from the oracle")
            ms = _median_ms(lambda: force.accel(pos, mass))
            line.append(f"{p} {ms:.4f} ms (unpruned {t_full[p]:.4f}, "
                        f"{t_full[p] / ms:.2f}x), {err:.3e} of max|a|")
        print(f"pruned accel at N={PRUNE_N}, bucket {bucket} ({n_c} members): "
              + "; ".join(line), flush=True)
        torch.cuda.empty_cache()
    del state, pos, mass
    torch.cuda.empty_cache()


def _memo_ic(prefetch=()):
    """Build each configuration's IC once in this process: the four
    escape_prune_65k paths share one King IC, whose f64 potential energy
    is an O(N^2) host sum (over a minute at N = 65,536). The configs of
    ``prefetch`` are built on a host thread from the start, on the CPU:
    the thread makes no CUDA call, so it cannot meet a graph capture on the
    main thread, and ``wait`` joins it before the phases that time
    host-launched work. The CLI runs as a user calls it; only the repeated
    IC construction is skipped, and each run gets its own copy of the state
    on its device. Returns (the original ``scene.build_ic``, wait), where
    wait() joins the prefetch threads and returns the seconds it waited."""
    import threading
    from oc_nbody_tpu_torch import scene
    real = scene.build_ic
    cache, threads = {}, {}

    def key_of(cfg, us):
        return (repr(cfg.ic), repr(us))

    def build(key, cfg, us):
        cache[key] = real(cfg, us, "cpu")

    for cfg in prefetch:
        us = scene.build_units(cfg)
        key = key_of(cfg, us)
        threads[key] = threading.Thread(target=build, args=(key, cfg, us))
        threads[key].start()

    def wait():
        t = time.perf_counter()
        for key in list(threads):
            threads.pop(key).join()
        return time.perf_counter() - t

    def build_ic(cfg, us, dev):
        key = key_of(cfg, us)
        if key in threads:
            threads.pop(key).join()
        if key not in cache:
            build(key, cfg, us)
        return cache[key].to(dev)   # scene.build_ic's own last step

    scene.build_ic = build_ic
    return real, wait


# the unmemoized scene.build_ic while the prune phases run
_REAL_BUILD_IC = []


def run_prune_paths(cg, device):
    """Phase 4, escape pruning: the paths of PATHS_PRUNE through the CLI
    at their fixed lengths (``scene.build_ic`` memoized by ``_memo_ic``,
    whose prefetch thread the caller started); returns ({name: RunResult},
    {name: launches})."""
    from oc_nbody_tpu_torch import scene
    try:
        runs, launches = _drive(
            cg, PATHS_PRUNE, {k: over for k, (_, over, _) in
                              PATHS_PRUNE.items()})
    finally:
        scene.build_ic = _REAL_BUILD_IC[0]
    for k, res in runs.items():
        print(f"{k}: set-up and run {res.wall_time_s:.1f} s, "
              f"{res.phase_s['advance'] / res.n_steps * 1e3:.3f} ms per "
              f"step, escape_prune {res.phase_s.get('escape_prune', 0):.2f} "
              f"s, diagnostics {res.phase_s['diagnostics']:.2f} s", flush=True)
    ctl, pr = runs["c10p_ctl"], runs["c10p"]
    print(f"c10p: pruned {pr.phase_s['advance'] / pr.n_steps:.4f} s/step "
          f"against the unpruned control's "
          f"{ctl.phase_s['advance'] / ctl.n_steps:.4f} "
          f"({ctl.phase_s['advance'] / ctl.n_steps / (pr.phase_s['advance'] / pr.n_steps):.2f}x)",
          flush=True)
    return runs, launches


def _ring_operands(key, nr, ns, device, seed):
    """A ring step's operands: the first nr stars of one Plummer sphere of
    nr + ns as the rows and the other ns as the slab (two shards of one
    cluster, centred in one frame), G m = m: (rows, [vrows,] src, [svel,]
    gm)."""
    pos, mass, vel = _moving_cluster(nr + ns, seed, device)
    rows, src, gm = (pos[:nr].contiguous(), pos[nr:].contiguous(),
                     mass[nr:].contiguous())
    if key == "ring_jerk":
        return rows, vel[:nr].contiguous(), src, vel[nr:].contiguous(), gm
    return rows, src, gm


def ring_case(cg, cr, key, nr, ns, eps, device, plain=False, seed=71):
    """One ring step of K20 (``ring``), K20<phi> (``ring_phi``) or K21
    (``ring_jerk``) on nr rows against an ns-source slab, eps > 0: the first
    step (a store) and a step accumulating onto non-zero incoming sums and
    compensations, each against the f64 twin (2e-5 of max|a| and max|j|,
    phi rtol 3e-5; the accumulated sum read as sum - comp, against the
    incoming sum - comp plus the f64 step); launched twice from the same
    incoming sums, bitwise equal; the accumulating step timed (CUDA-graph
    replays) beside its f32 twin (once, with ``plain``). Prints one line;
    returns dict(max_abs_err, ms, plain_ms, shape, bound)."""
    import torch
    f32, f64 = torch.float32, torch.float64
    jerk = key == "ring_jerk"
    ops = _ring_operands(key, nr, ns, device, seed)
    shapes = [(nr, 3), (nr,)] if key == "ring_phi" else (
        [(nr, 3), (nr, 3)] if jerk else [(nr, 3)])
    scratch = torch.empty((cr.ring_scratch_floats(
        nr, ns, with_phi=key == "ring_phi", jerk=jerk),), dtype=f32,
        device=device)

    def bufs(dtype, fill=None):
        return [torch.full(sh, fill, dtype=dtype, device=device) if fill
                is not None else torch.zeros(sh, dtype=dtype, device=device)
                for sh in shapes]

    def launch(sums, comps, first, twin=False):
        if jerk:
            fn = cr.ring_step_jerk_plain if twin else cr.ring_step_jerk_kernel
            args = (*ops, eps, sums[0], sums[1], comps[0], comps[1])
        else:
            fn = cr.ring_step_plain if twin else cr.ring_step_kernel
            args = (*ops, eps, sums[0], comps[0], *(
                (sums[1], comps[1]) if key == "ring_phi" else ()))
        kw = (dict(dtype=sums[0].dtype) if twin
              else dict(guarded=False, scratch=scratch))
        fn(*args, first=first, **kw)

    def check(got, want):
        if jerk:
            return _compare_jerk(tuple(got), tuple(want), 2e-5, 2e-5)[:2]
        return _compare(tuple(got) if key == "ring_phi" else got[0],
                        tuple(want) if key == "ring_phi" else want[0],
                        key == "ring_phi", 2e-5)[:2]

    # the first step: a store, the compensations zeroed
    step64, c64 = bufs(f64), bufs(f64)
    launch(step64, c64, True, twin=True)
    first, comps = bufs(f32), bufs(f32, 1.0)
    launch(first, comps, True)
    if any(float(c.abs().max()) != 0.0 for c in comps):
        raise AssertionError(f"{key} ({nr},{ns}): the first step left a "
                             "compensation")
    check(first, step64)
    # an accumulating step onto incoming sums (three slabs' worth) and
    # compensations of the size a Kahan step leaves
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    out0 = [3.0 * t for t in first]
    comp0 = [(1e-7 * t.abs() * torch.randn(t.shape, generator=gen,
                                           device=device)).to(f32)
             for t in out0]
    sums, comps = [t.clone() for t in out0], [t.clone() for t in comp0]
    launch(sums, comps, False)
    again_s, again_c = [t.clone() for t in out0], [t.clone() for t in comp0]
    launch(again_s, again_c, False)
    if not _same_bits(tuple(sums + comps), tuple(again_s + again_c)):
        raise AssertionError(f"{key} ({nr},{ns}): two launches differ "
                             "bitwise")
    got = [s.double() - c.double() for s, c in zip(sums, comps)]
    want = [o.double() - c.double() + x
            for o, c, x in zip(out0, comp0, step64)]
    err, rel = check(got, want)
    ms = _graph_ms(lambda: launch(again_s, again_c, False))
    pms = float("nan")
    if plain:
        ps, pc = [t.clone() for t in out0], [t.clone() for t in comp0]
        pms = _once_ms(lambda: launch(ps, pc, False, twin=True))
    nbytes = ((24 if jerk else 12) * nr + (28 if jerk else 16) * ns
              + 4 * 4 * sum(math.prod(sh) for sh in shapes))
    bound = _bound(nr * ns, FLOPS_PER_PAIR[key]
                   + RING_KAHAN_FLOPS[key] / ns, nbytes)
    print(f"{cg.KERNEL_LABEL[key]:<10}({nr},{ns}){'':<{15 - len(str(nr)) - len(str(ns))}}"
          f"{err:<11.3e}{rel:<9.2e}{ms:<10.4f}{pms:<10.2f}{bound[0]:<9.5f}"
          f"{bound[0] / ms:.0%}  first and accumulating, bitwise-repeatable",
          flush=True)
    torch.cuda.empty_cache()
    return dict(max_abs_err=err, ms=ms, plain_ms=pms, shape=[nr, ns],
                bound=bound)


def check_kernels_ring(cg, cr, device):
    """K20, K20<phi> and K21 at c5's ring step on a 4-shard mesh (32,768
    rows against a 32,768-source slab, eps = 1/512) and ragged (10,650
    stars padded to 10,656, 2,664 a shard), K21 also at c3's step on the
    mesh (4,096 x 4,096, eps = 1/256): ``ring_case``. Returns
    {key: ring_case's dict} at the main paths' shapes."""
    print("kernel    shape              max|da|    rel      ms        "
          "plain_ms  bound_ms share")
    main = {}
    s5 = MESH_N // MESH_D
    for key in ("ring", "ring_phi", "ring_jerk"):
        m = ring_case(cg, cr, key, s5, s5, 1.0 / 512, device,
                      plain=key != "ring_jerk")
        if key != "ring_jerk":
            main[key] = m
        ring_case(cg, cr, key, 2664, 2664, 1.0 / 512, device, seed=72)
    main["ring_jerk"] = ring_case(cg, cr, "ring_jerk", 4096, 4096, 1.0 / 256,
                                  device, plain=True, seed=73)
    return main


def _sharded_eval(sf, want, pos, vel, mass):
    if want == "jerk":
        return sf.accel_jerk(pos, vel, mass)
    if want == "phi":
        return sf.accel_potential(pos, mass)[:2]
    return sf.accel(pos, mass)


def check_ring_evals(cg, cr, device):
    """The sharded force at N = 131,072 (eps = 1/512) in every mode, on a
    4-shard mesh on this card and, with more than one card visible, on
    ``make_mesh(min(4, count))``: accel, accel + phi and accel + jerk
    against the unsharded ForceModel within 2e-5 of max|a| and max|j| (phi
    rtol 3e-5) and against the f64 oracle on 4,096 sampled rows, each
    timed beside the unsharded evaluation; rdma at d = 1 (one launch, no
    slab) and d = 8 (its error against the oracle no worse than the
    unsharded evaluation's); then the race check: the three ring evaluations with
    overlap bitwise equal, over 5 repeats, to the same schedule with the
    host waiting for the card after every ring step."""
    import torch
    from oc_nbody_tpu_torch.forces import make_force_model
    from oc_nbody_tpu_torch.models.plummer import plummer
    from oc_nbody_tpu_torch.ops import gravity
    from oc_nbody_tpu_torch.parallel.force import MODES, make_sharded_force
    from oc_nbody_tpu_torch.parallel.mesh import Mesh, make_mesh
    f64 = torch.float64
    eps = 1.0 / 512
    state = plummer(MESH_N, torch.Generator().manual_seed(81), device=device)
    pos, mass, vel = state.pos, state.mass, state.vel
    pos_c, mass_c, vel_c = gravity.prepare_f32(pos, mass, vel=vel)
    rows = torch.randperm(MESH_N, generator=torch.Generator().manual_seed(
        82))[:BIG_SAMPLE].to(device)
    ref_a, ref_phi = cg.rows_plain(pos_c[rows], pos_c, mass_c, eps,
                                   with_phi=True, dtype=f64, chunk=256)
    ref_phi = ref_phi + gravity.self_phi(mass_c[rows].to(f64), eps, 1.0)
    ref_j = cg.rows_jerk_plain(pos_c[rows], vel_c[rows], pos_c, vel_c,
                               mass_c, eps, dtype=f64, chunk=256)
    oracle = {"accel": ref_a, "phi": (ref_a, ref_phi), "jerk": ref_j}
    single = make_force_model(eps)

    def errors(out, want, against):
        if want == "jerk":
            return _compare_jerk(out, against, 2e-5, 2e-5)
        if want == "phi":
            return _compare(out, against, True, 2e-5)
        return _compare(out, against, False, 2e-5)

    def sample(out):
        return (tuple(o[rows] for o in out) if isinstance(out, tuple)
                else out[rows])

    base = {w: _sharded_eval(single, w, pos, vel, mass)
            for w in ("accel", "phi", "jerk")}
    base_ms = {w: _median_ms(lambda: _sharded_eval(single, w, pos, vel,
                                                   mass), reps=3)
               for w in base}
    meshes = [("one card", Mesh.on_one_device(MESH_D, device))]
    if torch.cuda.device_count() > 1:
        meshes.append(("cards", make_mesh(min(MESH_D,
                                              torch.cuda.device_count()))))
    print(f"the sharded force at N = {MESH_N} (eps = 1/512): against the "
          "unsharded evaluation and the f64 oracle on "
          f"{BIG_SAMPLE} rows; meshes: "
          + "; ".join(f"{m.describe()}" for _, m in meshes), flush=True)
    times = {}
    for label, mesh in meshes:
        for mode in MODES:
            sf = make_sharded_force(eps, mesh=mesh, mode=mode)
            for want in ("accel", "phi", "jerk"):
                out = _sharded_eval(sf, want, pos, vel, mass)
                e_single = errors(out, want, base[want])
                e_oracle = errors(sample(out), want, oracle[want])
                ms = _median_ms(lambda: _sharded_eval(sf, want, pos, vel,
                                                      mass), reps=3)
                times[label, mode, want] = ms
                print(f"  {mesh.n_devices} shards ({label}) {mode:<9} "
                      f"{want:<5} against unsharded {e_single[1]:.3e}, "
                      f"against f64 {e_oracle[1]:.3e} of max|a|"
                      + (f" ({e_oracle[2]:.3e} of max|j|)" if want == "jerk"
                         else "")
                      + f"; {ms:.3f} ms (unsharded {base_ms[want]:.3f})",
                      flush=True)
                del out
            torch.cuda.empty_cache()
    # rdma at d = 1: one launch from the shard's own planes
    sf1 = make_sharded_force(eps, mesh=Mesh.on_one_device(1, device),
                             mode="rdma")
    before = cg.LAUNCHES["ring"]
    a1 = sf1.accel(pos, mass)
    if cg.LAUNCHES["ring"] - before != 1 or sf1.buffers.rings:
        raise AssertionError("rdma at d = 1: not one launch without a slab")
    e1 = errors(a1, "accel", base["accel"])
    # rdma at d = 8 against the oracle, beside the unsharded evaluation
    sf8 = make_sharded_force(eps, mesh=Mesh.on_one_device(8, device),
                             mode="rdma")
    a8 = sf8.accel(pos, mass)
    e8 = errors(a8[rows], "accel", ref_a)
    es = errors(base["accel"][rows], "accel", ref_a)
    e8_mean = float((a8[rows].double() - ref_a).abs().mean())
    es_mean = float((base["accel"][rows].double() - ref_a).abs().mean())
    print(f"  rdma d = 1 against unsharded {e1[1]:.3e} (one launch); d = 8 "
          f"against f64 {e8[1]:.3e} of max|a| (mean {e8_mean:.3e}), the "
          f"unsharded evaluation {es[1]:.3e} (mean {es_mean:.3e})",
          flush=True)
    if not e8[0] <= es[0]:
        raise AssertionError("rdma at d = 8: the compensated ring errs more "
                             "than the unsharded evaluation")
    del a1, a8, sf1, sf8
    # the race check on each mesh
    for _, mesh in meshes:
        d = mesh.n_devices
        size = MESH_N // d
        ps, vs, ms_ = ([x[s * size:(s + 1) * size].to(dev)
                        for s, dev in enumerate(mesh.devices)]
                       for x in (pos_c, vel_c, mass_c))
        kw = dict(guarded=False, buffers=cr.RingBuffers())
        for name, fn in (("accel_ring", lambda serial: cr.accel_ring(
                ps, ms_, eps, serial=serial, **kw)),
                         ("accel_potential_ring",
                          lambda serial: cr.accel_potential_ring(
                              ps, ms_, eps, serial=serial, **kw)),
                         ("accel_jerk_ring",
                          lambda serial: cr.accel_jerk_ring(
                              ps, vs, ms_, eps, serial=serial, **kw))):
            serial = _flat(fn(True))
            for _ in range(5):
                if not _same_bits(_flat(fn(False)), serial):
                    raise AssertionError(
                        f"{name} on {mesh.describe()}: the overlapped ring "
                        "differs from the serial schedule (a race)")
        print(f"  race check on {mesh.describe()}: accel_ring, "
              "accel_potential_ring and accel_jerk_ring with overlap bitwise "
              "equal to the serial schedule over 5 repeats each", flush=True)
        del kw, ps, vs, ms_
    torch.cuda.empty_cache()
    return times, base_ms


def _flat(out):
    """A ring evaluation's per-shard outputs as one flat tuple."""
    return tuple(t for o in out for t in (o if isinstance(o, tuple)
                                          else (o,)))


def _drive_api(cg, paths, meshes):
    """``run.run`` on each of ``paths`` (the API a caller with its own mesh
    uses), on its mesh from ``meshes`` (none: the config's own, one card),
    the launch counters set to 0 just before each and read just after;
    returns ({name: RunResult}, {name: launches})."""
    import oc_nbody_tpu_torch.run as run_mod
    runs, launches = {}, {}
    for k, (path, over, want) in paths.items():
        mesh = meshes.get(k)
        print(f"--- main path: run.run({path} "
              f"{' '.join('--set ' + o for o in over)}, device cuda, mesh "
              f"{mesh.describe() if mesh else 'from the config: one card'})",
              flush=True)
        cfg = _load(k)
        for key in cg.LAUNCHES:
            cg.LAUNCHES[key] = 0
        for key in cg.PLAIN_CALLS:
            cg.PLAIN_CALLS[key] = 0
        runs[k] = run_mod.run(cfg, device="cuda", mesh=mesh)
        launches[k] = dict(cg.LAUNCHES)
        print(f"{k}: kernel launches "
              f"{ {n: c for n, c in launches[k].items() if c} }", flush=True)
        if launches[k][want] <= 0:
            raise AssertionError(f"{k}: the {want} kernel never launched")
        if any(cg.PLAIN_CALLS.values()):
            raise AssertionError(f"{k}: plain twins ran on the path: "
                                 f"{cg.PLAIN_CALLS}")
    for k, res in runs.items():
        _check_run(k, res)
    return runs, launches


def run_sharded_paths(cg, device):
    """The sharded phase's paths (PATHS_MESH) through ``run.run``: c5 and c3
    on a MESH_D-shard mesh on this card, each beside its unsharded control,
    and where more cards are visible c5 (rdma) on a mesh of up to MESH_D
    cards; every sharded force evaluation is d^2 launches of its kernel
    (K18 per hop under ring, K20 / K21 under rdma), every f32 diagnostics
    row d^2 of K20<phi>, every f64 row one K23 and, with the CH85 columns,
    one K22, and no other kernel runs. Returns
    ({name: RunResult}, {name: launches})."""
    import torch
    from oc_nbody_tpu_torch.parallel.mesh import Mesh, make_mesh
    mesh = Mesh.on_one_device(MESH_D, device)
    meshes = {k: mesh for k in MESH_RUNS}
    paths = {k: v for k, v in PATHS_MESH.items() if k != "c5_cards"}
    if torch.cuda.device_count() > 1:
        meshes["c5_cards"] = make_mesh(min(MESH_D,
                                           torch.cuda.device_count()))
        paths["c5_cards"] = PATHS_MESH["c5_cards"]
    runs, launches = _drive_api(cg, paths, meshes)
    for k, run_mesh in meshes.items():
        res = runs[k]
        rows = len(res.diagnostics["time"])
        d2 = run_mesh.n_devices ** 2
        want = {PATHS_MESH[k][2]: d2 * (res.n_steps + 1)}
        if _load(k).output.diag_f64:   # K23 on the gathered state
            want["phi_f64"] = rows
        else:
            want["ring_phi"] = d2 * rows
        if _load(k).output.core_diag:   # K22 on the gathered state
            want["knn_density"] = rows
        got = {n: c for n, c in launches[k].items() if c}
        if got != want:
            raise AssertionError(f"{k}: launches {got}, expected {want} "
                                 f"(d^2 per force evaluation: "
                                 f"{res.n_steps} steps, init, {rows} rows)")
    for sharded, single in (("c5_ring", "c5_single"), ("c5_rdma", "c5_single"),
                            ("c3_mesh", "c3_single"), ("c5_cards", "c5_single")):
        if sharded not in runs:
            continue
        a, b = runs[sharded], runs[single]
        ta = a.phase_s["advance"] / a.n_steps * 1e3
        tb = b.phase_s["advance"] / b.n_steps * 1e3
        what = ("a multi-card speed" if sharded == "c5_cards" else
                "the cost of sharding on one card, not a multi-card speed")
        print(f"{sharded}: {ta:.3f} ms/step on {meshes[sharded].describe()} "
              f"against {tb:.3f} unsharded on one card ({ta / tb:.2f}x: "
              f"{what}); {a.n_steps} steps against {b.n_steps}", flush=True)
    return runs, launches


def run_sharded_phase(cg, device):
    """The sharded phase: K20, K20<phi> and K21 against their twins, the
    sharded force at N = 131,072 in every mode, the race check, and the
    sharded paths. Returns (runs, launches, main shapes of K20/K20<phi>/K21,
    seconds)."""
    from oc_nbody_tpu_torch.ops import cuda_ring as cr
    t = time.perf_counter()
    shapes = check_kernels_ring(cg, cr, device)
    check_ring_evals(cg, cr, device)
    runs, launches = run_sharded_paths(cg, device)
    seconds = time.perf_counter() - t
    print(f"sharded phase: {seconds:.1f} s", flush=True)
    return runs, launches, shapes, seconds


def main():
    t_start = time.perf_counter()
    if sys.argv[1:] not in ([], ["--sharded"], ["--phi64"]):
        _fail("usage: python3 chip_smoke.py [--sharded | --phi64]")
    if not os.path.isfile(os.path.join(ROOT, "oc_nbody_tpu_torch",
                                       "__init__.py")):
        _fail("the oc_nbody_tpu_torch package is not beside this script")
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        _fail("torch sees no CUDA device; this smoke test needs one GPU")
    device = torch.device("cuda", 0)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    smi_line = smi.stdout.strip()
    print(smi_line)
    print(f"torch {torch.__version__}  CUDA {torch.version.cuda}  "
          f"python {sys.version.split()[0]}  "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    from oc_nbody_tpu_torch.ops import cuda_gravity as cg
    t = time.perf_counter()
    cg._library()
    print(f"kernel build: {time.perf_counter() - t:.2f} s "
          f"({cg.build_library().name})")
    for line in cg.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("  ptxas: " + line.strip())

    if sys.argv[1:] == ["--sharded"]:
        run_sharded_phase(cg, device)
        print(smi_line)
        return 0
    if sys.argv[1:] == ["--phi64"]:
        check_phi64(cg, device)
        print(smi_line)
        return 0
    from oc_nbody_tpu_torch.ops import cuda_df
    main_shapes = check_kernels(cg, device)
    main_shapes["knn_density"] = check_knn(cg, device)
    main_shapes["phi_f64"] = check_phi64(cg, device)
    check_kernels_x(cg, device, main_shapes)
    check_kernels_df(cg, cuda_df, device, main_shapes)
    check_kernels_big(cg, device, main_shapes)
    check_kernels_big_x(cg, device, main_shapes)
    check_jerk_geometries(cg, device)
    from oc_nbody_tpu_torch.ops import cuda_ring
    check_guard(cg, cuda_df, cuda_ring, device)
    runs, launches = run_df_paths(cg, device)
    big_runs, big_launches = run_big_paths(cg, device)
    runs.update(big_runs)
    launches.update(big_launches)
    budget = BUDGET_S - (time.perf_counter() - t_start)
    more_runs, more_launches = run_main_path(cg, device, budget)
    runs.update(more_runs)
    launches.update(more_launches)
    # K5 at the shape c4's main path gave it on average: its mean active
    # rows per micro-step against its 32,768 sources, eps = 1/256
    c4 = runs["c4"]
    nr = max(1, round(c4.n_active_sum / c4.n_steps))
    print(f"K5 at c4's mean active rows per micro-step ({nr}):")
    src, mass, svel = _moving_cluster(c4.state.n, 15, device)
    main_shapes["rows_jerk_t"] = k5_case(cg, src, svel, mass, nr,
                                         _load("c4").integrator.eps)
    del src, mass, svel
    # K14 likewise at c4_1m's, against its 1M sources
    c4b = runs["c4_1m"]
    nr = max(1, round(c4b.n_active_sum / c4b.n_steps))
    print(f"K14 at c4_1m's mean active rows per micro-step ({nr}):")
    src, mass, svel = _moving_cluster(c4b.state.n, 43, device)
    main_shapes["rows_jerk_stream"] = k14_case(cg, src, svel, mass, nr,
                                               _load("c4_1m").integrator.eps)
    del src, mass, svel
    # K17 likewise at c4x_1m's, against its 1M sources
    c4x_1m = runs["c4x_1m"]
    nr = max(1, round(c4x_1m.n_active_sum / c4x_1m.n_steps))
    print(f"K17 at c4x_1m's mean active rows per micro-step ({nr}):")
    src = _planes(c4x_1m.state.n, 49, device)
    main_shapes["rows_jerk_x_stream"] = k17_case(
        cg, src, nr, _load("c4x_1m").integrator.eps)
    del src
    # K9 likewise at c4x's mean active rows per micro-step
    c4x = runs["c4x"]
    nr = max(1, round(c4x.n_active_sum / c4x.n_steps))
    print(f"K9 at c4x's mean active rows per micro-step ({nr}):")
    src = _planes(c4x.state.n, 25, device)
    main_shapes["rows_jerk_x"] = k9_case(cg, src, nr,
                                         _load("c4x").integrator.eps)
    del src
    print("the tier's cost on this card (extended kernel ms / f32-tier "
          "kernel ms at the same shape): "
          + ", ".join(f"{key} {main_shapes[key]['ms'] / main_shapes[key]['f32_ms']:.2f}x"
                      for key in ("sym_x", "sym_x_phi", "sym_jerk_x",
                                  "rows_x", "rows_x_phi", "rows_jerk_x")))
    # past STREAM_N the shapes differ (the tiers' chunks): pairs per second
    rate = {key: math.prod(m["shape"]) / m["ms"]
            for key, m in main_shapes.items()}
    print("past STREAM_N, extended pairs/s over f32 pairs/s: "
          + ", ".join(f"{x} / {f} {rate[x] / rate[f]:.2f}x" for x, f in (
              ("cross_x", "cross"), ("cross_x_phi", "cross_phi"),
              ("cross_jerk_x", "cross_jerk"),
              ("rows_jerk_x_stream", "rows_jerk_stream"))))
    # escape pruning: its kernels, the pruned evaluation at 65,536, its
    # paths, and K18, K18<comp> and K19 at the shapes their paths gave them;
    # escape_prune_65k's King IC is built on a host thread during the kernel
    # checks (CUDA-graph replays and kernels of tens of ms, which a busy host
    # does not slow), and joined before the pruned evaluations are timed
    real_build_ic, wait_ic = _memo_ic(prefetch=[_load("escape_65k")])
    _REAL_BUILD_IC.append(real_build_ic)
    check_kernels_prune(cg, device)
    print(f"escape_prune_65k's King IC: waited {wait_ic():.1f} s for its host "
          "thread", flush=True)
    check_pruned_evals(cg, device)
    prune_runs, prune_launches = run_prune_paths(cg, device)
    runs.update(prune_runs)
    launches.update(prune_launches)
    for key, path, ns in (("rows_t", "escape_65k", PRUNE_N),
                          ("rows_stream", "c10p", BIG_N),
                          ("rows_x_stream", "c10p_x", BIG_N)):
        cfg = _load(path)
        nr = _bucket(cfg, runs[path].diagnostics["N_cluster"][0])
        print(f"{cg.KERNEL_LABEL[key]} at {path}'s sweep 2 (its bucket of "
              f"{nr} rows against {ns} sources):")
        main_shapes[key] = prune_case(cg, key, nr, ns, cfg.integrator.eps,
                                      device, plain=True)
    # the sharded force: K20, K20<phi>, K21, every mode at N = 131,072, the
    # race check, c5_131k_sharded and c3 on a mesh of this card's shards
    mesh_runs, mesh_launches, ring_shapes, _ = run_sharded_phase(cg, device)
    runs.update(mesh_runs)
    launches.update(mesh_launches)
    main_shapes.update(ring_shapes)
    measure_steps(device)

    kernels = []
    for key, name, src, rep, also in (
            ("rows", "rows_accel", "oc_nbody_tpu_torch/csrc/rows_accel.cu",
             "oc_nbody_tpu/ops/pallas_gravity.py:110",
             "oc_nbody_tpu/ops/pallas_gravity.py:199"),
            ("sym", "sym_accel", "oc_nbody_tpu_torch/csrc/sym_accel.cu",
             "oc_nbody_tpu/ops/pallas_pair.py:256",
             "oc_nbody_tpu/ops/pallas_pair.py:256 (_OP_P)"),
            ("sym_jerk", "sym_jerk", "oc_nbody_tpu_torch/csrc/sym_jerk.cu",
             "oc_nbody_tpu/ops/pallas_pair.py:256 (_OP_J, _pair_jerk :137)",
             None),
            ("rows_jerk", "rows_jerk", "oc_nbody_tpu_torch/csrc/rows_jerk.cu",
             "oc_nbody_tpu/ops/pallas_gravity.py:294", None),
            ("rows_jerk_t", "rows_jerk_t",
             "oc_nbody_tpu_torch/csrc/rows_jerk_t.cu",
             "oc_nbody_tpu/ops/pallas_gravity.py:926 (_sweep_t_jerk :801)",
             None),
            ("sym_x", "sym_accel_x", "oc_nbody_tpu_torch/csrc/sym_accel_x.cu",
             "oc_nbody_tpu/ops/pallas_pair.py:256 (_OP_AX, _pair_accel_x "
             ":174)",
             "oc_nbody_tpu/ops/pallas_pair.py:256 (_OP_PX, _pair_phi_x :182)"),
            ("sym_jerk_x", "sym_jerk_x",
             "oc_nbody_tpu_torch/csrc/sym_jerk_x.cu",
             "oc_nbody_tpu/ops/pallas_pair.py:256 (_OP_JX, _pair_jerk_x "
             ":202)", None),
            ("rows_x", "rows_accel_x",
             "oc_nbody_tpu_torch/csrc/rows_accel_x.cu",
             "oc_nbody_tpu/ops/pallas_gravity.py:1062",
             "oc_nbody_tpu/ops/pallas_gravity.py:1132"),
            ("rows_jerk_x", "rows_jerk_x",
             "oc_nbody_tpu_torch/csrc/rows_jerk_x.cu",
             "oc_nbody_tpu/ops/pallas_gravity.py:1208", None),
            ("rows_df", "rows_accel_df",
             "oc_nbody_tpu_torch/csrc/rows_accel_df.cu",
             "oc_nbody_tpu/ops/pallas_df.py:121", None),
            ("rows_jerk_df", "rows_jerk_df",
             "oc_nbody_tpu_torch/csrc/rows_jerk_df.cu",
             "oc_nbody_tpu/ops/pallas_df.py:186", None),
            ("cross", "cross_accel", "oc_nbody_tpu_torch/csrc/cross_accel.cu",
             "oc_nbody_tpu/ops/pallas_pair.py:296 (_OP_A)",
             "oc_nbody_tpu/ops/pallas_pair.py:296 (_OP_P)"),
            ("cross_jerk", "cross_jerk",
             "oc_nbody_tpu_torch/csrc/cross_jerk.cu",
             "oc_nbody_tpu/ops/pallas_pair.py:296 (_OP_J)", None),
            ("rows_jerk_stream", "rows_jerk_stream",
             "oc_nbody_tpu_torch/csrc/rows_jerk_t.cu",
             "oc_nbody_tpu/ops/pallas_gravity.py:586", None),
            ("cross_x", "cross_accel_x",
             "oc_nbody_tpu_torch/csrc/cross_accel_x.cu",
             "oc_nbody_tpu/ops/pallas_pair.py:296 (_OP_AX, _pair_accel_x "
             ":174)",
             "oc_nbody_tpu/ops/pallas_pair.py:296 (_OP_PX, _pair_phi_x :182)"),
            ("cross_jerk_x", "cross_jerk_x",
             "oc_nbody_tpu_torch/csrc/cross_jerk_x.cu",
             "oc_nbody_tpu/ops/pallas_pair.py:296 (_OP_JX, _pair_jerk_x "
             ":202)", None),
            ("rows_jerk_x_stream", "rows_jerk_x_stream",
             "oc_nbody_tpu_torch/csrc/rows_jerk_x.cu",
             "oc_nbody_tpu/ops/pallas_gravity.py:1415", None),
            ("rows_t", "rows_accel_t",
             "oc_nbody_tpu_torch/csrc/rows_accel_t.cu",
             "oc_nbody_tpu/ops/pallas_gravity.py:857 (_accel_kernel_t, "
             "_sweep_t_accel :763)",
             "oc_nbody_tpu/ops/pallas_gravity.py:913 (_accel_phi_kernel_t, "
             "_sweep_t_phi :869)"),
            ("rows_stream", "rows_accel_t_comp",
             "oc_nbody_tpu_torch/csrc/rows_accel_t.cu",
             "oc_nbody_tpu/ops/pallas_gravity.py:419",
             "oc_nbody_tpu/ops/pallas_gravity.py:495"),
            ("rows_x_stream", "rows_accel_xs",
             "oc_nbody_tpu_torch/csrc/rows_accel_xs.cu",
             "oc_nbody_tpu/ops/pallas_gravity.py:1361",
             "oc_nbody_tpu/ops/pallas_gravity.py:1384"),
            ("ring", "ring_accel", "oc_nbody_tpu_torch/csrc/ring_accel.cu",
             "oc_nbody_tpu/ops/pallas_ring.py:135", None),
            ("ring_phi", "ring_accel_phi",
             "oc_nbody_tpu_torch/csrc/ring_accel.cu",
             "oc_nbody_tpu/ops/pallas_ring.py:169", None),
            ("ring_jerk", "ring_jerk", "oc_nbody_tpu_torch/csrc/ring_jerk.cu",
             "oc_nbody_tpu/ops/pallas_ring.py:202", None),
            ("knn_density", "knn_density",
             "oc_nbody_tpu_torch/csrc/knn_density.cu",
             "none: oc_nbody_tpu/diagnostics.py:148 is plain jnp", None),
            ("phi_f64", "phi_f64", "oc_nbody_tpu_torch/csrc/phi_f64.cu",
             "none: the f64 row of oc_nbody_tpu/diagnostics.py is plain jnp",
             None)):
        m = main_shapes[key]
        bound_ms, bound_by = m["bound"]
        entry = {"name": name, "route": "cuda", "source": src,
                 "replaces": rep,
                 "launches": sum(n[key] for n in launches.values()),
                 "max_abs_err": m["max_abs_err"], "ms": m["ms"],
                 "plain_ms": m["plain_ms"], "bound_ms": bound_ms,
                 "bound_by": bound_by, "library_ms": None,
                 "shape": m["shape"]}
        if also:
            entry["also_replaces"] = also
        kernels.append(entry)
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(smi_line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
