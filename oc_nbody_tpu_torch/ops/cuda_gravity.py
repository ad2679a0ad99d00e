"""The pairwise force on the card: hand-written CUDA kernels for Hopper
(``sm_90a``), each beside its plain PyTorch twin. This module holds the f32
tier (K1-K5, K12-K14, K18) and the extended tier (K6-K9, K15-K17, K19) and builds the
one library all kernels live in; the two-float tier's K10 and K11 are wrapped
in ``ops/cuda_df.py``, the sharded ring's steps K20 and K21
(``csrc/ring_accel.cu``, ``csrc/ring_jerk.cu``) in ``ops/cuda_ring.py``, and
the diagnostics row's CH85 k-th-nearest-neighbour sweep K22
(``csrc/knn_density.cu``) in ``ops/cuda_knn.py`` and its f64 pair potential
K23 (``csrc/phi_f64.cu``) in ``ops/cuda_phi64.py``, which replace no TPU
kernel (the JAX package's ``local_density``, oc_nbody_tpu/diagnostics.py:148,
and its f64 row are plain jnp).

  * K1 ``csrc/rows_accel.cu`` — one-sided rows vs sources, optional
    potential. Replaces the Pallas row-grid kernels ``_accel_kernel`` and
    ``_accel_phi_kernel`` (oc_nbody_tpu/ops/pallas_gravity.py:110, :199).
  * K2 ``csrc/sym_accel.cu`` — pair-symmetric self-interaction, optional
    potential, bitwise deterministic; R rows a thread in registers
    (``csrc/sym_rows.cuh``), its tile geometry chosen from N
    (``sym_geometry``). Replaces ``_make_sym_kernel`` with ``_pair_accel`` /
    ``_pair_phi`` (oc_nbody_tpu/ops/pallas_pair.py:256).
  * K3 ``csrc/sym_jerk.cu`` — pair-symmetric self-interaction accel + jerk,
    bitwise deterministic. Replaces ``_make_sym_kernel`` with ``_pair_jerk``
    (oc_nbody_tpu/ops/pallas_pair.py:256, :137).
  * K4 ``csrc/rows_jerk.cu`` — one-sided rows vs sources accel + jerk.
    Replaces ``_accel_jerk_kernel`` (oc_nbody_tpu/ops/pallas_gravity.py:294).
  * K5 ``csrc/rows_jerk_t.cu`` — one-sided accel + jerk of few rows from
    many sources, the sources split over blocks; a row's bits do not depend
    on the other rows of the launch. Replaces ``_accel_jerk_kernel_t`` with
    ``_sweep_t_jerk`` (oc_nbody_tpu/ops/pallas_gravity.py:926, :801).
  * K12 ``csrc/cross_accel.cu`` — two disjoint sets, each pair once, A's
    action and B's reaction, optional potential, bitwise deterministic; K2's
    register-blocked rows, its geometry chosen from the set sizes
    (``cross_geometry``). Replaces ``_make_cross_kernel`` with
    ``_pair_accel`` / ``_pair_phi`` (oc_nbody_tpu/ops/pallas_pair.py:296).
  * K13 ``csrc/cross_jerk.cu`` — the same for accel + jerk, on the
    register-blocked rows of ``csrc/jerk_rows.cuh``, its geometry chosen
    from the set sizes (``cross_geometry(nA, nB, "cross_jerk")``). Replaces
    ``_make_cross_kernel`` with ``_pair_jerk`` (pallas_pair.py:296, :137).
  * K14, K5's compensated variant (``csrc/rows_jerk_t.cu``, Kahan steps
    across source stages and chunks) — accel + jerk of any number of rows
    from more than ``STREAM_N`` sources. Replaces
    ``_accel_jerk_stream_kernel`` (pallas_gravity.py:586).
  * K18 ``csrc/rows_accel_t.cu`` — one-sided accel, optional potential,
    of few rows from many sources, the sources split over blocks as in K5;
    a row's bits do not depend on the other rows of the launch. Replaces
    ``_accel_kernel_t`` / ``_sweep_t_accel`` and ``_accel_phi_kernel_t`` /
    ``_sweep_t_phi`` (pallas_gravity.py:857, :763, :913, :869).
  * K18<comp>, K18's compensated variant (the same source, Kahan steps
    across source stages and chunks on the accel and on the potential) —
    rows from more than ``STREAM_N`` sources. Replaces
    ``_accel_stream_kernel`` and ``_accel_phi_stream_kernel``
    (pallas_gravity.py:419, :495).

and the extended (hi/lo) precision tier, on pre-split f32 planes:

  * K6 ``csrc/sym_accel_x.cu`` — pair-symmetric self-interaction, optional
    raw potential, bitwise deterministic; K2's register-blocked rows and
    tile geometry with the hi/lo rows (``csrc/sym_rows.cuh``, the ``Ext``
    tier; ``sym_geometry(n, "sym_x")``). Replaces ``_make_sym_kernel`` with
    ``_pair_accel_x`` / ``_pair_phi_x`` (oc_nbody_tpu/ops/pallas_pair.py:256,
    :174, :182).
  * K7 ``csrc/sym_jerk_x.cu`` — pair-symmetric self-interaction accel +
    jerk, bitwise deterministic. Replaces ``_make_sym_kernel`` with
    ``_pair_jerk_x`` (oc_nbody_tpu/ops/pallas_pair.py:256, :202).
  * K8 ``csrc/rows_accel_x.cu`` — one-sided rows vs sources, optional raw
    potential. Replaces ``_accel_kernel_x`` and ``_accel_phi_kernel_x``
    (oc_nbody_tpu/ops/pallas_gravity.py:1062, :1132).
  * K9 ``csrc/rows_jerk_x.cu`` — one-sided accel + jerk of rows from
    sources, the sources split over blocks as in K5; a row's bits do not
    depend on the other rows of the launch. Replaces
    ``_accel_jerk_kernel_x`` (oc_nbody_tpu/ops/pallas_gravity.py:1208).
  * K15 ``csrc/cross_accel_x.cu`` — two disjoint sets, each pair once, A's
    action and B's reaction, optional raw potential, bitwise deterministic;
    K12's register-blocked plan with the hi/lo rows (``cross_geometry(nA,
    nB, "cross_x")``). Replaces ``_make_cross_kernel`` with
    ``_pair_accel_x`` / ``_pair_phi_x``
    (oc_nbody_tpu/ops/pallas_pair.py:296).
  * K16 ``csrc/cross_jerk_x.cu`` — the same for accel + jerk, on K13's
    register-blocked plan (``csrc/jerk_rows.cuh``). Replaces
    ``_make_cross_kernel`` with ``_pair_jerk_x`` (pallas_pair.py:296, :202).
  * K17, K9's compensated variant (``csrc/rows_jerk_x.cu``, Kahan steps
    across source stages and chunks) — accel + jerk of rows from more than
    ``STREAM_N`` sources, or of more than ``RT_MAX_ROWS`` rows. Replaces
    ``_accel_jerk_stream_kernel_x`` (pallas_gravity.py:1415).
  * K19 ``csrc/rows_accel_xs.cu`` — one-sided accel, optional raw
    potential, of rows from sources with Kahan steps across source stages
    and chunks, in K17's layout — past ``STREAM_N`` sources or
    ``RT_MAX_ROWS`` rows. Replaces ``_accel_stream_kernel_x`` and
    ``_accel_phi_stream_kernel_x`` (pallas_gravity.py:1361, :1384).

The public wrappers keep the signatures and return contracts of
``oc_nbody_tpu.ops.pallas_gravity``: ``accel_rows`` and
``accel_potential_rows`` take centred f32 rows and sources and return f32
(the rows potential includes the softened self term; K18<comp> past
``STREAM_N`` sources at any row count, K18 from ``RT_MIN_ACCEL`` sources
with at most ``RT_MAX_ROWS`` rows, K1 otherwise); ``accel_sym``,
``accel_potential_sym``, ``accel`` and ``accel_potential`` take the state's
positions, centre and cast them, and return the positions' dtype with the
self term removed from the potential. ``accel_jerk_rows`` takes centred f32
rows and sources with their velocities and returns f32 (K14 past
``STREAM_N`` sources; K5 for at least ``RT_MIN_JERK`` sources and at most
``RT_MAX_ROWS`` rows; K4 otherwise); ``accel_jerk_sym`` and ``accel_jerk``
take the state's positions and velocities, centre both and return the
positions' dtype.

Past ``STREAM_N`` particles the f32 self-interaction is chunked as in the
JAX package (``accel_sym_chunked``, ``accel_potential_sym_chunked``,
``accel_jerk_sym_chunked``): ONE centring of the whole set, then chunks of
``CHUNK_SYM`` (``CHUNK_SYMJ`` for the jerk) particles, the last one ragged;
each diagonal chunk through K2 or K3, each unordered chunk pair (i < j)
through K12 or K13, added in the JAX package's order (the diagonal outputs,
then the pairs in lexicographic order, A into chunk i, B into chunk j), and
``self_phi`` once at the end; under a profiler the evaluation and each
tile are spans (``_chunked_sum``). ``accel_cross_pair``,
``accel_potential_cross_pair`` and ``accel_jerk_cross_pair`` are the
disjoint-set forms on f32-ready inputs centred in one frame.

The extended tier follows the same module of the JAX package:
``accel_rows_x_hilo``, ``accel_potential_rows_x_hilo`` and
``accel_jerk_rows_x_hilo`` take (hi, lo) f32 planes split under ONE
centring and gm = G·m in f32, and return f32; ``accel_sym_x``,
``accel_potential_sym_x``, ``accel_jerk_sym_x``, ``accel_x``,
``accel_potential_x``, ``accel_jerk_x`` and ``accel_jerk_rows_x`` take the
f64 state, centre and split it (``gravity.prepare_x``) and return the
positions' dtype. The potential of this tier is RAW: it keeps the softened
self term -G m/eps, and the caller adds ``gravity.self_phi`` (in f64). All
three self-interaction forms take the pair-symmetric kernel from
``SYM_MIN``, the jerk too, and past ``STREAM_N`` go chunked as the f32 tier
does (``accel_sym_x_chunked``, ``accel_potential_sym_x_chunked``,
``accel_jerk_sym_x_chunked``: ONE centring and hi/lo split of the whole
set, ``CHUNK_SYMX`` particles a chunk (``CHUNK_SYMXJ`` for the jerk), K6
or K7 on the diagonal chunks and K15 or K16 on the chunk pairs);
``accel_cross_pair_x_hilo`` & co. are the disjoint-set forms on pre-split
planes.
``accel_jerk_rows_x_hilo`` takes K17 past ``STREAM_N`` sources or
``RT_MAX_ROWS`` rows, and the rows accel forms (``accel_rows_x_hilo``,
``accel_potential_rows_x_hilo``) take K19 there, K8 otherwise; escape
pruning reaches both. ``rows_route`` names the kernel every rows-vs-sources
call takes, and ``route`` the kernels of a run, pruned or not.

Every launch goes to the current CUDA device: a caller with tensors on
another card launches under ``on_device`` (the sharded force does, per
shard). A wrapper launches its kernel for CUDA tensors and calls the plain twin
(``rows_plain``, ``sym_plain``, ``rows_jerk_plain``, ``sym_jerk_plain``,
``rows_jerk_t_plain``, ``rows_jerk_stream_plain``, ``cross_plain``,
``cross_jerk_plain``, built on
``ops/gravity.py``; ``rows_x_plain``, ``sym_x_plain``,
``rows_jerk_x_plain``, ``sym_jerk_x_plain``, ``cross_x_plain``,
``cross_jerk_x_plain``, ``rows_jerk_x_stream_plain``,
``rows_x_stream_plain``, built on ``ops/df32.py``) for CPU tensors; there
is no fallback from one to the other. ``LAUNCHES`` counts kernel launches and ``PLAIN_CALLS`` calls
of the plain twins, so a run can show which one it went through.

The kernels are built with ``nvcc`` into ``build/oc_nbody_tpu_torch/`` at
first use (one ``nvcc -c`` per source, all started together, then one
link) and loaded with ``ctypes``. The build fails loudly (RuntimeError with
the compiler's output) if ``nvcc`` is missing or refuses a source.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from oc_nbody_tpu_torch.ops import df32, gravity
from oc_nbody_tpu_torch.utils.profiling import span

# Self-interaction dispatch: the pair-symmetric K2 for SYM_MIN <= N <=
# STREAM_N, chunked (K2 + K12) past it, the one-sided K1 below. SYM_MIN is
# the TPU's crossover (pallas_gravity.py:1686); the H100 crossover has not
# been measured yet.
SYM_MIN = 8192
# The same rule for accel + jerk: K3 for RT_MIN_JERK <= N <= STREAM_N, K4
# below (the TPU's jerk crossover, pallas_gravity.py:727, :2272). For rows
# against other sources it picks K5 over K4 from RT_MIN_JERK sources, up to
# RT_MAX_ROWS rows (pallas_gravity.py:356-360, :739); the H100 crossover
# between K4 and K5 is measured by chip_smoke.py, not used here.
RT_MIN_JERK = 16384
RT_MAX_ROWS = 65536
# The same for the rows accel forms: K18 over K1 from RT_MIN_ACCEL sources,
# up to RT_MAX_ROWS rows (the TPU's crossover, pallas_gravity.py:726; the
# H100's is not measured; chip_smoke.py times K1 beside K18 at escape
# pruning's shapes).
RT_MIN_ACCEL = 32768
# Largest N the resident sym kernels take (pallas_gravity.py:2233-2276);
# past it the self-interaction is chunked and rows against more sources
# take K14 (K17 at the extended tier). The df32 tier stops here
# (scene.check_supported).
STREAM_N = 262144
# Chunk sizes of the chunked self-interaction (pallas_gravity.py:1718-1719).
# These are the TPU's values, set by its 16 MiB scoped VMEM; the port keeps
# them for the same chunk layout (8 chunks at 1M, 16 at 2M). Here they bound
# the per-evaluation scratch instead: 4.3 GB (accel) and 3.6 GB (jerk).
CHUNK_SYM = 131072
CHUNK_SYMJ = 98304
# The extended tier's (pallas_gravity.py:1720-1721), kept likewise: 11
# chunks at 1M (15 for the jerk); scratch 2.4 GB (accel) and 2.0 GB (jerk).
CHUNK_SYMX = 98304
CHUNK_SYMXJ = 73728

_KERNELS = ("rows", "sym", "rows_jerk", "sym_jerk", "rows_jerk_t", "sym_x",
            "sym_jerk_x", "rows_x", "rows_jerk_x", "rows_df", "rows_jerk_df",
            "cross", "cross_jerk", "rows_jerk_stream", "cross_x",
            "cross_jerk_x", "rows_jerk_x_stream", "rows_t", "rows_stream",
            "rows_x_stream", "ring", "ring_phi", "ring_jerk", "knn_density",
            "phi_f64")
LAUNCHES = dict.fromkeys(_KERNELS, 0)
PLAIN_CALLS = dict.fromkeys(_KERNELS, 0)

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "oc_nbody_tpu_torch"
_HEADERS = ("pair.cuh", "sym_rows.cuh", "jerk_rows.cuh", "rows_split.cuh",
            "rows_accel_t.cuh", "rows_jerk_t.cuh", "df.cuh")
_SOURCES = ("rows_accel.cu", "sym_accel.cu", "rows_jerk.cu", "sym_jerk.cu",
            "rows_jerk_t.cu", "sym_accel_x.cu", "sym_jerk_x.cu",
            "rows_accel_x.cu", "rows_jerk_x.cu", "rows_accel_df.cu",
            "rows_jerk_df.cu", "df_selftest.cu", "cross_accel.cu",
            "cross_jerk.cu", "cross_accel_x.cu", "cross_jerk_x.cu",
            "rows_accel_t.cu", "rows_accel_xs.cu", "ring_accel.cu",
            "ring_jerk.cu", "knn_density.cu", "phi_f64.cu")
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib = None
# what nvcc printed for the build this process loaded (register and
# shared-memory use per kernel, from -Xptxas -v); empty for a cached build
BUILD_LOG = ""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME/bin: the CUDA gravity "
        "kernels cannot be built, and the port has no fallback for CUDA "
        "tensors")


def build_library() -> Path:
    """Compile the kernels (once per source version) and return the path of
    the shared library: one ``nvcc -c`` per source, all running at once,
    then one ``nvcc -shared`` link. Raises RuntimeError if nvcc is missing
    or fails."""
    global BUILD_LOG
    digest = hashlib.sha256()
    for name in _HEADERS + _SOURCES:
        digest.update((CSRC / name).read_bytes())
    digest.update(" ".join(_NVCC_FLAGS).encode())
    out = BUILD_DIR / f"libocn_gravity_{digest.hexdigest()[:12]}.so"
    if out.is_file():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        tmp = Path(tmp)
        jobs = []
        for src in _SOURCES:
            obj = tmp / (Path(src).stem + ".o")
            cmd = [nvcc, *_NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC / src)]
            log = open(tmp / (src + ".log"), "w+")
            jobs.append((cmd, obj, log, subprocess.Popen(
                cmd, stdout=log, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for cmd, _, log, proc in jobs:
            code = proc.wait()
            log.seek(0)
            logs.append(log.read())
            log.close()
            if code != 0:
                failed.append(f"nvcc failed ({code}): {' '.join(cmd)}\n"
                              f"{logs[-1]}")
        if failed:
            raise RuntimeError("\n".join(failed))
        lib = tmp / "lib.so"
        cmd = [nvcc, "-shared", "-o", str(lib),
               *(str(obj) for _, obj, _, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(lib, out)  # atomic: concurrent builds race harmlessly
    BUILD_LOG = "".join(logs)
    return out


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library()))
        p, i, f, d = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                      ctypes.c_double)
        lib.ocn_rows_accel.argtypes = [p, i, p, p, i, f, f, i, p, p, p]
        lib.ocn_rows_accel.restype = i
        lib.ocn_sym_accel.argtypes = [p, p, i, f, f, i, i, p, p, p, p]
        lib.ocn_sym_accel.restype = i
        lib.ocn_sym_geometry.argtypes = [i]
        lib.ocn_sym_geometry.restype = i
        lib.ocn_sym_scratch.argtypes = [i, i]
        lib.ocn_sym_scratch.restype = ctypes.c_longlong
        lib.ocn_rows_jerk.argtypes = [p, p, i, p, p, p, i, f, f, i, p, p, p]
        lib.ocn_rows_jerk.restype = i
        lib.ocn_sym_jerk.argtypes = [p, p, p, i, f, f, i, p, p, p, p]
        lib.ocn_sym_jerk.restype = i
        lib.ocn_rows_jerk_t.argtypes = [p, p, i, p, p, p, i, f, f, i, i, p,
                                        p, p, p]
        lib.ocn_rows_jerk_t.restype = i
        lib.ocn_rows_jerk_t_scratch.argtypes = [i, i]
        lib.ocn_rows_jerk_t_scratch.restype = ctypes.c_longlong
        lib.ocn_rows_accel_x.argtypes = [p, p, i, p, p, p, i, f, i, p, p, p]
        lib.ocn_rows_accel_x.restype = i
        lib.ocn_sym_accel_x.argtypes = [p, p, p, i, f, i, i, p, p, p, p]
        lib.ocn_sym_accel_x.restype = i
        lib.ocn_sym_x_geometry.argtypes = [i]
        lib.ocn_sym_x_geometry.restype = i
        lib.ocn_sym_x_scratch.argtypes = [i, i]
        lib.ocn_sym_x_scratch.restype = ctypes.c_longlong
        lib.ocn_sym_jerk_x.argtypes = [p, p, p, p, p, i, f, i, p, p, p, p]
        lib.ocn_sym_jerk_x.restype = i
        lib.ocn_rows_jerk_x.argtypes = [p, p, p, p, i, p, p, p, p, p, i, f,
                                        i, i, p, p, p, p]
        lib.ocn_rows_jerk_x.restype = i
        lib.ocn_rows_jerk_x_scratch.argtypes = [i, i]
        lib.ocn_rows_jerk_x_scratch.restype = ctypes.c_longlong
        lib.ocn_rows_accel_df.argtypes = [p, p, i, p, p, p, p, i, f, f, i, p,
                                          p, p, p]
        lib.ocn_rows_accel_df.restype = i
        lib.ocn_rows_accel_df_scratch.argtypes = [i, i]
        lib.ocn_rows_accel_df_scratch.restype = ctypes.c_longlong
        lib.ocn_rows_jerk_df.argtypes = [p, p, p, p, i, p, p, p, p, p, p, i,
                                         f, f, i, p, p, p, p, p, p]
        lib.ocn_rows_jerk_df.restype = i
        lib.ocn_rows_jerk_df_scratch.argtypes = [i, i]
        lib.ocn_rows_jerk_df_scratch.restype = ctypes.c_longlong
        lib.ocn_df_selftest.argtypes = [p, p, p, p, i, p, p]
        lib.ocn_df_selftest.restype = i
        lib.ocn_cross_accel.argtypes = [p, p, i, p, p, i, f, f, i, i, p, p,
                                        p, p, p, p]
        lib.ocn_cross_accel.restype = i
        lib.ocn_cross_geometry.argtypes = [i, i]
        lib.ocn_cross_geometry.restype = i
        lib.ocn_cross_accel_scratch.argtypes = [i, i, i]
        lib.ocn_cross_accel_scratch.restype = ctypes.c_longlong
        lib.ocn_cross_jerk.argtypes = [p, p, p, i, p, p, p, i, f, f, i, i,
                                       p, p, p, p, p, p]
        lib.ocn_cross_jerk.restype = i
        lib.ocn_cross_jerk_geometry.argtypes = [i, i]
        lib.ocn_cross_jerk_geometry.restype = i
        lib.ocn_cross_jerk_scratch.argtypes = [i, i, i]
        lib.ocn_cross_jerk_scratch.restype = ctypes.c_longlong
        lib.ocn_cross_accel_x.argtypes = [p, p, p, i, p, p, p, i, f, i, i, p,
                                          p, p, p, p, p]
        lib.ocn_cross_accel_x.restype = i
        lib.ocn_cross_x_geometry.argtypes = [i, i]
        lib.ocn_cross_x_geometry.restype = i
        lib.ocn_cross_x_scratch.argtypes = [i, i, i]
        lib.ocn_cross_x_scratch.restype = ctypes.c_longlong
        lib.ocn_cross_jerk_x.argtypes = [p, p, p, p, p, i, p, p, p, p, p, i,
                                         f, i, i, p, p, p, p, p, p]
        lib.ocn_cross_jerk_x.restype = i
        lib.ocn_cross_jerk_x_geometry.argtypes = [i, i]
        lib.ocn_cross_jerk_x_geometry.restype = i
        lib.ocn_cross_jerk_x_scratch.argtypes = [i, i, i]
        lib.ocn_cross_jerk_x_scratch.restype = ctypes.c_longlong
        lib.ocn_rows_accel_t.argtypes = [p, i, p, p, i, f, f, i, i, p, p, p,
                                         p]
        lib.ocn_rows_accel_t.restype = i
        lib.ocn_rows_accel_t_scratch.argtypes = [i, i, i]
        lib.ocn_rows_accel_t_scratch.restype = ctypes.c_longlong
        lib.ocn_rows_accel_xs.argtypes = [p, p, i, p, p, p, i, f, i, p, p, p,
                                          p]
        lib.ocn_rows_accel_xs.restype = i
        lib.ocn_rows_accel_xs_scratch.argtypes = [i, i, i]
        lib.ocn_rows_accel_xs_scratch.restype = ctypes.c_longlong
        lib.ocn_ring_accel.argtypes = [p, i, p, p, i, f, i, i, p, p, p, p,
                                       p, p]
        lib.ocn_ring_accel.restype = i
        lib.ocn_ring_accel_scratch.argtypes = [i, i, i]
        lib.ocn_ring_accel_scratch.restype = ctypes.c_longlong
        lib.ocn_ring_jerk.argtypes = [p, p, i, p, p, p, i, f, i, i, p, p, p,
                                      p, p, p]
        lib.ocn_ring_jerk.restype = i
        lib.ocn_ring_jerk_scratch.argtypes = [i, i]
        lib.ocn_ring_jerk_scratch.restype = ctypes.c_longlong
        lib.ocn_knn_density.argtypes = [p, i, p, i, i, p, p, p]
        lib.ocn_knn_density.restype = i
        lib.ocn_phi_f64.argtypes = [p, i, d, d, i, p, p, p]
        lib.ocn_phi_f64.restype = i
        lib.ocn_phi_f64_scratch.argtypes = [i]
        lib.ocn_phi_f64_scratch.restype = ctypes.c_longlong
        lib.ocn_sym_tile.argtypes = []
        lib.ocn_sym_tile.restype = i
        lib.ocn_error_string.argtypes = [i]
        lib.ocn_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check_launch(lib, code: int, name: str) -> None:
    if code != 0:
        msg = lib.ocn_error_string(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {code} "
                           f"({msg})")


def _on_cuda(*tensors) -> bool:
    """True for CUDA tensors (-> kernel), False for CPU tensors (-> plain
    twin); anything else, or a mix, is refused."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"tensors must all be on one CUDA device or all on the "
                     f"CPU; got devices {sorted(kinds)}")


def _check_f32(name, t, shape):
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _f32(x) -> float:
    return gravity.rounded(x, torch.float32)


def _stream(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def on_device(device):
    """The context to launch kernels for tensors on ``device`` in: that
    CUDA device made current (a no-op on the CPU). A launch goes to the
    current device, and a device's default stream has the handle 0, so
    tensors on another card than the current one are launched on under
    their own device, or the launch would run on the current card, unordered
    with their stream."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


# --------------------------------------------------------------------------
# plain twins (the reference the kernels are held to; CPU path)
# --------------------------------------------------------------------------

def rows_plain(rows, src, mass, eps, G=1.0, with_phi=False,
               dtype=torch.float32, chunk=1024, key="rows"):
    """K1's function in plain PyTorch, computed in ``dtype`` (f64: the
    oracle the kernel is held to on the card). Returns acc, or (acc, phi)
    with the self term kept, in ``dtype``. It is K18's and K18<comp>'s
    function too, counted under ``key`` ("rows_t", "rows_stream"; its f32
    sum is not compensated, the f64 one is the oracle)."""
    PLAIN_CALLS[key] += 1
    rows, src, mass = rows.to(dtype), src.to(dtype), mass.to(dtype)
    fn = gravity.accel_potential_rows if with_phi else gravity.accel_rows
    return fn(rows, src, mass, eps, G, chunk)


def sym_plain(pos_c, mass_c, eps, G=1.0, with_phi=False,
              dtype=torch.float32, chunk=1024):
    """K2's function in plain PyTorch: the self-interaction of centred
    ``pos_c`` summed one-sidedly in ``dtype``. Same return contract as
    ``rows_plain`` (the potential keeps the self term)."""
    PLAIN_CALLS["sym"] += 1
    pos_c, mass_c = pos_c.to(dtype), mass_c.to(dtype)
    fn = gravity.accel_potential_rows if with_phi else gravity.accel_rows
    return fn(pos_c, pos_c, mass_c, eps, G, chunk)


def _jerk_plain(key, rows, vrows, src, svel, mass, eps, G, dtype, chunk):
    """The accel + jerk rows sum in ``dtype``, counted under ``key``."""
    PLAIN_CALLS[key] += 1
    rows, vrows, src, svel, mass = (t.to(dtype) for t in
                                    (rows, vrows, src, svel, mass))
    return gravity.accel_jerk_rows(rows, vrows, src, svel, mass, eps, G,
                                   chunk)


def rows_jerk_plain(rows, vrows, src, svel, mass, eps, G=1.0,
                    dtype=torch.float32, chunk=1024):
    """K4's function in plain PyTorch, computed in ``dtype`` (f64: the
    oracle the kernel is held to on the card). Returns (acc, jerk) in
    ``dtype``."""
    return _jerk_plain("rows_jerk", rows, vrows, src, svel, mass, eps, G,
                       dtype, chunk)


def rows_jerk_t_plain(rows, vrows, src, svel, mass, eps, G=1.0,
                      dtype=torch.float32, chunk=1024):
    """K5's function in plain PyTorch: K4's function, counted apart."""
    return _jerk_plain("rows_jerk_t", rows, vrows, src, svel, mass, eps, G,
                       dtype, chunk)


def sym_jerk_plain(pos_c, vel_c, mass_c, eps, G=1.0, dtype=torch.float32,
                   chunk=1024):
    """K3's function in plain PyTorch: the accel + jerk self-interaction of
    centred ``pos_c`` / ``vel_c`` summed one-sidedly in ``dtype``."""
    return _jerk_plain("sym_jerk", pos_c, vel_c, pos_c, vel_c, mass_c, eps,
                       G, dtype, chunk)


def rows_jerk_stream_plain(rows, vrows, src, svel, mass, eps, G=1.0,
                           dtype=torch.float32, chunk=1024):
    """K14's function in plain PyTorch: K4's function, counted apart (its
    f32 sum is not compensated; the f64 one is the oracle)."""
    return _jerk_plain("rows_jerk_stream", rows, vrows, src, svel, mass, eps,
                       G, dtype, chunk)


def cross_plain(posA, posB, massA, massB, eps, G=1.0, with_phi=False,
                dtype=torch.float32, chunk=1024):
    """K12's function in plain PyTorch, computed in ``dtype``: (accA, accB),
    or (accA, phiA, accB, phiB) with ``with_phi``."""
    PLAIN_CALLS["cross"] += 1
    posA, posB, massA, massB = (t.to(dtype) for t in
                                (posA, posB, massA, massB))
    fn = (gravity.accel_potential_cross_pair if with_phi
          else gravity.accel_cross_pair)
    return fn(posA, posB, massA, massB, eps, G, chunk)


def cross_jerk_plain(posA, velA, posB, velB, massA, massB, eps, G=1.0,
                     dtype=torch.float32, chunk=1024):
    """K13's function in plain PyTorch, computed in ``dtype``: (accA,
    jerkA, accB, jerkB)."""
    PLAIN_CALLS["cross_jerk"] += 1
    args = (t.to(dtype) for t in (posA, velA, posB, velB, massA, massB))
    return gravity.accel_jerk_cross_pair(*args, eps, G, chunk)


def rows_x_plain(rhi, rlo, shi, slo, gm, eps, with_phi=False,
                 dtype=torch.float32, chunk=256, guarded=True):
    """K8's function in plain PyTorch on the same (hi, lo) planes, computed
    in ``dtype`` (f32: the tier, in the kernel's order of operations per
    pair; f64: the oracle the kernel is held to on the card). Returns acc,
    or (acc, raw phi), in ``dtype``."""
    PLAIN_CALLS["rows_x"] += 1
    fn = (df32.accel_potential_rows_x_hilo if with_phi
          else df32.accel_rows_x_hilo)
    return fn(rhi, rlo, shi, slo, gm, eps, chunk, guarded, dtype)


def sym_x_plain(hi, lo, gm, eps, with_phi=False, dtype=torch.float32,
                chunk=256, guarded=True):
    """K6's function in plain PyTorch: the self-interaction of the planes
    summed one-sidedly in ``dtype``; ``rows_x_plain``'s return contract."""
    PLAIN_CALLS["sym_x"] += 1
    fn = (df32.accel_potential_rows_x_hilo if with_phi
          else df32.accel_rows_x_hilo)
    return fn(hi, lo, hi, lo, gm, eps, chunk, guarded, dtype)


def rows_jerk_x_plain(rhi, rlo, vhi, vlo, shi, slo, svhi, svlo, gm, eps,
                      dtype=torch.float32, chunk=256, guarded=True):
    """K9's function in plain PyTorch, computed in ``dtype``; (acc, jerk)."""
    PLAIN_CALLS["rows_jerk_x"] += 1
    return df32.accel_jerk_rows_x_hilo(rhi, rlo, vhi, vlo, shi, slo, svhi,
                                       svlo, gm, eps, chunk, guarded, dtype)


def sym_jerk_x_plain(hi, lo, vhi, vlo, gm, eps, dtype=torch.float32,
                     chunk=256, guarded=True):
    """K7's function in plain PyTorch: the accel + jerk self-interaction of
    the planes summed one-sidedly in ``dtype``."""
    PLAIN_CALLS["sym_jerk_x"] += 1
    return df32.accel_jerk_rows_x_hilo(hi, lo, vhi, vlo, hi, lo, vhi, vlo,
                                       gm, eps, chunk, guarded, dtype)


def rows_jerk_x_stream_plain(rhi, rlo, vhi, vlo, shi, slo, svhi, svlo, gm,
                             eps, dtype=torch.float32, chunk=256,
                             guarded=True):
    """K17's function in plain PyTorch: K9's function, counted apart (its
    f32 sum is not compensated; the f64 one is the oracle)."""
    PLAIN_CALLS["rows_jerk_x_stream"] += 1
    return df32.accel_jerk_rows_x_hilo(rhi, rlo, vhi, vlo, shi, slo, svhi,
                                       svlo, gm, eps, chunk, guarded, dtype)


def rows_x_stream_plain(rhi, rlo, shi, slo, gm, eps, with_phi=False,
                        dtype=torch.float32, chunk=256, guarded=True):
    """K19's function in plain PyTorch: K8's function, counted apart (its
    f32 sum is not compensated; the f64 one is the oracle)."""
    PLAIN_CALLS["rows_x_stream"] += 1
    fn = (df32.accel_potential_rows_x_hilo if with_phi
          else df32.accel_rows_x_hilo)
    return fn(rhi, rlo, shi, slo, gm, eps, chunk, guarded, dtype)


def cross_x_plain(hiA, loA, hiB, loB, gmA, gmB, eps, with_phi=False,
                  dtype=torch.float32, chunk=256, guarded=True):
    """K15's function in plain PyTorch on the same (hi, lo) planes, computed
    in ``dtype``: (accA, accB), or (accA, phiA, accB, phiB) with
    ``with_phi``."""
    PLAIN_CALLS["cross_x"] += 1
    fn = (df32.accel_potential_cross_pair_x_hilo if with_phi
          else df32.accel_cross_pair_x_hilo)
    return fn(hiA, loA, hiB, loB, gmA, gmB, eps, chunk, guarded, dtype)


def cross_jerk_x_plain(hiA, loA, vhiA, vloA, hiB, loB, vhiB, vloB, gmA, gmB,
                       eps, dtype=torch.float32, chunk=256, guarded=True):
    """K16's function in plain PyTorch, computed in ``dtype``: (accA, jerkA,
    accB, jerkB)."""
    PLAIN_CALLS["cross_jerk_x"] += 1
    return df32.accel_jerk_cross_pair_x_hilo(hiA, loA, vhiA, vloA, hiB, loB,
                                             vhiB, vloB, gmA, gmB, eps, chunk,
                                             guarded, dtype)


# --------------------------------------------------------------------------
# kernel launches
# --------------------------------------------------------------------------

def _scratch(floats: int, device, scratch=None):
    """``floats`` f32 of kernel scratch: a new buffer, or ``scratch`` (a
    caller's buffer, reused across launches) when it is large enough."""
    if scratch is None:
        return torch.empty((floats,), dtype=torch.float32, device=device)
    if (scratch.dtype != torch.float32 or scratch.device != device
            or not scratch.is_contiguous() or scratch.numel() < floats):
        raise ValueError(f"scratch must be a contiguous float32 tensor of at "
                         f"least {floats} elements on {device}")
    return scratch


# The tile geometries of the register-blocked kernels K2, K6, K12, K15
# (csrc/sym_rows.cuh), K13 and K16 (csrc/jerk_rows.cuh): (R, S), R rows a
# thread and S parts of a tile pair's columns. The kernels pick one from the
# sizes alone (``sym_geometry``, ``cross_geometry``); the ``geometry``
# argument of ``sym_kernel``, ``sym_x_kernel``, ``cross_kernel``,
# ``cross_x_kernel``, ``cross_jerk_kernel`` and ``cross_jerk_x_kernel``
# names another, for the tests and the geometry sweep of
# sym_kernel_times.py. All six compile every one of them without spilling
# (ptxas -v).
GEOMETRIES = tuple((r, s) for r in (1, 2, 4, 8) for s in (1, 2, 4, 8)
                   if s <= r)


def _geom(geometry) -> int:
    """(R, S) encoded as the library takes it (0: chosen by the sizes)."""
    if geometry is None:
        return 0
    if tuple(geometry) not in GEOMETRIES:
        raise ValueError(f"geometry must be one of {GEOMETRIES}, got "
                         f"{geometry!r}")
    return geometry[0] * 16 + geometry[1]


def sym_geometry(n: int, kernel: str = "sym") -> tuple[int, int]:
    """The (R, S) of the register-blocked self-interaction ``kernel`` (by
    its launch key: "sym" K2, "sym_x" K6) at N = n."""
    export = {"sym": "ocn_sym_geometry",
              "sym_x": "ocn_sym_x_geometry"}.get(kernel)
    if export is None:
        raise ValueError(f"no register-blocked pair-symmetric kernel "
                         f"{kernel!r}")
    return divmod(getattr(_library(), export)(n), 16)


def cross_geometry(nA: int, nB: int, kernel: str = "cross") -> tuple[int, int]:
    """The (R, S) of the cross ``kernel`` (by its launch key: "cross" K12,
    "cross_x" K15, "cross_jerk" K13, "cross_jerk_x" K16) on nA x nB."""
    export = {"cross": "ocn_cross_geometry",
              "cross_x": "ocn_cross_x_geometry",
              "cross_jerk": "ocn_cross_jerk_geometry",
              "cross_jerk_x": "ocn_cross_jerk_x_geometry"}.get(kernel)
    if export is None:
        raise ValueError(f"no register-blocked cross kernel {kernel!r}")
    return divmod(getattr(_library(), export)(nA, nB), 16)


def sym_scratch_floats(n: int, kernel: str = "sym", geometry=None) -> int:
    """Floats of scratch the pair-symmetric ``kernel`` (by its launch key:
    "sym" K2, "sym_jerk" K3, "sym_x" K6, "sym_jerk_x" K7) needs at N = n.
    K2's and K6's come from the kernel's own export (in ``geometry``,
    default its own); K3 and K7 tile by ``ocn_sym_tile()``: nt x nt x T
    slots of six floats."""
    lib = _library()
    sized = {"sym": lib.ocn_sym_scratch, "sym_x": lib.ocn_sym_x_scratch}
    if kernel in sized:
        return sized[kernel](n, _geom(geometry))
    if kernel not in ("sym_jerk", "sym_jerk_x"):
        raise ValueError(f"no pair-symmetric kernel {kernel!r}")
    t = lib.ocn_sym_tile()
    nt = -(-n // t)
    return nt * nt * t * 6


def rows_kernel(rows, src, mass, eps, G=1.0, with_phi=False, guarded=True):
    """Launch K1 on centred f32 CUDA tensors; the same contract as
    ``rows_plain``."""
    nr, ns = rows.shape[0], src.shape[0]
    _check_f32("pos_rows", rows, (nr, 3))
    _check_f32("src_pos", src, (ns, 3))
    _check_f32("src_mass", mass, (ns,))
    lib = _library()
    acc = torch.empty((nr, 3), dtype=torch.float32, device=rows.device)
    phi = (torch.empty((nr,), dtype=torch.float32, device=rows.device)
           if with_phi else None)
    code = lib.ocn_rows_accel(
        rows.data_ptr(), nr, src.data_ptr(), mass.data_ptr(), ns, _f32(G),
        _f32(_f32(eps) ** 2), int(guarded), acc.data_ptr(),
        phi.data_ptr() if with_phi else None, _stream(rows))
    LAUNCHES["rows"] += 1
    _check_launch(lib, code, "rows_accel")
    return (acc, phi) if with_phi else acc


def rows_t_kernel(rows, src, mass, eps, G=1.0, with_phi=False,
                  guarded=True):
    """Launch K18 (both passes) on centred f32 CUDA tensors; the same
    contract as ``rows_plain``."""
    return _rows_accel_t_launch("rows_t", False, rows, src, mass, eps, G,
                                with_phi, guarded)


def rows_stream_kernel(rows, src, mass, eps, G=1.0, with_phi=False,
                       guarded=True):
    """Launch K18<comp>, K18 with Kahan steps across source stages and
    chunks, on centred f32 CUDA tensors; the same contract as
    ``rows_plain``."""
    return _rows_accel_t_launch("rows_stream", True, rows, src, mass, eps, G,
                                with_phi, guarded)


def _rows_accel_t_launch(key, compensated, rows, src, mass, eps, G, with_phi,
                         guarded):
    nr, ns = rows.shape[0], src.shape[0]
    _check_f32("pos_rows", rows, (nr, 3))
    _check_f32("src_pos", src, (ns, 3))
    _check_f32("src_mass", mass, (ns,))
    lib = _library()
    dev = rows.device
    scratch = torch.empty((lib.ocn_rows_accel_t_scratch(nr, ns,
                                                        int(with_phi)),),
                          dtype=torch.float32, device=dev)
    acc = torch.empty((nr, 3), dtype=torch.float32, device=dev)
    phi = (torch.empty((nr,), dtype=torch.float32, device=dev)
           if with_phi else None)
    code = lib.ocn_rows_accel_t(
        rows.data_ptr(), nr, src.data_ptr(), mass.data_ptr(), ns, _f32(G),
        _f32(_f32(eps) ** 2), int(guarded), int(compensated),
        scratch.data_ptr(), acc.data_ptr(),
        phi.data_ptr() if with_phi else None, _stream(rows))
    LAUNCHES[key] += 1
    _check_launch(lib, code, key)
    return (acc, phi) if with_phi else acc


def sym_kernel(pos_c, mass_c, eps, G=1.0, with_phi=False, guarded=True,
               scratch=None, geometry=None):
    """Launch K2 (both passes) on centred f32 CUDA tensors; the same
    contract as ``sym_plain``. ``scratch``, if given, is a float32 buffer of
    at least ``sym_scratch_floats(n, "sym", geometry)`` elements to use.
    ``geometry`` (one of ``GEOMETRIES``) overrides ``sym_geometry(n)``;
    every caller in the port leaves it None."""
    n = pos_c.shape[0]
    _check_f32("pos", pos_c, (n, 3))
    _check_f32("mass", mass_c, (n,))
    lib = _library()
    scratch = _scratch(sym_scratch_floats(n, "sym", geometry), pos_c.device,
                       scratch)
    acc = torch.empty((n, 3), dtype=torch.float32, device=pos_c.device)
    phi = (torch.empty((n,), dtype=torch.float32, device=pos_c.device)
           if with_phi else None)
    code = lib.ocn_sym_accel(
        pos_c.data_ptr(), mass_c.data_ptr(), n, _f32(G),
        _f32(_f32(eps) ** 2), int(guarded), _geom(geometry),
        scratch.data_ptr(), acc.data_ptr(),
        phi.data_ptr() if with_phi else None, _stream(pos_c))
    LAUNCHES["sym"] += 1
    _check_launch(lib, code, "sym_accel")
    return (acc, phi) if with_phi else acc


def rows_jerk_kernel(rows, vrows, src, svel, mass, eps, G=1.0,
                     guarded=True):
    """Launch K4 on centred f32 CUDA tensors; the same contract as
    ``rows_jerk_plain``."""
    nr, ns = rows.shape[0], src.shape[0]
    _check_f32("pos_rows", rows, (nr, 3))
    _check_f32("vel_rows", vrows, (nr, 3))
    _check_f32("src_pos", src, (ns, 3))
    _check_f32("src_vel", svel, (ns, 3))
    _check_f32("src_mass", mass, (ns,))
    lib = _library()
    acc = torch.empty((nr, 3), dtype=torch.float32, device=rows.device)
    jerk = torch.empty((nr, 3), dtype=torch.float32, device=rows.device)
    code = lib.ocn_rows_jerk(
        rows.data_ptr(), vrows.data_ptr(), nr, src.data_ptr(),
        svel.data_ptr(), mass.data_ptr(), ns, _f32(G), _f32(_f32(eps) ** 2),
        int(guarded), acc.data_ptr(), jerk.data_ptr(), _stream(rows))
    LAUNCHES["rows_jerk"] += 1
    _check_launch(lib, code, "rows_jerk")
    return acc, jerk


def rows_jerk_t_kernel(rows, vrows, src, svel, mass, eps, G=1.0,
                       guarded=True):
    """Launch K5 (both passes) on centred f32 CUDA tensors; the same
    contract as ``rows_jerk_t_plain``."""
    return _rows_jerk_t_launch("rows_jerk_t", False, rows, vrows, src, svel,
                               mass, eps, G, guarded)


def rows_jerk_stream_kernel(rows, vrows, src, svel, mass, eps, G=1.0,
                            guarded=True):
    """Launch K14, K5 with Kahan steps across source stages and chunks, on
    centred f32 CUDA tensors; the same contract as
    ``rows_jerk_stream_plain``."""
    return _rows_jerk_t_launch("rows_jerk_stream", True, rows, vrows, src,
                               svel, mass, eps, G, guarded)


def _rows_jerk_t_launch(key, compensated, rows, vrows, src, svel, mass, eps,
                        G, guarded):
    nr, ns = rows.shape[0], src.shape[0]
    _check_f32("pos_rows", rows, (nr, 3))
    _check_f32("vel_rows", vrows, (nr, 3))
    _check_f32("src_pos", src, (ns, 3))
    _check_f32("src_vel", svel, (ns, 3))
    _check_f32("src_mass", mass, (ns,))
    lib = _library()
    scratch = torch.empty((lib.ocn_rows_jerk_t_scratch(nr, ns),),
                          dtype=torch.float32, device=rows.device)
    acc = torch.empty((nr, 3), dtype=torch.float32, device=rows.device)
    jerk = torch.empty((nr, 3), dtype=torch.float32, device=rows.device)
    code = lib.ocn_rows_jerk_t(
        rows.data_ptr(), vrows.data_ptr(), nr, src.data_ptr(),
        svel.data_ptr(), mass.data_ptr(), ns, _f32(G), _f32(_f32(eps) ** 2),
        int(guarded), int(compensated), scratch.data_ptr(), acc.data_ptr(),
        jerk.data_ptr(), _stream(rows))
    LAUNCHES[key] += 1
    _check_launch(lib, code, key)
    return acc, jerk


def sym_jerk_kernel(pos_c, vel_c, mass_c, eps, G=1.0, guarded=True,
                    scratch=None):
    """Launch K3 (both passes) on centred f32 CUDA tensors; the same
    contract as ``sym_jerk_plain``. ``scratch``, if given, is a float32
    buffer of at least ``sym_scratch_floats(n, "sym_jerk")`` elements."""
    n = pos_c.shape[0]
    _check_f32("pos", pos_c, (n, 3))
    _check_f32("vel", vel_c, (n, 3))
    _check_f32("mass", mass_c, (n,))
    lib = _library()
    # six floats per slot: a float4 plane, then a float2 plane
    scratch = _scratch(sym_scratch_floats(n, "sym_jerk"), pos_c.device,
                       scratch)
    acc = torch.empty((n, 3), dtype=torch.float32, device=pos_c.device)
    jerk = torch.empty((n, 3), dtype=torch.float32, device=pos_c.device)
    code = lib.ocn_sym_jerk(
        pos_c.data_ptr(), vel_c.data_ptr(), mass_c.data_ptr(), n, _f32(G),
        _f32(_f32(eps) ** 2), int(guarded), scratch.data_ptr(),
        acc.data_ptr(), jerk.data_ptr(), _stream(pos_c))
    LAUNCHES["sym_jerk"] += 1
    _check_launch(lib, code, "sym_jerk")
    return acc, jerk


def cross_scratch_floats(nA: int, nB: int, kernel: str = "cross",
                         geometry=None) -> int:
    """Floats of scratch the cross ``kernel`` (by its launch key: "cross"
    K12, "cross_x" K15, "cross_jerk" K13 and "cross_jerk_x" K16, each in
    ``geometry``, default its own) needs on nA x nB, as the library
    says."""
    lib = _library()
    sized = {"cross": lib.ocn_cross_accel_scratch,
             "cross_x": lib.ocn_cross_x_scratch,
             "cross_jerk": lib.ocn_cross_jerk_scratch,
             "cross_jerk_x": lib.ocn_cross_jerk_x_scratch}
    if kernel not in sized:
        raise ValueError(f"no cross kernel {kernel!r}")
    return sized[kernel](nA, nB, _geom(geometry))


def cross_kernel(posA, posB, massA, massB, eps, G=1.0, with_phi=False,
                 guarded=True, scratch=None, geometry=None):
    """Launch K12 (the tile pass and a reduce per set) on f32 CUDA tensors
    centred in one frame; the same contract as ``cross_plain``.
    ``scratch``, if given, is a float32 buffer of at least
    ``cross_scratch_floats(nA, nB, "cross", geometry)`` elements.
    ``geometry`` (one of ``GEOMETRIES``) overrides ``cross_geometry(nA,
    nB)``; every caller in the port leaves it None."""
    nA, nB = posA.shape[0], posB.shape[0]
    _check_f32("posA", posA, (nA, 3))
    _check_f32("posB", posB, (nB, 3))
    _check_f32("massA", massA, (nA,))
    _check_f32("massB", massB, (nB,))
    lib = _library()
    dev = posA.device
    scratch = _scratch(cross_scratch_floats(nA, nB, "cross", geometry), dev,
                       scratch)
    accA = torch.empty((nA, 3), dtype=torch.float32, device=dev)
    accB = torch.empty((nB, 3), dtype=torch.float32, device=dev)
    phiA, phiB = ((torch.empty((nA,), dtype=torch.float32, device=dev),
                   torch.empty((nB,), dtype=torch.float32, device=dev))
                  if with_phi else (None, None))
    code = lib.ocn_cross_accel(
        posA.data_ptr(), massA.data_ptr(), nA, posB.data_ptr(),
        massB.data_ptr(), nB, _f32(G), _f32(_f32(eps) ** 2), int(guarded),
        _geom(geometry), scratch.data_ptr(), accA.data_ptr(),
        phiA.data_ptr() if with_phi else None, accB.data_ptr(),
        phiB.data_ptr() if with_phi else None, _stream(posA))
    LAUNCHES["cross"] += 1
    _check_launch(lib, code, "cross_accel")
    return (accA, phiA, accB, phiB) if with_phi else (accA, accB)


def cross_jerk_kernel(posA, velA, posB, velB, massA, massB, eps, G=1.0,
                      guarded=True, scratch=None, geometry=None):
    """Launch K13 (the tile pass and a reduce per set) on f32 CUDA tensors
    centred in one frame; the same contract as ``cross_jerk_plain``.
    ``scratch``, if given, is a float32 buffer of at least
    ``cross_scratch_floats(nA, nB, "cross_jerk", geometry)`` elements.
    ``geometry`` (one of ``GEOMETRIES``) overrides
    ``cross_geometry(nA, nB, "cross_jerk")``; every caller in the port
    leaves it None."""
    nA, nB = posA.shape[0], posB.shape[0]
    _check_planes(nA, posA=posA, velA=velA)
    _check_planes(nB, posB=posB, velB=velB)
    _check_f32("massA", massA, (nA,))
    _check_f32("massB", massB, (nB,))
    lib = _library()
    dev = posA.device
    scratch = _scratch(cross_scratch_floats(nA, nB, "cross_jerk", geometry),
                       dev, scratch)
    accA, jerkA = (torch.empty((nA, 3), dtype=torch.float32, device=dev)
                   for _ in range(2))
    accB, jerkB = (torch.empty((nB, 3), dtype=torch.float32, device=dev)
                   for _ in range(2))
    code = lib.ocn_cross_jerk(
        posA.data_ptr(), velA.data_ptr(), massA.data_ptr(), nA,
        posB.data_ptr(), velB.data_ptr(), massB.data_ptr(), nB, _f32(G),
        _f32(_f32(eps) ** 2), int(guarded), _geom(geometry),
        scratch.data_ptr(), accA.data_ptr(), jerkA.data_ptr(),
        accB.data_ptr(), jerkB.data_ptr(), _stream(posA))
    LAUNCHES["cross_jerk"] += 1
    _check_launch(lib, code, "cross_jerk")
    return accA, jerkA, accB, jerkB


def _check_planes(n, **planes):
    for name, t in planes.items():
        _check_f32(name, t, (n, 3))


def rows_x_kernel(rhi, rlo, shi, slo, gm, eps, with_phi=False, guarded=True):
    """Launch K8 on (hi, lo) f32 CUDA planes; the same contract as
    ``rows_x_plain``."""
    nr, ns = rhi.shape[0], shi.shape[0]
    _check_planes(nr, rows_hi=rhi, rows_lo=rlo)
    _check_planes(ns, src_hi=shi, src_lo=slo)
    _check_f32("gm", gm, (ns,))
    lib = _library()
    acc = torch.empty((nr, 3), dtype=torch.float32, device=rhi.device)
    phi = (torch.empty((nr,), dtype=torch.float32, device=rhi.device)
           if with_phi else None)
    code = lib.ocn_rows_accel_x(
        rhi.data_ptr(), rlo.data_ptr(), nr, shi.data_ptr(), slo.data_ptr(),
        gm.data_ptr(), ns, _f32(_f32(eps) ** 2), int(guarded),
        acc.data_ptr(), phi.data_ptr() if with_phi else None, _stream(rhi))
    LAUNCHES["rows_x"] += 1
    _check_launch(lib, code, "rows_accel_x")
    return (acc, phi) if with_phi else acc


def rows_x_stream_kernel(rhi, rlo, shi, slo, gm, eps, with_phi=False,
                         guarded=True):
    """Launch K19 (both passes) on (hi, lo) f32 CUDA planes; the same
    contract as ``rows_x_stream_plain``."""
    nr, ns = rhi.shape[0], shi.shape[0]
    _check_planes(nr, rows_hi=rhi, rows_lo=rlo)
    _check_planes(ns, src_hi=shi, src_lo=slo)
    _check_f32("gm", gm, (ns,))
    lib = _library()
    dev = rhi.device
    scratch = torch.empty((lib.ocn_rows_accel_xs_scratch(nr, ns,
                                                         int(with_phi)),),
                          dtype=torch.float32, device=dev)
    acc = torch.empty((nr, 3), dtype=torch.float32, device=dev)
    phi = (torch.empty((nr,), dtype=torch.float32, device=dev)
           if with_phi else None)
    code = lib.ocn_rows_accel_xs(
        rhi.data_ptr(), rlo.data_ptr(), nr, shi.data_ptr(), slo.data_ptr(),
        gm.data_ptr(), ns, _f32(_f32(eps) ** 2), int(guarded),
        scratch.data_ptr(), acc.data_ptr(),
        phi.data_ptr() if with_phi else None, _stream(rhi))
    LAUNCHES["rows_x_stream"] += 1
    _check_launch(lib, code, "rows_x_stream")
    return (acc, phi) if with_phi else acc


def sym_x_kernel(hi, lo, gm, eps, with_phi=False, guarded=True,
                 scratch=None, geometry=None):
    """Launch K6 (both passes) on (hi, lo) f32 CUDA planes; the same
    contract as ``sym_x_plain``. ``scratch``, if given, is a float32 buffer
    of at least ``sym_scratch_floats(n, "sym_x", geometry)`` elements.
    ``geometry`` (one of ``GEOMETRIES``) overrides ``sym_geometry(n,
    "sym_x")``; every caller in the port leaves it None."""
    n = hi.shape[0]
    _check_planes(n, pos_hi=hi, pos_lo=lo)
    _check_f32("gm", gm, (n,))
    lib = _library()
    scratch = _scratch(sym_scratch_floats(n, "sym_x", geometry), hi.device,
                       scratch)
    acc = torch.empty((n, 3), dtype=torch.float32, device=hi.device)
    phi = (torch.empty((n,), dtype=torch.float32, device=hi.device)
           if with_phi else None)
    code = lib.ocn_sym_accel_x(
        hi.data_ptr(), lo.data_ptr(), gm.data_ptr(), n,
        _f32(_f32(eps) ** 2), int(guarded), _geom(geometry),
        scratch.data_ptr(), acc.data_ptr(),
        phi.data_ptr() if with_phi else None, _stream(hi))
    LAUNCHES["sym_x"] += 1
    _check_launch(lib, code, "sym_accel_x")
    return (acc, phi) if with_phi else acc


def rows_jerk_x_kernel(rhi, rlo, vhi, vlo, shi, slo, svhi, svlo, gm, eps,
                       guarded=True):
    """Launch K9 (both passes) on (hi, lo) f32 CUDA planes; the same
    contract as ``rows_jerk_x_plain``."""
    return _rows_jerk_x_launch("rows_jerk_x", False, rhi, rlo, vhi, vlo, shi,
                               slo, svhi, svlo, gm, eps, guarded)


def rows_jerk_x_stream_kernel(rhi, rlo, vhi, vlo, shi, slo, svhi, svlo, gm,
                              eps, guarded=True):
    """Launch K17, K9 with Kahan steps across source stages and chunks, on
    (hi, lo) f32 CUDA planes; the same contract as
    ``rows_jerk_x_stream_plain``."""
    return _rows_jerk_x_launch("rows_jerk_x_stream", True, rhi, rlo, vhi,
                               vlo, shi, slo, svhi, svlo, gm, eps, guarded)


def _rows_jerk_x_launch(key, compensated, rhi, rlo, vhi, vlo, shi, slo,
                        svhi, svlo, gm, eps, guarded):
    nr, ns = rhi.shape[0], shi.shape[0]
    _check_planes(nr, rows_hi=rhi, rows_lo=rlo, vel_rows_hi=vhi,
                  vel_rows_lo=vlo)
    _check_planes(ns, src_hi=shi, src_lo=slo, src_vel_hi=svhi,
                  src_vel_lo=svlo)
    _check_f32("gm", gm, (ns,))
    lib = _library()
    scratch = torch.empty((lib.ocn_rows_jerk_x_scratch(nr, ns),),
                          dtype=torch.float32, device=rhi.device)
    acc = torch.empty((nr, 3), dtype=torch.float32, device=rhi.device)
    jerk = torch.empty((nr, 3), dtype=torch.float32, device=rhi.device)
    code = lib.ocn_rows_jerk_x(
        rhi.data_ptr(), rlo.data_ptr(), vhi.data_ptr(), vlo.data_ptr(), nr,
        shi.data_ptr(), slo.data_ptr(), svhi.data_ptr(), svlo.data_ptr(),
        gm.data_ptr(), ns, _f32(_f32(eps) ** 2), int(guarded),
        int(compensated), scratch.data_ptr(), acc.data_ptr(),
        jerk.data_ptr(), _stream(rhi))
    LAUNCHES[key] += 1
    _check_launch(lib, code, key)
    return acc, jerk


def sym_jerk_x_kernel(hi, lo, vhi, vlo, gm, eps, guarded=True,
                      scratch=None):
    """Launch K7 (both passes) on (hi, lo) f32 CUDA planes; the same
    contract as ``sym_jerk_x_plain``. ``scratch``, if given, is a float32
    buffer of at least ``sym_scratch_floats(n, "sym_jerk_x")`` elements."""
    n = hi.shape[0]
    _check_planes(n, pos_hi=hi, pos_lo=lo, vel_hi=vhi, vel_lo=vlo)
    _check_f32("gm", gm, (n,))
    lib = _library()
    # six floats per slot: a float4 plane, then a float2 plane
    scratch = _scratch(sym_scratch_floats(n, "sym_jerk_x"), hi.device,
                       scratch)
    acc = torch.empty((n, 3), dtype=torch.float32, device=hi.device)
    jerk = torch.empty((n, 3), dtype=torch.float32, device=hi.device)
    code = lib.ocn_sym_jerk_x(
        hi.data_ptr(), lo.data_ptr(), vhi.data_ptr(), vlo.data_ptr(),
        gm.data_ptr(), n, _f32(_f32(eps) ** 2), int(guarded),
        scratch.data_ptr(), acc.data_ptr(), jerk.data_ptr(), _stream(hi))
    LAUNCHES["sym_jerk_x"] += 1
    _check_launch(lib, code, "sym_jerk_x")
    return acc, jerk


def cross_x_kernel(hiA, loA, hiB, loB, gmA, gmB, eps, with_phi=False,
                   guarded=True, scratch=None, geometry=None):
    """Launch K15 (the tile pass and a reduce per set) on (hi, lo) f32 CUDA
    planes split under one centring; the same contract as
    ``cross_x_plain``. ``scratch``, if given, is a float32 buffer of at
    least ``cross_scratch_floats(nA, nB, "cross_x", geometry)`` elements.
    ``geometry`` (one of ``GEOMETRIES``) overrides ``cross_geometry(nA, nB,
    "cross_x")``; every caller in the port leaves it None."""
    nA, nB = hiA.shape[0], hiB.shape[0]
    _check_planes(nA, hiA=hiA, loA=loA)
    _check_planes(nB, hiB=hiB, loB=loB)
    _check_f32("gmA", gmA, (nA,))
    _check_f32("gmB", gmB, (nB,))
    lib = _library()
    dev = hiA.device
    scratch = _scratch(cross_scratch_floats(nA, nB, "cross_x", geometry), dev,
                       scratch)
    accA = torch.empty((nA, 3), dtype=torch.float32, device=dev)
    accB = torch.empty((nB, 3), dtype=torch.float32, device=dev)
    phiA, phiB = ((torch.empty((nA,), dtype=torch.float32, device=dev),
                   torch.empty((nB,), dtype=torch.float32, device=dev))
                  if with_phi else (None, None))
    code = lib.ocn_cross_accel_x(
        hiA.data_ptr(), loA.data_ptr(), gmA.data_ptr(), nA, hiB.data_ptr(),
        loB.data_ptr(), gmB.data_ptr(), nB, _f32(_f32(eps) ** 2),
        int(guarded), _geom(geometry), scratch.data_ptr(), accA.data_ptr(),
        phiA.data_ptr() if with_phi else None, accB.data_ptr(),
        phiB.data_ptr() if with_phi else None, _stream(hiA))
    LAUNCHES["cross_x"] += 1
    _check_launch(lib, code, "cross_accel_x")
    return (accA, phiA, accB, phiB) if with_phi else (accA, accB)


def cross_jerk_x_kernel(hiA, loA, vhiA, vloA, hiB, loB, vhiB, vloB, gmA, gmB,
                        eps, guarded=True, scratch=None, geometry=None):
    """Launch K16 (the tile pass and a reduce per set) on (hi, lo) f32 CUDA
    planes; the same contract as ``cross_jerk_x_plain``. ``scratch``, if
    given, is a float32 buffer of at least ``cross_scratch_floats(nA, nB,
    "cross_jerk_x", geometry)`` elements. ``geometry`` (one of
    ``GEOMETRIES``) overrides ``cross_geometry(nA, nB, "cross_jerk_x")``;
    every caller in the port leaves it None."""
    nA, nB = hiA.shape[0], hiB.shape[0]
    _check_planes(nA, hiA=hiA, loA=loA, vhiA=vhiA, vloA=vloA)
    _check_planes(nB, hiB=hiB, loB=loB, vhiB=vhiB, vloB=vloB)
    _check_f32("gmA", gmA, (nA,))
    _check_f32("gmB", gmB, (nB,))
    lib = _library()
    dev = hiA.device
    scratch = _scratch(cross_scratch_floats(nA, nB, "cross_jerk_x",
                                            geometry), dev, scratch)
    accA, jerkA = (torch.empty((nA, 3), dtype=torch.float32, device=dev)
                   for _ in range(2))
    accB, jerkB = (torch.empty((nB, 3), dtype=torch.float32, device=dev)
                   for _ in range(2))
    code = lib.ocn_cross_jerk_x(
        hiA.data_ptr(), loA.data_ptr(), vhiA.data_ptr(), vloA.data_ptr(),
        gmA.data_ptr(), nA, hiB.data_ptr(), loB.data_ptr(), vhiB.data_ptr(),
        vloB.data_ptr(), gmB.data_ptr(), nB, _f32(_f32(eps) ** 2),
        int(guarded), _geom(geometry), scratch.data_ptr(), accA.data_ptr(),
        jerkA.data_ptr(), accB.data_ptr(), jerkB.data_ptr(), _stream(hiA))
    LAUNCHES["cross_jerk_x"] += 1
    _check_launch(lib, code, "cross_jerk_x")
    return accA, jerkA, accB, jerkB


# --------------------------------------------------------------------------
# public wrappers (pallas_gravity's signatures and return contracts)
# --------------------------------------------------------------------------

def rows_route(nr: int, ns: int, jerk: bool = False,
               extended: bool = False) -> str:
    """The launch-counter key of the kernel a rows-vs-sources call of ``nr``
    rows against ``ns`` sources takes: the accel forms (with or without the
    potential) or the accel + jerk form (``jerk``), at the f32 or the
    ``extended`` tier. The JAX package's rule (pallas_gravity.py:156-168,
    :248-256, :350-360, :1461, :1524, :1596): at the f32 tier the
    compensated streamed kernel past STREAM_N sources at any row count, the
    source-split kernel from RT_MIN_ACCEL (RT_MIN_JERK) sources up to
    RT_MAX_ROWS rows, the one-thread-per-row kernel otherwise; at the
    extended tier the compensated kernel past STREAM_N sources or
    RT_MAX_ROWS rows."""
    if extended:
        big = ns > STREAM_N or nr > RT_MAX_ROWS
        if jerk:
            return "rows_jerk_x_stream" if big else "rows_jerk_x"
        return "rows_x_stream" if big else "rows_x"
    if ns > STREAM_N:
        return "rows_jerk_stream" if jerk else "rows_stream"
    if nr <= RT_MAX_ROWS and ns >= (RT_MIN_JERK if jerk else RT_MIN_ACCEL):
        return "rows_jerk_t" if jerk else "rows_t"
    return "rows_jerk" if jerk else "rows"


# rows_route's f32 accel keys -> kernel (the plain twin is rows_plain)
_ROWS_ACCEL = {"rows": rows_kernel, "rows_t": rows_t_kernel,
               "rows_stream": rows_stream_kernel}


def _accel_rows(pos_rows, src_pos, src_mass, eps, G, guarded, with_phi):
    key = rows_route(pos_rows.shape[0], src_pos.shape[0])
    if _on_cuda(pos_rows, src_pos, src_mass):
        return _ROWS_ACCEL[key](pos_rows, src_pos, src_mass, eps, G,
                                with_phi, guarded)
    return rows_plain(pos_rows, src_pos, src_mass, eps, G, with_phi=with_phi,
                      key=key)


def accel_rows(pos_rows, src_pos, src_mass, eps, G=1.0, chunk: int = 0,
               guarded: bool = True):
    """Accel on centred f32 rows from centred f32 sources; f32 out.
    K18<comp> (compensated) past STREAM_N sources at any row count; K18 for
    RT_MIN_ACCEL <= sources with at most RT_MAX_ROWS rows; K1 otherwise
    (``rows_route``). ``chunk`` is accepted for the pallas_gravity signature
    and ignored."""
    return _accel_rows(pos_rows, src_pos, src_mass, eps, G, guarded, False)


def accel_potential_rows(pos_rows, src_pos, src_mass, eps, G=1.0,
                         chunk: int = 0, guarded: bool = True):
    """(accel, phi) on rows; phi includes the softened self term where rows
    overlap sources (the caller adds ``self_phi``). The dispatch rule of
    ``accel_rows``."""
    return _accel_rows(pos_rows, src_pos, src_mass, eps, G, guarded, True)


def accel_sym(pos, mass, eps=0.0, G=1.0, guarded: bool = True):
    """Pair-symmetric self-interaction accel; pos.dtype out."""
    pos_c, mass_c = gravity.prepare_f32(pos, mass)
    if _on_cuda(pos_c, mass_c):
        acc = sym_kernel(pos_c, mass_c, eps, G, False, guarded)
    else:
        acc = sym_plain(pos_c, mass_c, eps, G)
    return acc.to(pos.dtype)


def accel_potential_sym(pos, mass, eps=0.0, G=1.0, guarded: bool = True):
    """Pair-symmetric self-interaction (accel, phi); the softened self term
    is removed from phi, as in pallas_gravity.accel_potential_sym."""
    pos_c, mass_c = gravity.prepare_f32(pos, mass)
    if _on_cuda(pos_c, mass_c):
        acc, phi = sym_kernel(pos_c, mass_c, eps, G, True, guarded)
    else:
        acc, phi = sym_plain(pos_c, mass_c, eps, G, with_phi=True)
    phi = phi + gravity.self_phi(mass_c, eps, _f32(G))
    return acc.to(pos.dtype), phi.to(pos.dtype)


def _chunked_sum(n, chunk, diag, cross, form, device):
    """The chunked self-interaction's order (the JAX package's
    ``_sym_chunked_generic``): chunks of ``chunk`` particles, the last one
    ragged; ``diag(k0, k1)`` gives a diagonal chunk's outputs, ``cross(i0,
    i1, j0, j1)`` a chunk pair's (A's, then B's), each unordered pair (i <
    j) in lexicographic order, A's outputs added into chunk i and B's into
    chunk j after the diagonal outputs.

    Spans: ``force.chunked`` around the evaluation, ``force.diag`` around
    each diagonal tile (k(k-1)/2 pairs, k particles) and ``force.cross``
    around each chunk pair (nA·nB pairs, nA + nB particles), the tiles'
    ``form`` the pair work's (``sym``, ``sym_phi``, ``sym_jerk``, ``_x`` at
    the extended tier), all timed on ``device``. A tile's span holds its
    kernel alone; the concatenation and the additions into the outputs
    lie between the tiles."""
    bounds = [(k, min(k + chunk, n)) for k in range(0, n, chunk)]
    with span("force.chunked", device=device):
        tiles = []
        for k0, k1 in bounds:
            k = k1 - k0
            with span("force.diag", device=device, pairs=k * (k - 1) // 2,
                      form=form, particles=k):
                tiles.append(diag(k0, k1))
        outs = [torch.cat(parts) for parts in zip(*tiles)]
        del tiles
        k = len(outs)
        for i, (i0, i1) in enumerate(bounds):
            for j0, j1 in bounds[i + 1:]:
                na, nb = i1 - i0, j1 - j0
                with span("force.cross", device=device, pairs=na * nb,
                          form=form, particles=na + nb):
                    res = cross(i0, i1, j0, j1)
                for o, a in zip(outs, res[:k]):
                    o[i0:i1] += a
                for o, b in zip(outs, res[k:]):
                    o[j0:j1] += b
    return outs


def chunk_scratch_floats(n, chunk, jerk=False, extended=False):
    """Floats of the one scratch buffer every launch of a chunked evaluation
    shares: the most any of them needs. The diagonal kernel (K2, K3, K6 or
    K7 by ``jerk`` and ``extended``) runs on full chunks and on the ragged
    last one, the cross kernel (K12, K13, K15 or K16) on full chunk pairs
    and on a full chunk against the ragged last one; the two tile their
    sets differently, and the register-blocked kernels' geometries depend on
    the sizes, so each shape is asked."""
    diag = "sym" + ("_jerk" if jerk else "") + ("_x" if extended else "")
    cross = diag.replace("sym", "cross")
    width, last = min(chunk, n), n % chunk or min(chunk, n)
    needs = [sym_scratch_floats(w, diag) for w in {width, last}]
    if n > chunk:
        needs += [cross_scratch_floats(width, w, cross)
                  for w in {width, last}]
    return max(needs)


def _chunk_scratch(n, chunk, jerk, extended, device):
    return torch.empty((chunk_scratch_floats(n, chunk, jerk, extended),),
                       dtype=torch.float32, device=device)


def _sym_chunked(pos_c, mass_c, vel_c, eps, G, guarded, chunk, with_phi):
    """The chunked self-interaction of centred f32 particles: each diagonal
    chunk through K2 (K3 with ``vel_c``), each chunk pair through K12
    (K13), in ``_chunked_sum``'s order. On CPU tensors the plain twins take
    the same route. Returns [acc] or [acc, phi] (the potential with its
    softened self term) or [acc, jerk], f32."""
    jerk = vel_c is not None
    planes = (pos_c, vel_c) if jerk else (pos_c,)
    on_cuda = _on_cuda(*planes, mass_c)
    n = pos_c.shape[0]
    scratch = (_chunk_scratch(n, chunk, jerk, False, pos_c.device)
               if on_cuda else None)

    def diag(k0, k1):
        p, m = pos_c[k0:k1], mass_c[k0:k1]
        if jerk:
            v = vel_c[k0:k1]
            if on_cuda:
                return sym_jerk_kernel(p, v, m, eps, G, guarded, scratch)
            return sym_jerk_plain(p, v, m, eps, G)
        if on_cuda:
            out = sym_kernel(p, m, eps, G, with_phi, guarded, scratch)
        else:
            out = sym_plain(p, m, eps, G, with_phi)
        return out if with_phi else (out,)

    def cross(i0, i1, j0, j1):
        pA, pB = pos_c[i0:i1], pos_c[j0:j1]
        mA, mB = mass_c[i0:i1], mass_c[j0:j1]
        if jerk:
            vA, vB = vel_c[i0:i1], vel_c[j0:j1]
            if on_cuda:
                return cross_jerk_kernel(pA, vA, pB, vB, mA, mB, eps, G,
                                         guarded, scratch)
            return cross_jerk_plain(pA, vA, pB, vB, mA, mB, eps, G)
        if on_cuda:
            return cross_kernel(pA, pB, mA, mB, eps, G, with_phi, guarded,
                                scratch)
        return cross_plain(pA, pB, mA, mB, eps, G, with_phi)

    form = "sym_jerk" if jerk else "sym_phi" if with_phi else "sym"
    return _chunked_sum(n, chunk, diag, cross, form, pos_c.device)


def accel_sym_chunked(pos, mass, eps=0.0, G=1.0, guarded: bool = True,
                      chunk: int | None = None):
    """Chunked pair-symmetric self-interaction accel for N past the
    resident cap, ``CHUNK_SYM`` particles a chunk; pos.dtype out."""
    chunk = CHUNK_SYM if chunk is None else chunk
    pos_c, mass_c = gravity.prepare_f32(pos, mass)
    (acc,) = _sym_chunked(pos_c, mass_c, None, eps, G, guarded, chunk, False)
    return acc.to(pos.dtype)


def accel_potential_sym_chunked(pos, mass, eps=0.0, G=1.0,
                                guarded: bool = True,
                                chunk: int | None = None):
    """Chunked pair-symmetric (accel, phi) past the resident cap; the
    softened self term, which the diagonal chunks hold, is removed once at
    the end, as in ``accel_potential_sym``."""
    chunk = CHUNK_SYM if chunk is None else chunk
    pos_c, mass_c = gravity.prepare_f32(pos, mass)
    acc, phi = _sym_chunked(pos_c, mass_c, None, eps, G, guarded, chunk,
                            True)
    phi = phi + gravity.self_phi(mass_c, eps, _f32(G))
    return acc.to(pos.dtype), phi.to(pos.dtype)


def accel_jerk_sym_chunked(pos, vel, mass, eps=0.0, G=1.0,
                           guarded: bool = True, chunk: int | None = None):
    """Chunked pair-symmetric (accel, jerk) past the resident cap,
    ``CHUNK_SYMJ`` particles a chunk; pos.dtype out."""
    chunk = CHUNK_SYMJ if chunk is None else chunk
    pos_c, mass_c, vel_c = gravity.prepare_f32(pos, mass, vel=vel)
    acc, jerk = _sym_chunked(pos_c, mass_c, vel_c, eps, G, guarded, chunk,
                             False)
    return acc.to(pos.dtype), jerk.to(pos.dtype)


def _f32_ready(*tensors):
    return tuple(t.to(torch.float32).contiguous() for t in tensors)


def accel_cross_pair(posA, posB, massA, massB, eps, G=1.0,
                     guarded: bool = True):
    """(accel on A from B, accel on B from A) in one sweep, each pair once
    (K12); inputs centred in one frame and cast to f32 here, each output in
    its set's dtype."""
    args = _f32_ready(posA, posB, massA, massB)
    if _on_cuda(*args):
        aA, aB = cross_kernel(*args, eps, G, False, guarded)
    else:
        aA, aB = cross_plain(*args, eps, G)
    return aA.to(posA.dtype), aB.to(posB.dtype)


def accel_potential_cross_pair(posA, posB, massA, massB, eps, G=1.0,
                               guarded: bool = True):
    """(accA, phiA, accB, phiB) in one sweep (K12 with the potential). The
    sets are disjoint, so neither phi holds a self term."""
    args = _f32_ready(posA, posB, massA, massB)
    if _on_cuda(*args):
        aA, pA, aB, pB = cross_kernel(*args, eps, G, True, guarded)
    else:
        aA, pA, aB, pB = cross_plain(*args, eps, G, with_phi=True)
    return (aA.to(posA.dtype), pA.to(posA.dtype), aB.to(posB.dtype),
            pB.to(posB.dtype))


def accel_jerk_cross_pair(posA, velA, posB, velB, massA, massB, eps, G=1.0,
                          guarded: bool = True):
    """(accA, jerkA, accB, jerkB) in one sweep (K13)."""
    args = _f32_ready(posA, velA, posB, velB, massA, massB)
    if _on_cuda(*args):
        out = cross_jerk_kernel(*args, eps, G, guarded)
    else:
        out = cross_jerk_plain(*args, eps, G)
    aA, jA, aB, jB = out
    return (aA.to(posA.dtype), jA.to(posA.dtype), aB.to(posB.dtype),
            jB.to(posB.dtype))


def accel(pos, mass, eps=0.0, G=1.0, guarded: bool = True):
    """Self-interaction accel, pos.dtype out: K2 for SYM_MIN <= N <=
    STREAM_N, chunked K2 + K12 past it, K1 below SYM_MIN (the dispatch rule
    of pallas_gravity.accel)."""
    n = pos.shape[0]
    if n > STREAM_N:
        return accel_sym_chunked(pos, mass, eps, G, guarded)
    if n >= SYM_MIN:
        return accel_sym(pos, mass, eps, G, guarded)
    pos_c, mass_c = gravity.prepare_f32(pos, mass)
    return accel_rows(pos_c, pos_c, mass_c, eps, G, 0, guarded).to(pos.dtype)


def accel_potential(pos, mass, eps=0.0, G=1.0, guarded: bool = True):
    """Self-interaction (accel, phi) with the self term removed, pos.dtype
    out; same dispatch rule as ``accel``."""
    n = pos.shape[0]
    if n > STREAM_N:
        return accel_potential_sym_chunked(pos, mass, eps, G, guarded)
    if n >= SYM_MIN:
        return accel_potential_sym(pos, mass, eps, G, guarded)
    pos_c, mass_c = gravity.prepare_f32(pos, mass)
    acc, phi = accel_potential_rows(pos_c, pos_c, mass_c, eps, G, 0, guarded)
    phi = phi + gravity.self_phi(mass_c, eps, _f32(G))
    return acc.to(pos.dtype), phi.to(pos.dtype)


def accel_jerk_rows(pos_rows, vel_rows, src_pos, src_vel, src_mass, eps,
                    G=1.0, chunk: int = 0, guarded: bool = True):
    """(accel, jerk) on centred f32 rows from centred f32 sources; f32 out.
    K14 (compensated) past STREAM_N sources at any row count; K5 for
    RT_MIN_JERK <= sources with at most RT_MAX_ROWS rows; K4 otherwise (the
    dispatch rule of pallas_gravity.accel_jerk_rows). ``chunk`` is accepted
    for the pallas_gravity signature and ignored."""
    on_cuda = _on_cuda(pos_rows, vel_rows, src_pos, src_vel, src_mass)
    launch, plain = {
        "rows_jerk_stream": (rows_jerk_stream_kernel, rows_jerk_stream_plain),
        "rows_jerk_t": (rows_jerk_t_kernel, rows_jerk_t_plain),
        "rows_jerk": (rows_jerk_kernel, rows_jerk_plain),
    }[rows_route(pos_rows.shape[0], src_pos.shape[0], jerk=True)]
    if on_cuda:
        return launch(pos_rows, vel_rows, src_pos, src_vel, src_mass, eps, G,
                      guarded)
    return plain(pos_rows, vel_rows, src_pos, src_vel, src_mass, eps, G)


def accel_jerk_sym(pos, vel, mass, eps=0.0, G=1.0, guarded: bool = True):
    """Pair-symmetric self-interaction (accel, jerk); pos.dtype out."""
    pos_c, mass_c, vel_c = gravity.prepare_f32(pos, mass, vel=vel)
    if _on_cuda(pos_c, vel_c, mass_c):
        acc, jerk = sym_jerk_kernel(pos_c, vel_c, mass_c, eps, G, guarded)
    else:
        acc, jerk = sym_jerk_plain(pos_c, vel_c, mass_c, eps, G)
    return acc.to(pos.dtype), jerk.to(pos.dtype)


def accel_jerk(pos, vel, mass, eps=0.0, G=1.0, guarded: bool = True):
    """Self-interaction (accel, jerk), pos.dtype out: K3 for RT_MIN_JERK <=
    N <= STREAM_N, chunked K3 + K13 past it, K4 below RT_MIN_JERK (the
    dispatch rule of pallas_gravity.accel_jerk)."""
    n = pos.shape[0]
    if n > STREAM_N:
        return accel_jerk_sym_chunked(pos, vel, mass, eps, G, guarded)
    if n >= RT_MIN_JERK:
        return accel_jerk_sym(pos, vel, mass, eps, G, guarded)
    pos_c, mass_c, vel_c = gravity.prepare_f32(pos, mass, vel=vel)
    acc, jerk = accel_jerk_rows(pos_c, vel_c, pos_c, vel_c, mass_c, eps, G,
                                0, guarded)
    return acc.to(pos.dtype), jerk.to(pos.dtype)


def route(n: int, kind: str = "kdk", precision: str = "f32") -> str:
    """The kernels on the card for N = n under integrator ``kind`` at the
    f32 or the extended ``precision`` tier: the self-interaction (accel
    under KDK, accel + jerk under Hermite and block steps; the diagnostics
    potential takes the accel route with its kernels' potential form), and
    under block steps the active rows."""
    def chunked(kernel, cross, chunk):
        c = -(-n // chunk)
        return (f"chunked pair-symmetric: {kernel} on {c} diagonal chunks of "
                f"up to {chunk}, {cross} on {c * (c - 1) // 2} chunk pairs")

    if precision == "extended":
        if n > STREAM_N:
            acc = chunked("K6", "K15", CHUNK_SYMX)
            jerk = chunked("K7", "K16", CHUNK_SYMXJ)
            rows = "K17 (compensated, any row count)"
        else:
            acc, jerk = (("K6 (pair-symmetric, resident)",
                          "K7 (pair-symmetric, resident)") if n >= SYM_MIN
                         else ("K8 (one-sided)", "K9 (one-sided)"))
            rows = "K9, K17 (compensated) past RT_MAX_ROWS rows"
    elif n > STREAM_N:
        acc = chunked("K2", "K12", CHUNK_SYM)
        jerk = chunked("K3", "K13", CHUNK_SYMJ)
        rows = "K14 (compensated, any row count)"
    else:
        acc = ("K2 (pair-symmetric, resident)" if n >= SYM_MIN
               else "K1 (one-sided)")
        jerk = ("K3 (pair-symmetric, resident)" if n >= RT_MIN_JERK
                else "K4 (one-sided)")
        rows = "K5, K4 past RT_MAX_ROWS rows" if n >= RT_MIN_JERK else "K4"
    if kind == "kdk":
        return f"accel and potential: {acc}"
    line = f"accel + jerk: {jerk}; potential: {acc}"
    if kind == "block":
        line += f"; active rows: {rows}"
    return line


# rows_route's keys, and the sharded ring's (ops/cuda_ring.py) -> the
# kernels' names in the modules' docstrings
KERNEL_LABEL = {"rows": "K1", "rows_t": "K18", "rows_stream": "K18<comp>",
                "rows_jerk": "K4", "rows_jerk_t": "K5",
                "rows_jerk_stream": "K14", "rows_x": "K8",
                "rows_x_stream": "K19", "rows_jerk_x": "K9",
                "rows_jerk_x_stream": "K17", "ring": "K20",
                "ring_phi": "K20<phi>", "ring_jerk": "K21"}


def route_pruned(n: int, bucket: int, kind: str = "kdk",
                 precision: str = "f32") -> str:
    """The kernels of an escape-pruned evaluation at N = n with a cluster
    bucket of ``bucket`` sources: sweep 1 (all n rows against the bucket)
    and sweep 2 (the bucket's rows against all n sources), in the accel
    form under KDK and for the diagnostics potential, in the accel + jerk
    form under Hermite and block steps; under block steps the active rows
    take sweep 2's jerk kernel when they are cluster members and the
    bucket's when they are tail stars (``rows_route`` at one row)."""
    ext = precision == "extended"

    def sweeps(jerk):
        one = KERNEL_LABEL[rows_route(n, bucket, jerk, ext)]
        two = KERNEL_LABEL[rows_route(bucket, n, jerk, ext)]
        return (f"sweep 1 ({n} rows x {bucket} bucket sources) {one}, "
                f"sweep 2 ({bucket} rows x {n} sources) {two}")

    if kind == "kdk":
        return f"accel and potential: {sweeps(False)}"
    line = f"accel + jerk: {sweeps(True)}; potential: {sweeps(False)}"
    if kind == "block":
        line += (f"; active rows: cluster rows x all sources "
                 f"{KERNEL_LABEL[rows_route(1, n, True, ext)]}, tail rows x "
                 f"the bucket {KERNEL_LABEL[rows_route(1, bucket, True, ext)]}")
    return line


# --------------------------------------------------------------------------
# the extended (hi/lo) tier: pallas_gravity's *_x and *_x_hilo functions
# --------------------------------------------------------------------------

def _accel_rows_x(rhi, rlo, shi, slo, gm, eps, guarded, with_phi):
    big = rows_route(rhi.shape[0], shi.shape[0],
                     extended=True) == "rows_x_stream"
    launch, plain = ((rows_x_stream_kernel, rows_x_stream_plain) if big
                     else (rows_x_kernel, rows_x_plain))
    if _on_cuda(rhi, rlo, shi, slo, gm):
        return launch(rhi, rlo, shi, slo, gm, eps, with_phi, guarded)
    return plain(rhi, rlo, shi, slo, gm, eps, with_phi=with_phi,
                 guarded=guarded)


def accel_rows_x_hilo(rhi, rlo, shi, slo, gm, eps, guarded: bool = True):
    """Extended-tier accel of rows from sources on pre-split (hi, lo) f32
    planes (one centring for both sets); f32 out. K19 (compensated) past
    STREAM_N sources or RT_MAX_ROWS rows, K8 otherwise (the dispatch rule of
    pallas_gravity.accel_rows_x_hilo)."""
    return _accel_rows_x(rhi, rlo, shi, slo, gm, eps, guarded, False)


def accel_potential_rows_x_hilo(rhi, rlo, shi, slo, gm, eps,
                                guarded: bool = True):
    """Extended-tier (accel, raw phi) of rows from sources on pre-split
    planes; f32 out, the dispatch rule of ``accel_rows_x_hilo``. With eps >
    0 phi includes the softened self term of a row that is also a source
    (the caller adds ``self_phi``)."""
    return _accel_rows_x(rhi, rlo, shi, slo, gm, eps, guarded, True)


def accel_jerk_rows_x_hilo(rhi, rlo, vhi, vlo, shi, slo, svhi, svlo, gm, eps,
                           guarded: bool = True):
    """Extended-tier (accel, jerk) of rows from sources on pre-split
    position and velocity planes; f32 out. K17 (compensated) past STREAM_N
    sources or RT_MAX_ROWS rows, K9 otherwise (the dispatch rule of
    pallas_gravity.accel_jerk_rows_x_hilo)."""
    planes = (rhi, rlo, vhi, vlo, shi, slo, svhi, svlo, gm)
    on_cuda = _on_cuda(*planes)
    if rows_route(rhi.shape[0], shi.shape[0], jerk=True,
                  extended=True) == "rows_jerk_x_stream":
        launch, plain = rows_jerk_x_stream_kernel, rows_jerk_x_stream_plain
    else:
        launch, plain = rows_jerk_x_kernel, rows_jerk_x_plain
    if on_cuda:
        return launch(*planes, eps, guarded)
    return plain(*planes, eps, guarded=guarded)


def accel_sym_x(pos, mass, eps=0.0, G=1.0, guarded: bool = True):
    """Extended-tier pair-symmetric self-interaction accel; f64 in,
    pos.dtype out (K6)."""
    hi, lo, gm = gravity.prepare_x(pos, mass, G)
    if _on_cuda(hi, lo, gm):
        acc = sym_x_kernel(hi, lo, gm, eps, False, guarded)
    else:
        acc = sym_x_plain(hi, lo, gm, eps, guarded=guarded)
    return acc.to(pos.dtype)


def accel_potential_sym_x(pos, mass, eps=0.0, G=1.0, guarded: bool = True):
    """Extended-tier pair-symmetric self-interaction (accel, RAW phi);
    pos.dtype out (K6). The caller adds ``gravity.self_phi``."""
    hi, lo, gm = gravity.prepare_x(pos, mass, G)
    if _on_cuda(hi, lo, gm):
        acc, phi = sym_x_kernel(hi, lo, gm, eps, True, guarded)
    else:
        acc, phi = sym_x_plain(hi, lo, gm, eps, with_phi=True,
                               guarded=guarded)
    return acc.to(pos.dtype), phi.to(pos.dtype)


def accel_jerk_sym_x(pos, vel, mass, eps=0.0, G=1.0, guarded: bool = True):
    """Extended-tier pair-symmetric self-interaction (accel, jerk);
    pos.dtype out (K7)."""
    hi, lo, gm, vhi, vlo = gravity.prepare_x(pos, mass, G, vel=vel)
    if _on_cuda(hi, lo, vhi, vlo, gm):
        acc, jerk = sym_jerk_x_kernel(hi, lo, vhi, vlo, gm, eps, guarded)
    else:
        acc, jerk = sym_jerk_x_plain(hi, lo, vhi, vlo, gm, eps,
                                     guarded=guarded)
    return acc.to(pos.dtype), jerk.to(pos.dtype)


def _sym_chunked_x(hi, lo, gm, vel, eps, guarded, chunk, with_phi):
    """The chunked extended self-interaction of (hi, lo) planes split ONCE
    for the whole set (a split per chunk would break the hi/lo frame across
    chunks): each diagonal chunk through K6 (K7 with ``vel`` = (vhi, vlo)),
    each chunk pair through K15 (K16), in ``_chunked_sum``'s order. On CPU
    tensors the plain twins take the same route. Returns [acc] or [acc,
    raw phi] or [acc, jerk], f32."""
    jerk = vel is not None
    planes = (hi, lo, *vel) if jerk else (hi, lo)
    on_cuda = _on_cuda(*planes, gm)
    n = hi.shape[0]
    scratch = (_chunk_scratch(n, chunk, jerk, True, hi.device) if on_cuda
               else None)

    def part(k0, k1):
        return tuple(p[k0:k1] for p in planes)

    def diag(k0, k1):
        ps, g = part(k0, k1), gm[k0:k1]
        if jerk:
            if on_cuda:
                return sym_jerk_x_kernel(*ps, g, eps, guarded, scratch)
            return sym_jerk_x_plain(*ps, g, eps, guarded=guarded)
        if on_cuda:
            out = sym_x_kernel(*ps, g, eps, with_phi, guarded, scratch)
        else:
            out = sym_x_plain(*ps, g, eps, with_phi, guarded=guarded)
        return out if with_phi else (out,)

    def cross(i0, i1, j0, j1):
        args = (*part(i0, i1), *part(j0, j1), gm[i0:i1], gm[j0:j1])
        if jerk:
            if on_cuda:
                return cross_jerk_x_kernel(*args, eps, guarded, scratch)
            return cross_jerk_x_plain(*args, eps, guarded=guarded)
        if on_cuda:
            return cross_x_kernel(*args, eps, with_phi, guarded, scratch)
        return cross_x_plain(*args, eps, with_phi, guarded=guarded)

    form = "sym_jerk_x" if jerk else "sym_phi_x" if with_phi else "sym_x"
    return _chunked_sum(n, chunk, diag, cross, form, hi.device)


def accel_sym_x_chunked(pos, mass, eps=0.0, G=1.0, guarded: bool = True,
                        chunk: int | None = None):
    """Extended-tier chunked pair-symmetric accel past the resident cap,
    ``CHUNK_SYMX`` particles a chunk; f64 in, pos.dtype out."""
    chunk = CHUNK_SYMX if chunk is None else chunk
    hi, lo, gm = gravity.prepare_x(pos, mass, G)
    (acc,) = _sym_chunked_x(hi, lo, gm, None, eps, guarded, chunk, False)
    return acc.to(pos.dtype)


def accel_potential_sym_x_chunked(pos, mass, eps=0.0, G=1.0,
                                  guarded: bool = True,
                                  chunk: int | None = None):
    """Extended-tier chunked pair-symmetric (accel, RAW phi) past the
    resident cap; the diagonal chunks hold the softened self term, which
    the caller cancels with ``gravity.self_phi``."""
    chunk = CHUNK_SYMX if chunk is None else chunk
    hi, lo, gm = gravity.prepare_x(pos, mass, G)
    acc, phi = _sym_chunked_x(hi, lo, gm, None, eps, guarded, chunk, True)
    return acc.to(pos.dtype), phi.to(pos.dtype)


def accel_jerk_sym_x_chunked(pos, vel, mass, eps=0.0, G=1.0,
                             guarded: bool = True, chunk: int | None = None):
    """Extended-tier chunked pair-symmetric (accel, jerk) past the resident
    cap, ``CHUNK_SYMXJ`` particles a chunk: ONE centring and split of the
    positions and of the velocities; pos.dtype out."""
    chunk = CHUNK_SYMXJ if chunk is None else chunk
    hi, lo, gm, vhi, vlo = gravity.prepare_x(pos, mass, G, vel=vel)
    acc, jerk = _sym_chunked_x(hi, lo, gm, (vhi, vlo), eps, guarded, chunk,
                               False)
    return acc.to(pos.dtype), jerk.to(pos.dtype)


def accel_cross_pair_x_hilo(rAhi, rAlo, rBhi, rBlo, gmA, gmB, eps,
                            guarded: bool = True):
    """Extended-tier (accel on A from B, accel on B from A) of two disjoint
    sets in one sweep, each pair once (K15), on planes split under ONE
    centring; f32 out."""
    args = (rAhi, rAlo, rBhi, rBlo, gmA, gmB)
    if _on_cuda(*args):
        return cross_x_kernel(*args, eps, False, guarded)
    return cross_x_plain(*args, eps, guarded=guarded)


def accel_potential_cross_pair_x_hilo(rAhi, rAlo, rBhi, rBlo, gmA, gmB, eps,
                                      guarded: bool = True):
    """Extended-tier (accA, phiA, accB, phiB) in one sweep (K15 with the
    potential). The sets are disjoint, so neither phi holds a self term."""
    args = (rAhi, rAlo, rBhi, rBlo, gmA, gmB)
    if _on_cuda(*args):
        return cross_x_kernel(*args, eps, True, guarded)
    return cross_x_plain(*args, eps, with_phi=True, guarded=guarded)


def accel_jerk_cross_pair_x_hilo(rAhi, rAlo, vAhi, vAlo, rBhi, rBlo, vBhi,
                                 vBlo, gmA, gmB, eps, guarded: bool = True):
    """Extended-tier (accA, jerkA, accB, jerkB) in one sweep (K16)."""
    args = (rAhi, rAlo, vAhi, vAlo, rBhi, rBlo, vBhi, vBlo, gmA, gmB)
    if _on_cuda(*args):
        return cross_jerk_x_kernel(*args, eps, guarded)
    return cross_jerk_x_plain(*args, eps, guarded=guarded)


def accel_x(pos, mass, eps=0.0, G=1.0, guarded: bool = True):
    """Extended-tier self-interaction accel, f64 in, pos.dtype out: K6 for
    SYM_MIN <= N <= STREAM_N, chunked K6 + K15 past it, K8 below SYM_MIN
    (the dispatch rule of pallas_gravity.accel_x)."""
    n = pos.shape[0]
    if n > STREAM_N:
        return accel_sym_x_chunked(pos, mass, eps, G, guarded)
    if n >= SYM_MIN:
        return accel_sym_x(pos, mass, eps, G, guarded)
    hi, lo, gm = gravity.prepare_x(pos, mass, G)
    return accel_rows_x_hilo(hi, lo, hi, lo, gm, eps,
                             guarded).to(pos.dtype)


def accel_potential_x(pos, mass, eps=0.0, G=1.0, guarded: bool = True):
    """Extended-tier self-interaction (accel, RAW phi), pos.dtype out; the
    dispatch rule of ``accel_x``. The caller adds ``gravity.self_phi``."""
    n = pos.shape[0]
    if n > STREAM_N:
        return accel_potential_sym_x_chunked(pos, mass, eps, G, guarded)
    if n >= SYM_MIN:
        return accel_potential_sym_x(pos, mass, eps, G, guarded)
    hi, lo, gm = gravity.prepare_x(pos, mass, G)
    acc, phi = accel_potential_rows_x_hilo(hi, lo, hi, lo, gm, eps, guarded)
    return acc.to(pos.dtype), phi.to(pos.dtype)


def split_rows_x(pos_rows, vel_rows, center, vcenter):
    """(rhi, rlo, vhi, vlo): rows centred on the SOURCES' centres, in f64,
    and split, so the rows' planes share the sources' frame."""
    f64 = torch.float64
    return (*gravity.split_hilo(pos_rows.to(f64) - center),
            *gravity.split_hilo(vel_rows.to(f64) - vcenter))


def accel_jerk_rows_x(pos_rows, vel_rows, src_pos, src_vel, src_mass,
                      eps=0.0, G=1.0, guarded: bool = True):
    """Extended-tier (accel, jerk) of a row subset from the full source set
    (the block-timestep active rows); f64 in, pos_rows.dtype out (K9, or
    K17 past STREAM_N sources or RT_MAX_ROWS rows). Rows and sources are
    centred on the unweighted SOURCE means before the split."""
    shi, slo, center = gravity.centre_split(src_pos)
    svhi, svlo, vcenter = gravity.centre_split(src_vel)
    acc, jerk = accel_jerk_rows_x_hilo(
        *split_rows_x(pos_rows, vel_rows, center, vcenter), shi, slo, svhi,
        svlo, gravity.gm_f32(src_mass, G), eps, guarded)
    return acc.to(pos_rows.dtype), jerk.to(pos_rows.dtype)


def accel_jerk_x(pos, vel, mass, eps=0.0, G=1.0, guarded: bool = True):
    """Extended-tier self-interaction (accel, jerk), pos.dtype out: K7 for
    SYM_MIN <= N <= STREAM_N (not RT_MIN_JERK, the f32 tier's crossover),
    chunked K7 + K16 past it, K9 below SYM_MIN (the dispatch rule of
    pallas_gravity.accel_jerk_x)."""
    n = pos.shape[0]
    if n > STREAM_N:
        return accel_jerk_sym_x_chunked(pos, vel, mass, eps, G, guarded)
    if n >= SYM_MIN:
        return accel_jerk_sym_x(pos, vel, mass, eps, G, guarded)
    return accel_jerk_rows_x(pos, vel, pos, vel, mass, eps, G, guarded)
