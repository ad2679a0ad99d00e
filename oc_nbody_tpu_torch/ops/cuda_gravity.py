"""The pairwise force on the card: two hand-written CUDA kernels for Hopper
(``sm_90a``), each beside its plain PyTorch twin.

  * K1 ``csrc/rows_accel.cu`` — one-sided rows vs sources, optional
    potential. Replaces the Pallas row-grid kernels ``_accel_kernel`` and
    ``_accel_phi_kernel`` (oc_nbody_tpu/ops/pallas_gravity.py:110, :199).
  * K2 ``csrc/sym_accel.cu`` — pair-symmetric self-interaction, optional
    potential, bitwise deterministic. Replaces ``_make_sym_kernel`` with
    ``_pair_accel`` / ``_pair_phi`` (oc_nbody_tpu/ops/pallas_pair.py:256).

The public wrappers keep the signatures and return contracts of
``oc_nbody_tpu.ops.pallas_gravity``: ``accel_rows`` and
``accel_potential_rows`` take centred f32 rows and sources and return f32
(the rows potential includes the softened self term); ``accel_sym``,
``accel_potential_sym``, ``accel`` and ``accel_potential`` take the state's
positions, centre and cast them, and return the positions' dtype with the
self term removed from the potential.

A wrapper launches its kernel for CUDA tensors and calls the plain twin
(``rows_plain`` / ``sym_plain``, built on ``ops/gravity.py``) for CPU
tensors; there is no fallback from one to the other. ``LAUNCHES`` counts
kernel launches and ``PLAIN_CALLS`` calls of the plain twins, so a run can
show which one it went through.

The kernels are built with ``nvcc`` into ``build/oc_nbody_tpu_torch/`` at
first use and loaded with ``ctypes``. The build fails loudly (RuntimeError
with the compiler's output) if ``nvcc`` is missing or refuses the source.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from oc_nbody_tpu_torch.ops import gravity

# Self-interaction dispatch: the pair-symmetric K2 for SYM_MIN <= N <=
# STREAM_N, the one-sided K1 below. SYM_MIN is the TPU's crossover
# (pallas_gravity.py:1686); the H100 crossover has not been measured yet.
SYM_MIN = 8192
# Largest N the resident sym kernel takes; past it the TPU runs chunked
# sym kernels, not ported yet (ROADMAP B5).
STREAM_N = 262144

LAUNCHES = {"rows": 0, "sym": 0}
PLAIN_CALLS = {"rows": 0, "sym": 0}

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "oc_nbody_tpu_torch"
_SOURCES = ("rows_accel.cu", "sym_accel.cu")
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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
    the shared library. Raises RuntimeError if nvcc is missing or fails."""
    global BUILD_LOG
    digest = hashlib.sha256()
    for name in ("pair.cuh",) + _SOURCES:
        digest.update((CSRC / name).read_bytes())
    digest.update(" ".join(_NVCC_FLAGS).encode())
    out = BUILD_DIR / f"libocn_gravity_{digest.hexdigest()[:12]}.so"
    if out.is_file():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *_NVCC_FLAGS, "-o", tmp, *(str(CSRC / s) for s in _SOURCES)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)  # atomic: concurrent builds race harmlessly
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    BUILD_LOG = proc.stdout + proc.stderr
    return out


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library()))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.ocn_rows_accel.argtypes = [p, i, p, p, i, f, f, i, p, p, p]
        lib.ocn_rows_accel.restype = i
        lib.ocn_sym_accel.argtypes = [p, p, i, f, f, i, p, p, p, p]
        lib.ocn_sym_accel.restype = i
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


# --------------------------------------------------------------------------
# plain twins (the reference the kernels are held to; CPU path)
# --------------------------------------------------------------------------

def rows_plain(rows, src, mass, eps, G=1.0, with_phi=False,
               dtype=torch.float32, chunk=1024):
    """K1's function in plain PyTorch, computed in ``dtype`` (f64: the
    oracle the kernel is held to on the card). Returns acc, or (acc, phi)
    with the self term kept, in ``dtype``."""
    PLAIN_CALLS["rows"] += 1
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


# --------------------------------------------------------------------------
# kernel launches
# --------------------------------------------------------------------------

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


def sym_kernel(pos_c, mass_c, eps, G=1.0, with_phi=False, guarded=True):
    """Launch K2 (both passes) on centred f32 CUDA tensors; the same
    contract as ``sym_plain``."""
    n = pos_c.shape[0]
    _check_f32("pos", pos_c, (n, 3))
    _check_f32("mass", mass_c, (n,))
    lib = _library()
    t = lib.ocn_sym_tile()
    nt = -(-n // t)
    scratch = torch.empty((nt * nt * t, 4), dtype=torch.float32,
                          device=pos_c.device)
    acc = torch.empty((n, 3), dtype=torch.float32, device=pos_c.device)
    phi = (torch.empty((n,), dtype=torch.float32, device=pos_c.device)
           if with_phi else None)
    code = lib.ocn_sym_accel(
        pos_c.data_ptr(), mass_c.data_ptr(), n, _f32(G), _f32(_f32(eps) ** 2),
        int(guarded), scratch.data_ptr(), acc.data_ptr(),
        phi.data_ptr() if with_phi else None, _stream(pos_c))
    LAUNCHES["sym"] += 1
    _check_launch(lib, code, "sym_accel")
    return (acc, phi) if with_phi else acc


# --------------------------------------------------------------------------
# public wrappers (pallas_gravity's signatures and return contracts)
# --------------------------------------------------------------------------

def accel_rows(pos_rows, src_pos, src_mass, eps, G=1.0, chunk: int = 0,
               guarded: bool = True):
    """Accel on centred f32 rows from centred f32 sources; f32 out.
    ``chunk`` is accepted for the pallas_gravity signature and ignored."""
    if _on_cuda(pos_rows, src_pos, src_mass):
        return rows_kernel(pos_rows, src_pos, src_mass, eps, G, False,
                           guarded)
    return rows_plain(pos_rows, src_pos, src_mass, eps, G)


def accel_potential_rows(pos_rows, src_pos, src_mass, eps, G=1.0,
                         chunk: int = 0, guarded: bool = True):
    """(accel, phi) on rows; phi includes the softened self term where rows
    overlap sources (the caller adds ``self_phi``)."""
    if _on_cuda(pos_rows, src_pos, src_mass):
        return rows_kernel(pos_rows, src_pos, src_mass, eps, G, True,
                           guarded)
    return rows_plain(pos_rows, src_pos, src_mass, eps, G, with_phi=True)


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


def _check_n(n: int) -> None:
    if n > STREAM_N:
        raise ValueError(
            f"N = {n} exceeds STREAM_N = {STREAM_N}: the chunked "
            "pair-symmetric kernels that run past it are not ported yet "
            "(ROADMAP B5)")


def accel(pos, mass, eps=0.0, G=1.0, guarded: bool = True):
    """Self-interaction accel, pos.dtype out: K2 for SYM_MIN <= N, K1
    below (the dispatch rule of pallas_gravity.accel)."""
    n = pos.shape[0]
    _check_n(n)
    if n >= SYM_MIN:
        return accel_sym(pos, mass, eps, G, guarded)
    pos_c, mass_c = gravity.prepare_f32(pos, mass)
    return accel_rows(pos_c, pos_c, mass_c, eps, G, 0, guarded).to(pos.dtype)


def accel_potential(pos, mass, eps=0.0, G=1.0, guarded: bool = True):
    """Self-interaction (accel, phi) with the self term removed, pos.dtype
    out; same dispatch rule as ``accel``."""
    n = pos.shape[0]
    _check_n(n)
    if n >= SYM_MIN:
        return accel_potential_sym(pos, mass, eps, G, guarded)
    pos_c, mass_c = gravity.prepare_f32(pos, mass)
    acc, phi = accel_potential_rows(pos_c, pos_c, mass_c, eps, G, 0, guarded)
    phi = phi + gravity.self_phi(mass_c, eps, _f32(G))
    return acc.to(pos.dtype), phi.to(pos.dtype)
