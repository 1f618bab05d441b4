"""Native (C++) host runtime of the port.

Builds runtime/native.cpp with g++ at first use into
``tfhe_aes_tpu_torch/_build/`` (git-ignored), keyed by a hash of the
source, the flags and the host CPU (the build is -march=native), and loads
it with ctypes.  Nothing is written next to the source.  There is no numpy
fallback: a failed build raises.  See native.cpp for what lives here and
why.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import platform
import subprocess

import numpy as np

_SRC = pathlib.Path(__file__).resolve().parent / "native.cpp"
BUILD_DIR = _SRC.parent.parent / "_build"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
             "-pthread")

_lib = None


def _cpu_id() -> bytes:
    """The CPU's model and feature flags (what -march=native compiles for)."""
    try:
        lines = pathlib.Path("/proc/cpuinfo").read_text().splitlines()
    except OSError:
        return platform.machine().encode()
    return "\n".join([ln for ln in lines if ln.startswith("model name")][:1]
                     + [ln for ln in lines if ln.startswith("flags")][:1]
                     ).encode()


def _build() -> pathlib.Path:
    digest = hashlib.sha1(_SRC.read_bytes())
    digest.update(" ".join(GXX_FLAGS).encode() + _cpu_id())
    so = BUILD_DIR / f"libtfheaes_native-{digest.hexdigest()[:12]}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = BUILD_DIR / f"tmp{os.getpid()}-{so.name}"
    try:
        proc = subprocess.run(["g++", *GXX_FLAGS, str(_SRC), "-o", str(tmp)],
                              capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"the native runtime did not build: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {_SRC.name}:\n{proc.stderr}")
    os.replace(tmp, so)
    return so


def get_lib():
    """Load (building if needed) the native library; raises if it fails."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(_build()))
    lib.signed_limbs_u64.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int]
    lib.balanced_residues_u64.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64]
    lib.ntt_rows_mod.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64]
    lib.chacha20_fill_u64.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_uint32]
    _lib = lib
    return _lib


def signed_limbs(v: np.ndarray, n_limbs: int) -> np.ndarray:
    """u64 [...] -> int8 [..., n_limbs] balanced base-2^8 limbs."""
    lib = get_lib()
    v = np.ascontiguousarray(v, dtype=np.uint64)
    out = np.empty(v.shape + (n_limbs,), dtype=np.int8)
    lib.signed_limbs_u64(v.ctypes.data, out.ctypes.data, v.size, n_limbs)
    return out


def balanced_residues(v: np.ndarray, p: int) -> np.ndarray:
    """u64 [...] -> balanced int32 residues mod p (signed representative)."""
    lib = get_lib()
    v = np.ascontiguousarray(v, dtype=np.uint64)
    out = np.empty(v.shape, dtype=np.int32)
    lib.balanced_residues_u64(v.ctypes.data, out.ctypes.data, v.size, p)
    return out


def ntt_rows_mod(rows: np.ndarray, mat: np.ndarray, p: int) -> np.ndarray:
    """Balanced int32 rows [m, n] x canonical mat [n, n] -> balanced NTT."""
    lib = get_lib()
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    mat_c = np.ascontiguousarray(mat, dtype=np.int32)
    m, n = rows.shape
    out = np.empty((m, n), dtype=np.int32)
    lib.ntt_rows_mod(rows.ctypes.data, mat_c.ctypes.data, out.ctypes.data,
                     m, n, p)
    return out
