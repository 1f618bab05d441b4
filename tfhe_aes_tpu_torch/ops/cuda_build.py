"""Builds the hand-written CUDA kernels (csrc/*.cu) and loads them.

Each kernel file compiles with nvcc for sm_90a into its own shared library
with a plain C interface, loaded through ctypes.  The build happens at first
use, into ``tfhe_aes_tpu_torch/_build/`` (git-ignored), keyed by a hash of
every file under ``csrc/`` and the flags, so that no change to a source or
a header can load a stale library.  Nothing here runs at import time: the
CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import weakref

from . import modular

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_libs: dict[str, ctypes.CDLL] = {}
_derived: dict[tuple[str, int], tuple] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def library_path(name: str) -> pathlib.Path:
    """Where csrc/<name>.cu's library lives: keyed by the name, the flags
    and the bytes of every file under csrc/."""
    digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for part in sorted(CSRC.iterdir()):
        if part.is_file():
            digest.update(part.name.encode() + b"\0" + part.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu; raises on any failure."""
    if name in _libs:
        return _libs[name]
    src = CSRC / f"{name}.cu"
    so = library_path(name)
    if not so.exists():
        nvcc = _nvcc()
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = BUILD_DIR / f"tmp{os.getpid()}-{so.name}"
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    _libs[name] = lib
    return lib


def prime_args(plan):
    """The per-prime constant arrays of a plan as ctypes host arrays: the
    primes, their 32-bit Barrett constants (modular.barrett32_consts), the
    CRT constants, the count and M mod 2^q."""
    n = plan.n_primes
    consts = [modular.barrett32_consts(int(p)) for p in plan.p_i32]
    return ((ctypes.c_int * n)(*[int(p) for p in plan.p_i32]),
            (ctypes.c_uint32 * n)(*[c for c, _ in consts]),
            (ctypes.c_uint32 * n)(*[off for _, off in consts]),
            (ctypes.c_uint64 * n)(*[int(v) for v in plan.mk64]),
            (ctypes.c_int64 * n)(*[int(v) for v in plan.fp]),
            n, ctypes.c_uint64(int(plan.m64)))


def derived(leaf, what: str, build):
    """build(leaf), made once per key leaf: the kernels' tile-ordered forms
    of the constant NTT matrices.  Held as long as the leaf tensor itself
    lives (a key set's leaves are never written), on the leaf's device, and
    never stored in the key cache."""
    key = (what, id(leaf))
    hit = _derived.get(key)
    if hit is None or hit[0]() is not leaf:
        ref = weakref.ref(leaf, lambda _: _derived.pop(key, None))
        hit = _derived[key] = (ref, build(leaf))
    return hit[1]


def expect(t, name: str, dtype, shape) -> None:
    """Raise unless t is a CUDA tensor of this dtype and shape."""
    if not t.is_cuda or t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: want CUDA {dtype} {tuple(shape)}, got "
                         f"{t.device} {t.dtype} {tuple(t.shape)}")


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")
