"""Cold-start warm-up: the port's first-call costs, overlapped with keygen.

Counterpart of tfhe_aes_tpu/utils/warmup.py.  The JAX package hides its
XLA/Mosaic compiles behind key generation; the port's cold costs are of
another kind, and each is paid here, in background threads, while keygen
or the key-cache load runs on the caller's thread:

  * ``nvcc_<kernel>``: the kernel libraries (the rotate, VP and the
    device marks of utils/profiling.py) built at once, one nvcc each
    (ops/cuda_build.load; a subprocess releases the GIL).  Without this
    they build one after the other inside the first WoPBS;
  * ``tiles``: the card's context, the shared constant leaves on the
    device (ops/keys.constant_leaves) and the kernels' tile-ordered forms
    of them (ops/cuda_build.derived), which the real keys' calls then find;
  * ``zero_key_wopbs``: one many-LUT WoPBS at the key-expansion shape (16
    bytes, the {identity, S-box} stack) under all-zero keys of the real
    shapes (client/keygen_fast.zero_device_keys), on a CUDA stream of its
    own: it launches each kernel, the int8 products and the elementwise
    ops once, so their modules are loaded before the first timed call.

What the warm-up leaves behind (the constant leaves, the tiles) is
complete before ``join()`` returns, and the zero keys are freed by then.
A failure is not a fallback: ``join()`` raises it.  On the CPU there is
nothing to build, so only ``tiles`` (the constant leaves) and
``zero_key_wopbs`` run.
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch

from ..params import ParamSet
from . import device as device_mod
from . import torus

KERNELS = ("blind_rotate", "blind_rotate_k1", "vertical_packing", "marks")


def _tiles(params: ParamSet, device: torch.device) -> None:
    """The shared constant leaves on `device` and, on a card, the tiles of
    them that the kernels of this parameter set read."""
    from ..ops import cuda_blind_rotate, cuda_vp, keys as keys_mod
    shapes = keys_mod.device_keys_shapes(params, device)
    if device.type == "cuda":
        cuda_blind_rotate.rotate_tiles(shapes.fwd_full, shapes.inv_crt_full)
        if params.cbs_level == 1:          # the VP kernel's scope
            cuda_vp.vp_tiles(shapes)


def _zero_key_wopbs(params: ParamSet, device: torch.device) -> None:
    """One 16-byte key-expansion WoPBS under zero keys, waited for."""
    from ..client import keygen_fast
    from ..models import fhe_aes
    from ..ops import wopbs
    keys = keygen_fast.zero_device_keys(params, device)
    state = torch.zeros((16, 8, params.big_lwe_dimension + 1),
                        dtype=torch.int64, device=device)
    lut = torus.from_u64(fhe_aes._refresh_sbox_lut(params), device)
    wopbs.many_wopbs(keys, state, lut)
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


class Warmup:
    """The running warm-up; ``join()`` waits for it."""

    def __init__(self, report: dict):
        self.report = report
        self._t0 = time.perf_counter()
        self._threads: list[threading.Thread] = []
        self._errors: list[Exception] = []

    def _timed(self, name: str, fn, *args) -> None:
        t0 = time.perf_counter()
        fn(*args)
        self.report[name] = round(time.perf_counter() - t0, 3)

    def _thread(self, body) -> threading.Thread:
        def run():
            try:
                body()
            except Exception as e:      # raised again by join()
                self._errors.append(e)
        th = threading.Thread(target=run, daemon=True)
        th.start()
        self._threads.append(th)
        return th

    def join(self) -> dict:
        """Wait for every target; the report of seconds by target, with
        `waited` (seconds this call blocked) and `joined_at` (seconds since
        precompile started).  Raises the first target's failure."""
        t0 = time.perf_counter()
        for th in self._threads:
            th.join()
        self.report["waited"] = round(time.perf_counter() - t0, 3)
        self.report["joined_at"] = round(time.perf_counter() - self._t0, 3)
        if self._errors:
            raise self._errors[0]
        return self.report


def precompile(params: ParamSet, n_blocks: int, *,
               block_chunk: int | None = None, device=None,
               report: dict | None = None) -> Warmup:
    """Start the warm-up of `params` on `device` (default: the card;
    raises without one unless device="cpu") in background threads and
    return at once; ``join()`` before the first timed call.

    n_blocks (the CTR batch) and block_chunk (its AES chunks) are kept
    for the JAX signature: nothing warmed here depends on the batch.  The
    JAX warm-up compiles ctr_step (or the ripple add and the AES chunk)
    ahead of the keys; the port's counterpart, a captured graph, belongs
    to a key set and reads its leaves by address, so nothing of it can be
    made before the real keys exist.  `report` (optional) is the dict the
    seconds of each target go to, as ``join()`` returns it.
    """
    del n_blocks, block_chunk
    device = device_mod.resolve(device)
    warm = Warmup(report if report is not None else {})
    builds = []
    if device.type == "cuda":
        from ..ops import cuda_build
        builds = [warm._thread(lambda name=name: warm._timed(
            f"nvcc_{name}", cuda_build.load, name)) for name in KERNELS]

    def on_device():
        # The stream is made here, not by the caller: the card's context
        # starts in this thread, beside the caller's keygen or key load.
        with (torch.cuda.stream(torch.cuda.Stream(device))
              if device.type == "cuda" else contextlib.nullcontext()):
            warm._timed("tiles", _tiles, params, device)
            for th in builds:
                th.join()
            if not warm._errors:           # the WoPBS needs the kernels
                warm._timed("zero_key_wopbs", _zero_key_wopbs, params,
                            device)
    warm._thread(on_device)
    return warm
