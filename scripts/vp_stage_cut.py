#!/usr/bin/env python3
"""Where the CUDA vertical-packing kernel's time goes, by cutting stages out.

    python3 scripts/vp_stage_cut.py [--bytes 512] [--luts 24]

Builds csrc/vertical_packing.cu as it is and in variants with one stage
removed or changed by a textual cut (each cut is a (text, replacement)
pair below, or (file, text, replacement) for another file of csrc/, and
must match the source exactly once, or the script fails), runs each on the
same random inputs at PARAM_TPU, and prints the device time of each launch
of a call (torch.profiler, summed over the 8 selector bits) on one line a
variant.  Most variants' words are wrong by construction; the full build
and the variants marked exact are compared with the plain version.  A
stage's cost is the full time minus the time without it, as far as the
rest does not speed up or slow down for its absence (two blocks share an
SM, so stages overlap).  While the full build runs in a loop the script
also reads the card's SM clock and power draw from nvidia-smi.
Imports nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import pathlib
import shutil
import subprocess
import sys
import tempfile
import threading

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import torch
from torch.profiler import ProfilerActivity, profile

from scripts.vp_card_check import constant_keys, random_inputs
from tfhe_aes_tpu_torch.ops import cuda_build, cuda_vp, vertical_packing
from tfhe_aes_tpu_torch.params import PARAM_TPU

V1_MAC = "for (int gl = gl0; gl < gl1; ++gl) {"
V1_RESIDUES = "for (int n8 = 0; n8 < kCols1 / 8; ++n8) {"
V1_X_STORES = """      xk[x_lo + ro] = static_cast<int8_t>(delta - (h8 << 8));
      xk[x_hi + ro] = static_cast<int8_t>(h8);"""
V1_PRODUCE = "ring.produce(n_kb, [&]"
V1_CONSUME = "ring.consume(n_kb, n_kb, d, [](int) {});"
V1_GGSW = "for (int i = threadIdx.x; i < g_rows * (kCols1 / 4); i += kConsumers) {"
V2_RESIDUES = "for (int n8 = 0; n8 < kCols2 / 8; ++n8)"
V2_CRT = "for (int i = 0; i < kRowsA / kRowStep; ++i) {"
V2_PRODUCE = "ring.produce(c.count * n_kb,"
V2_CONSUME = "ring.consume_pipelined(c.count * n_kb, n_kb, d, [&](int k) {"
V2_ACC = "for (int i = threadIdx.x; i < kRowsA * kCols2 / 2; i += kConsumers) {"
V2_CONSUME_END = "\n  });\n  sm90::cp_async_wait_all();"
PRODUCTS_ONLY = [
    (V1_RESIDUES, "for (int n8 = 0; n8 < 0; ++n8) {"),
    (V1_MAC, "for (int gl = gl0; gl < gl0; ++gl) {"),
    (V1_GGSW, "for (int i = 0; i < 0; ++i) {"),
    (V2_RESIDUES, "for (int n8 = 0; n8 < 0; ++n8)"),
    (V2_CRT, "for (int i = 0; i < 0; ++i) {"),
    (V2_ACC, "for (int i = 0; i < 0; ++i) {")]
# The producer completes each stage's barrier without copying anything: the
# products run on whatever shared memory holds.
NO_COPIES = [("sm90_gemm.cuh",
              """      mbar_expect_tx(&full[s], kStageBytes);
      bulk_g2s(dst, a, kABytes, &full[s]);
      bulk_g2s(dst + kABytes, b, kBBytes, &full[s]);""",
              "      (void)dst; mbar_arrive(&full[s]);")]
# Of the two V1 blocks that start together on an SM, the second waits 8000
# cycles (a third of a block's life), so that one block's product meets the
# other's epilogue; the words stay exact.
V1_TOP = "  int32_t* gs = reinterpret_cast<int32_t*>(smem + Ring::kBytes);"
V1_STAGGER = [
    ("namespace tfhe {\n\nusing sm90::kBK;",
     """namespace tfhe {
__device__ unsigned int g_slot[256];
__device__ __forceinline__ void stagger(int delay) {
  __shared__ unsigned int slot;
  if (threadIdx.x == 0) {
    unsigned int smid;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(smid));
    slot = atomicAdd(&g_slot[smid & 255], 1u);
  }
  __syncthreads();
  if ((slot & 1) && blockIdx.y * gridDim.x + blockIdx.x < 264) {
    const long long t0 = clock64();
    while (clock64() - t0 < delay) {}
  }
}

using sm90::kBK;"""),
    (V1_TOP, "  stagger(8000);\n" + V1_TOP)]
# V2 as the blind rotate's K2 is laid out: 32-coefficient tiles, two blocks
# an SM, four stages, one wgmma group in flight (two blocks an SM leave 112
# registers a thread); the wrapper tiles vp_inv_full to match.
V2_NARROW = [("constexpr int kCols2 = 64, kBN2 = 2 * kCols2, kStages2 = 8, "
              "kBlocks2 = 1;",
              "constexpr int kCols2 = 32, kBN2 = 2 * kCols2, kStages2 = 4, "
              "kBlocks2 = 2;")]
V2_UNPIPELINED = [(V2_CONSUME,
                   V2_CONSUME.replace("consume_pipelined", "consume"))]
EXACT = ("full", "V1's second block of an SM starts 8000 cycles late (exact)",
         "V2 on 32-coefficient tiles, two blocks an SM, four stages (exact)",
         "V2 with one wgmma group in flight (Ring::consume) (exact)")
V2_COLS = {EXACT[2]: 32}        # the wrapper's tile width, where not 64

VARIANTS = {
    "full": [],
    "V1 alone on its SM (100 KB of shared memory more)": [
        ("  if (smem1 > kSmemTwoBlocks) return (int)cudaErrorInvalidValue;\n",
         ""),
        ("                       2 * kStages1 * 8;",
         "                       2 * kStages1 * 8 + 100 * 1024;")],
    EXACT[1]: V1_STAGGER,
    EXACT[2]: V2_NARROW + V2_UNPIPELINED,
    EXACT[3]: V2_UNPIPELINED,
    "V1 and V2, products only (no residues, MAC, CRT, acc fetch)":
        PRODUCTS_ONLY,
    "V1 and V2, products only, no operand copies": PRODUCTS_ONLY + NO_COPIES,
    "V1 and V2, all stages, no operand copies": NO_COPIES,
    "V1 without its product (no copies, no wgmma)": [
        (V1_PRODUCE, "ring.produce(0, [&]"),
        (V1_CONSUME, "for (int i = 0; i < kBN1 / 2; ++i) d[i] = threadIdx.x + i;")],
    "V1 without the residue pass": [
        (V1_RESIDUES, "for (int n8 = 0; n8 < 0; ++n8) {")],
    "V1 without the MAC and the X stores": [
        (V1_MAC, "for (int gl = gl0; gl < gl0; ++gl) {")],
    "V1 without the X stores (one store a thread)": [
        (V1_X_STORES, "      if (delta == 0x7fffffff) xk[x_lo + ro] = h8;")],
    "V1 without staging the GGSW rows": [
        (V1_GGSW, "for (int i = 0; i < 0; ++i) {")],
    "V2 without its products (no copies, no wgmma)": [
        (V2_PRODUCE, "ring.produce(0,"),
        (V2_CONSUME, "for (int i = 0; i < kBN2 / 2; ++i) d[i] = threadIdx.x + i;\n"
                     "  auto epi = [&](int k) {"),
        (V2_CONSUME_END, "\n  };\n  for (int k = 0; k < c.count; ++k) epi(k);"
                         "\n  sm90::cp_async_wait_all();")],
    "V2 without the residue passes": [
        (V2_RESIDUES, "for (int n8 = 0; n8 < 0; ++n8)")],
    "V2 without the CRT and the acc stores": [
        (V2_CRT, "for (int i = 0; i < 0; ++i) {")],
    "V2 without fetching the acc tile": [
        (V2_ACC, "for (int i = 0; i < 0; ++i) {")],
}


def build(tmp: pathlib.Path, index: int, cuts) -> ctypes.CDLL:
    src_dir = tmp / f"v{index}"
    shutil.copytree(cuda_build.CSRC, src_dir)
    path = src_dir / "vertical_packing.cu"
    for cut in cuts:
        name, old, new = cut if len(cut) == 3 else (path.name, *cut)
        text = (src_dir / name).read_text()
        if text.count(old) != 1:
            raise SystemExit(f"cut does not match {name} once: {old!r}")
        (src_dir / name).write_text(text.replace(old, new))
    so = src_dir / "vp.so"
    proc = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o",
                           str(so), str(path)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed on variant {index}:\n{proc.stderr}")
    return ctypes.CDLL(str(so))


def launch_times(k, acc, ggsw) -> dict[str, float]:
    """Device ms of each of the kernel's launches over one call."""
    cuda_vp.vp_rotations_cuda(k, acc, ggsw)           # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        cuda_vp.vp_rotations_cuda(k, acc, ggsw)
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        us = e.self_cuda_time_total if us is None else us
        for name in ("vp_digits", "vp_forward_mac", "vp_inverse_crt"):
            if name in e.key:
                out[name] = us / 1e3
    return out


def clock_and_power(k, acc, ggsw) -> str:
    """The SM clock and power draw nvidia-smi reports while the kernel runs
    back to back for about two seconds, sampled after the first second."""
    stop = threading.Event()

    def load():
        while not stop.is_set():
            for _ in range(10):
                cuda_vp.vp_rotations_cuda(k, acc, ggsw)
            torch.cuda.synchronize()

    worker = threading.Thread(target=load)
    worker.start()
    try:
        stop.wait(1.0)
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    finally:
        stop.set()
        worker.join()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--bytes", type=int, default=512)
    ap.add_argument("--luts", type=int, default=24)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("vp_stage_cut: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    k = constant_keys(PARAM_TPU, dev)
    acc, ggsw = random_inputs(k, args.bytes, args.luts, 8, dev)
    argtypes = cuda_vp._lib().argtypes
    with tempfile.TemporaryDirectory() as tmp:
        with concurrent.futures.ThreadPoolExecutor(len(VARIANTS)) as pool:
            libs = list(pool.map(
                lambda item: build(pathlib.Path(tmp), *item),
                enumerate(VARIANTS.values())))
        real_lib, real_cols = cuda_vp._lib, cuda_vp.V2_COLS
        try:
            for (name, _), lib in zip(VARIANTS.items(), libs):
                fn = lib.tfhe_vp_rotations
                fn.argtypes, fn.restype = argtypes, ctypes.c_int
                cuda_vp._lib = lambda fn=fn: fn
                cuda_vp.V2_COLS = V2_COLS.get(name, real_cols)
                cuda_build._derived.clear()     # vp_inv_full is tiled anew
                if name in EXACT:
                    got = cuda_vp.vp_rotations_cuda(k, acc, ggsw)
                    want = vertical_packing.vp_rotations_plain(k, acc, ggsw)
                    if not torch.equal(got, want):
                        raise SystemExit(f"{name}: differs from the plain "
                                         f"version")
                if name == "full":
                    print(f"full, back to back: SM clock, its maximum, power "
                          f"draw: {clock_and_power(k, acc, ggsw)}")
                t = launch_times(k, acc, ggsw)
                print(f"{args.bytes} B x {args.luts} outputs x 8 bits, {name}: "
                      f"digits {t['vp_digits']:.3f} ms, V1 "
                      f"{t['vp_forward_mac']:.3f} ms, V2 "
                      f"{t['vp_inverse_crt']:.3f} ms")
        finally:
            cuda_vp._lib, cuda_vp.V2_COLS = real_lib, real_cols
            cuda_build._derived.clear()
    return 0


if __name__ == "__main__":
    sys.exit(main())
