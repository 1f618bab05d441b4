#!/usr/bin/env python3
"""Where the blind rotate's two kernels, K1 and K2, spend their time, by
cutting stages out.

    python3 scripts/br_stage_cut.py [--bits 2048] [--steps 32] [--only TEXT]

Builds csrc/blind_rotate.cu and csrc/blind_rotate_k1.cu as they are and
in variants with one stage removed by a textual cut (each cut is a (text,
replacement) pair below, in the source of the variant's K1, or (file,
text, replacement) for another file of csrc/, as all of K2's are, and
must match the source exactly once, or the script fails), runs a rotation
of --steps CMux steps on the same random inputs at PARAM_OPT (random BSK
limbs, the set's own NTT matrices and twiddles) on the variant's K1 (one
block a tile, or the persistent K1, forced through
cuda_blind_rotate.K1_TILES_PER_SM), and prints K1's and K2's device time
a step (torch.profiler, the records of one call over its steps) on one
line a variant.  --only runs the uncut builds and the variants whose name
holds TEXT.  The cut variants' words are wrong by construction; the uncut
ones are compared with blind_rotate_plain.  A stage's cost is the full
time minus the time without it, as far as the rest does not speed up or
slow down for its absence.  Also prints ptxas's registers and spills of
each kernel of the full build, and the card's SM clock and power draw
while the full build runs back to back.
Imports nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import dataclasses
import pathlib
import shutil
import subprocess
import sys
import tempfile
import threading

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from tfhe_aes_tpu_torch.ops import (blind_rotate, cuda_blind_rotate,
                                    cuda_build, keys, ntt)
from tfhe_aes_tpu_torch.params import PARAM_OPT
from tfhe_aes_tpu_torch.utils import torus

# K1, one block a (column tile, row tile).
K1_RESIDUES = "for (int n8 = 0; n8 < kCols1 / 8; ++n8) {"
K1_MAC = "for (int r = 0; r < s.R; ++r) {"
K1_X_STORES = "if (bl >= nbits || b >= s.B) continue;"
K1_BSK = ("for (int i = threadIdx.x; i < rows2j * kCols1 / 16; "
          "i += kConsumers) {")
K1_TWIDDLES = "tw1[i] = rot[mask_a[i] * s.PN + gc] - 1;"
NO_MAC = [(K1_MAC, "for (int r = 0; r < 0; ++r) {"),
          (K1_X_STORES, "continue;")]
NO_EPILOGUE = NO_MAC + [
    (K1_RESIDUES, "for (int n8 = 0; n8 < 0; ++n8) {"),
    (K1_TWIDDLES, "tw1[i] = mask_a[i];")]
NO_BSK = [(K1_BSK, "for (int i = 0; i < 0; ++i) {")]
# The producer completes each stage's barrier without copying anything: the
# products run on whatever shared memory holds.
RING_COPY = """      mbar_expect_tx(&full[s], kStageBytes);
      bulk_g2s(dst, a, kABytes, &full[s]);
      bulk_g2s(dst + kABytes, b, kBBytes, &full[s]);"""
NO_COPIES = [("sm90_gemm.cuh", RING_COPY,
              "      (void)dst; mbar_arrive(&full[s]);")]

# K2 (br_inverse_crt_kernel), on the persistent K1's path: its ring's
# producer copies only the inverse matrix's B stage, or only the X rows' A
# stage, and expects only those bytes; or its epilogue (the residues of
# each prime's product, the CRT, acc += delta, the next digits) or a part
# of it is emptied; or its blocks take one SM each.
K2_NO_A_COPY = [("sm90_gemm.cuh", RING_COPY, """      mbar_expect_tx(&full[s], kBBytes);
      (void)a;
      bulk_g2s(dst + kABytes, b, kBBytes, &full[s]);""")]
K2_NO_B_COPY = [("sm90_gemm.cuh", RING_COPY, """      mbar_expect_tx(&full[s], kABytes);
      bulk_g2s(dst, a, kABytes, &full[s]);
      (void)b;""")]
K2_RESIDUES = "for (int n8 = 0; n8 < kCols2 / 8; ++n8)"
K2_CRT = "    if (r >= r_hi) break;"
K2_NO_EPILOGUE = [("blind_rotate.cu", K2_RESIDUES,
                   K2_RESIDUES.replace("n8 < kCols2 / 8", "n8 < 0")),
                  ("blind_rotate.cu", K2_CRT, K2_CRT.replace("r_hi", "0"))]
K2_ACC_PREFETCH = "  if (threadIdx.x < 2 * (r_hi - r_lo))\n    sm90::prefetch_l2("
K2_CRT_WORD = """      v[w] = (old[w] + crt_word(c, [&](int k) {
               return static_cast<int>((yq[k] >> (16 * w)) & 0xFFFF);
             })) & c.qmask;"""
K2_ACC_STORE = """    out[0] = make_ulonglong2(v[0], v[1]);
    out[1] = make_ulonglong2(v[2], v[3]);"""
K2_DIGITS = "    if (A != nullptr) decompose_store(v, m2, a_lo, a_hi, s, A);"
# K2's blocks ask for 110 KB more shared memory than they use: one block
# an SM instead of two.
K2_SMEM = "  const size_t smem2 = sm90::Ring<kBN2, kStages2>::kBytes +"
K2_ONE_BLOCK = [("blind_rotate.cu", K2_SMEM,
                 K2_SMEM.replace("smem2 = ", "smem2 = 110 * 1024 + "))]

# The persistent K1 (br_forward_mac_kernel_persistent).
P_RESIDUES = """    for (int g = 0; g < 8; ++g) {
      const int i2 = g >> 2, p = g & 3;
      int v[4];"""
P_MAC = """    for (int bl = 0; bl < kBitsWg; ++bl) {
      uint32_t lo[4 * kChunks]"""
P_SWAP = """    for (int m = 0; m < kFin; ++m)
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int mine"""
P_X_STORES = """    for (int m = 0; m < kFin; ++m) {
      const int b = rt * nbits + wg * kBitsWg + 2 * m + jh;
      if (b >= s.B) continue;"""
P_TWIDDLES = "tw1[m] = __ldg(rot + mask_next[m] * s.PN + ct * kCols1 + col);"
P_BSK_ROWS = ("for (int item = lane; item < 2 * J * (kCols1 / 4); "
              "item += 32) {")
P_STAGE_COPY = """          sm90::mbar_expect_tx(&rf[slot], kHalfStage);
#pragma unroll
          for (int k2 = 0; k2 < kStageKb; ++k2)
            sm90::bulk_g2s("""
P_NO_MAC = [(P_MAC, P_MAC.replace("bl < kBitsWg", "bl < 0")),
            (P_SWAP, P_SWAP.replace("m < kFin", "m < 0")),
            (P_X_STORES, P_X_STORES.replace("m < kFin", "m < 0"))]
P_NO_EPILOGUE = P_NO_MAC + [
    (P_RESIDUES, P_RESIDUES.replace("g < 8", "g < 0")),
    (P_TWIDDLES, "tw1[m] = mask_next[m];")]
P_NO_COPIES = [(P_STAGE_COPY, """          sm90::mbar_arrive(&rf[slot]);
#pragma unroll
          for (int k2 = 0; k2 < 0; ++k2)
            sm90::bulk_g2s(""")]

# name -> (K1's path, cuts)
VARIANTS = {
    "full": ("tiled", []),
    "K1 without the MAC and the X stores": ("tiled", NO_MAC),
    "K1 without its epilogue (residues, twiddles, MAC, X stores)":
        ("tiled", NO_EPILOGUE),
    "K1 without the BSK copy": ("tiled", NO_BSK),
    "K1 products only": ("tiled", NO_EPILOGUE + NO_BSK),
    "K1 products only, no operand copies":
        ("tiled", NO_EPILOGUE + NO_BSK + NO_COPIES),
    "persistent K1": ("persistent", []),
    "persistent K1 without the MAC and the X stores":
        ("persistent", P_NO_MAC),
    "persistent K1 without its epilogue (residues, twiddles, MAC, X stores)":
        ("persistent", P_NO_EPILOGUE),
    "persistent K1 without the residues' reductions": (
        "persistent", [(P_RESIDUES, P_RESIDUES.replace("g < 8", "g < 0"))]),
    "persistent K1 without writing the BSK rows": (
        "persistent", [(P_BSK_ROWS, P_BSK_ROWS.replace(
            "item < 2 * J * (kCols1 / 4)", "item < 0"))]),
    "persistent K1 without digit copies": ("persistent", P_NO_COPIES),
    "persistent K1 products only, no digit copies":
        ("persistent", P_NO_EPILOGUE + P_NO_COPIES),
    "K2 without the X copies (A stages)": ("persistent", K2_NO_A_COPY),
    "K2 without the inverse matrix's copies (B stages)":
        ("persistent", K2_NO_B_COPY),
    "K2 without its epilogue (residues, CRT, acc, digits)":
        ("persistent", K2_NO_EPILOGUE),
    "K2 products only, no operand copies":
        ("persistent", K2_NO_EPILOGUE + NO_COPIES),
    "K2 without the residues of each prime's product":
        ("persistent", K2_NO_EPILOGUE[:1]),
    "K2 without the CRT loop (CRT, acc, digits)":
        ("persistent", K2_NO_EPILOGUE[1:]),
    "K2 without the CRT's arithmetic": ("persistent", [(
        "blind_rotate.cu", K2_CRT_WORD, "      v[w] = old[w] + (yq[0] >> w);")]),
    "K2 without the acc stores": ("persistent", [(
        "blind_rotate.cu", K2_ACC_STORE, "    (void)out;")]),
    "K2 without the next digits": ("persistent", [(
        "blind_rotate.cu", K2_DIGITS, "    (void)a_lo; (void)a_hi;")]),
    "K2 one block an SM": ("persistent", K2_ONE_BLOCK),
    "K2 without its epilogue, one block an SM":
        ("persistent", K2_NO_EPILOGUE + K2_ONE_BLOCK),
    "K2 products only, no operand copies, one block an SM":
        ("persistent", K2_NO_EPILOGUE + NO_COPIES + K2_ONE_BLOCK),
    "K2 without the acc prefetch into L2": ("persistent", [(
        "blind_rotate.cu", K2_ACC_PREFETCH, K2_ACC_PREFETCH.replace(
            "threadIdx.x < 2 * (r_hi - r_lo)", "threadIdx.x < 0"))]),
}


def build(tmp: pathlib.Path, index: int, variant, verbose: bool = False):
    """(the variant's two libraries, blind_rotate.cu's and
    blind_rotate_k1.cu's, and nvcc's stderr).  A cut names its file, or
    takes the variant's kernel's: blind_rotate.cu for the tiled K1,
    blind_rotate_k1.cu for the persistent one."""
    src_dir = tmp / f"v{index}"
    shutil.copytree(cuda_build.CSRC, src_dir)
    path, cuts = variant
    own = "blind_rotate_k1.cu" if path == "persistent" else "blind_rotate.cu"
    for cut in cuts:
        name, old, new = cut if len(cut) == 3 else (own, *cut)
        text = (src_dir / name).read_text()
        if text.count(old) != 1:
            raise SystemExit(f"cut does not match {name} once: {old!r}")
        (src_dir / name).write_text(text.replace(old, new))
    flags = ("-Xptxas", "-v") if verbose else ()
    libs, err = [], ""
    for src in ("blind_rotate", "blind_rotate_k1"):
        so = src_dir / f"{src}.so"
        proc = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS,
                               *flags, "-o", str(so),
                               str(src_dir / f"{src}.cu")],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on variant {index}:\n"
                             f"{proc.stderr}")
        libs.append(ctypes.CDLL(str(so)))
        err += proc.stderr
    return libs, err


def ptxas_report(stderr: str) -> None:
    name = ""
    for line in stderr.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "registers" in line or "spill" in line or "C75" in line:
            print(f"ptxas {name[:64]}: {line.split(':')[-1].strip()}")


def random_keys(steps: int, dev):
    """PARAM_OPT's constant leaves with `steps` steps of random BSK limbs."""
    p = PARAM_OPT
    plan = ntt.make_plan(p.polynomial_size)
    rplan = keys.make_rotate_plan(p)
    kp1 = p.glwe_dimension + 1
    rows = kp1 * p.pbs_level * 2 * kp1
    rng = np.random.default_rng(steps)
    bsk = rng.integers(-128, 128, (steps, rows, rplan.n_primes *
                                   p.polynomial_size), dtype=np.int8)
    none = torch.zeros(1, dtype=torch.int8)
    return keys._keys_from_arrays(p, plan, rplan, dict(
        bsk_limbs=torch.from_numpy(bsk), ksk_limbs=none,
        pfpksk_limbs=none)).to(dev)


def random_batch(k, bits: int, steps: int, dev):
    p = k.params
    rng = np.random.default_rng(bits)
    lwe = rng.integers(0, 1 << 64, (bits, steps + 1), dtype=np.uint64)
    test = rng.integers(0, 1 << 64, (p.glwe_dimension + 1,
                                     p.polynomial_size), dtype=np.uint64)
    return torus.from_u64(lwe, dev), torus.from_u64(test, dev)


def step_ms(call, steps: int) -> dict[str, float]:
    """Device ms a step of K1 and K2 over one call."""
    call()                                              # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    out = {"K1": 0.0, "K2": 0.0}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        us = e.self_cuda_time_total if us is None else us
        for key, name in (("K1", "br_forward_mac_kernel"),
                          ("K2", "br_inverse_crt_kernel")):
            if name in e.key:
                out[key] += us / 1e3 / steps
    return out


def clock_and_power(call) -> str:
    """The SM clock and power draw nvidia-smi reports while `call` runs
    back to back for about two seconds, sampled after the first second."""
    stop = threading.Event()

    def load():
        while not stop.is_set():
            call()
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
    ap.add_argument("--bits", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--only", default="",
                    help="run only the variants whose name holds this text "
                         "(and the uncut builds)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("br_stage_cut: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    k = random_keys(args.steps, dev)
    params = dataclasses.replace(PARAM_OPT, lwe_dimension=args.steps)
    lwe, test = random_batch(k, args.bits, args.steps, dev)
    br_args = (k.rplan, params, k.bsk_limbs, lwe, test)
    argtypes = cuda_blind_rotate._lib().argtypes
    variants = {name: v for name, v in VARIANTS.items()
                if not v[1] or args.only in name}
    want = None
    with tempfile.TemporaryDirectory() as tmp:
        with concurrent.futures.ThreadPoolExecutor(len(variants)) as pool:
            built = list(pool.map(
                lambda item: build(pathlib.Path(tmp), *item,
                                   verbose=item[0] == 0),
                enumerate(variants.values())))
        ptxas_report(built[0][1])
        real_lib = cuda_blind_rotate._lib, cuda_blind_rotate._k1_lib
        real_edge = cuda_blind_rotate.K1_TILES_PER_SM
        try:
            for (name, (path, cuts)), ((lib, k1lib), _) in zip(
                    variants.items(), built):
                fn = lib.tfhe_blind_rotate
                fn.argtypes, fn.restype = argtypes, ctypes.c_int
                prepare = k1lib.tfhe_k1_prepare
                prepare.argtypes, prepare.restype = [], ctypes.c_int
                launch = ctypes.cast(k1lib.tfhe_k1_persistent,
                                     ctypes.c_void_p).value
                cuda_blind_rotate._k1_lib = (
                    lambda launch=launch, prepare=prepare: (launch, prepare))
                cuda_blind_rotate.K1_TILES_PER_SM = (
                    0 if path == "persistent" else 1 << 30)

                def call():
                    return cuda_blind_rotate.blind_rotate_cuda(
                        *br_args, k.fwd_full, k.inv_crt_full, k.rot_table)
                cuda_blind_rotate._lib = lambda fn=fn: fn
                if not cuts:
                    if want is None:
                        want = blind_rotate.blind_rotate_plain(
                            *br_args, k.rfwd_limbs, k.rinv_crt_limbs,
                            k.rot_table)
                    if not torch.equal(call(), want):
                        raise SystemExit(f"{name}: differs from the plain "
                                         f"version")
                    print(f"{name}, back to back: SM clock, its maximum, "
                          f"power draw: {clock_and_power(call)}")
                t = step_ms(call, args.steps)
                print(f"PARAM_OPT {args.bits} bits, {name}: K1 "
                      f"{t['K1']:.4f} ms a step, K2 {t['K2']:.4f} ms a step")
        finally:
            cuda_blind_rotate._lib, cuda_blind_rotate._k1_lib = real_lib
            cuda_blind_rotate.K1_TILES_PER_SM = real_edge
    return 0


if __name__ == "__main__":
    sys.exit(main())
