#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (tfhe_aes_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--blocks N] [--blocks2 M]

Phases, each printing its result on its own line; any failure raises and
the script exits non-zero:
  0. environment: the card, the native host runtime, the kernel builds;
  1. the blind-rotate kernel against blind_rotate_plain, word for word, at
     three toy sets x batches 1, 9, 128 and at PARAM_TPU batch 128; both
     timed at the AES-round batch (128 bits per block);
  2. the vertical-packing kernel against vp_rotations_plain through a real
     circuit bootstrap: a cbs_level=1 toy set, PARAM_TPU at 16 bytes x 8
     bits (AES-round LUTs) and 4 bytes x 9 bits (ripple-add LUTs); both
     timed at the AES-round shape;
  3. the main path at PARAM_TPU through Client and Server: host keygen,
     key expansion, two CTR keystream batches at different offsets, host
     decryption checked against plaintext AES, the kernels' launch counts.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.  Needs a CUDA device: without one it exits 1.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time

KEY = 0x2B7E151628AED2A6ABF7158809CF4F3C
IV = 0x00112233445566778899AABBCCDDEEFF


def _timed(fn, *args):
    """(result, ms) of fn(*args) on the card, synchronised."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _max_abs_err(got, want) -> float:
    """Largest |difference| of the u64 words as signed 64-bit integers."""
    return float((got - want).abs().max().item())


def _require_equal(got, want, what: str) -> float:
    import torch
    if not torch.equal(got, want):
        raise AssertionError(f"{what}: kernel words differ from the plain "
                             f"version")
    return _max_abs_err(got, want)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--blocks", type=int, default=4,
                    help="CTR blocks of the first keystream batch")
    ap.add_argument("--blocks2", type=int, default=32,
                    help="CTR blocks of the second, timed batch")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import numpy as np
    from tfhe_aes_tpu import runtime
    from tfhe_aes_tpu.backend import numpy_backend as nb
    from tfhe_aes_tpu.models import aes_plain, luts, tables
    from tfhe_aes_tpu.params import PARAM_TOY, PARAM_TOY_WIDE, PARAM_TPU
    from tfhe_aes_tpu_torch.client.client import Client
    from tfhe_aes_tpu_torch.models import fhe_aes
    from tfhe_aes_tpu_torch.ops import (blind_rotate, cbs, cuda_blind_rotate,
                                        cuda_build, cuda_vp, lwe,
                                        vertical_packing, wopbs)
    from tfhe_aes_tpu_torch.server import Server
    from tfhe_aes_tpu_torch.utils import torus

    dev = torch.device("cuda")
    U64 = np.uint64

    # -- phase 0: environment ------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"phase 0: torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    if runtime.get_lib() is None:
        raise RuntimeError("the native host runtime did not build")
    t0 = time.perf_counter()
    for name in ("blind_rotate", "vertical_packing"):
        cuda_build.load(name)
    print(f"phase 0: kernels built in {time.perf_counter() - t0:.1f} s "
          f"({cuda_build.BUILD_DIR})")

    # -- phase 1: blind-rotate kernel vs plain -------------------------------
    def rotate_inputs(params, n_batch, lwe_key):
        rng = np.random.default_rng(5)
        bits = rng.integers(0, 2, n_batch).astype(U64)
        small = nb.lwe_encrypt(lwe_key, bits << U64(63), params.lwe_noise_std,
                               rng)
        test = np.zeros((params.glwe_dimension + 1, params.polynomial_size),
                        U64)
        test[-1, :] = U64(1) << U64(60)
        return torus.from_u64(small, dev), torus.from_u64(test, dev)

    def rotate_pair(k, params, small, test):
        args = (k.rplan, params, k.bsk_limbs, small, test)
        got, ms = _timed(cuda_blind_rotate.blind_rotate_cuda, *args,
                         k.fwd_full, k.inv_crt_full, k.rot_table)
        want, plain_ms = _timed(blind_rotate.blind_rotate_plain, *args,
                                k.rfwd_limbs, k.rinv_crt_limbs, k.rot_table)
        return got, want, ms, plain_ms

    toy_l5 = dataclasses.replace(PARAM_TOY, name="PARAM_TOY_L5", pbs_level=5)
    for params in (PARAM_TOY, toy_l5, PARAM_TOY_WIDE):
        client = Client(params, seed=11)
        k = client.make_device_keys().to(dev)
        for n_batch in (1, 9, 128):
            small, test = rotate_inputs(params, n_batch, client.sk.lwe_key)
            got, want, _, _ = rotate_pair(k, params, small, test)
            _require_equal(got, want, f"blind rotate {params.name} B={n_batch}")
        print(f"phase 1: blind rotate {params.name} kernel == plain at "
              f"batches 1, 9, 128")

    t0 = time.perf_counter()
    client = Client(PARAM_TPU, seed=0)
    keys_host = client.make_device_keys()
    keygen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    keys = keys_host.to(dev)
    torch.cuda.synchronize()
    print(f"phase 1: PARAM_TPU host keygen {keygen_s:.1f} s, keys to card "
          f"{time.perf_counter() - t0:.1f} s")

    small, test = rotate_inputs(PARAM_TPU, 128, client.sk.lwe_key)
    got, want, _, _ = rotate_pair(keys, PARAM_TPU, small, test)
    br_err = _require_equal(got, want, "blind rotate PARAM_TPU B=128")
    aes_bits = 128 * args.blocks2
    small, test = rotate_inputs(PARAM_TPU, aes_bits, client.sk.lwe_key)
    got, want, br_ms, br_plain_ms = rotate_pair(keys, PARAM_TPU, small, test)
    br_err = max(br_err, _require_equal(got, want,
                                        f"blind rotate PARAM_TPU B={aes_bits}"))
    print(f"phase 1: blind rotate PARAM_TPU kernel == plain at B=128 and "
          f"B={aes_bits}; B={aes_bits}: kernel {br_ms:.1f} ms, plain "
          f"{br_plain_ms:.1f} ms")
    del got, want, small, test

    # -- phase 2: vertical-packing kernel vs plain ---------------------------
    def vp_case(k, cl, params, values, lut_np, nbits):
        """CBS of real encrypted bytes, then both VP versions on the same
        accumulators and GGSW; checks words and decryption."""
        p = params
        cts = np.stack([
            nb.lwe_encrypt(cl.sk.big_lwe_key,
                           np.array([(v >> j) & 1 for j in range(nbits)],
                                    U64) << U64(63),
                           p.glwe_noise_std, np.random.default_rng(v))
            for v in values])
        cts = torus.from_u64(cts, dev)
        B = len(values)
        small = wopbs.extract_bits(k, cts).reshape(B * nbits, -1)
        bigs = cbs.cbs_pbs_levels(k, small)
        g = cbs.cbs_stage_ggsw(k, bigs)
        g = g.reshape((g.shape[0], B, nbits) + g.shape[2:])
        ggsw = g.movedim(2, 0).contiguous()
        lut = torus.from_u64(lut_np, dev)
        L = lut.shape[1]
        acc = torch.zeros((B, L, p.glwe_dimension + 1, p.polynomial_size),
                          dtype=torch.int64, device=dev)
        acc[..., -1, :] = lut[:, :, 0].expand(B, L, p.polynomial_size)
        got, ms = _timed(cuda_vp.vp_rotations_cuda, k, acc, ggsw)
        want, plain_ms = _timed(vertical_packing.vp_rotations_plain, k, acc,
                                ggsw)
        err = _require_equal(got, want, f"VP {p.name} {B} bytes x {nbits}")
        return torus.to_u64(lwe.sample_extract0(got)), err, ms, plain_ms

    def decrypt_lut_check(cl, out, values, want_fn, n_out):
        for bi, v in enumerate(values):
            got = [int(cl.decrypt_bits(out[bi, o])) for o in range(n_out)]
            if got != want_fn(bi, v):
                raise AssertionError(f"VP output of byte {v} decrypts wrong")

    sbox = tables.sbox()
    toy_vp = dataclasses.replace(PARAM_TOY, name="PARAM_TOY_VP", cbs_level=1,
                                 cbs_base_log=15)
    cl_vp = Client(toy_vp, seed=11)
    k_vp = cl_vp.make_device_keys().to(dev)
    vals = [0x5A, 0x01, 0xFF, 0x80]
    # toy N=128 < 2^8: exercise the kernel on the 7 rotation bits of a
    # 7-bit table (the CMux tree for an 8th bit stays plain torch).
    t7 = np.arange(128, dtype=np.uint64) * 3 % 128
    out, _, _, _ = vp_case(k_vp, cl_vp, toy_vp, [v % 128 for v in vals],
                           luts.lut_polys_from_tables(toy_vp, t7[None], 7), 7)
    decrypt_lut_check(cl_vp, out, [v % 128 for v in vals],
                      lambda bi, v: [(int(t7[v]) >> o) & 1 for o in range(8)],
                      8)
    print("phase 2: VP PARAM_TOY_VP kernel == plain (4 bytes x 7 bits), "
          "decrypts to the table")

    fwd = fhe_aes._fwd_luts(PARAM_TPU)
    mul = [sbox, tables.gf_mul_table(2)[sbox], tables.gf_mul_table(3)[sbox]]
    vals16 = [(37 * i + 11) % 256 for i in range(16)]
    out, vp_err, _, _ = vp_case(keys, client, PARAM_TPU, vals16, fwd, 8)
    decrypt_lut_check(client, out, vals16, lambda bi, v: [
        (int(mul[o // 8][v]) >> (o % 8)) & 1 for o in range(24)], 24)
    i_bytes = fhe_aes.counter_bytes(4, 0x1FE)
    _, rest = fhe_aes.add_scalar_luts(PARAM_TPU, i_bytes)
    vals9 = [0x0FF, 0x1FF, 0x000, 0x17F]
    out, err9, _, _ = vp_case(keys, client, PARAM_TPU, vals9, rest[0], 9)
    vp_err = max(vp_err, err9)

    def want9(bi, v):
        s = (v & 0xFF) + (v >> 8) + int(i_bytes[bi, 14])
        return [((s % 256) >> o) & 1 for o in range(8)] + [int(s > 255)]
    decrypt_lut_check(client, out, vals9, want9, 9)
    aes_bytes = 16 * args.blocks2
    vals_t = [(13 * i + 5) % 256 for i in range(aes_bytes)]
    _, err_t, vp_ms, vp_plain_ms = vp_case(keys, client, PARAM_TPU, vals_t,
                                           fwd, 8)
    vp_err = max(vp_err, err_t)
    print(f"phase 2: VP PARAM_TPU kernel == plain at 16 B x 8 bits, 4 B x 9 "
          f"bits and {aes_bytes} B x 8 bits (L=24), all decrypt right; "
          f"{aes_bytes} B: kernel {vp_ms:.1f} ms, plain {vp_plain_ms:.1f} ms")

    # -- phase 3: the main path ----------------------------------------------
    server = Server(keys)
    enc_key = torus.from_u64(client.encrypt_u128(KEY), dev)
    enc_iv = torus.from_u64(client.encrypt_u128(IV), dev)
    cuda_blind_rotate.blind_rotate_cuda.launches = 0
    cuda_vp.vp_rotations_cuda.launches = 0
    rks, keyexp_ms = _timed(server.aes_key_expansion, enc_key)
    ks1, ctr1_ms = _timed(server.ctr_keystream, rks, enc_iv, args.blocks, 0)
    ks2, ctr2_ms = _timed(server.ctr_keystream, rks, enc_iv, args.blocks2,
                          args.blocks)
    launches = {"blind_rotate": cuda_blind_rotate.blind_rotate_cuda.launches,
                "vertical_packing": cuda_vp.vp_rotations_cuda.launches}
    rk_host = torus.to_u64(rks)
    want_rk = aes_plain.key_expansion(aes_plain.u128_to_bytes_be(KEY))
    for r in range(11):
        got_rk = [client.decrypt_byte(rk_host[r, i]) for i in range(16)]
        if got_rk != want_rk[r]:
            raise AssertionError(f"round key {r} decrypts wrong")
    client.fetch_and_verify_ctr(ks1, KEY, IV, offset=0)
    client.fetch_and_verify_ctr(ks2, KEY, IV, offset=args.blocks)
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel was not launched: {launches}")
    print(f"phase 3: PARAM_TPU key expansion {keyexp_ms / 1e3:.2f} s, "
          f"decrypts to the AES schedule")
    print(f"phase 3: CTR {args.blocks} blocks (offset 0) "
          f"{ctr1_ms / 1e3:.2f} s; {args.blocks2} blocks (offset "
          f"{args.blocks}) {ctr2_ms / 1e3:.2f} s = "
          f"{args.blocks2 / (ctr2_ms / 6e4):.3f} blocks/min; all decrypt to "
          f"AES-128 CTR")
    print(f"phase 3: launches {launches}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")

    kernels = [
        {"name": "blind_rotate", "route": "cuda",
         "source": "tfhe_aes_tpu_torch/csrc/blind_rotate.cu",
         "replaces": "tfhe_aes_tpu/ops/pallas_blind_rotate.py:73",
         "launches": launches["blind_rotate"], "max_abs_err": br_err,
         "ms": br_ms, "plain_ms": br_plain_ms},
        {"name": "vertical_packing", "route": "cuda",
         "source": "tfhe_aes_tpu_torch/csrc/vertical_packing.cu",
         "replaces": "tfhe_aes_tpu/ops/pallas_vp.py:63",
         "launches": launches["vertical_packing"], "max_abs_err": vp_err,
         "ms": vp_ms, "plain_ms": vp_plain_ms},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
