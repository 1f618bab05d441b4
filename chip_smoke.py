#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (tfhe_aes_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--blocks N] [--blocks2 M]

Phases, each printing its result on its own line; any failure raises and
the script exits non-zero:
  0. environment: the card, the native host runtime, the kernel builds;
  1. the blind-rotate kernel against blind_rotate_plain, word for word, at
     four toy sets (one with 25 GGSW rows) x batches 1, 9, 128, at
     PARAM_TPU at every batch the paths below give it (16 to 1024 bits,
     and phase 7's 64-block AES round, 8192 bits, timed) and at
     PARAM_OPT (the CLI's default set, 25 rows) at the batches of its
     4-block CTR on both of K2's paths (one block a tile; a cluster of one
     block a prime, which cuda_blind_rotate.k2_cluster picks for batches
     of up to 128 bits on the H100), each timed beside its bound; then on
     both of K1's paths (one block a tile; the persistent K1, which
     cuda_blind_rotate.k1_persistent picks from 4 tiles an SM) at PARAM_OPT
     8, 16, 32, 128, 144, 512, 1024, 2048 and 4096 bits and PARAM_TPU 8192
     bits (where its slice does not fit, one block a tile only), each path's
     words against the plain version (its first 16 rows above 512 bits) and
     the other path's, timed, and from 144 bits on K2's device ms a step
     (the rule's K2, one profiled call); ptxas's registers and spills of
     K2's two instances (no spill allowed); then torch._int_mm on one
     step's product shapes as a yardstick of the int8 product rate;
  2. the vertical-packing kernel against vp_rotations_plain through a real
     circuit bootstrap: two cbs_level=1 toy sets (k+1 = 3; k+1 = 5 at a
     batch that fills neither a digit tile's group of 25 accumulators nor
     a 128-row tile); PARAM_TPU at the paths' byte-LUT shapes: AES rounds
     (L=24) and final rounds (S-box, L=8) at 16 to 1024 bytes (1024, the
     64-block round, timed), the ripple add (L=9) at 2, 4, 8 and 64 blocks,
     the key-expansion round (L=16), decrypt's L=8 and L=32 at 64 and 16
     bytes, the SubWord and pk-RCON refreshes at 4 and 12 bytes (L=8),
     each timed beside its bound; then torch._int_mm on one selector bit's
     product shapes as a yardstick (PARAM_OPT's VP shapes are PARAM_TPU's:
     the two sets differ only in the blind rotate's decomposition);
  3. the main path at PARAM_TPU through Client and Server: host keygen,
     key expansion, two CTR keystream batches (4 and 8 blocks) at
     different offsets, host decryption checked against plaintext AES,
     the kernels' launch counts.  From here on the server's circuits
     (phases 3, 5-7, 10, 12: CTR batches, AES encryption and decryption,
     the pk-RCON key expansion) are replays of whole-function CUDA graphs
     (models/fhe_aes's ctr_step_jit, aes_encrypt_jit, aes_decrypt_jit,
     aes_key_expansion_jit), captured at the first call of a key set and
     shape, every WoPBS inside inline, and so is phase 8's mesh function
     over NCCL, its collectives inside (parallel/mesh.sharded_ctr_fn);
     the trivial key expansion and phase 6's run with the noise checks
     armed replay a graph a WoPBS (ops/graphs.py); phase 8 (b)'s gloo
     ranks and the noise study (phase 9) run eagerly;
  4. device keygen: PARAM_TOY on the card equals the CPU leaf by leaf;
     PARAM_TPU timed beside phase 1's host keygen; its keys saved to the
     key cache in a temporary directory and loaded back to equal leaves;
  5. the reference circuits at PARAM_TPU on those keys: pk-RCON key
     expansion, aes_encrypt of the 4 NIST blocks, aes_decrypt back, each
     timed and checked, with the kernels' launch counts; then one more
     aes_decrypt under torch.profiler, each kernel's device time;
  6. the CLI in-process on the cached keys: a 2-block CTR run with
     --pk-rcon --decrypt --noise-asserts, then the --test harness;
  7. CTR batches through Client and Server: PARAM_TPU at 64 blocks
     (device keygen beside the warm-up, saved to the seed-0 key cache),
     its second call (a replay) timed, every block verified on the host
     and 4 decrypted back homomorphically; then PARAM_OPT at 4 blocks,
     verified on the card;
  8. the mesh: (a) the multi-process CTR launcher with one rank a card
     over NCCL, PARAM_TPU, 8 blocks, keys from phase 7's cache, every
     block verified by its rank, each rank's mesh function one graph
     (first call and timed replay printed, with its peak memory); (b) two
     ranks on the one card over gloo, dp=1 x mp=2 with the keyswitch
     keys' contraction rows and each round's bytes split between them,
     PARAM_TOY, 2 blocks: equal word for word to the one-rank
     ctr_keystream on the same keys, eager (gloo is not capturable);
     (c) one spawned rank on a one-rank NCCL world, dp=1 x mp=1,
     contraction rows and bytes sharded, PARAM_TPU, 8 blocks, phase 7's
     keys: the graphed mesh function's first call and two replays equal
     to ctr_keystream in this process word for word and decrypting to
     AES; one capture, three replays, its held launches against its
     WoPBS, counts and kernel nodes; NCCL's copy nodes in its DOT dump,
     the ten byte all-gathers' among them;
  9. the measured noise study (python -m tfhe_aes_tpu_torch.noise_study)
     at PARAM_TPU and PARAM_OPT on phase 7's seed-0 caches: 4096 boolean
     PBS and a 512-byte identity-LUT WoPBS each, every sigma printed
     beside the TPU's, any failed budget check fails the run, the reports
     in the temporary directory; then each set's 4096-bit rotate batch
     through the kernel again, timed beside its bound, its first 16 rows
     against the plain version and its extracted phases against the
     study's errors;
 10. cold start: the package copied into a temporary directory without its
     _build/, an empty key cache, and python -m tfhe_aes_tpu_torch.cli
     --params tpu --seed 0 --number-of-outputs 2 --device-verify run in a
     subprocess twice: cold (both nvcc builds in the warm-up, device
     keygen, the cache save) and warm (the built libraries, the saved
     keys); for each, the seconds to the first verified block, the
     warm-up's report, keygen or key load and the first key expansion;
 11. the compiled dispatch units on phase 7's PARAM_TPU keys: the staged
     key expansion graphed (first, warm) against every WoPBS eager, word
     for word; graphed against eager word for word at every shape the
     main path's graphs take (key expansion 16 B, L=16; phase 7's
     ripple add 64 B at 8 and 9 bits, L=9; its AES rounds 1024 B, L=24 and
     L=8; decrypt 64 B, L=8 and L=32; pk-RCON 4, 12 and 4 B, L=8), each
     graph's kernel nodes (read from its DOT dump) equal to the launches
     that its replays add to the counts; the rotate alone at 16 and 128
     bits, eager and replayed; the peak memory of the 1024-byte rounds,
     eager and graphed.  Times are medians of 3;
 12. the whole-function units on phase 7's PARAM_TPU keys: each of
     add_scalar_device_jit, ctr_step_jit, aes_encrypt_jit, aes_decrypt_jit
     (4 blocks) and aes_key_expansion_jit (trivial and pk-RCON) graphed,
     its first call and its replays against the function run eagerly,
     word for word, decrypting as AES says; its graph's rotate and VP
     calls against the WoPBS it runs, its kernel nodes (DOT dump) against
     them; eager, first-call and replay times; the 4-block decrypt
     profiled graphed and eager; then the memory sweep:
     Server.ctr_keystream over 1 to 8 blocks in turn on one key set, then
     1 and 8 again, the allocated and reserved memory after each beside
     the bytes of the new graph's static buffers.
Every launch count is what the port's counts (utils/profiling) grew by
over one run of a path (phases 3, 5 and 6; each of phase 7's two runs; each of phase 8's (a), (b)
and (c), whose ranks count their own and report them; each of phase 9's two study
runs, summed; phase 10's two CLI processes, each counting its own and
summed; phase 11, eager and graphed calls together; phase 12, the
same); a replay counts
the launches its graph holds, a capture none.  Every kernel of a path
must have been launched, and (b),
at cbs_level 2, must launch the rotate and no VP.  The comparisons with
the plain versions are not counted.  The key cache of phases 4-12 lives
in a temporary directory, removed at the end; phase 10's in one of its
own.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.  Needs a CUDA device: without one it exits 1.
Imports nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

# Published dense peaks of one H100 SXM (NVIDIA's data sheet, 700 W): the
# bounds are the larger of operations over the int8 rate and bytes over the
# memory rate.
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12

KEY = 0x2B7E151628AED2A6ABF7158809CF4F3C
IV = 0x00112233445566778899AABBCCDDEEFF
KERNELS = ("blind_rotate", "blind_rotate_k1", "vertical_packing")
CACHE_SEED = 1          # the seed of phase 4's keys and phase 6's CLI runs
CLI_BLOCKS = 2          # phase 6's CTR run
BENCH_BLOCKS = 64       # phase 7: the PARAM_TPU batch
BENCH_DECRYPT = 4       # phase 7: its blocks decrypted back
OPT_BLOCKS = 4          # phase 7: the PARAM_OPT batch
MESH_BLOCKS = 8         # phase 8 (a): the launcher's batch, PARAM_TPU
TOY_MESH_BLOCKS = 2     # phase 8 (b): the two-rank gloo batch, PARAM_TOY
NOISE_PBS = 4096        # phase 9: boolean PBS bits of a set's study
NOISE_WOPBS_BYTES = 512  # phase 9: identity-LUT WoPBS bytes of a set's study
NOISE_PLAIN_ROWS = 16   # phase 9: rotate rows held against the plain version
COLD_BLOCKS = 2         # phase 10: the CLI's CTR blocks, cold and warm
UNIT_BLOCKS = 4         # phase 12: the batch units' blocks
SWEEP_BLOCKS = 8        # phase 12: the memory sweep's largest CTR batch
# The TPU's measured sigmas, log2, boolean PBS and WoPBS output
# (NOISE_REPORT_TPU.md, NOISE_REPORT.md): printed beside the card's.
TPU_SIGMAS = {"PARAM_TPU": (36.06, 55.63), "PARAM_OPT": (32.09, 53.25)}


def _timed(fn, *args, **kwargs):
    """(result, ms) of fn(*args, **kwargs) on the card, synchronised."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _int_mm_ms(cases: dict) -> dict:
    """ms of each case's torch._int_mm calls, the mean of five after a
    warm-up.  A case is a list of ((rows, depth, columns), count): that
    many products of ones [rows, depth] x [depth, columns] a call."""
    import torch
    out = {}
    for name, products in cases.items():
        ops = [(torch.ones(m, k, dtype=torch.int8, device="cuda"),
                torch.ones(k, n, dtype=torch.int8, device="cuda"), count)
               for (m, k, n), count in products]

        def call():
            for a, b, count in ops:
                for _ in range(count):
                    torch._int_mm(a, b)
        call()
        _, ms = _timed(lambda: [call() for _ in range(5)])
        out[name] = ms / 5
    return out


def _bound(ops: float, nbytes: float) -> tuple[float, str]:
    """(ms, what bounds it) of the least time the card could take."""
    t_ops, t_bytes = ops / PEAK_INT8_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def rotate_bound(params, plan, n_bits: int) -> tuple[float, str]:
    """A blind rotation of n_bits LWE bits: per step the forward product
    [B R, dn] x [dn, 2 P N] and P inverse products [B (k+1), 2N] x [2N, 2N]
    (int8); it reads the LWE batch, the test polynomial, n steps of BSK
    rows, the NTT matrices and the twiddles, and writes the accumulators."""
    n, kp1 = params.polynomial_size, params.glwe_dimension + 1
    r_rows, pcount, steps = kp1 * params.pbs_level, plan.n_primes, \
        params.lwe_dimension
    pn = pcount * n
    dn = 2 * n if params.pbs_base_log > 8 else n
    ops = steps * (2 * n_bits * r_rows * dn * 2 * pn
                   + 2 * n_bits * kp1 * 2 * n * 2 * n * pcount)
    nbytes = (n_bits * (steps + 1) * 8 + kp1 * n * 8
              + steps * r_rows * 2 * kp1 * pn + dn * 2 * pn
              + pcount * 4 * n * n + 2 * n * pn * 2 + n_bits * kp1 * n * 8)
    return _bound(ops, nbytes)


def vp_bound(params, plan, n_bytes: int, L: int, nbits: int):
    """The VP rotations of n_bytes x L accumulators over nbits selector
    bits: per bit the forward product [M, 2N] x [2N, 2 P N] (a digit as
    two int8 limbs) and P inverse products [M, 2N] x [2N, 2N], M =
    n_bytes L (k+1); it reads and writes the accumulators and reads the
    GGSW residues and the NTT matrices."""
    n, kp1, pcount = params.polynomial_size, params.glwe_dimension + 1, \
        plan.n_primes
    m, pn = n_bytes * L * kp1, pcount * n
    ops = nbits * (2 * m * 2 * n * 2 * pn + 2 * m * 2 * n * 2 * n * pcount)
    nbytes = (2 * m * n * 8 + nbits * pcount * n_bytes * kp1 * kp1 * n * 4
              + 2 * n * 2 * pn + pcount * 4 * n * n)
    return _bound(ops, nbytes)


def _max_abs_err(got, want) -> float:
    """Largest |difference| of the u64 words as signed 64-bit integers."""
    return float((got - want).abs().max().item())


def _require_equal(got, want, what: str) -> float:
    import torch
    if not torch.equal(got, want):
        raise AssertionError(f"{what}: the words differ")
    return _max_abs_err(got, want)


# The kernels whose calls the phases count, by name: their keys in the
# port's counts (utils/profiling.COUNTS).
COUNTED = {"blind_rotate": "rotate_calls", "vertical_packing": "vp_calls"}


def _launches(since=None) -> dict:
    """The counted kernels' calls so far by name, less those of `since`
    (an earlier _launches())."""
    from tfhe_aes_tpu_torch.utils import profiling
    return {name: profiling.COUNTS[key] - (since or {}).get(name, 0)
            for name, key in COUNTED.items()}


def _held(graph) -> dict:
    """The counted kernels' calls a replay of `graph` adds, by name."""
    return {name: graph.record.counts[key] for name, key in COUNTED.items()}


def _read_launches(since: dict, path: str) -> dict:
    """The launch counts since `since` (_launches()); raises if a kernel
    of the path was not launched."""
    counts = _launches(since)
    if min(counts.values()) < 1:
        raise AssertionError(f"{path}: a kernel was not launched: {counts}")
    return counts


def _run_cli(cli, argv) -> tuple[str, float]:
    """cli.main(argv) in this process; echoes its output, raises unless it
    returns 0.  Returns (output, seconds)."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
    finally:
        for line in buf.getvalue().splitlines():
            print(f"phase 6:   {line}")
    if rc != 0:
        raise AssertionError(f"cli {' '.join(argv)} returned {rc}")
    return buf.getvalue(), time.perf_counter() - t0


def _profile_decrypt(server, rks, ct, n_blocks: int,
                     phase: str = "phase 5", top: int = 8) -> float:
    """Where the time goes: one warm aes_decrypt under torch.profiler, the
    device time of each kernel (self time, summed over launches).  Returns
    the card's busy share, in percent."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def dev_ms(e):
        us = getattr(e, "self_device_time_total", None)
        return (us if us is not None else e.self_cuda_time_total) / 1e3

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = _timed(server.aes_decrypt, rks, ct)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and dev_ms(e) > 0]
    busy = sum(dev_ms(e) for e in kernels)
    print(f"{phase}: profile of one warm aes_decrypt of {n_blocks} blocks: "
          f"wall {wall:.1f} ms, kernels {busy:.1f} ms on the card "
          f"({100 * busy / wall:.1f}% busy)")
    ranked = sorted(kernels, key=dev_ms, reverse=True)
    for e in ranked[:top] + [e for e in ranked[top:] if "tfhe::" in e.key]:
        print(f"{phase}:   {dev_ms(e):9.1f} ms {100 * dev_ms(e) / busy:5.1f}% "
              f"x{e.count:<6} {e.key[:70]}")
    return 100 * busy / wall


def _reference_phases(dev, host_keygen_s: float) -> dict:
    """Phases 4-6, with the key cache in $TFHE_AES_TPU_CACHE.  Returns the
    launch counts of each path run."""
    import numpy as np
    import torch
    from tfhe_aes_tpu_torch import cli
    from tfhe_aes_tpu_torch.client.client import Client
    from tfhe_aes_tpu_torch.models import aes_plain
    from tfhe_aes_tpu_torch.ops.keys import KEY_LEAVES
    from tfhe_aes_tpu_torch.params import PARAM_TOY, PARAM_TPU
    from tfhe_aes_tpu_torch.server import Server
    from tfhe_aes_tpu_torch.utils import serialization, torus

    def require_same_keys(got, want, what):
        for name in KEY_LEAVES:
            a, b = getattr(got, name), getattr(want, name)
            if a.device != b.device:
                a = a.to(b.device)
            if not torch.equal(a, b):
                raise AssertionError(f"{what}: leaf {name} differs")

    # -- phase 4: device keygen and the key cache -----------------------------
    toy_cpu = Client(PARAM_TOY, seed=11).make_device_keys(fast=True,
                                                         device="cpu")
    toy_card = Client(PARAM_TOY, seed=11).make_device_keys(fast=True,
                                                          device=dev)
    if any(getattr(toy_card, n).device.type != dev.type for n in KEY_LEAVES):
        raise AssertionError("device keygen left a leaf off the card")
    require_same_keys(toy_card, toy_cpu, "PARAM_TOY device keygen card/CPU")
    print("phase 4: PARAM_TOY device keygen on the card == on the CPU, "
          "leaf by leaf")
    t0 = time.perf_counter()
    client = Client(PARAM_TPU, seed=CACHE_SEED)
    keys = client.make_device_keys(fast=True, device=dev)
    torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t0
    print(f"phase 4: PARAM_TPU device keygen {keygen_s:.1f} s (host keygen, "
          f"phase 1: {host_keygen_s:.1f} s)")
    path = serialization.cache_path(PARAM_TPU, CACHE_SEED)
    t0 = time.perf_counter()
    serialization.save_keys(path, client.sk, keys)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sk, loaded = serialization.load_keys(path)
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = loaded.to(dev)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    if not (np.array_equal(sk.lwe_key, client.sk.lwe_key)
            and np.array_equal(sk.glwe_key, client.sk.glwe_key)):
        raise AssertionError("key cache: secret keys differ")
    require_same_keys(loaded, keys, "key cache round trip")
    del loaded, toy_card, toy_cpu
    print(f"phase 4: key cache {path.name} {path.stat().st_size / 2**20:.1f} "
          f"MiB: save {save_s:.1f} s, load {load_s:.1f} s, to the card "
          f"{upload_s:.1f} s; every leaf equal")

    # -- phase 5: the reference circuits on those keys ------------------------
    server = Server(keys, client.make_public_key(),
                    rng=np.random.default_rng(7))
    enc_key = torus.from_u64(client.encrypt_u128(cli.NIST_KEY), dev)
    state = torus.from_u64(np.stack([client.encrypt_u128(p)
                                     for p in cli.NIST_PLAINS]), dev)
    start = _launches()
    rks, pk_ms = _timed(server.aes_key_expansion, enc_key, pk_rcon=True)
    ct, enc_ms = _timed(server.aes_encrypt, rks, state)
    pt, dec_ms = _timed(server.aes_decrypt, rks, ct)
    launches = _read_launches(start, "phase 5")
    rk_host = torus.to_u64(rks)
    want_rk = aes_plain.key_expansion(aes_plain.u128_to_bytes_be(cli.NIST_KEY))
    for r in range(11):
        if [client.decrypt_byte(rk_host[r, i]) for i in range(16)] \
                != want_rk[r]:
            raise AssertionError(f"pk-RCON round key {r} decrypts wrong")
    ct_host, pt_host = torus.to_u64(ct), torus.to_u64(pt)
    n = len(cli.NIST_PLAINS)
    if [client.decrypt_state_u128(ct_host[i]) for i in range(n)] \
            != list(cli.NIST_CIPHERS):
        raise AssertionError("aes_encrypt of the NIST blocks is not AES")
    if [client.decrypt_state_u128(pt_host[i]) for i in range(n)] \
            != list(cli.NIST_PLAINS):
        raise AssertionError("aes_decrypt does not give the plaintexts back")
    print(f"phase 5: PARAM_TPU pk-RCON key expansion {pk_ms / 1e3:.2f} s, "
          f"decrypts to the AES schedule")
    print(f"phase 5: aes_encrypt {n} NIST blocks {enc_ms / 1e3:.2f} s, "
          f"equal to AES; aes_decrypt {dec_ms / 1e3:.2f} s = "
          f"{n / (dec_ms / 6e4):.3f} decrypt blocks/min, back to the "
          f"plaintexts")
    print(f"phase 5: launches {launches}")
    _profile_decrypt(server, rks, ct, n)
    del server, keys, rks, ct, pt, state, enc_key

    # -- phase 6: the CLI, on the cached keys ---------------------------------
    start = _launches()
    seed = str(CACHE_SEED)
    outs = [_run_cli(cli, ["--params", "tpu", "--seed", seed,
                           "--number-of-outputs", "2", "--iv", hex(IV),
                           "--key", hex(KEY), "--pk-rcon", "--decrypt",
                           "--noise-asserts"]),
            _run_cli(cli, ["--params", "tpu", "--seed", seed, "--test",
                           "--test-random", "1"])]
    cli_launches = _read_launches(start, "phase 6")
    for text, _ in outs:
        if "loaded cached keys" not in text or "device keygen" in text:
            raise AssertionError("the CLI did not load the key cache")
    if "All 5 test cases passed." not in outs[1][0]:
        raise AssertionError("the CLI test harness did not pass")
    print(f"phase 6: CLI CTR run {outs[0][1]:.1f} s, --test harness "
          f"{outs[1][1]:.1f} s, both from the key cache, both returned 0; "
          f"launches {cli_launches}")
    return {"reference circuits (phase 5)": launches,
            "cli (phase 6)": cli_launches}


def _ctr_phase(dev) -> dict:
    """Phase 7: PARAM_TPU at 64 blocks with 4 blocks decrypted back, then
    PARAM_OPT at 4 blocks verified on the card, each batch timed on its
    second call (a replay); keys by device keygen beside the warm-up,
    saved to the seed-0 key cache the later phases load; PARAM_OPT's
    rotate calls run K1 persistently, PARAM_TPU's none.  Returns the
    launch counts of each run, by path."""
    import torch
    from tfhe_aes_tpu_torch import cli
    from tfhe_aes_tpu_torch.params import PARAM_OPT, PARAM_TPU
    from tfhe_aes_tpu_torch.server import Server
    from tfhe_aes_tpu_torch.utils import profiling, torus, warmup

    runs = ((PARAM_TPU, BENCH_BLOCKS, BENCH_DECRYPT, False),
            (PARAM_OPT, OPT_BLOCKS, 0, True))
    torch.cuda.empty_cache()
    paths = {}
    for params, blocks, decrypt, on_card in runs:
        start = _launches()
        persistent0 = profiling.COUNTS["rotate_persistent_calls"]
        t0 = time.perf_counter()
        warm = warmup.precompile(params, blocks, device=dev)
        client, keys = cli.client_and_keys(params, 0, dev, True)
        report = warm.join()
        server = Server(keys)
        enc_key = torus.from_u64(client.encrypt_u128(KEY), dev)
        enc_iv = torus.from_u64(client.encrypt_u128(IV), dev)
        rks = profiling.device_fence(server.aes_key_expansion(enc_key))
        # The batch's first call: a one-block warm-up, the capture, a replay.
        profiling.device_fence(server.ctr_keystream(rks, enc_iv, blocks, 1))
        t1 = time.perf_counter()
        ks = profiling.device_fence(
            server.ctr_keystream(rks, enc_iv, blocks, 1))
        ctr_s = time.perf_counter() - t1
        if on_card:
            client.verify_ctr_device(ks, KEY, IV, offset=1)
        else:
            client.fetch_and_verify_ctr(ks, KEY, IV, offset=1)
        if decrypt:
            back = torus.to_u64(server.aes_decrypt(rks, ks[:decrypt]))
            for i in range(decrypt):
                if client.decrypt_state_u128(back[i]) != IV + 1 + i:
                    raise AssertionError(f"{params.name}: decrypt "
                                         f"round-trip block {i} wrong")
        path = f"ctr {params.name} (phase 7)"
        paths[path] = _read_launches(start, path)
        # PARAM_OPT's rounds (512 bits) run K1 persistently; PARAM_TPU's
        # slice does not fit, so none of its rotates do.
        persistent = profiling.COUNTS["rotate_persistent_calls"] - persistent0
        if (persistent > 0) != (params is PARAM_OPT):
            raise AssertionError(f"phase 7: {params.name}: {persistent} "
                                 f"rotate calls ran K1 persistently")
        print(f"phase 7: {params.name} {blocks} blocks {ctr_s:.2f} s = "
              f"{blocks / ctr_s * 60:.3f} blocks/min (warm, a graph "
              f"replay), every block verified on the "
              f"{'card' if on_card else 'host'}"
              f"{f', {decrypt} decrypted back' if decrypt else ''}; "
              f"warm-up {report}; whole run "
              f"{time.perf_counter() - t0:.1f} s; launches {paths[path]}, "
              f"{persistent} of the rotate calls with K1 persistent")
        del server, keys, rks, ks
    return paths


def _toy_mesh_rank(rank, out_dir, port) -> None:
    """Phase 8 (b), one of two ranks on the one card over gloo: dp=1 x
    mp=2, contraction rows and bytes sharded.  Saves its keystream and its
    kernels' launch counts."""
    import numpy as np
    import torch
    from tfhe_aes_tpu_torch.client.client import Client
    from tfhe_aes_tpu_torch.ops import graphs
    from tfhe_aes_tpu_torch.parallel import mesh
    from tfhe_aes_tpu_torch.params import PARAM_TOY

    os.environ.update(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK="0",
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    m = mesh.make_mesh(n_dp=1, n_mp=2, backend="gloo")
    try:
        keys = Client(PARAM_TOY, seed=11).make_device_keys(device=m.device)
        skeys = mesh.shard_keys(m, keys, shard_contractions=True)
        x = {k: torch.from_numpy(v) for k, v in
             np.load(os.path.join(out_dir, "in.npz")).items()}
        fn = mesh.sharded_ctr_fn(m, skeys, TOY_MESH_BLOCKS, shard_bytes=True)
        start = _launches()
        local, _ = fn(x["rks"], x["iv"], x["lut_lsb"], x["luts_rest"])
        whole = mesh.gather_blocks(m, local).cpu().numpy()
        launches = _launches(start)
        np.save(os.path.join(out_dir, f"out{rank}.npy"), whole)
        with open(os.path.join(out_dir, f"launches{rank}.json"), "w") as f:
            json.dump({"launches": launches,
                       "capturable": graphs.capturable(m.mp_group),
                       "captures": graphs.GRAPHS.captures}, f)
    finally:
        torch.distributed.destroy_process_group()


def _nccl_mesh_rank(rank, out_dir, port) -> None:
    """Phase 8 (c), the rank of a one-rank NCCL world: dp=1 x mp=1,
    contraction rows and bytes sharded, PARAM_TPU keys from phase 7's
    cache.  The graphed sharded_ctr_fn's first call on inputs A, then
    replays on B and A; saves the three keystreams and a record of the
    graph: its calls, launches, kernel and copy nodes, times, memory."""
    import numpy as np
    import torch
    from tfhe_aes_tpu_torch.client.client import Client
    from tfhe_aes_tpu_torch.models import fhe_aes
    from tfhe_aes_tpu_torch.ops import graphs
    from tfhe_aes_tpu_torch.parallel import mesh
    from tfhe_aes_tpu_torch.params import PARAM_TPU
    from tfhe_aes_tpu_torch.utils import serialization

    os.environ.update(RANK=str(rank), WORLD_SIZE="1", LOCAL_RANK="0",
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    p = PARAM_TPU
    m = mesh.make_mesh(n_dp=1, n_mp=1)
    try:
        client = Client(p, seed=0)
        client.sk, raw = serialization.load_keys(
            serialization.cache_path(p, 0))
        skeys = mesh.shard_keys(m, raw, shard_contractions=True)
        del raw
        x = {k: torch.from_numpy(v) for k, v in
             np.load(os.path.join(out_dir, "in.npz")).items()}
        fn = mesh.sharded_ctr_fn(m, skeys, MESH_BLOCKS, shard_bytes=True)
        graphs.GRAPHS.cuda.keep = True          # for the graph's DOT dump
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        start = _launches()
        counts, times = [], []
        for i, s in enumerate("ABA"):
            (out, _), ms = _timed(fn, x["rks"], x["iv"], x[f"lut_lsb{s}"],
                                  x[f"luts_rest{s}"])
            np.save(os.path.join(out_dir, f"out{i}.npy"), out.cpu().numpy())
            counts.append(list(_launches(start).values()))
            times.append(ms)
        peak = _peak_gib()
        ((key, graph),) = graphs.GRAPHS.graphs(skeys).items()
        unit, static = key[0], key[1]
        rot, vp, vp_bits = _unit_launches(p, unit, graph, static)
        warm = sum(unit.wopbs(*unit.first(*graph.inputs,
                                          *static[:-1])).values())
        n_nodes = _check_graph_nodes(graph, p, vp_bits, "phase 8 (c)")
        with tempfile.TemporaryDirectory() as tmp:
            copies = graphs.memcpy_nodes(graph, os.path.join(tmp, "g.dot"))
        n_bytes = 16 * MESH_BLOCKS          # the one 'mp' rank's bytes
        big1 = p.big_lwe_dimension + 1
        gathers = {L: n_bytes * L * big1 * 8 for L in (24, 8)}
        record = {
            "unit": unit is fhe_aes._CTR_STEP, "caps": static[-1],
            "captures": graphs.GRAPHS.captures,
            "replays": graphs.GRAPHS.replays,
            "held": list(_held(graph).values()),
            "want_held": [rot, vp], "warm_wopbs": warm, "counts": counts,
            "ms": times, "kernel_nodes": n_nodes, "peak": peak,
            "gather_bytes": gathers,
            "gather_nodes": {L: copies.get(("default (DEVICE to DEVICE)", b),
                                           0) for L, b in gathers.items()},
            "nccl_copies": sorted([k[1], n] for k, n in copies.items()
                                  if k[0].startswith("default")),
            "torch_copies": sum(n for k, n in copies.items()
                                if not k[0].startswith("default"))}
        with open(os.path.join(out_dir, "record.json"), "w") as f:
            json.dump(record, f)
    finally:
        torch.distributed.destroy_process_group()


def _spawn(target, nprocs: int, out_dir: str, what: str, timeout: float):
    """Run target(rank, out_dir, port) in nprocs spawned processes to their
    end; the seconds it took."""
    import torch.multiprocessing as tmp
    from tfhe_aes_tpu_torch.parallel.multihost_ctr import free_port
    t0 = time.perf_counter()
    ctx = tmp.start_processes(target, args=(out_dir, free_port()),
                              nprocs=nprocs, join=False,
                              start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{what}: the ranks did not end")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
                proc.join()
    return time.perf_counter() - t0


def _nccl_mesh_phase(dev) -> dict:
    """Phase 8 (c): the graphed mesh function on a one-rank NCCL world,
    contraction rows and bytes sharded, PARAM_TPU, phase 7's keys; its
    first call and two replays against ctr_keystream in this process on
    the same keys and inputs, word for word, decrypting to AES.  Returns
    its launch counts."""
    import gc
    import numpy as np
    import torch
    from tfhe_aes_tpu_torch.client.client import Client
    from tfhe_aes_tpu_torch.models import aes_plain, fhe_aes
    from tfhe_aes_tpu_torch.params import PARAM_TPU
    from tfhe_aes_tpu_torch.utils import serialization, torus

    p = PARAM_TPU
    client = Client(p, seed=0)
    client.sk, keys = serialization.load_keys(serialization.cache_path(p, 0))
    keys = keys.to(dev)
    rks = np.stack([np.stack([client.encrypt_byte(b) for b in rk]) for rk in
                    aes_plain.key_expansion(aes_plain.u128_to_bytes_be(KEY))])
    enc_iv = client.encrypt_u128(IV)
    offsets = {"A": 0, "B": 0x1FE}          # B's counter add carries
    inputs = {"rks": rks, "iv": enc_iv}
    want = {}
    t0 = time.perf_counter()
    for s, off in offsets.items():
        inputs[f"lut_lsb{s}"], inputs[f"luts_rest{s}"] = \
            fhe_aes.add_scalar_luts(p, fhe_aes.counter_bytes(MESH_BLOCKS,
                                                             off))
        want[s] = torus.to_u64(fhe_aes.ctr_keystream(
            keys, torus.from_u64(rks, dev), torus.from_u64(enc_iv, dev),
            MESH_BLOCKS, off))
        client.decrypt_and_verify_ctr(want[s], KEY, IV, offset=off)
    ref_s = time.perf_counter() - t0
    del keys
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out_dir = tempfile.mkdtemp(prefix="tfhe_aes_smoke_nccl_")
    try:
        np.savez(os.path.join(out_dir, "in.npz"), **{
            k: np.ascontiguousarray(v, np.uint64).view(np.int64)
            for k, v in inputs.items()})
        wall = _spawn(_nccl_mesh_rank, 1, out_dir, "phase 8 (c)", 600)
        with open(os.path.join(out_dir, "record.json")) as f:
            rec = json.load(f)
        for i, s in enumerate("ABA"):
            got = np.load(os.path.join(out_dir, f"out{i}.npy")).view(np.uint64)
            what = "first call" if i == 0 else f"replay {i}"
            if not np.array_equal(got, want[s]):
                raise AssertionError(f"phase 8 (c): the {what} ({s}) differs "
                                     f"from ctr_keystream")
            client.decrypt_and_verify_ctr(got, KEY, IV, offset=offsets[s])
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    held, counts = tuple(rec["held"]), [tuple(c) for c in rec["counts"]]
    steps = [tuple(b - a for a, b in zip(x, y))
             for x, y in zip(counts, counts[1:])]
    warm = tuple(c - h for c, h in zip(counts[0], held))
    if not rec["unit"] or (rec["captures"], rec["replays"]) != (1, 3) \
            or held != tuple(rec["want_held"]) or steps != [held, held] \
            or warm[0] != rec["warm_wopbs"] * p.cbs_level \
            or warm[1] < rec["warm_wopbs"]:
        raise AssertionError(f"phase 8 (c): not one graph captured at the "
                             f"first call and replayed, holding its WoPBS "
                             f"launches: {rec}")
    gathers = rec["gather_nodes"]
    if gathers != {"24": 9, "8": 1}:
        raise AssertionError(f"phase 8 (c): the graph does not hold the "
                             f"byte all-gathers' copies: {gathers} "
                             f"(NCCL's copies {rec['nccl_copies']})")
    path = "mesh (c) NCCL one rank, graphed (phase 8)"
    counts_c = dict(zip(COUNTED, counts[-1]))
    print(f"phase 8: (c) 1 rank over NCCL, dp=1 x mp=1, contraction rows and "
          f"bytes sharded, PARAM_TPU, {MESH_BLOCKS} blocks: first call (A) "
          f"and replays (B, A) == ctr_keystream word for word, decrypt to "
          f"AES; first call {rec['ms'][0]:.1f} ms (a warm-up call on the "
          f"first block, the capture, a replay), replays "
          f"{rec['ms'][1]:.1f} / {rec['ms'][2]:.1f} ms; the reference's "
          f"two ctr_keystream calls {ref_s:.1f} s; whole rank {wall:.1f} s")
    print(f"phase 8: (c) one graph (captures {rec['captures']}, replays "
          f"{rec['replays']}), caps {rec['caps']}; launches a replay "
          f"{dict(zip(COUNTED, held))} = its WoPBS', {rec['kernel_nodes']} "
          f"kernel nodes of theirs in the graph; the warm-up's {warm}; "
          f"launches {counts_c}; peak allocated / reserved {rec['peak']} "
          f"(the 64-block bench in PERF.md: 19.41 / 22.84 GiB)")
    print(f"phase 8: (c) NCCL's nodes in the graph (one rank: copies of kind "
          f"default, [bytes, count]): {rec['nccl_copies']}; the byte "
          f"all-gathers' {gathers} at {rec['gather_bytes']} bytes (L=24, "
          f"L=8); the in-place all-reduces leave none; torch's own copies "
          f"{rec['torch_copies']}")
    return {path: counts_c}


def _mesh_phase(dev) -> dict:
    """Phase 8: (a) the launcher over NCCL, a rank a card, PARAM_TPU, keys
    from phase 7's cache; (b) two gloo ranks on the one card at PARAM_TOY
    against the one-rank keystream.  Returns the launch counts of (a) and
    of (b), each summed over its ranks, by path."""
    import numpy as np
    import torch
    from tfhe_aes_tpu_torch.client.client import Client
    from tfhe_aes_tpu_torch.models import aes_plain, fhe_aes
    from tfhe_aes_tpu_torch.params import PARAM_TOY
    from tfhe_aes_tpu_torch.utils import torus

    torch.cuda.empty_cache()
    procs = torch.cuda.device_count()
    cmd = [sys.executable, "-m", "tfhe_aes_tpu_torch.parallel.multihost_ctr",
           "--procs", str(procs), "--blocks", str(MESH_BLOCKS), "--params",
           "tpu", "--seed", "0", "--timeout", "600"]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=660,
                       cwd=os.path.dirname(os.path.abspath(__file__)))
    wall = time.perf_counter() - t0
    for line in (r.stderr + r.stdout).splitlines():
        print(f"phase 8:   {line}")
    want = f"{MESH_BLOCKS}/{MESH_BLOCKS} blocks verified"
    if r.returncode != 0 or want not in r.stdout:
        raise AssertionError(f"launcher failed (rc {r.returncode})")
    records = [json.loads(ln) for ln in r.stdout.splitlines()
               if ln.startswith("{")]
    # Each rank's first call (a warm-up call, the capture, a replay) and
    # its timed run (a replay), from its stderr.
    ranks = re.findall(
        r"# proc (\d+): first call ([\d.]+) s, timed run ([\d.]+) s; graphs "
        r"captured (\d+), replayed (\d+); peak device memory ([\d.]+) GiB "
        r"\(reserved ([\d.]+)\)", r.stderr)
    if len(ranks) != procs or any((c, rp) != ("1", "2")
                                  for _, _, _, c, rp, _, _ in ranks):
        raise AssertionError(f"phase 8 (a): not one graph a rank, captured "
                             f"at the first call and replayed: {ranks}")
    path_a = "mesh (a) launcher (phase 8)"
    counts_a = {name: sum(rec["launches"][name] for rec in records)
                for name in COUNTED}
    if min(counts_a.values()) < 1:
        raise AssertionError(f"{path_a}: a kernel was not launched: "
                             f"{counts_a}")
    slowest = max(rec["seconds"] for rec in records)
    print(f"phase 8: (a) launcher, {procs} rank(s) over NCCL, PARAM_TPU, "
          f"{MESH_BLOCKS} blocks: {MESH_BLOCKS / slowest * 60.0:.2f} "
          f"blocks/min (timed run {slowest} s, the slowest rank), {want}; "
          f"whole launcher {wall:.1f} s; launches {counts_a}")
    for rank, first_s, timed_s, _, _, alloc, reserved in ranks:
        print(f"phase 8: (a) rank {rank}: graphed, first call {first_s} s "
              f"(a warm-up call on the first block, the capture, a "
              f"replay), timed run {timed_s} s (a replay); peak allocated "
              f"/ reserved {alloc} / {reserved} GiB (the 64-block bench "
              f"in PERF.md: 19.41 / 22.84)")

    # (b): the same keys and inputs in this process, one rank, as the
    # reference; the two ranks make their keys from the same seed (and
    # take rank 0's by broadcast).
    client = Client(PARAM_TOY, seed=11)
    keys = client.make_device_keys(device=dev)
    rks = np.stack([np.stack([client.encrypt_byte(b) for b in rk]) for rk in
                    aes_plain.key_expansion(aes_plain.u128_to_bytes_be(KEY))])
    enc_iv = client.encrypt_u128(IV)
    lut_lsb, luts_rest = fhe_aes.add_scalar_luts(
        PARAM_TOY, fhe_aes.counter_bytes(TOY_MESH_BLOCKS))
    ref = torus.to_u64(fhe_aes.ctr_keystream(
        keys, torus.from_u64(rks, dev), torus.from_u64(enc_iv, dev),
        TOY_MESH_BLOCKS))
    client.decrypt_and_verify_ctr(ref, KEY, IV)
    out_dir = tempfile.mkdtemp(prefix="tfhe_aes_smoke_mesh_")
    try:
        np.savez(os.path.join(out_dir, "in.npz"), **{
            k: np.ascontiguousarray(v, np.uint64).view(np.int64)
            for k, v in (("rks", rks), ("iv", enc_iv), ("lut_lsb", lut_lsb),
                         ("luts_rest", luts_rest))})
        wall = _spawn(_toy_mesh_rank, 2, out_dir, "phase 8 (b)", 300)
        counts_b = dict.fromkeys(COUNTED, 0)
        for rank in range(2):
            got = np.load(os.path.join(out_dir, f"out{rank}.npy"))
            if not np.array_equal(got.view(np.uint64), ref):
                raise AssertionError(f"phase 8 (b): rank {rank}'s keystream "
                                     f"differs from the one-rank one")
            with open(os.path.join(out_dir, f"launches{rank}.json")) as f:
                rec = json.load(f)
            for name, n in rec["launches"].items():
                counts_b[name] += n
            if rec["capturable"] or rec["captures"]:
                raise AssertionError(f"phase 8 (b): rank {rank} captured "
                                     f"over gloo: {rec}")
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    print(f"phase 8: (b) 2 ranks on one card over gloo, dp=1 x mp=2, "
          f"contraction rows and bytes sharded, PARAM_TOY, "
          f"{TOY_MESH_BLOCKS} blocks: both ranks == the one-rank "
          f"ctr_keystream word for word, decrypts to AES; {wall:.1f} s; "
          f"eager by the group's backend (graphs.capturable: False for "
          f"gloo), no graph captured")
    # The VP kernel runs only at cbs_level 1: (b)'s path never launches it;
    # (a) and phase 7 carry it.
    path_b = "mesh (b) gloo dp=1 x mp=2 (phase 8)"
    if counts_b["blind_rotate"] < 1 or counts_b["vertical_packing"]:
        raise AssertionError(f"{path_b}: unexpected launches {counts_b}")
    print(f"phase 8: (b) launches {counts_b}; vertical_packing is not on "
          f"this path (PARAM_TOY has cbs_level {PARAM_TOY.cbs_level}, the "
          f"VP kernel runs at cbs_level 1 only)")
    return {path_a: counts_a, path_b: counts_b,
            **_nccl_mesh_phase(dev)}


def _noise_phase(dev) -> tuple[dict, list, float]:
    """Phase 9: the measured noise study (python -m
    tfhe_aes_tpu_torch.noise_study) at PARAM_TPU and PARAM_OPT on phase
    7's seed-0 caches, without classic samples, its reports in the cache
    directory.  Then, outside the count, each set's rotate batch again
    through the kernel, its first rows against the plain version.  Returns
    (the launch counts of the study runs by path, the rotate shapes, the
    largest rotate error)."""
    import numpy as np
    import torch
    from tfhe_aes_tpu_torch import noise_study
    from tfhe_aes_tpu_torch.backend import numpy_backend as nb
    from tfhe_aes_tpu_torch.ops import blind_rotate, cuda_blind_rotate, lwe
    from tfhe_aes_tpu_torch.params import PARAM_OPT, PARAM_TPU
    from tfhe_aes_tpu_torch.utils import noise_model, serialization, torus

    torch.cuda.empty_cache()
    path = "noise study (phase 9)"
    counts = dict.fromkeys(COUNTED, 0)
    shapes, err_max = [], 0.0
    for p in (PARAM_TPU, PARAM_OPT):
        report = os.path.join(serialization.default_cache_dir(),
                              f"NOISE_REPORT_H100_{p.name}.md")
        buf = io.StringIO()
        start = _launches()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                study = noise_study.run(p, n_pbs=NOISE_PBS,
                                        n_wopbs_bytes=NOISE_WOPBS_BYTES,
                                        n_classic=0, device=dev, out=report)
        finally:
            for line in buf.getvalue().splitlines():
                print(f"phase 9:   {line}")
        wall = time.perf_counter() - t0
        for name, n in _launches(start).items():
            counts[name] += n
        if "loaded cached keys" not in buf.getvalue():
            raise AssertionError(f"phase 9 {p.name}: keys not from the cache")
        tpu = TPU_SIGMAS[p.name]
        models = (noise_model.budget(p).sigma_pbs,
                  noise_model.budget(p, vp_steps=8).sigma_wopbs)
        for label, err, was, model in (
                ("boolean PBS", study.pbs, tpu[0], models[0]),
                ("WoPBS output", study.wopbs, tpu[1], models[1])):
            s = noise_study.Stage.of(err)
            print(f"phase 9: {p.name} {label} x{s.samples}: sigma "
                  f"2^{s.sigma:.2f} (TPU 2^{was:.2f}), max 2^{s.max_err:.2f},"
                  f" margin {noise_study.BUDGET_FRESH - s.sigma:.2f} under the "
                  f"fresh budget 2^{noise_study.BUDGET_FRESH:.2f}; model "
                  f"2^{model:.2f}")
        if not study.ok:
            raise AssertionError(f"phase 9 {p.name}: the noise budget check "
                                 f"failed")
        print(f"phase 9: {p.name} study {wall:.1f} s, budget check PASS, "
              f"report {os.path.basename(report)} written")

        # The same rotate batch the study's pbs_boolean ran, as it builds it.
        sk, keys = serialization.load_keys(serialization.cache_path(p, 0))
        keys = keys.to(dev)
        bits, small = noise_study.pbs_inputs(
            p, sk, NOISE_PBS, np.random.default_rng(noise_study.RNG_SEED))
        ct = torus.from_u64(small, dev)
        ct[:, -1] += 1 << 62
        test = torch.zeros((p.glwe_dimension + 1, p.polynomial_size),
                           dtype=torch.int64, device=dev)
        test[-1, :] = -(1 << 61)
        acc, ms = _timed(cuda_blind_rotate.blind_rotate_cuda, keys.rplan, p,
                         keys.bsk_limbs, ct, test, keys.fwd_full,
                         keys.inv_crt_full, keys.rot_table)
        want, plain_ms = _timed(blind_rotate.blind_rotate_plain, keys.rplan, p,
                                keys.bsk_limbs, ct[:NOISE_PLAIN_ROWS], test,
                                keys.rfwd_limbs, keys.rinv_crt_limbs,
                                keys.rot_table)
        err_max = max(err_max, _require_equal(
            acc[:NOISE_PLAIN_ROWS], want,
            f"blind rotate {p.name} B={NOISE_PBS}, first {NOISE_PLAIN_ROWS} "
            f"rows"))
        out = lwe.sample_extract0(acc)
        out[:, -1] += 1 << 61
        if not np.array_equal(noise_study.signed_err(
                nb.lwe_phase(sk.big_lwe_key, torus.to_u64(out)),
                bits << np.uint64(62)), study.pbs):
            raise AssertionError(f"phase 9 {p.name}: the rotate batch is not "
                                 f"the study's")
        bound, bound_by = rotate_bound(p, keys.rplan, NOISE_PBS)
        shapes.append({"shape": f"{p.name} {NOISE_PBS} bits", "ms": ms,
                       "plain_ms": plain_ms, "plain_rows": NOISE_PLAIN_ROWS,
                       "bound_ms": bound})
        print(f"phase 9: blind rotate {p.name} kernel == plain on the first "
              f"{NOISE_PLAIN_ROWS} of {NOISE_PBS} rows, and its batch gives "
              f"the study's errors; kernel {ms:.1f} ms, plain "
              f"{plain_ms:.1f} ms ({NOISE_PLAIN_ROWS} rows), bound "
              f"{bound:.2f} ms ({bound_by})")
        del keys, acc, want, ct, out
    print(f"phase 9: launches {counts} (predicted 4 rotate, 2 VP)")
    if min(counts.values()) < 1:
        raise AssertionError(f"{path}: a kernel was not launched: {counts}")
    return {path: counts}, shapes, err_max


# Phase 10's child: runs the CLI as `python -m` does, then reports its
# kernels' launch counts (COUNTED) on stderr.
COLD_RUNNER = """
import atexit, json, runpy, sys
from tfhe_aes_tpu_torch.utils import profiling
atexit.register(lambda: print("LAUNCHES " + json.dumps({
    "blind_rotate": profiling.COUNTS["rotate_calls"],
    "vertical_packing": profiling.COUNTS["vp_calls"]}),
    file=sys.stderr, flush=True))
sys.argv = ["tfhe_aes_tpu_torch.cli"] + sys.argv[1:]
runpy.run_module("tfhe_aes_tpu_torch.cli", run_name="__main__",
                 alter_sys=True)
"""


def _cold_start_phase() -> dict:
    """Phase 10: the CLI in a subprocess on a copy of the package without
    its built libraries and on an empty key cache, cold then warm.
    Returns the launch counts of the two runs, summed, by path."""
    import ast
    import re

    import torch
    torch.cuda.empty_cache()
    here = os.path.dirname(os.path.abspath(__file__))
    work = tempfile.mkdtemp(prefix="tfhe_aes_smoke_cold_")
    path = "cold start (phase 10)"
    counts = dict.fromkeys(COUNTED, 0)
    try:
        shutil.copytree(os.path.join(here, "tfhe_aes_tpu_torch"),
                        os.path.join(work, "tfhe_aes_tpu_torch"),
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        env = dict(os.environ, PYTHONPATH=work, PYTHONUNBUFFERED="1",
                   TFHE_AES_TPU_CACHE=os.path.join(work, "cache"))
        argv = ["--params", "tpu", "--seed", "0", "--number-of-outputs",
                str(COLD_BLOCKS), "--iv", hex(IV), "--key", hex(KEY),
                "--device-verify"]
        for kind in ("cold", "warm"):
            t0 = time.perf_counter()
            proc = subprocess.Popen([sys.executable, "-c", COLD_RUNNER, *argv],
                                    cwd=work, env=env, text=True,
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT)
            lines, first = [], None
            try:
                for line in proc.stdout:
                    if first is None and line.startswith("[client] verified"):
                        first = time.perf_counter() - t0
                    lines.append(line)
                    print(f"phase 10:   {line.rstrip()}")
                proc.wait(timeout=60)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            out = "".join(lines)
            want = f"[client] verified {COLD_BLOCKS} blocks bit-exact"
            if proc.returncode != 0 or want not in out or first is None:
                raise AssertionError(f"phase 10 {kind}: the CLI failed (rc "
                                     f"{proc.returncode})")
            keys = re.search(r"\[client\] (device keygen \+ packing took|"
                             r"loaded cached keys .* in) ([0-9.]+)s", out)
            how = "device keygen + save" if kind == "cold" else "cache load"
            if keys is None or (kind == "cold") != ("keygen" in keys[1]):
                raise AssertionError(f"phase 10 {kind}: keys not by {how}")
            report = ast.literal_eval(re.search(
                r"warm-up \(overlapped\): (\{.*\})", out)[1])
            targets = {"tiles", "zero_key_wopbs"} | {
                f"nvcc_{name}" for name in KERNELS}
            if not targets <= set(report):
                raise AssertionError(f"phase 10 {kind}: warm-up report "
                                     f"{report}")
            ran = json.loads(re.search(r"LAUNCHES (\{.*\})", out)[1])
            if min(ran.values()) < 1:
                raise AssertionError(f"phase 10 {kind}: a kernel was not "
                                     f"launched: {ran}")
            for name in counts:
                counts[name] += ran[name]
            keyexp = re.search(r"AES key expansion took: ([0-9.]+)s", out)[1]
            print(f"phase 10: {kind} start: first verified block at "
                  f"{first:.2f} s after the process started; keys "
                  f"{keys[2]} s ({how}); warm-up nvcc blind_rotate "
                  f"{report['nvcc_blind_rotate']} s, vertical_packing "
                  f"{report['nvcc_vertical_packing']} s (at once), tiles "
                  f"{report['tiles']} s, zero-key WoPBS "
                  f"{report['zero_key_wopbs']} s, joined at "
                  f"{report['joined_at']} s (waited {report['waited']} s); "
                  f"first key expansion {keyexp} s; launches {ran}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {path: counts}


def _rotate_unit(keys, ct, test):
    """One blind rotation (the kernel, on the card): phase 11's graphed
    unit."""
    from tfhe_aes_tpu_torch.ops import blind_rotate
    return blind_rotate.blind_rotate(
        keys.rplan, keys.params, keys.bsk_limbs, ct, test, keys.rfwd_limbs,
        keys.fwd_full, keys.rinv_crt_limbs, keys.inv_crt_full,
        keys.rot_table)


# The whole-function units of models/fhe_aes, by name: (the unit, the
# function it graphs).
UNITS = {"add_scalar_device_jit": ("_ADD_SCALAR", "add_scalar_device"),
         "ctr_step_jit": ("_CTR_STEP", "ctr_step"),
         "aes_encrypt_jit": ("_ENCRYPT", "aes_encrypt"),
         "aes_decrypt_jit": ("_DECRYPT", "aes_decrypt"),
         "aes_key_expansion_jit": ("_KEY_EXPANSION", "aes_key_expansion")}


@contextlib.contextmanager
def _eager_wopbs():
    """Everything of the circuits eager (the dispatch before graphs):
    many_wopbs_jit swapped for many_wopbs and each whole-function unit
    for the function it graphs while the block runs."""
    from tfhe_aes_tpu_torch.models import fhe_aes
    from tfhe_aes_tpu_torch.ops import wopbs
    saved = {name: getattr(fhe_aes, name) for name in UNITS}
    jit = wopbs.many_wopbs_jit
    wopbs.many_wopbs_jit = wopbs.many_wopbs
    for name, (_, plain) in UNITS.items():
        setattr(fhe_aes, name, getattr(fhe_aes, plain))
    try:
        yield
    finally:
        wopbs.many_wopbs_jit = jit
        for name, fn in saved.items():
            setattr(fhe_aes, name, fn)


# The kernel functions one launch-counted call runs: the rotate's per
# step (K1, K2) and per call (the decomposition), the VP's per selector bit.
ROTATE_NODES = ("br_forward_mac_kernel", "br_inverse_crt_kernel")
ROTATE_ONCE = "br_decompose_kernel"
ROTATE_SPLIT = "br_inverse_crt_kernelILb1E"    # K2 as clusters, mangled
ROTATE_PERSISTENT = "br_forward_mac_kernel_persistent"   # K1 persistent
VP_NODES = ("vp_digits_kernel", "vp_forward_mac_kernel",
            "vp_inverse_crt_kernel")


def _check_graph_nodes(graph, p, vp_bits: int, what: str):
    """The kernel nodes of a captured graph, by kernel, against what its
    replays add to the counts (graph.record.counts: rotate and VP calls,
    device marks, rotate calls whose K2 ran split, rotate calls whose K1
    ran persistently): a call of the rotate is one decomposition and n (the
    LWE dimension) steps of K1 and K2 (the split instance of K2 in a split
    call, the persistent K1 in a persistent one), a call of VP one of each
    of its three kernels a rotated selector bit (min(nbits, log2 N) a call:
    vp_bits in all), a mark one node, as many as the labels the capture
    recorded."""
    from tfhe_aes_tpu_torch.ops import graphs
    from tfhe_aes_tpu_torch.utils import profiling
    with tempfile.TemporaryDirectory() as tmp:
        nodes = graphs.kernel_nodes(graph, os.path.join(tmp, "graph.dot"))
    counts = graph.record.counts
    rot, marks, split, persistent = (counts[key] for key in (
        "rotate_calls", "mark_launches", "rotate_split_calls",
        "rotate_persistent_calls"))
    if marks != len(graph.record.labels):
        raise AssertionError(f"{what}: the graph counts {marks} marks, its "
                             f"capture recorded {len(graph.record.labels)}")
    want = {ROTATE_ONCE: rot,
            **{k: rot * p.lwe_dimension for k in ROTATE_NODES},
            ROTATE_SPLIT: split * p.lwe_dimension,
            ROTATE_PERSISTENT: persistent * p.lwe_dimension,
            **{k: vp_bits for k in VP_NODES},
            profiling.MARK_KERNEL: marks}
    got = {k: sum(n for name, n in nodes.items() if k in name)
           for k in want}
    if got != want:
        raise AssertionError(f"{what}: the graph holds kernel "
                             f"nodes {got}, its replays count {want}")
    return sum(got.values())


def _peak_gib() -> str:
    """The peak device memory since the last reset, allocated (live
    tensors) / reserved (with the allocator's cache and the graph pools,
    whose intermediates no tensor holds between replays)."""
    import torch
    return (f"{torch.cuda.max_memory_allocated() / 2**30:.2f} / "
            f"{torch.cuda.max_memory_reserved() / 2**30:.2f} GiB")


def _k2_step_ms(fn, *args, steps: int) -> float:
    """K2's device ms a step (br_inverse_crt_kernel's records over one
    profiled call of `steps` steps)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn(*args)
        torch.cuda.synchronize()
    us = 0.0
    for e in prof.key_averages():
        if "br_inverse_crt_kernel" in e.key:
            dev_us = getattr(e, "self_device_time_total", None)
            us += e.self_cuda_time_total if dev_us is None else dev_us
    return us / 1e3 / steps


def _k2_registers() -> str:
    """ptxas's registers and spills of K2's instances (blind_rotate.cu built
    with -Xptxas -v into a temporary directory); raises on a spill."""
    from tfhe_aes_tpu_torch.ops import cuda_build
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-Xptxas", "-v",
             "-o", os.path.join(tmp, "k2.so"),
             str(cuda_build.CSRC / "blind_rotate.cu")],
            capture_output=True, text=True, check=True)
    report, name = [], ""
    for line in proc.stderr.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "br_inverse_crt_kernel" in name and (
                "registers" in line or "spill" in line):
            report.append(f"{name[:32]}: {line.split(':')[-1].strip()}")
            if re.search(r"[1-9]\d* bytes spill", line):
                raise AssertionError(f"K2 spills: {name}: {line}")
    return "; ".join(report)


def _median_ms(fn, *args, runs: int = 3):
    """(the last result, the median ms) of `runs` synchronised calls."""
    times = []
    for _ in range(runs):
        out, ms = _timed(fn, *args)
        times.append(ms)
    return out, sorted(times)[runs // 2]


def _graph_phase(dev) -> dict:
    """Phase 11: the compiled dispatch units (ops/graphs.py) on phase 7's
    PARAM_TPU keys.  The staged key expansion graphed (first, warm) and
    eager; every WoPBS shape the main path's graphs take, graphed against
    eager word for word (the first call on the bytes reversed, so the
    replays read new static inputs), each replay adding the launches its
    graph holds; the rotate alone at 16 and 128 bits, eager and replayed;
    peak memory of the 1024-byte rounds eager and graphed.  Every graph
    is captured keeping its CUDA graph, whose kernel nodes are held
    against the launches its replays count.  Times are medians of 3.
    Returns the launch counts of the phase."""
    import numpy as np
    import torch
    from tfhe_aes_tpu_torch.backend import numpy_backend as nb
    from tfhe_aes_tpu_torch.client.client import Client
    from tfhe_aes_tpu_torch.models import aes_plain, fhe_aes
    from tfhe_aes_tpu_torch.ops import graphs, wopbs
    from tfhe_aes_tpu_torch.params import PARAM_TPU
    from tfhe_aes_tpu_torch.server import Server
    from tfhe_aes_tpu_torch.utils import serialization, torus

    torch.cuda.empty_cache()
    p, U64 = PARAM_TPU, np.uint64
    path = "graphed vs eager (phase 11)"
    t_phase = time.perf_counter()
    client = Client(p, seed=0)
    client.sk, keys = serialization.load_keys(serialization.cache_path(p, 0))
    keys = keys.to(dev)
    server = Server(keys)
    graphs.GRAPHS.cuda.keep = True          # for the graphs' DOT dumps
    start = _launches()

    # The staged key expansion: its one 16-byte graph captured in the
    # first call, replayed in the rest; then every WoPBS eager.
    enc_key = torus.from_u64(client.encrypt_u128(KEY), dev)
    rks, first_ms = _timed(server.aes_key_expansion, enc_key)
    rks_g, warm_ms = _median_ms(server.aes_key_expansion, enc_key)
    with _eager_wopbs():
        rks_e, eager_ms = _median_ms(server.aes_key_expansion, enc_key)
    _require_equal(rks_g, rks_e, "staged key expansion, graphed vs eager")
    _require_equal(rks, rks_e, "staged key expansion, first vs eager")
    want_rk = aes_plain.key_expansion(aes_plain.u128_to_bytes_be(KEY))
    rk_host = torus.to_u64(rks_g)
    if [[client.decrypt_byte(rk_host[r, i]) for i in range(16)]
            for r in range(11)] != want_rk:
        raise AssertionError("phase 11: the graphed key expansion is not AES")
    print(f"phase 11: staged key expansion graphed: first {first_ms:.1f} ms "
          f"(with the capture), warm {warm_ms:.1f} ms; eager {eager_ms:.1f} "
          f"ms; == eager word for word, decrypts to the AES schedule")

    def encrypted(n_bytes, nbits, seed):
        rng = np.random.default_rng(seed)
        vals = rng.integers(0, 1 << nbits, n_bytes)
        bits = (vals[:, None] >> np.arange(nbits)) & 1
        cts = nb.lwe_encrypt(client.sk.big_lwe_key,
                             bits.astype(U64) << U64(63), p.glwe_noise_std,
                             rng)
        return torus.from_u64(cts, dev)

    # Phase 7's batch: its ripple add (a byte a block) and AES rounds;
    # its decrypt's rounds; the pk-RCON schedule's three WoPBS.
    nb_, aes_bytes, dec_bytes = BENCH_BLOCKS, 16 * BENCH_BLOCKS, \
        16 * BENCH_DECRYPT
    lsb, rest = fhe_aes.add_scalar_luts(p, fhe_aes.counter_bytes(nb_, 0x1FE))
    shapes = (
        ("key expansion 16 B x 8 bits, L=16", 16, 8,
         fhe_aes._refresh_sbox_lut(p)),
        (f"ripple add {nb_} B x 8 bits, L=9", nb_, 8, lsb),
        (f"ripple add {nb_} B x 9 bits, L=9", nb_, 9, rest[0]),
        (f"AES round {aes_bytes} B, L=24", aes_bytes, 8, fhe_aes._fwd_luts(p)),
        (f"final round {aes_bytes} B, L=8", aes_bytes, 8,
         fhe_aes._sbox_lut(p, False)),
        (f"decrypt {dec_bytes} B, L=8", dec_bytes, 8,
         fhe_aes._sbox_lut(p, True)),
        (f"decrypt {dec_bytes} B, L=32", dec_bytes, 8,
         fhe_aes._inv_mul_luts(p)),
        ("pk-RCON SubWord 4 B, L=8", 4, 8, fhe_aes._sbox_lut(p, False)),
        ("pk-RCON refresh 12 B, L=8", 12, 8, fhe_aes._identity_lut(p)),
        ("pk-RCON refresh 4 B, L=8 (the SubWord's graph)", 4, 8,
         fhe_aes._identity_lut(p)))
    for i, (label, n_bytes, nbits, lut_np) in enumerate(shapes):
        x, lut = encrypted(n_bytes, nbits, 100 + i), torus.from_u64(lut_np, dev)
        big = n_bytes == aes_bytes
        if big:
            torch.cuda.reset_peak_memory_stats()
        want, e_ms = _median_ms(wopbs.many_wopbs, keys, x, lut)
        if big:
            eager_peak = _peak_gib()
            torch.cuda.empty_cache()        # the eager runs' cache
            torch.cuda.reset_peak_memory_stats()
        rev_lut = lut.flip(0) if lut.shape[0] > 1 else lut
        first, f_ms = _timed(wopbs.many_wopbs_jit, keys, x.flip(0), rev_lut)
        _require_equal(first.flip(0), want, f"phase 11 {label}: first call")
        (graph,) = [g for k, g in graphs.GRAPHS.graphs(keys).items()
                    if k[2][0][0] == tuple(x.shape)
                    and k[2][1][0] == tuple(lut.shape)]
        n_nodes = _check_graph_nodes(
            graph, p,
            graph.record.counts["vp_calls"] * min(nbits, p.log2_poly_size),
            f"phase 11 {label}")
        times = []
        for _ in range(3):
            got, ms = _timed(wopbs.many_wopbs_jit, keys, x, lut)
            times.append(ms)
            _require_equal(got, want, f"phase 11 {label}: replay")
        g_ms = sorted(times)[1]
        if big:
            print(f"phase 11: {label}: peak device memory, allocated / "
                  f"reserved: eager {eager_peak}, first graphed call and "
                  f"replays {_peak_gib()}")
        print(f"phase 11: {label}: replays == eager word for word; eager "
              f"{e_ms:.1f} ms, first call {f_ms:.1f} ms (a byte eagerly, "
              f"the capture, a replay), replay {g_ms:.1f} ms; launches a "
              f"replay {_held(graph)}, {n_nodes} kernel "
              f"nodes of theirs in the graph")
        del x, lut, want, first, got

    # The rotate alone: the latency-bound small batches.
    for n_bits in (16, 128):
        rng = np.random.default_rng(n_bits)
        small = nb.lwe_encrypt(client.sk.lwe_key,
                               rng.integers(0, 2, n_bits).astype(U64)
                               << U64(63), p.lwe_noise_std, rng)
        ct = torus.from_u64(small, dev)
        test = torch.zeros((p.glwe_dimension + 1, p.polynomial_size),
                           dtype=torch.int64, device=dev)
        test[-1, :] = 1 << 60
        want, e_ms = _median_ms(_rotate_unit, keys, ct, test)
        graphs.GRAPHS(_rotate_unit, keys, (ct.flip(0), test))
        (graph,) = [g for k, g in graphs.GRAPHS.graphs(keys).items()
                    if k[0] is _rotate_unit and k[2][0][0] == tuple(ct.shape)]
        _check_graph_nodes(graph, p, 0, f"phase 11 rotate {n_bits} bits")
        got, g_ms = _median_ms(graphs.GRAPHS, _rotate_unit, keys, (ct, test))
        _require_equal(got, want, f"phase 11 rotate {n_bits} bits")
        bound, _ = rotate_bound(p, keys.rplan, n_bits)
        print(f"phase 11: rotate {n_bits} bits (1339 launches): eager "
              f"{e_ms:.2f} ms, replayed {g_ms:.2f} ms, == word for word; "
              f"bound {bound:.2f} ms")

    counts = _read_launches(start, path)
    graphs.GRAPHS.cuda.keep = False
    print(f"phase 11: {graphs.GRAPHS.captures} captures and "
          f"{graphs.GRAPHS.replays} replays in this process; whole phase "
          f"{time.perf_counter() - t_phase:.1f} s; launches {counts}")
    del server, keys, rks, rks_g, rks_e
    return {path: counts}


def _unit_graph(keys, before: set):
    """The one graph of `keys` captured since `before` (its keys then)."""
    from tfhe_aes_tpu_torch.ops import graphs
    new = [g for k, g in graphs.GRAPHS.graphs(keys).items() if k not in before]
    if len(new) != 1:
        raise AssertionError(f"phase 12: {len(new)} graphs captured, not 1")
    key = next(k for k in graphs.GRAPHS.graphs(keys) if k not in before)
    return key, new[0]


def _unit_launches(p, unit, graph, static) -> tuple:
    """(rotate calls, VP calls, VP selector bits) of a unit's graph: a
    rotate call a cbs level of each WoPBS the unit runs, a VP call a tail
    chunk (its balanced chunks under the cap in the graph's key), each
    rotating min(nbits, log2 N) selector bits."""
    from tfhe_aes_tpu_torch.ops import wopbs
    caps = dict(static[-1])
    rot = vp = bits = 0
    for shape, count in unit.wopbs(*graph.inputs, *static[:-1]).items():
        n_bytes, _, nbits = shape
        chunks = -(-n_bytes // wopbs._chunk_size(n_bytes, caps[shape]))
        rot += count * p.cbs_level
        if p.cbs_level == 1:
            vp += count * chunks
            bits += count * chunks * min(nbits, p.log2_poly_size)
    return rot, vp, bits


def _unit_phase(dev, smi: str) -> dict:
    """Phase 12: the whole-function dispatch units of models/fhe_aes
    (add_scalar_device_jit, ctr_step_jit, aes_encrypt_jit, aes_decrypt_jit,
    aes_key_expansion_jit with trivial and pk-RCON schedules) on phase 7's
    PARAM_TPU keys, UNIT_BLOCKS blocks.  Each run eagerly (every WoPBS
    eager) on inputs A and B; graphed, its first call (a warm-up call on
    the first block or round, the capture, a replay) on B and two replays
    on A, each word for word against eager, the results
    decrypting as AES says; its graph's rotate and VP calls against those
    of the WoPBS the unit runs, and its kernel nodes (DOT dump) against
    them.  The decrypt profiled graphed and eager.  Then the memory sweep
    on a fresh load of the keys: Server.ctr_keystream over 1 to
    SWEEP_BLOCKS blocks in turn, then 1 and SWEEP_BLOCKS again (replays),
    memory_allocated / reserved after each beside the bytes of the new
    graph's static buffers.  Returns the
    launch counts of the phase."""
    import gc
    import numpy as np
    import torch
    from tfhe_aes_tpu_torch.client.client import Client
    from tfhe_aes_tpu_torch.models import aes_plain, fhe_aes
    from tfhe_aes_tpu_torch.ops import graphs
    from tfhe_aes_tpu_torch.params import PARAM_TPU
    from tfhe_aes_tpu_torch.server import Server
    from tfhe_aes_tpu_torch.utils import serialization, torus

    torch.cuda.empty_cache()
    p, n = PARAM_TPU, UNIT_BLOCKS
    path = "whole-function units (phase 12)"
    t_phase = time.perf_counter()
    print(f"phase 12: {smi}")
    client = Client(p, seed=0)
    cache = serialization.cache_path(p, 0)
    client.sk, keys = serialization.load_keys(cache)
    keys = keys.to(dev)
    server = Server(keys, client.make_public_key(),
                    rng=np.random.default_rng(9))
    graphs.GRAPHS.cuda.keep = True          # for the graphs' DOT dumps
    start = _launches()

    def u64(x):
        return torus.from_u64(x, dev)

    def schedule(key):
        return aes_plain.key_expansion(aes_plain.u128_to_bytes_be(key))

    def blocks(vals):
        return u64(np.stack([client.encrypt_u128(v) for v in vals]))

    def luts(offset):
        return tuple(u64(t) for t in fhe_aes.add_scalar_luts(
            p, fhe_aes.counter_bytes(n, offset)))

    def aes(vals):
        return [aes_plain.ctr_keystream(KEY, v, 1)[0] for v in vals]

    key_b = KEY ^ 0xFF
    rks = u64(np.stack([np.stack([client.encrypt_byte(b) for b in rk])
                        for rk in schedule(KEY)]))
    iv = u64(client.encrypt_u128(IV))
    rcon = u64(server.encrypt_rcon())
    plains = {"A": [IV + t for t in range(n)],
              "B": [IV + 0x100 + t for t in range(n)]}
    offsets = {"A": 0x1FE, "B": 0x2FD}
    enc_keys = {"A": u64(client.encrypt_u128(KEY)),
                "B": u64(client.encrypt_u128(key_b))}
    states = {k: blocks(v) for k, v in plains.items()}
    cts = {k: blocks(aes(v)) for k, v in plains.items()}
    lut_sets = {k: luts(v) for k, v in offsets.items()}
    cases = (
        ("add_scalar_device_jit", f"{n} blocks", {},
         lambda s: (iv[None].expand((n,) + tuple(iv.shape)), *lut_sets[s]),
         lambda s: [IV + offsets[s] + t for t in range(n)]),
        ("ctr_step_jit", f"{n} blocks", {},
         lambda s: (rks, iv, *lut_sets[s]),
         lambda s: aes([IV + offsets[s] + t for t in range(n)])),
        ("aes_encrypt_jit", f"{n} blocks", {},
         lambda s: (rks, states[s]), lambda s: aes(plains[s])),
        ("aes_decrypt_jit", f"{n} blocks", {},
         lambda s: (rks, cts[s]), lambda s: plains[s]),
        ("aes_key_expansion_jit", "trivial RCON", {},
         lambda s: (enc_keys[s],), None),
        ("aes_key_expansion_jit", "pk-RCON", {"rcon_fresh": True},
         lambda s: (enc_keys[s], rcon), None))
    for name, what, kw, args, want_plain in cases:
        label = f"{name} ({what})"
        unit_obj = getattr(fhe_aes, UNITS[name][0])
        with _eager_wopbs():
            jit = getattr(fhe_aes, name)            # the plain function
            want_a, e_ms = _timed(jit, keys, *args("A"), **kw)
            want_b = jit(keys, *args("B"), **kw)
        before = set(graphs.GRAPHS.graphs(keys))
        jit = getattr(fhe_aes, name)
        first, f_ms = _timed(jit, keys, *args("B"), **kw)
        _require_equal(first, want_b, f"phase 12 {label}: first call")
        times = []
        for _ in range(2):
            got, ms = _timed(jit, keys, *args("A"), **kw)
            times.append(ms)
            _require_equal(got, want_a, f"phase 12 {label}: replay")
        key, graph = _unit_graph(keys, before)
        if key[0] is not unit_obj:
            raise AssertionError(f"phase 12 {label}: not the unit's graph")
        rot, vp, vp_bits = _unit_launches(p, unit_obj, graph, key[1])
        if tuple(_held(graph).values()) != (rot, vp):
            raise AssertionError(f"phase 12 {label}: the graph holds "
                                 f"{_held(graph)} calls, its WoPBS "
                                 f"{rot, vp}")
        n_nodes = _check_graph_nodes(graph, p, vp_bits, f"phase 12 {label}")
        host = torus.to_u64(got)
        if want_plain is None:
            ok = [[client.decrypt_byte(host[r, i]) for i in range(16)]
                  for r in range(11)] == schedule(KEY)
        else:
            ok = [client.decrypt_state_u128(host[i])
                  for i in range(n)] == want_plain("A")
        if not ok:
            raise AssertionError(f"phase 12 {label}: does not decrypt as "
                                 f"AES says")
        print(f"phase 12: {label}: first call and replays == eager word for "
              f"word, decrypt as AES says; eager {e_ms:.1f} ms, first call "
              f"{f_ms:.1f} ms (a warm-up call, the capture, a replay), "
              f"replays {times[0]:.1f} / {times[1]:.1f} ms; launches a replay "
              f"{_held(graph)}, {n_nodes} kernel nodes "
              f"of theirs in the graph")
        if name == "aes_decrypt_jit":
            busy_g = _profile_decrypt(server, rks, cts["A"], n, "phase 12",
                                      top=3)
            with _eager_wopbs():
                busy_e = _profile_decrypt(server, rks, cts["A"], n,
                                          "phase 12", top=3)
            print(f"phase 12: {label}: busy share graphed {busy_g:.1f}%, "
                  f"eager {busy_e:.1f}%")
        del first, got, want_a, want_b
    graphs.GRAPHS.cuda.keep = False
    del server, keys, rks, iv, rcon, states, cts, lut_sets, enc_keys
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # The memory sweep: one key set, one graph a new CTR batch size.
    client.sk, keys = serialization.load_keys(cache)
    keys = keys.to(dev)
    server = Server(keys)
    rks = u64(np.stack([np.stack([client.encrypt_byte(b) for b in rk])
                        for rk in schedule(KEY)]))
    iv = u64(client.encrypt_u128(IV))
    torch.cuda.synchronize()
    start_alloc = torch.cuda.memory_allocated()
    static_sum = 0
    for rnd, sizes in (("new shape", range(1, SWEEP_BLOCKS + 1)),
                       ("replay", (1, SWEEP_BLOCKS))):
        for b in sizes:
            before = set(graphs.GRAPHS.graphs(keys))
            a0, r0 = torch.cuda.memory_allocated(), \
                torch.cuda.memory_reserved()
            ks, ms = _timed(server.ctr_keystream, rks, iv, b, 16 * b)
            client.fetch_and_verify_ctr(ks, KEY, IV, offset=16 * b)
            del ks
            torch.cuda.synchronize()
            a1, r1 = torch.cuda.memory_allocated(), \
                torch.cuda.memory_reserved()
            new = [g for k, g in graphs.GRAPHS.graphs(keys).items()
                   if k not in before]
            static = sum(t.numel() * t.element_size()
                         for g in new for t in g.inputs + (g.output,))
            static_sum += static
            print(f"phase 12: memory sweep, ctr_keystream {b} blocks "
                  f"({rnd}, {len(new)} graph(s) captured): {ms:.0f} ms, "
                  f"verified; allocated {a1 / 2**20:.1f} MiB "
                  f"({(a1 - a0) / 2**20:+.2f}), its graph's static buffers "
                  f"{static / 2**20:.2f} MiB; reserved {r1 / 2**30:.2f} GiB "
                  f"({(r1 - r0) / 2**20:+.1f} MiB)")
    grew = torch.cuda.memory_allocated() - start_alloc
    print(f"phase 12: memory sweep: allocated grew {grew / 2**20:.2f} MiB "
          f"over {SWEEP_BLOCKS} new batch sizes and two replays, the "
          f"graphs' static buffers {static_sum / 2**20:.2f} MiB "
          f"({(grew - static_sum) / 2**20:+.2f} MiB beyond them)")
    counts = _read_launches(start, path)
    print(f"phase 12: whole phase {time.perf_counter() - t_phase:.1f} s; "
          f"launches {counts}")
    del server, keys, rks, iv
    return {path: counts}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--blocks", type=int, default=4,
                    help="CTR blocks of the first keystream batch")
    ap.add_argument("--blocks2", type=int, default=MESH_BLOCKS,
                    help="CTR blocks of the second, timed batch")
    args = ap.parse_args()
    t_start = time.perf_counter()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import numpy as np
    from tfhe_aes_tpu_torch import runtime
    from tfhe_aes_tpu_torch.backend import numpy_backend as nb
    from tfhe_aes_tpu_torch.client.client import Client
    from tfhe_aes_tpu_torch.models import aes_plain, fhe_aes, luts, tables
    from tfhe_aes_tpu_torch.ops import (blind_rotate, cbs, cuda_blind_rotate,
                                        cuda_build, cuda_vp, lwe,
                                        vertical_packing, wopbs)
    from tfhe_aes_tpu_torch.params import (PARAM_OPT, PARAM_TOY,
                                           PARAM_TOY_WIDE, PARAM_TPU)
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
          f"nccl {'.'.join(map(str, torch.cuda.nccl.version()))} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    runtime.get_lib()                   # raises if the host runtime fails
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(KERNELS)) as pool:
        list(pool.map(cuda_build.load, KERNELS))     # one nvcc per source
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
    toy_r25 = dataclasses.replace(PARAM_TOY, name="PARAM_TOY_R25",
                                  glwe_dimension=4, pbs_level=5)
    for params in (PARAM_TOY, toy_l5, PARAM_TOY_WIDE, toy_r25):
        client = Client(params, seed=11)
        k = client.make_device_keys(fast=False, device=dev)
        for n_batch in (1, 9, 128):
            small, test = rotate_inputs(params, n_batch, client.sk.lwe_key)
            got, want, _, _ = rotate_pair(k, params, small, test)
            _require_equal(got, want, f"blind rotate {params.name} B={n_batch}")
        print(f"phase 1: blind rotate {params.name} kernel == plain at "
              f"batches 1, 9, 128")

    t0 = time.perf_counter()
    client = Client(PARAM_TPU, seed=0)
    keys_host = client.make_device_keys(fast=False, device="cpu")
    keygen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    keys = keys_host.to(dev)
    torch.cuda.synchronize()
    print(f"phase 1: PARAM_TPU host keygen {keygen_s:.1f} s, keys to card "
          f"{time.perf_counter() - t0:.1f} s")

    # The batches (in bits) the paths give the rotate: for each CTR batch
    # of b blocks (the CLI's 2, phase 3's, the launcher's 8, the bench's
    # 64, decrypt's 4) its ripple add's first and later steps (8 b and
    # 9 b) and its AES rounds (128 b); 32 the 4-byte SubWord, 96 the
    # pk-RCON 12-byte refresh, 128 a 16-byte key-expansion round.  The
    # bench's AES round last, timed.
    path_blocks = sorted({CLI_BLOCKS, args.blocks, args.blocks2,
                          BENCH_DECRYPT, MESH_BLOCKS, BENCH_BLOCKS})
    aes_bits = 128 * BENCH_BLOCKS
    br_err = 0.0
    br_shapes = []
    batches = {m * b for b in path_blocks for m in (8, 9, 128)} | {32, 96, 128}
    for n_batch in sorted(batches - {aes_bits}) + [aes_bits]:
        small, test = rotate_inputs(PARAM_TPU, n_batch, client.sk.lwe_key)
        got, want, br_ms, br_plain_ms = rotate_pair(keys, PARAM_TPU, small,
                                                    test)
        br_err = max(br_err, _require_equal(
            got, want, f"blind rotate PARAM_TPU B={n_batch}"))
        br_bound, br_bound_by = rotate_bound(PARAM_TPU, keys.rplan, n_batch)
        br_shapes.append({"shape": f"PARAM_TPU {n_batch} bits",
                          "ms": br_ms, "plain_ms": br_plain_ms,
                          "bound_ms": br_bound})
        print(f"phase 1: blind rotate PARAM_TPU kernel == plain at "
              f"B={n_batch}: kernel {br_ms:.1f} ms, plain {br_plain_ms:.1f} "
              f"ms, bound {br_bound:.2f} ms ({br_bound_by})")
    del got, want, small, test

    # The CLI's default set: 8-bit digits (dn = N), 25 GGSW rows a bit; at
    # the batches of phase 7's 4-block CTR (ripple steps, AES rounds) and
    # of its key expansion (4-byte SubWord, 16-byte rounds).  Each batch
    # on both of K2's paths (cuda_blind_rotate.k2_cluster forced: one block
    # a tile, or a cluster of one block a prime), each path's median of 3
    # beside the one the rule takes.  Then both of K1's paths (forced
    # through cuda_blind_rotate.K1_TILES_PER_SM: one block a tile, or the
    # persistent K1) at 8 to 4096 bits (a session's ripple add, 16 bits,
    # a session's SubWord and key schedule rounds, the bulk
    # ripple add, a 4-block round, bulk16's rounds, the noise study's
    # batch), K2 as the rule takes it: the words
    # of both against the plain version (on the first NOISE_PLAIN_ROWS
    # rows above 512 bits, and each path's against the other's on all).
    t0 = time.perf_counter()
    cl_opt = Client(PARAM_OPT, seed=0)
    k_opt = cl_opt.make_device_keys(fast=True, device=dev)
    torch.cuda.synchronize()
    print(f"phase 1: PARAM_OPT device keygen "
          f"{time.perf_counter() - t0:.1f} s")
    rule = cuda_blind_rotate.k2_cluster
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for n_batch in sorted({8 * OPT_BLOCKS, 9 * OPT_BLOCKS, 128 * OPT_BLOCKS,
                           32, 128}):
        small, test = rotate_inputs(PARAM_OPT, n_batch, cl_opt.sk.lwe_key)
        br_args = (k_opt.rplan, PARAM_OPT, k_opt.bsk_limbs, small, test)
        want, plain_ms = _timed(blind_rotate.blind_rotate_plain, *br_args,
                                k_opt.rfwd_limbs, k_opt.rinv_crt_limbs,
                                k_opt.rot_table)
        path_ms = {}
        try:
            for path in ("unsplit", "split"):
                cuda_blind_rotate.k2_cluster = (
                    lambda p, b, n, sm, path=path: n if path == "split" else 1)
                got, path_ms[path] = _median_ms(
                    cuda_blind_rotate.blind_rotate_cuda, *br_args,
                    k_opt.fwd_full, k_opt.inv_crt_full, k_opt.rot_table)
                br_err = max(br_err, _require_equal(
                    got, want, f"blind rotate PARAM_OPT B={n_batch} {path}"))
        finally:
            cuda_blind_rotate.k2_cluster = rule
        taken = "split" if rule(PARAM_OPT, n_batch, k_opt.rplan.n_primes,
                                sms) > 1 else "unsplit"
        bound, bound_by = rotate_bound(PARAM_OPT, k_opt.rplan, n_batch)
        br_shapes.append({"shape": f"PARAM_OPT {n_batch} bits",
                          "ms": path_ms[taken], "plain_ms": plain_ms,
                          "bound_ms": bound, "k2": taken,
                          "unsplit_ms": path_ms["unsplit"],
                          "split_ms": path_ms["split"]})
        print(f"phase 1: blind rotate PARAM_OPT kernel == plain at "
              f"B={n_batch} on both K2 paths: unsplit "
              f"{path_ms['unsplit']:.1f} ms, split {path_ms['split']:.1f} "
              f"ms (the rule: {taken}), plain {plain_ms:.1f} ms, bound "
              f"{bound:.2f} ms ({bound_by})")
    print(f"phase 1: K2's registers and spills: {_k2_registers()}")
    edge = cuda_blind_rotate.K1_TILES_PER_SM
    for params_k1, keys_k1, cl_k1, batches_k1 in (
            (PARAM_OPT, k_opt, cl_opt,
             (8, 16, 32, 128, 144, 512, 1024, 2048, 4096)),
            (PARAM_TPU, keys, client, (aes_bits,))):
        primes = keys_k1.rplan.n_primes
        for n_batch in batches_k1:
            small, test = rotate_inputs(params_k1, n_batch,
                                        cl_k1.sk.lwe_key)
            rows = n_batch if n_batch <= 512 else NOISE_PLAIN_ROWS
            br_args = (keys_k1.rplan, params_k1, keys_k1.bsk_limbs)
            want, plain_ms = _timed(blind_rotate.blind_rotate_plain,
                                    *br_args, small[:rows], test,
                                    keys_k1.rfwd_limbs,
                                    keys_k1.rinv_crt_limbs,
                                    keys_k1.rot_table)
            path_ms, words = {}, {}
            try:
                for path in ("tiled", "persistent"):
                    cuda_blind_rotate.K1_TILES_PER_SM = (
                        0 if path == "persistent" else 1 << 30)
                    if path == "persistent" and not \
                            cuda_blind_rotate.k1_persistent(
                                params_k1, n_batch, primes, sms):
                        continue            # its resident slice does not fit
                    words[path], path_ms[path] = _median_ms(
                        cuda_blind_rotate.blind_rotate_cuda, *br_args, small,
                        test, keys_k1.fwd_full, keys_k1.inv_crt_full,
                        keys_k1.rot_table)
                    br_err = max(br_err, _require_equal(
                        words[path][:rows], want,
                        f"blind rotate {params_k1.name} B={n_batch} K1 "
                        f"{path}"))
            finally:
                cuda_blind_rotate.K1_TILES_PER_SM = edge
            if len(words) == 2:
                _require_equal(words["persistent"], words["tiled"],
                               f"blind rotate {params_k1.name} B={n_batch}: "
                               f"the two K1 paths")
            taken = "persistent" if cuda_blind_rotate.k1_persistent(
                params_k1, n_batch, primes, sms) else "tiled"
            k2_ms = None
            if params_k1 is PARAM_OPT and n_batch >= 144:
                k2_ms = _k2_step_ms(
                    cuda_blind_rotate.blind_rotate_cuda, *br_args, small,
                    test, keys_k1.fwd_full, keys_k1.inv_crt_full,
                    keys_k1.rot_table, steps=params_k1.lwe_dimension)
            bound, bound_by = rotate_bound(params_k1, keys_k1.rplan, n_batch)
            br_shapes.append({"shape": f"{params_k1.name} {n_batch} bits, "
                                       f"K1 paths",
                              "ms": path_ms[taken], "plain_ms": plain_ms,
                              "plain_rows": rows, "bound_ms": bound,
                              "k1": taken, "k2_step_ms": k2_ms,
                              **{f"{k}_ms": v for k, v in path_ms.items()}})
            shown = ", ".join(f"{k} {v:.1f} ms" for k, v in path_ms.items())
            if k2_ms is not None:
                shown += f", K2 {k2_ms:.4f} ms a step"
            if len(words) < 2:
                shown += " (no persistent K1: its slice does not fit)"
            print(f"phase 1: blind rotate {params_k1.name} kernel == plain at "
                  f"B={n_batch} on both K1 paths (the plain version on "
                  f"{rows} rows, the paths against each other on all): "
                  f"{shown} "
                  f"(the rule: {taken}), plain {plain_ms:.1f} ms, bound "
                  f"{bound:.2f} ms ({bound_by})")
    del got, want, small, test, k_opt, cl_opt, words

    # Yardstick of the int8 product rate: torch._int_mm on one PARAM_TPU
    # step's product shapes at the timed batch (the port never calls it
    # for the rotate).
    r_rows = (PARAM_TPU.glwe_dimension + 1) * PARAM_TPU.pbs_level
    kp1, n_poly = PARAM_TPU.glwe_dimension + 1, PARAM_TPU.polynomial_size
    pcount = keys.rplan.n_primes
    mm_ms = _int_mm_ms({
        "forward": [((r_rows * aes_bits, 2 * n_poly, 2 * pcount * n_poly),
                     1)],
        "inverse": [((kp1 * aes_bits, 2 * n_poly, 2 * n_poly), pcount)]})
    print(f"phase 1: yardstick torch._int_mm, one PARAM_TPU step at "
          f"{aes_bits} bits: forward [{r_rows * aes_bits}x{2 * n_poly}]x"
          f"[{2 * n_poly}x{2 * pcount * n_poly}] {mm_ms['forward']:.3f} ms, "
          f"inverse {pcount} x [{kp1 * aes_bits}x{2 * n_poly}]x"
          f"[{2 * n_poly}x{2 * n_poly}] {mm_ms['inverse']:.3f} ms; the "
          f"kernel's whole step {br_ms / PARAM_TPU.lwe_dimension:.3f} ms")

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
        bound = vp_bound(p, k.plan, B, L, nbits)
        return torus.to_u64(lwe.sample_extract0(got)), err, ms, plain_ms, \
            bound

    def decrypt_lut_check(cl, out, values, want_fn, n_out):
        for bi, v in enumerate(values):
            got = [int(cl.decrypt_bits(out[bi, o])) for o in range(n_out)]
            if got != want_fn(bi, v):
                raise AssertionError(f"VP output of byte {v} decrypts wrong")

    sbox = tables.sbox()
    toy_vp = dataclasses.replace(PARAM_TOY, name="PARAM_TOY_VP", cbs_level=1,
                                 cbs_base_log=15)
    cl_vp = Client(toy_vp, seed=11)
    k_vp = cl_vp.make_device_keys(fast=False, device=dev)
    vals = [0x5A, 0x01, 0xFF, 0x80]
    # toy N=128 < 2^8: exercise the kernel on the 7 rotation bits of a
    # 7-bit table (the CMux tree for an 8th bit stays plain torch).
    t7 = np.arange(128, dtype=np.uint64) * 3 % 128
    out, _, _, _, _ = vp_case(k_vp, cl_vp, toy_vp, [v % 128 for v in vals],
                           luts.lut_polys_from_tables(toy_vp, t7[None], 7), 7)
    decrypt_lut_check(cl_vp, out, [v % 128 for v in vals],
                      lambda bi, v: [(int(t7[v]) >> o) & 1 for o in range(8)],
                      8)
    print("phase 2: VP PARAM_TOY_VP kernel == plain (4 bytes x 7 bits), "
          "decrypts to the table")
    # k+1 = 5 digit rows an accumulator, as PARAM_TPU: 5 bytes x 8 outputs
    # = 40 accumulators (groups of 25 and 15), 200 rows of X (128 + 72).
    toy_vp4 = dataclasses.replace(toy_vp, name="PARAM_TOY_VP_K4",
                                  glwe_dimension=4)
    cl_vp = Client(toy_vp4, seed=11)
    k_vp = cl_vp.make_device_keys(fast=False, device=dev)
    vals5 = [0x5A, 0x01, 0x7F, 0x00, 0x33]
    out, _, _, _, _ = vp_case(k_vp, cl_vp, toy_vp4, vals5,
                              luts.lut_polys_from_tables(toy_vp4, t7[None], 7),
                              7)
    decrypt_lut_check(cl_vp, out, vals5,
                      lambda bi, v: [(int(t7[v]) >> o) & 1 for o in range(8)],
                      8)
    print("phase 2: VP PARAM_TOY_VP_K4 kernel == plain (5 bytes x 7 bits, "
          "ragged group and tile), decrypts to the table")
    del k_vp, cl_vp

    fwd = fhe_aes._fwd_luts(PARAM_TPU)
    mul = [sbox, tables.gf_mul_table(2)[sbox], tables.gf_mul_table(3)[sbox]]
    vals16 = [(37 * i + 11) % 256 for i in range(16)]
    out, vp_err, _, _, _ = vp_case(keys, client, PARAM_TPU, vals16, fwd, 8)
    decrypt_lut_check(client, out, vals16, lambda bi, v: [
        (int(mul[o // 8][v]) >> (o % 8)) & 1 for o in range(24)], 24)
    # The ripple add's per-block LUTs (L=9): its later steps (9 bits in)
    # and its first (8 bits), at every CTR batch of the paths.
    ripple = path_blocks
    for n_blk in ripple:
        i_bytes = fhe_aes.counter_bytes(n_blk, 0x1FE)
        lsb, rest = fhe_aes.add_scalar_luts(PARAM_TPU, i_bytes)
        vals9 = [(0x0FF, 0x1FF, 0x000, 0x17F)[i % 4] for i in range(n_blk)]
        out, err, _, _, _ = vp_case(keys, client, PARAM_TPU, vals9, rest[0],
                                    9)
        vp_err = max(vp_err, err)

        def want9(bi, v, i_bytes=i_bytes):
            s = (v & 0xFF) + (v >> 8) + int(i_bytes[bi, 14])
            return [((s % 256) >> o) & 1 for o in range(8)] + [int(s > 255)]
        decrypt_lut_check(client, out, vals9, want9, 9)
        vals8 = [(0xFF, 0x01, 0x00, 0x7F)[i % 4] for i in range(n_blk)]
        out, err, _, _, _ = vp_case(keys, client, PARAM_TPU, vals8, lsb, 8)
        vp_err = max(vp_err, err)

        def want8(bi, v, i_bytes=i_bytes):
            s = v + int(i_bytes[bi, 15])
            return [((s % 256) >> o) & 1 for o in range(8)] + [int(s > 255)]
        decrypt_lut_check(client, out, vals8, want8, 9)
    aes_bytes = 16 * BENCH_BLOCKS
    vals_t = [(13 * i + 5) % 256 for i in range(aes_bytes)]
    _, err_t, vp_ms, vp_plain_ms, (vp_bound_ms, vp_bound_by) = vp_case(
        keys, client, PARAM_TPU, vals_t, fwd, 8)
    vp_err = max(vp_err, err_t)
    print(f"phase 2: VP PARAM_TPU kernel == plain at 16 B x 8 bits (L=24), "
          f"the ripple add's LUTs (L=9, 9 and 8 bits) at {ripple} blocks "
          f"and {aes_bytes} B x 8 bits (L=24), all decrypt right; "
          f"{aes_bytes} B: kernel {vp_ms:.1f} ms, plain {vp_plain_ms:.1f} "
          f"ms, bound {vp_bound_ms:.2f} ms ({vp_bound_by})")

    # The other byte-LUT shapes of the paths: the AES rounds (L=24) and
    # the final rounds' S-box (L=8) of the 32-, 8-, 4- and 2-block batches
    # (512 B also for a 64-block round the memory chunking halves) and the
    # final round of the 64- and 1-block ones; the
    # trivial key-expansion round (16 B, L=16); decrypt's InvSubBytes
    # (L=8) and InvMixColumns multiples (L=32) at a 4-block round's 64
    # bytes and the CLI's 1-block 16; the SubWord (4 B, S-box) and the
    # pk-RCON refreshes (12 B and 4 B, identity).
    vp_shapes = [{"shape": f"PARAM_TPU {aes_bytes} B x 8 bits, L=24",
                  "ms": vp_ms, "plain_ms": vp_plain_ms,
                  "bound_ms": vp_bound_ms}]
    fwd24 = ("L=24 S-box x1/x2/x3", fwd, mul)
    inv_mul = ("L=32 mul9/11/13/14", fhe_aes._inv_mul_luts(PARAM_TPU),
               [tables.gf_mul_table(c) for c in (9, 11, 13, 14)])
    inv_sbox = ("L=8 inverse S-box", fhe_aes._sbox_lut(PARAM_TPU, True),
                [tables.inv_sbox()])
    fwd_sbox = ("L=8 S-box", fhe_aes._sbox_lut(PARAM_TPU, False), [sbox])
    ident = ("L=8 identity", fhe_aes._identity_lut(PARAM_TPU),
             [np.arange(256, dtype=np.uint64)])
    refresh = ("L=16 identity + S-box", fhe_aes._refresh_sbox_lut(PARAM_TPU),
               [np.arange(256, dtype=np.uint64), sbox])
    for n_bytes, (label, lut_np, tabs) in (
            (aes_bytes, fwd_sbox), (512, fwd24), (512, fwd_sbox),
            (128, fwd24), (128, fwd_sbox), (64, fwd24), (64, fwd_sbox),
            (32, fwd24),
            (32, fwd_sbox), (16, fwd_sbox), (16, refresh), (64, inv_mul),
            (64, inv_sbox), (16, inv_mul), (16, inv_sbox), (4, fwd_sbox),
            (12, ident), (4, ident)):
        vals_b = [(29 * i + 3) % 256 for i in range(n_bytes)]
        out, err, ms, plain_ms, (bound, _) = vp_case(
            keys, client, PARAM_TPU, vals_b, lut_np, 8)
        vp_err = max(vp_err, err)
        decrypt_lut_check(client, out, vals_b, lambda bi, v, tabs=tabs: [
            (int(tabs[o // 8][v]) >> (o % 8)) & 1
            for o in range(8 * len(tabs))], 8 * len(tabs))
        vp_shapes.append({"shape": f"PARAM_TPU {n_bytes} B x 8 bits, {label}",
                          "ms": ms, "plain_ms": plain_ms, "bound_ms": bound})
        print(f"phase 2: VP PARAM_TPU kernel == plain at {n_bytes} B x 8 "
              f"bits, {label}, decrypts to the table; kernel {ms:.1f} ms, "
              f"plain {plain_ms:.1f} ms, bound {bound:.2f} ms")

    # Yardstick of the int8 product rate: torch._int_mm on one selector
    # bit's product shapes at the timed shape (the port never calls it for
    # the rotations).
    m_rows = aes_bytes * 24 * kp1
    pcount = keys.plan.n_primes
    # The forward product at the kernel's depth (a digit as two int8
    # limbs, 2N) and at the three base-2^5 limbs' (3N) of the TPU kernel.
    mm_ms = _int_mm_ms({
        "forward": [((m_rows, 2 * n_poly, 2 * pcount * n_poly), 1)],
        "forward3": [((m_rows, 3 * n_poly, 2 * pcount * n_poly), 1)],
        "inverse": [((m_rows, 2 * n_poly, 2 * n_poly), pcount)]})
    print(f"phase 2: yardstick torch._int_mm, one PARAM_TPU selector bit at "
          f"{aes_bytes} B, L=24: forward [{m_rows}x{2 * n_poly}]x"
          f"[{2 * n_poly}x{2 * pcount * n_poly}] {mm_ms['forward']:.3f} ms "
          f"(three-limb digits, [{m_rows}x{3 * n_poly}]x"
          f"[{3 * n_poly}x{2 * pcount * n_poly}]: {mm_ms['forward3']:.3f} "
          f"ms), inverse {pcount} x [{m_rows}x{2 * n_poly}]x"
          f"[{2 * n_poly}x{2 * n_poly}] {mm_ms['inverse']:.3f} ms; the "
          f"kernel's whole bit {vp_ms / 8:.3f} ms")

    # -- phase 3: the main path ----------------------------------------------
    server = Server(keys)
    enc_key = torus.from_u64(client.encrypt_u128(KEY), dev)
    enc_iv = torus.from_u64(client.encrypt_u128(IV), dev)
    start = _launches()
    rks, keyexp_ms = _timed(server.aes_key_expansion, enc_key)
    ks1, ctr1_ms = _timed(server.ctr_keystream, rks, enc_iv, args.blocks, 0)
    ks2, ctr2_ms = _timed(server.ctr_keystream, rks, enc_iv, args.blocks2,
                          args.blocks)
    launches = _launches(start)
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
    print(f"phase 3: launches {launches}; peak device memory, allocated / "
          f"reserved: {_peak_gib()}")
    del server, keys, ks1, ks2, rks

    cache_dir = tempfile.mkdtemp(prefix="tfhe_aes_smoke_keys_")
    old_cache = os.environ.get("TFHE_AES_TPU_CACHE")
    os.environ["TFHE_AES_TPU_CACHE"] = cache_dir
    try:
        paths = {"ctr (phase 3)": launches}
        paths.update(_reference_phases(dev, keygen_s))
        paths.update(_ctr_phase(dev))
        paths.update(_mesh_phase(dev))
        noise_paths, noise_shapes, noise_err = _noise_phase(dev)
        paths.update(noise_paths)
        br_shapes += noise_shapes
        br_err = max(br_err, noise_err)
        paths.update(_cold_start_phase())
        print("phase 10: temporary directory removed")
        paths.update(_graph_phase(dev))
        paths.update(_unit_phase(dev, smi))
    finally:
        if old_cache is None:
            os.environ.pop("TFHE_AES_TPU_CACHE", None)
        else:
            os.environ["TFHE_AES_TPU_CACHE"] = old_cache
        shutil.rmtree(cache_dir, ignore_errors=True)
    print(f"phase 12: key cache directory removed; whole script "
          f"{time.perf_counter() - t_start:.0f} s")

    def launch_fields(name):
        by_path = {path: counts[name] for path, counts in paths.items()}
        return {"launches": sum(by_path.values()), "launches_by_path": by_path}

    kernels = [
        {"name": "blind_rotate", "route": "cuda",
         "source": "tfhe_aes_tpu_torch/csrc/blind_rotate.cu",
         "replaces": "tfhe_aes_tpu/ops/pallas_blind_rotate.py:73",
         **launch_fields("blind_rotate"), "max_abs_err": br_err,
         "ms": br_ms, "plain_ms": br_plain_ms, "bound_ms": br_bound,
         "bound_by": br_bound_by, "library_ms": None, "shapes": br_shapes},
        {"name": "vertical_packing", "route": "cuda",
         "source": "tfhe_aes_tpu_torch/csrc/vertical_packing.cu",
         "replaces": "tfhe_aes_tpu/ops/pallas_vp.py:63",
         **launch_fields("vertical_packing"), "max_abs_err": vp_err,
         "ms": vp_ms, "plain_ms": vp_plain_ms, "bound_ms": vp_bound_ms,
         "bound_by": vp_bound_by, "library_ms": None, "shapes": vp_shapes},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
