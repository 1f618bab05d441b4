#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (tfhe_aes_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--blocks N] [--blocks2 M]

Phases, each printing its result on its own line; any failure raises and
the script exits non-zero:
  0. environment: the card, the native host runtime, the kernel builds;
  1. the blind-rotate kernel against blind_rotate_plain, word for word, at
     four toy sets (one with 25 GGSW rows) x batches 1, 9, 128, at
     PARAM_TPU at every batch the paths below give it (16 to 1024 bits,
     and the bench's 64-block AES round, 8192 bits, timed) and at
     PARAM_OPT (the CLI's default set, 25 rows) at the batches of its
     4-block CTR, each timed beside its bound; then torch._int_mm on one
     step's product shapes as a yardstick of the int8 product rate;
  2. the vertical-packing kernel against vp_rotations_plain through a real
     circuit bootstrap: two cbs_level=1 toy sets (k+1 = 3; k+1 = 5 at a
     batch that fills neither a digit tile's group of 25 accumulators nor
     a 128-row tile); PARAM_TPU at the paths' byte-LUT shapes: AES rounds
     (L=24) and final rounds (S-box, L=8) at 16 to 1024 bytes (1024, the
     bench's round, timed), the ripple add (L=9) at 2, 4, 8 and 64 blocks,
     the key-expansion round (L=16), decrypt's L=8 and L=32 at 64 and 16
     bytes, the SubWord and pk-RCON refreshes at 4 and 12 bytes (L=8),
     each timed beside its bound; then torch._int_mm on one selector bit's
     product shapes as a yardstick (PARAM_OPT's VP shapes are PARAM_TPU's:
     the two sets differ only in the blind rotate's decomposition);
  3. the main path at PARAM_TPU through Client and Server: host keygen,
     key expansion, two CTR keystream batches (4 and 8 blocks) at
     different offsets, host decryption checked against plaintext AES,
     the kernels' launch counts;
  4. device keygen: PARAM_TOY on the card equals the CPU leaf by leaf;
     PARAM_TPU timed beside phase 1's host keygen; its keys saved to the
     key cache in a temporary directory and loaded back to equal leaves;
  5. the reference circuits at PARAM_TPU on those keys: pk-RCON key
     expansion, aes_encrypt of the 4 NIST blocks, aes_decrypt back, each
     timed and checked, with the kernels' launch counts; then one more
     aes_decrypt under torch.profiler, each kernel's device time;
  6. the CLI in-process on the cached keys: a 2-block CTR run with
     --pk-rcon --decrypt --noise-asserts, then the --test harness;
  7. the bench entry in-process (python -m tfhe_aes_tpu_torch.bench):
     PARAM_TPU at its default 64 blocks, 1 repeat, --decrypt 4 (device
     keygen, saved to the key cache); then PARAM_OPT at 4 blocks; each
     JSON line parsed, every block verified on the host;
  8. the mesh: (a) the multi-process CTR launcher with one rank a card
     over NCCL, PARAM_TPU, 8 blocks, keys from phase 7's cache, every
     block verified by its rank; (b) two ranks on the one card over gloo,
     dp=1 x mp=2 with the keyswitch keys' contraction rows and each
     round's bytes split between them, PARAM_TOY, 2 blocks: equal word
     for word to the one-rank ctr_keystream on the same keys;
  9. the measured noise study (python -m tfhe_aes_tpu_torch.noise_study)
     at PARAM_TPU and PARAM_OPT on phase 7's seed-0 caches: 4096 boolean
     PBS and a 512-byte identity-LUT WoPBS each, every sigma printed
     beside the TPU's, any failed budget check fails the run, the reports
     in the temporary directory; then each set's 4096-bit rotate batch
     through the kernel again, timed beside its bound, its first 16 rows
     against the plain version and its extracted phases against the
     study's errors.
Every launch count is read from zero around one run of a path (phases 3,
5 and 6; each of phase 7's two bench runs; each of phase 8's (a) and (b),
whose ranks count their own and report them; each of phase 9's two study
runs, summed); every kernel of a path must have been launched, and (b),
at cbs_level 2, must launch the rotate and no VP.  The comparisons with
the plain versions are not counted.  The key cache of phases 4-9 lives in
a temporary directory, removed at the end.
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
KERNELS = ("blind_rotate", "vertical_packing")
CACHE_SEED = 1          # the seed of phase 4's keys and phase 6's CLI runs
CLI_BLOCKS = 2          # phase 6's CTR run
BENCH_BLOCKS = 64       # phase 7: the bench's default batch, PARAM_TPU
BENCH_DECRYPT = 4       # phase 7: its --decrypt blocks
OPT_BLOCKS = 4          # phase 7: the PARAM_OPT bench batch
MESH_BLOCKS = 8         # phase 8 (a): the launcher's batch, PARAM_TPU
TOY_MESH_BLOCKS = 2     # phase 8 (b): the two-rank gloo batch, PARAM_TOY
NOISE_PBS = 4096        # phase 9: boolean PBS bits of a set's study
NOISE_WOPBS_BYTES = 512  # phase 9: identity-LUT WoPBS bytes of a set's study
NOISE_PLAIN_ROWS = 16   # phase 9: rotate rows held against the plain version
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
        raise AssertionError(f"{what}: kernel words differ from the plain "
                             f"version")
    return _max_abs_err(got, want)


def _reset_launches(wrappers) -> None:
    for fn in wrappers.values():
        fn.launches = 0


def _read_launches(wrappers, path: str) -> dict:
    """The launch counts since _reset_launches; raises if a kernel of the
    path was not launched."""
    counts = {name: fn.launches for name, fn in wrappers.items()}
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


def _profile_decrypt(server, rks, ct, n_blocks: int) -> None:
    """Where the time goes: one warm aes_decrypt under torch.profiler, the
    device time of each kernel (self time, summed over launches)."""
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
    print(f"phase 5: profile of one warm aes_decrypt of {n_blocks} blocks: "
          f"wall {wall:.1f} ms, kernels {busy:.1f} ms on the card "
          f"({100 * busy / wall:.1f}% busy)")
    ranked = sorted(kernels, key=dev_ms, reverse=True)
    for e in ranked[:8] + [e for e in ranked[8:] if "tfhe::" in e.key]:
        print(f"phase 5:   {dev_ms(e):9.1f} ms {100 * dev_ms(e) / busy:5.1f}% "
              f"x{e.count:<6} {e.key[:70]}")


def _reference_phases(dev, wrappers, host_keygen_s: float) -> dict:
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
    _reset_launches(wrappers)
    rks, pk_ms = _timed(server.aes_key_expansion, enc_key, pk_rcon=True)
    ct, enc_ms = _timed(server.aes_encrypt, rks, state)
    pt, dec_ms = _timed(server.aes_decrypt, rks, ct)
    launches = _read_launches(wrappers, "phase 5")
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
    _reset_launches(wrappers)
    seed = str(CACHE_SEED)
    outs = [_run_cli(cli, ["--params", "tpu", "--seed", seed,
                           "--number-of-outputs", "2", "--iv", hex(IV),
                           "--key", hex(KEY), "--pk-rcon", "--decrypt",
                           "--noise-asserts"]),
            _run_cli(cli, ["--params", "tpu", "--seed", seed, "--test",
                           "--test-random", "1"])]
    cli_launches = _read_launches(wrappers, "phase 6")
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


def _run_bench(bench, argv) -> tuple[dict, str]:
    """bench.main(argv) in this process; echoes its output.  Returns (the
    JSON record of its last stdout line, its stderr)."""
    out, err = io.StringIO(), io.StringIO()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = bench.main(argv)
    finally:
        for line in (err.getvalue() + out.getvalue()).splitlines():
            print(f"phase 7:   {line}")
    if rc != 0:
        raise AssertionError(f"bench {' '.join(argv)} returned {rc}")
    return json.loads(out.getvalue().strip().splitlines()[-1]), err.getvalue()


def _bench_phase(dev, wrappers) -> dict:
    """Phase 7: the bench entry at PARAM_TPU (64 blocks, decrypt 4) and
    PARAM_OPT (4 blocks), keys by device keygen into the key cache.
    Returns the launch counts of each run, by path."""
    import torch
    from tfhe_aes_tpu_torch import bench

    card = {"name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}
    runs = (("PARAM_TPU", BENCH_BLOCKS,
             ["--blocks", str(BENCH_BLOCKS), "--repeats", "1", "--decrypt",
              str(BENCH_DECRYPT)]),
            ("PARAM_OPT", OPT_BLOCKS,
             ["--params", "prod", "--blocks", str(OPT_BLOCKS), "--repeats",
              "1"]))
    torch.cuda.empty_cache()
    paths = {}
    for name, blocks, argv in runs:
        _reset_launches(wrappers)
        t0 = time.perf_counter()
        rec, err = _run_bench(bench, argv)
        wall = time.perf_counter() - t0
        path = f"bench {name} (phase 7)"
        paths[path] = _read_launches(wrappers, path)
        if (rec["metric"], rec["params"], rec["blocks"], rec["device"]) != \
                ("aes128_ctr_blocks_per_min", name, blocks, card):
            raise AssertionError(f"bench {name}: unexpected record {rec}")
        if f"# verified {blocks} blocks bit-exact" not in err:
            raise AssertionError(f"bench {name}: blocks not verified")
        if "--decrypt" in argv and \
                f"round-trip verified ({BENCH_DECRYPT} blocks)" not in err:
            raise AssertionError(f"bench {name}: decrypt not verified")
        print(f"phase 7: bench {name} {blocks} blocks: {rec['value']} "
              f"blocks/min ({rec['vs_baseline']}x the reference's 84 "
              f"s/block), every block verified; whole run {wall:.1f} s; "
              f"launches {paths[path]}")
    return paths


def _toy_mesh_rank(rank, out_dir, port) -> None:
    """Phase 8 (b), one of two ranks on the one card over gloo: dp=1 x
    mp=2, contraction rows and bytes sharded.  Saves its keystream and its
    kernels' launch counts."""
    import numpy as np
    import torch
    from tfhe_aes_tpu_torch.client.client import Client
    from tfhe_aes_tpu_torch.ops import cuda_blind_rotate, cuda_vp
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
        wrappers = {"blind_rotate": cuda_blind_rotate.blind_rotate_cuda,
                    "vertical_packing": cuda_vp.vp_rotations_cuda}
        _reset_launches(wrappers)
        local, _ = fn(x["rks"], x["iv"], x["lut_lsb"], x["luts_rest"])
        whole = mesh.gather_blocks(m, local).cpu().numpy()
        launches = {name: w.launches for name, w in wrappers.items()}
        np.save(os.path.join(out_dir, f"out{rank}.npy"), whole)
        with open(os.path.join(out_dir, f"launches{rank}.json"), "w") as f:
            json.dump(launches, f)
    finally:
        torch.distributed.destroy_process_group()


def _mesh_phase(dev, wrappers) -> dict:
    """Phase 8: (a) the launcher over NCCL, a rank a card, PARAM_TPU, keys
    from phase 7's cache; (b) two gloo ranks on the one card at PARAM_TOY
    against the one-rank keystream.  Returns the launch counts of (a) and
    of (b), each summed over its ranks, by path."""
    import numpy as np
    import torch
    import torch.multiprocessing as tmp
    from tfhe_aes_tpu_torch.client.client import Client
    from tfhe_aes_tpu_torch.models import aes_plain, fhe_aes
    from tfhe_aes_tpu_torch.parallel.multihost_ctr import free_port
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
    path_a = "mesh (a) launcher (phase 8)"
    counts_a = {name: sum(rec["launches"][name] for rec in records)
                for name in wrappers}
    if min(counts_a.values()) < 1:
        raise AssertionError(f"{path_a}: a kernel was not launched: "
                             f"{counts_a}")
    slowest = max(rec["seconds"] for rec in records)
    print(f"phase 8: (a) launcher, {procs} rank(s) over NCCL, PARAM_TPU, "
          f"{MESH_BLOCKS} blocks: {MESH_BLOCKS / slowest * 60.0:.2f} "
          f"blocks/min (timed run {slowest} s, the slowest rank), {want}; "
          f"whole launcher {wall:.1f} s; launches {counts_a}")

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
        t0 = time.perf_counter()
        ctx = tmp.start_processes(_toy_mesh_rank, args=(out_dir, free_port()),
                                  nprocs=2, join=False, start_method="spawn")
        deadline = time.monotonic() + 300
        try:
            while not ctx.join(timeout=5):
                if time.monotonic() > deadline:
                    raise TimeoutError("phase 8 (b): the ranks did not end")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
                    proc.join()
        wall = time.perf_counter() - t0
        counts_b = {name: 0 for name in wrappers}
        for rank in range(2):
            got = np.load(os.path.join(out_dir, f"out{rank}.npy"))
            if not np.array_equal(got.view(np.uint64), ref):
                raise AssertionError(f"phase 8 (b): rank {rank}'s keystream "
                                     f"differs from the one-rank one")
            with open(os.path.join(out_dir, f"launches{rank}.json")) as f:
                for name, n in json.load(f).items():
                    counts_b[name] += n
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    print(f"phase 8: (b) 2 ranks on one card over gloo, dp=1 x mp=2, "
          f"contraction rows and bytes sharded, PARAM_TOY, "
          f"{TOY_MESH_BLOCKS} blocks: both ranks == the one-rank "
          f"ctr_keystream word for word, decrypts to AES; {wall:.1f} s")
    # The VP kernel runs only at cbs_level 1: (b)'s path never launches it;
    # (a) and phase 7 carry it.
    path_b = "mesh (b) gloo dp=1 x mp=2 (phase 8)"
    if counts_b["blind_rotate"] < 1 or counts_b["vertical_packing"]:
        raise AssertionError(f"{path_b}: unexpected launches {counts_b}")
    print(f"phase 8: (b) launches {counts_b}; vertical_packing is not on "
          f"this path (PARAM_TOY has cbs_level {PARAM_TOY.cbs_level}, the "
          f"VP kernel runs at cbs_level 1 only)")
    return {path_a: counts_a, path_b: counts_b}


def _noise_phase(dev, wrappers) -> tuple[dict, list, float]:
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
    counts = {name: 0 for name in wrappers}
    shapes, err_max = [], 0.0
    for p in (PARAM_TPU, PARAM_OPT):
        report = os.path.join(serialization.default_cache_dir(),
                              f"NOISE_REPORT_H100_{p.name}.md")
        buf = io.StringIO()
        _reset_launches(wrappers)
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
        for name, fn in wrappers.items():
            counts[name] += fn.launches
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
    wrappers = {"blind_rotate": cuda_blind_rotate.blind_rotate_cuda,
                "vertical_packing": cuda_vp.vp_rotations_cuda}

    # -- phase 0: environment ------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"phase 0: torch {torch.__version__} cuda {torch.version.cuda} "
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
    # of its key expansion (4-byte SubWord, 16-byte rounds).
    t0 = time.perf_counter()
    cl_opt = Client(PARAM_OPT, seed=0)
    k_opt = cl_opt.make_device_keys(fast=True, device=dev)
    torch.cuda.synchronize()
    print(f"phase 1: PARAM_OPT device keygen "
          f"{time.perf_counter() - t0:.1f} s")
    for n_batch in sorted({8 * OPT_BLOCKS, 9 * OPT_BLOCKS, 128 * OPT_BLOCKS,
                           32, 128}):
        small, test = rotate_inputs(PARAM_OPT, n_batch, cl_opt.sk.lwe_key)
        got, want, ms, plain_ms = rotate_pair(k_opt, PARAM_OPT, small, test)
        br_err = max(br_err, _require_equal(
            got, want, f"blind rotate PARAM_OPT B={n_batch}"))
        bound, bound_by = rotate_bound(PARAM_OPT, k_opt.rplan, n_batch)
        br_shapes.append({"shape": f"PARAM_OPT {n_batch} bits", "ms": ms,
                          "plain_ms": plain_ms, "bound_ms": bound})
        print(f"phase 1: blind rotate PARAM_OPT kernel == plain at "
              f"B={n_batch}: kernel {ms:.1f} ms, plain {plain_ms:.1f} ms, "
              f"bound {bound:.2f} ms ({bound_by})")
    del got, want, small, test, k_opt, cl_opt

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
    del server, keys, ks1, ks2, rks

    cache_dir = tempfile.mkdtemp(prefix="tfhe_aes_smoke_keys_")
    old_cache = os.environ.get("TFHE_AES_TPU_CACHE")
    os.environ["TFHE_AES_TPU_CACHE"] = cache_dir
    try:
        paths = {"ctr (phase 3)": launches}
        paths.update(_reference_phases(dev, wrappers, keygen_s))
        paths.update(_bench_phase(dev, wrappers))
        paths.update(_mesh_phase(dev, wrappers))
        noise_paths, noise_shapes, noise_err = _noise_phase(dev, wrappers)
        paths.update(noise_paths)
        br_shapes += noise_shapes
        br_err = max(br_err, noise_err)
    finally:
        if old_cache is None:
            os.environ.pop("TFHE_AES_TPU_CACHE", None)
        else:
            os.environ["TFHE_AES_TPU_CACHE"] = old_cache
        shutil.rmtree(cache_dir, ignore_errors=True)
    print(f"phase 9: key cache directory removed; whole script "
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
