"""Benchmark: FHE AES-128 CTR throughput of the torch port on one card.

    python -m tfhe_aes_tpu_torch.bench [--blocks 64] [--params {prod,tpu,toy}]
        [--repeats 2] [--skip-verify] [--device-verify] [--decrypt N]
        [--device {cuda,cpu}]

Counterpart of the root bench.py.  Prints one JSON line, the last line on
stdout: {"metric": "aes128_ctr_blocks_per_min", "value", "unit",
"vs_baseline", "params", "blocks", "device"}; everything else goes to
stderr.  Baseline: the reference's published 84 s/block on one CPU core
= 0.714 blocks/min.  The metric is CTR keystream blocks/min at a batch of
--blocks, each repeat at another counter offset, host LUT building inside
the timed window, every window ended by a device fence; the blocks are
then decrypted on the host (the client; on the device with
``--device-verify``) and checked against plaintext AES.  ``device`` names
the card and how many there are, or is "cpu": ``--device cpu`` runs the
plain torch versions, never a card's number.

Keys come from the key cache (utils/serialization.cache_path(params, 0),
shared with the JAX package) or from device keygen, saved to the cache
in a thread that is always joined before run() returns.  The cold-start
warm-up (utils/warmup.py) runs beside the key load or keygen and is
joined before the first key expansion.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import sys
import time

import torch

from .cli import NIST_KEY as KEY
from .cli import PARAMS
from .client.client import Client
from .params import ParamSet
from .server import Server
from .utils import device as device_mod
from .utils import profiling, serialization, torus, warmup

BASELINE_BLOCKS_PER_MIN = 60.0 / 84.0  # reference: 84 s/block, 1 CPU core
IV = 0x00112233445566778899AABBCCDDEEFF


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def device_record(device: torch.device):
    """What the numbers ran on: the card's name and count, or "cpu"."""
    if device.type == "cuda":
        return {"name": torch.cuda.get_device_name(device),
                "count": torch.cuda.device_count()}
    return "cpu"


def run(params: ParamSet, blocks: int = 64, repeats: int = 2,
        decrypt: int = 0, skip_verify: bool = False, device=None,
        device_verify: bool = False) -> dict:
    """Key load or keygen beside the warm-up, key expansion (first and
    warm), a warm-up CTR batch and `repeats` timed ones, the JSON line on
    stdout, then verification (on the host; on the device with
    device_verify) and the optional decrypt benchmark.  Returns the record
    of the JSON line.  `device` is the card unless the caller asks for the
    CPU; raises without a card."""
    device = device_mod.resolve(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    log(f"# device: {device_record(device)}, params: {params.name}, "
        f"blocks: {blocks}")
    warm = warmup.precompile(params, blocks, device=device)
    cache = serialization.cache_path(params, 0)
    t0 = time.perf_counter()
    client = Client(params, seed=0)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        saving = None
        if cache.exists():
            client.sk, dkeys = serialization.load_keys(cache)
            dkeys = dkeys.to(device)
            how = f"loaded from {cache}"
        else:
            dkeys = client.make_device_keys(device=device)
            # The npz write (a device-to-host pull) overlaps the first
            # dispatches; leaving the `with` joins it, whatever happens.
            saving = pool.submit(serialization.save_keys, cache, client.sk,
                                 dkeys)
            how = "device keygen"
        profiling.device_fence(dkeys.bsk_limbs)
        log(f"# keys ready in {time.perf_counter() - t0:.1f}s ({how})")
        report = warm.join()
        log(f"# warm-up (overlapped with keygen): {report} joined at "
            f"{report['joined_at']:.1f} s")
        record = _measure(client, Server(dkeys), params, blocks, repeats,
                          decrypt, skip_verify, device, device_verify)
        if saving is not None:
            saving.result()
    return record


def _measure(client, server, params, blocks, repeats, decrypt, skip_verify,
             device, device_verify) -> dict:
    enc_key = torus.from_u64(client.encrypt_u128(KEY), device)
    enc_iv = torus.from_u64(client.encrypt_u128(IV), device)
    for label in ("first", "warm"):
        t0 = time.perf_counter()
        rks = profiling.device_fence(server.aes_key_expansion(enc_key))
        log(f"# key expansion ({label}): {time.perf_counter() - t0:.2f}s")

    def batch(offset):
        return profiling.device_fence(
            server.ctr_keystream(rks, enc_iv, blocks, offset))

    t0 = time.perf_counter()
    out = batch(0)
    log(f"# warmup batch: {time.perf_counter() - t0:.2f}s")
    # Every timed batch runs at another counter offset: distinct work.
    times = []
    last_offset = 0
    for i in range(repeats):
        last_offset = (i + 1) * blocks
        t0 = time.perf_counter()
        out = batch(last_offset)
        times.append(time.perf_counter() - t0)
        log(f"# repeat {i}: {times[-1]:.2f}s")
    t_batch = min(times)
    blocks_per_min = blocks / t_batch * 60.0
    pbs_per_block = profiling.count_pbs_per_block(params)
    log(f"# steady-state: {t_batch:.2f}s/batch, "
        f"{blocks / t_batch * pbs_per_block:.0f} PBS/s")
    if device.type == "cuda":
        # Reserved counts the memory a graph's pool holds between replays,
        # which allocated (live tensors) does not.
        log(f"# peak device memory: "
            f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB "
            f"(reserved {torch.cuda.max_memory_reserved(device) / 2**30:.2f}"
            f" GiB)")
    record = {
        "metric": "aes128_ctr_blocks_per_min",
        "value": round(blocks_per_min, 3),
        "unit": "blocks/min",
        "vs_baseline": round(blocks_per_min / BASELINE_BLOCKS_PER_MIN, 2),
        "params": params.name,
        "blocks": blocks,
        "device": device_record(device),
    }
    print(json.dumps(record), flush=True)

    where = "device" if device_verify else "host"
    if not skip_verify:
        t0 = time.perf_counter()
        if device_verify:
            client.verify_ctr_device(out, KEY, IV, offset=last_offset)
        else:
            client.fetch_and_verify_ctr(out, KEY, IV, offset=last_offset)
        log(f"# verified {blocks} blocks bit-exact vs plaintext AES ({where} "
            f"decrypt, {time.perf_counter() - t0:.1f}s, outside the metric)")

    if decrypt:
        nd = min(decrypt, blocks)
        ct = out[:nd]
        t0 = time.perf_counter()
        back = profiling.device_fence(server.aes_decrypt(rks, ct))
        log(f"# decrypt warmup ({nd} blocks): "
            f"{time.perf_counter() - t0:.2f}s")
        t0 = time.perf_counter()
        back = profiling.device_fence(server.aes_decrypt(rks, ct))
        t_dec = time.perf_counter() - t0
        log(f"# homomorphic decrypt: {t_dec:.2f}s for {nd} blocks = "
            f"{nd / t_dec * 60:.3f} blocks/min (encrypt: "
            f"{blocks_per_min:.3f})")
        if not skip_verify:
            if device_verify:
                got_all = client.decrypt_states_device(back)
            else:
                got_all = [client.decrypt_state_u128(s)
                           for s in torus.to_u64(back)]
            for i, got in enumerate(got_all):
                want = (IV + last_offset + i) % (1 << 128)
                if got != want:
                    raise AssertionError(f"decrypt round-trip block {i}: "
                                         f"{got:#x} != {want:#x}")
            log(f"# decrypt round-trip verified ({nd} blocks) by {where} "
                f"decrypt")
    return record


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m tfhe_aes_tpu_torch.bench",
        description="FHE AES-128 CTR blocks/min of the torch port")
    ap.add_argument("--blocks", type=int, default=64,
                    help="CTR blocks per timed batch")
    ap.add_argument("--params", choices=sorted(PARAMS), default="tpu",
                    help="prod = the reference's PARAM_OPT; tpu = PARAM_TPU "
                         "(same security, base-2^12 x 3 BSK digits); toy = "
                         "PARAM_TOY (no security)")
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--skip-verify", action="store_true")
    ap.add_argument("--device-verify", action="store_true",
                    help="measurement-only shortcut: decrypt on-device "
                         "(ships the secret key to the accelerator).  The "
                         "default verifies on the CLIENT via chunked D2H — "
                         "the trust boundary the Server facade models")
    ap.add_argument("--decrypt", type=int, default=0, metavar="N",
                    help="also time homomorphic AES decryption of N blocks "
                         "of the keystream and check the round trip "
                         "(reported on stderr)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda needs a card and fails without one; cpu "
                         "runs the plain torch versions")
    return ap


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    run(PARAMS[args.params], args.blocks, args.repeats, args.decrypt,
        args.skip_verify, args.device, args.device_verify)
    return 0


if __name__ == "__main__":
    sys.exit(main())
