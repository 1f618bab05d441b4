"""Command-line entry point of the torch port, with the reference's flags.

    python -m tfhe_aes_tpu_torch.cli --number-of-outputs N --iv IV --key KEY
        [--params {prod,tpu,toy}] [--seed S] [--device {cuda,cpu}]
        [--pk-rcon] [--decrypt] [--noise-asserts] [--no-verify] [--no-cache]
    python -m tfhe_aes_tpu_torch.cli --test [--test-random R] ...

Counterpart of tfhe_aes_tpu/cli.py: keygen (or a key-cache load), client
encryption of key and IV, server key expansion and CTR keystream (timed),
client decryption against plaintext AES; ``--test`` runs the NIST-vector
harness instead.  ``--device`` replaces the JAX ``--platform``: ``cuda``
(the default) needs a card and fails without one, ``cpu`` runs the plain
torch versions (use it with ``--params toy``).  Verification always runs
on the client, on the host.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from .models import aes_plain
from .params import PARAM_OPT, PARAM_TOY, PARAM_TPU
from .client.client import Client
from .server import Server
from .utils import noise_asserts, profiling, serialization, torus
from .utils import device as device_mod

PARAMS = {"prod": PARAM_OPT, "tpu": PARAM_TPU, "toy": PARAM_TOY}

# FIPS-197 / SP 800-38A (F.1.1, ECB-AES128) key, plaintexts and ciphertexts.
NIST_KEY = 0x2B7E151628AED2A6ABF7158809CF4F3C
NIST_PLAINS = (0x6BC1BEE22E409F96E93D7E117393172A,
               0xAE2D8A571E03AC9C9EB76FAC45AF8E51,
               0x30C81C46A35CE411E5FBC1191A0A52EF,
               0xF69F2445DF4F9B17AD2B417BE66C3710)
NIST_CIPHERS = (0x3AD77BB40D7A3660A89ECAF32466EF97,
                0xF5D3D58503B9699DE785895A96FDBAAF,
                0x43B1CD7F598ECE23881B00E3ED030688,
                0x7B0C785E27E8AD3F8223207104725DD4)


def aes_block(key: int, plain: int) -> int:
    """Plaintext AES-128 of one u128 block."""
    return aes_plain.bytes_be_to_u128(aes_plain.encrypt_block(
        aes_plain.u128_to_bytes_be(key), aes_plain.u128_to_bytes_be(plain)))


def client_and_keys(params, seed, device, use_cache: bool):
    """A Client and its evaluation keys on `device`.  With a seed and the
    cache on, the keys load from the cache (serialization.cache_path); on
    a miss, device keygen runs and saves them."""
    cache = serialization.cache_path(params, seed)
    use_cache = use_cache and seed is not None
    t0 = time.perf_counter()
    client = Client(params, seed=seed)
    if use_cache and cache.exists():
        client.sk, keys = serialization.load_keys(cache)
        keys = keys.to(device)
        print(f"[client] loaded cached keys {cache} in "
              f"{time.perf_counter() - t0:.2f}s")
        return client, keys
    keys = client.make_device_keys(fast=True, device=device)
    print(f"[client] device keygen + packing took "
          f"{time.perf_counter() - t0:.2f}s")
    if use_cache:
        serialization.save_keys(cache, client.sk, keys)
        print(f"[client] saved keys to {cache}")
    return client, keys


def run_test_harness(params, n_random: int, seed: int | None = None, *,
                     device=None, use_cache: bool = True) -> None:
    """The reference's test harness: the 4 NIST vectors as one batch, then
    n_random random key/plaintext cases; each case runs pk-RCON key
    expansion, aes_encrypt, aes_decrypt and checks both against plaintext
    AES.  One keyset serves every case (evaluation keys do not depend on
    the AES inputs).  `device` defaults to the card and raises without one
    unless device="cpu"."""
    device = device_mod.resolve(device)
    client, keys = client_and_keys(params, seed, device, use_cache)
    server = Server(keys, client.make_public_key())

    def one_case(key: int, plains) -> None:
        enc_key = torus.from_u64(client.encrypt_u128(key), device)
        rks = server.aes_key_expansion(enc_key, pk_rcon=True)
        state = torus.from_u64(
            np.stack([client.encrypt_u128(p) for p in plains]), device)
        ct = server.aes_encrypt(rks, state)
        pt = torus.to_u64(server.aes_decrypt(rks, ct))
        ct = torus.to_u64(ct)
        for i, plain in enumerate(plains):
            want = aes_block(key, plain)
            got_ct = client.decrypt_state_u128(ct[i])
            got_pt = client.decrypt_state_u128(pt[i])
            if got_ct != want:
                raise AssertionError(f"key={key:#x} plain={plain:#x}: FHE ct "
                                     f"{got_ct:#x} != AES {want:#x}")
            if got_pt != plain:
                raise AssertionError(f"key={key:#x}: decrypt round-trip "
                                     f"{got_pt:#x} != {plain:#x}")
            print(f"Passed test case. key={key:032x} plain={plain:032x}")

    one_case(NIST_KEY, NIST_PLAINS)
    rng = np.random.default_rng(seed)
    for _ in range(n_random):
        key = int.from_bytes(rng.bytes(16), "big")
        plain = int.from_bytes(rng.bytes(16), "big")
        one_case(key, [plain])
    print(f"All {len(NIST_PLAINS) + n_random} test cases passed.")


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="tfhe-aes-torch",
        description="Fully homomorphic AES-128 CTR (WoPBS/TFHE), PyTorch "
                    "and CUDA")
    ap.add_argument("--number-of-outputs", type=int,
                    help="number of CTR keystream blocks")
    ap.add_argument("--iv", type=lambda s: int(s, 0),
                    help="u128 initialization vector / counter start")
    ap.add_argument("--key", type=lambda s: int(s, 0), help="u128 AES key")
    ap.add_argument("--test", action="store_true",
                    help="run the test harness (NIST vectors + random "
                         "encrypt/decrypt round-trips) and exit")
    ap.add_argument("--test-random", type=int, default=10,
                    help="number of random cases for --test")
    ap.add_argument("--params", choices=sorted(PARAMS), default="prod",
                    help="prod = PARAM_OPT (the reference's); tpu = "
                         "PARAM_TPU (same security, base-2^12 x 3 BSK "
                         "digits); toy = PARAM_TOY (no security, tests)")
    ap.add_argument("--seed", type=int, default=None,
                    help="client RNG seed (default: OS entropy); also "
                         "keys the key cache")
    ap.add_argument("--no-verify", action="store_true")
    ap.add_argument("--host-verify", action="store_true",
                    help="(default since round 5) decrypt + verify on the "
                         "client: ciphertexts are pulled to host in small "
                         "chunks and the secret key never touches the "
                         "accelerator")
    ap.add_argument("--decrypt", action="store_true",
                    help="also run the homomorphic decryption round-trip")
    ap.add_argument("--no-cache", action="store_true",
                    help="do not load or save evaluation keys")
    ap.add_argument("--pk-rcon", action="store_true",
                    help="public-key-encrypt RCON on the server, as the "
                         "reference does (the 3-WoPBS key schedule) "
                         "instead of trivial noise-free encodings")
    ap.add_argument("--noise-asserts", action="store_true",
                    help="measure the phase error of every WoPBS input and "
                         "output against the noise model and fail on a "
                         "violation (needs the secret key: debug only)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the server runs: cuda needs a card and "
                         "fails without one; cpu runs the plain torch "
                         "versions")
    return ap


def main(argv=None) -> int:
    ap = _parser()
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("tfhe-aes-torch: --device cuda, but no CUDA device is "
              "available (use --device cpu to run on the CPU)",
              file=sys.stderr)
        return 2
    device = torch.device(args.device)
    params = PARAMS[args.params]
    if args.test:
        run_test_harness(params, args.test_random, seed=args.seed,
                         device=device, use_cache=not args.no_cache)
        return 0
    if None in (args.number_of_outputs, args.iv, args.key):
        ap.error("--number-of-outputs, --iv and --key are required "
                 "(or pass --test)")
    print(f"[client] parameters: {params.name}  (n={params.lwe_dimension}, "
          f"k={params.glwe_dimension}, N={params.polynomial_size}) on "
          f"{device}")
    client, dkeys = client_and_keys(params, args.seed, device,
                                    not args.no_cache)
    if args.noise_asserts:
        noise_asserts.enable(client.sk)
    try:
        _run(args, client, dkeys, device)
        if args.noise_asserts:
            n_checks = len(noise_asserts.checks())
            noise_asserts.assert_clean()
            print(f"[client] noise asserts: {n_checks} checkpoints, all "
                  f"within modelled sigma")
    finally:
        noise_asserts.disable()
    return 0


def _run(args, client, dkeys, device) -> None:
    enc_key = torus.from_u64(client.encrypt_u128(args.key), device)
    enc_iv = torus.from_u64(client.encrypt_u128(args.iv), device)
    server = Server(dkeys, client.make_public_key() if args.pk_rcon else None)

    t0 = time.perf_counter()
    round_keys = profiling.device_fence(
        server.aes_key_expansion(enc_key, pk_rcon=args.pk_rcon))
    print(f"[server] AES key expansion took: "
          f"{time.perf_counter() - t0:.2f}s")

    n = args.number_of_outputs
    t0 = time.perf_counter()
    ks = profiling.device_fence(server.ctr_keystream(round_keys, enc_iv, n))
    t_ctr = time.perf_counter() - t0
    pbs = n * profiling.count_pbs_per_block(client.params)
    print(f"[server] AES of #{n} outputs computed in: {t_ctr:.2f}s "
          f"({n / t_ctr * 60:.2f} blocks/min, {pbs / t_ctr:.0f} PBS/s)")

    if not args.no_verify:
        got = client.fetch_and_verify_ctr(ks, args.key, args.iv)
        print(f"[client] verified {n} blocks bit-exact vs plaintext AES")
        print(f"[client] first block: {got[0]:#034x}")

    if args.decrypt:
        t0 = time.perf_counter()
        back = profiling.device_fence(server.aes_decrypt(round_keys, ks[:1]))
        print(f"[server] homomorphic decrypt (1 block) took "
              f"{time.perf_counter() - t0:.2f}s")
        got = client.decrypt_state_u128(torus.to_u64(back)[0])
        if got != args.iv % (1 << 128):
            raise AssertionError(f"decrypt round-trip {got:#x} != "
                                 f"{args.iv:#x}")
        print("[client] homomorphic decryption round-trip verified")


if __name__ == "__main__":
    sys.exit(main())
