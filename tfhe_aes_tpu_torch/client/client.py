"""Client (trusted party): keygen, bit encryption, decryption, verify.

Counterpart of tfhe_aes_tpu/client/client.py without jax: the same
csprng.default_rng(seed) draws in the same order, so one seed gives the
same secret keys, evaluation keys and ciphertexts in both packages.
Ciphertexts cross to the server as numpy u64 arrays (``utils.torus.
from_u64`` puts them on a device) and come back through ``.cpu()``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..backend import numpy_backend as nb
from ..models import aes_plain
from ..params import PARAM_OPT, ParamSet
from ..ops import keys as keys_mod
from ..utils import csprng, torus
from ..utils import device as device_mod

U64 = np.uint64


@dataclasses.dataclass
class PublicKey:
    """LWE public key: zero-encryptions under the big key.  Encrypting
    with it is a random binary combination of them plus the message, so
    a server can encrypt public constants (RCON) without a secret."""
    zeros: np.ndarray  # [n_pk, big+1] u64

    def encrypt_bits(self, bits: np.ndarray,
                     rng: np.random.Generator) -> np.ndarray:
        """bits [...] in {0,1} -> [..., big+1] u64 at delta 2^63."""
        bits = np.asarray(bits, dtype=np.uint64)
        sel = rng.integers(0, 2, size=bits.shape + (self.zeros.shape[0],),
                           dtype=np.uint64)
        ct = np.einsum("...s,sj->...j", sel, self.zeros,
                       dtype=np.uint64, casting="unsafe").astype(np.uint64)
        ct[..., -1] += bits << U64(63)
        return ct


class Client:
    def __init__(self, params: ParamSet = PARAM_OPT, seed: int | None = None):
        """seed=None: ChaCha20 CSPRNG from OS entropy; an integer seed
        selects numpy PCG64 (reproducible, for tests and benches only)."""
        self.params = params
        self.rng = csprng.default_rng(seed)
        self.sk = nb.gen_secret_keys(params, self.rng)

    def make_device_keys(self, fast: bool = True,
                         device=None) -> keys_mod.DeviceKeys:
        """Evaluation keys in device layout, on `device` (default: the
        card; raises without one unless device="cpu").

        fast=True (the default, as in the JAX package): device keygen
        (client/keygen_fast), the GLWE mask products and the BSK staging on
        `device`, with the draws of the JAX package's default path, so one
        seed gives the same keys in both.  fast=False: host keygen, the
        draws of its fast=False path.
        """
        device = device_mod.resolve(device)
        if fast:
            from . import keygen_fast
            return keygen_fast.make_device_keys_fast(self.sk, self.rng,
                                                     device=device)
        keys = keys_mod.make_device_keys(self.sk, self.rng)
        return keys.to(device)

    def make_public_key(self, n_pk: int | None = None) -> PublicKey:
        p = self.params
        n_pk = n_pk or (p.big_lwe_dimension + 128)
        zeros = nb.lwe_encrypt(self.sk.big_lwe_key,
                               np.zeros(n_pk, dtype=np.uint64),
                               p.glwe_noise_std, self.rng)
        return PublicKey(zeros)

    # -- encryption ----------------------------------------------------------
    def encrypt_byte(self, byte: int) -> np.ndarray:
        """byte -> [8, big+1] u64, bit j (LSB first) at delta 2^63."""
        bits = np.array([(byte >> j) & 1 for j in range(8)], dtype=np.uint64)
        return nb.lwe_encrypt(self.sk.big_lwe_key, bits << U64(63),
                              self.params.glwe_noise_std, self.rng)

    def encrypt_u128(self, x: int) -> np.ndarray:
        """u128 -> [16, 8, big+1] u64, bytes MSB-first."""
        return np.stack([self.encrypt_byte(b)
                         for b in aes_plain.u128_to_bytes_be(x)])

    # -- decryption / verification -------------------------------------------
    def decrypt_bits(self, cts: np.ndarray) -> np.ndarray:
        return nb.lwe_decrypt_bit(self.sk.big_lwe_key, cts)

    def decrypt_byte(self, ct_bits: np.ndarray) -> int:
        bits = self.decrypt_bits(ct_bits)
        return int(sum(int(b) << j for j, b in enumerate(bits)))

    def decrypt_state_u128(self, state: np.ndarray) -> int:
        """state [16, 8, big+1] (bytes MSB-first) -> u128."""
        return aes_plain.bytes_be_to_u128(
            [self.decrypt_byte(state[i]) for i in range(16)])

    def decrypt_and_verify_ctr(self, states: np.ndarray, key: int, iv: int,
                               offset: int = 0) -> list[int]:
        """states [n, 16, 8, big+1] u64; raises unless block i ==
        AES(key, iv + offset + i)."""
        got = [self.decrypt_state_u128(states[i])
               for i in range(states.shape[0])]
        _verify(got, key, iv, offset)
        return got

    def fetch_and_verify_ctr(self, states_dev, key: int, iv: int,
                             offset: int = 0) -> list[int]:
        """Pull device states [n, 16, 8, big+1] to the host and verify
        them there: the secret key never leaves the client."""
        return self.decrypt_and_verify_ctr(torus.to_u64(states_dev), key, iv,
                                           offset)


def _verify(got: list[int], key: int, iv: int, offset: int) -> None:
    want = aes_plain.ctr_keystream(key, iv + offset, len(got))
    for i, (g, w) in enumerate(zip(got, want)):
        if g != w:
            raise AssertionError(
                f"CTR block {i}: FHE {g:#034x} != plain {w:#034x}")
