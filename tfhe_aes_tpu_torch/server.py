"""Server (untrusted evaluator) facade over the torch AES circuits.

Counterpart of tfhe_aes_tpu/server.py: holds only what crosses the trust
boundary (evaluation keys already on the device they run on, the LWE
public key, its own randomness) and takes encrypted inputs as int64
tensors of u64 words on that device.  With the public key it encrypts
RCON itself, for the reference-faithful key schedule.  Its circuits
dispatch through the compiled units of models/fhe_aes (aes_encrypt_jit,
aes_decrypt_jit, aes_key_expansion_jit, ctr_step_jit ...), as the JAX
server's do.  Its key schedule and keystream calls are the top-level
host spans of utils/profiling.py: one request each.
"""

from __future__ import annotations

import numpy as np

from .models import fhe_aes, tables
from .ops.keys import DeviceKeys
from .utils import csprng, profiling, torus


class Server:
    def __init__(self, dkeys: DeviceKeys, public_key=None,
                 rng: np.random.Generator | None = None):
        """public_key: client.client.PublicKey, needed only for pk-RCON;
        rng: the server's randomness for it (default: OS entropy)."""
        self.dkeys = dkeys
        self.public_key = public_key
        self.rng = rng if rng is not None else csprng.default_rng(None)

    def encrypt_rcon(self) -> np.ndarray:
        """Public-key-encrypt the 10 RCON bytes: [10, 8, big+1] u64."""
        if self.public_key is None:
            raise ValueError("pk-RCON needs the public key")
        rcon_bits = np.stack([
            np.array([(int(r) >> j) & 1 for j in range(8)], dtype=np.uint64)
            for r in tables.RCON])
        return self.public_key.encrypt_bits(rcon_bits, self.rng)

    def aes_key_expansion(self, enc_key, *, pk_rcon: bool = False):
        """enc_key [16, 8, big+1] -> round keys [11, 16, 8, big+1].

        pk_rcon=False: trivial RCON, one WoPBS per round, through
        fhe_aes.aes_key_expansion_staged (all 11 WoPBS one shape, one
        captured graph), as the JAX server dispatches it.
        pk_rcon=True: RCON encrypted by this server, three per round,
        through fhe_aes.aes_key_expansion_jit (one graph)."""
        with profiling.span("aes_key_expansion"):
            if not pk_rcon:
                return fhe_aes.aes_key_expansion_staged(self.dkeys, enc_key)
            rcon = torus.from_u64(self.encrypt_rcon(), enc_key.device)
            return fhe_aes.aes_key_expansion_jit(self.dkeys, enc_key, rcon)

    def aes_encrypt(self, round_keys, state):
        return fhe_aes.aes_encrypt_jit(self.dkeys, round_keys, state)

    def aes_decrypt(self, round_keys, state):
        return fhe_aes.aes_decrypt_jit(self.dkeys, round_keys, state)

    def add_scalar(self, state, i_bytes: np.ndarray):
        """Homomorphic counter add (exact per-byte carry)."""
        return fhe_aes.add_scalar(self.dkeys, state, i_bytes)

    def ctr_keystream(self, round_keys, enc_iv, n_blocks: int,
                      offset: int = 0, *, block_chunk: int | None = None):
        """FHE keystream AES(key, iv + offset + t), t < n_blocks
        (block_chunk: fhe_aes.ctr_keystream)."""
        with profiling.span("ctr_keystream"):
            return fhe_aes.ctr_keystream(self.dkeys, round_keys, enc_iv,
                                         n_blocks, offset,
                                         block_chunk=block_chunk)
