"""Server (untrusted evaluator) facade over the torch AES circuits.

Counterpart of tfhe_aes_tpu/server.py: holds only evaluation keys
(already on the device they run on) and takes encrypted inputs as int64
tensors of u64 words on that device.  Key expansion runs the trivial-RCON
schedule.
"""

from __future__ import annotations

import numpy as np

from .models import fhe_aes
from .ops.keys import DeviceKeys


class Server:
    def __init__(self, dkeys: DeviceKeys):
        self.dkeys = dkeys

    def aes_key_expansion(self, enc_key):
        """enc_key [16, 8, big+1] -> round keys [11, 16, 8, big+1]."""
        return fhe_aes.aes_key_expansion_staged(self.dkeys, enc_key)

    def aes_encrypt(self, round_keys, state):
        return fhe_aes.aes_encrypt(self.dkeys, round_keys, state)

    def add_scalar(self, state, i_bytes: np.ndarray):
        """Homomorphic counter add (exact per-byte carry)."""
        return fhe_aes.add_scalar(self.dkeys, state, i_bytes)

    def ctr_keystream(self, round_keys, enc_iv, n_blocks: int,
                      offset: int = 0):
        """FHE keystream AES(key, iv + offset + t), t < n_blocks."""
        return fhe_aes.ctr_keystream(self.dkeys, round_keys, enc_iv,
                                     n_blocks, offset)
