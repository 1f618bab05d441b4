"""Plain AES-128 (FIPS-197), its inverse cipher and its CTR keystream, in
numpy.

Written from the standard alone: the S-box is the multiplicative inverse
in GF(2^8) followed by the affine map, the state is column-major (byte i
at row i % 4, column i // 4).  Blocks and keys are Python ints read
big-endian, so byte 0 is the most significant.
"""

from __future__ import annotations

import numpy as np

RCON = (0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80, 0x1B, 0x36)


def _xtime(b: int) -> int:
    return ((b << 1) ^ (0x1B if b & 0x80 else 0)) & 0xFF


def _gmul(a: int, b: int) -> int:
    out = 0
    while b:
        if b & 1:
            out ^= a
        a, b = _xtime(a), b >> 1
    return out


def _sbox() -> np.ndarray:
    table = np.zeros(256, np.uint8)
    for x in range(256):
        inv = 0
        if x:
            inv = next(y for y in range(1, 256) if _gmul(x, y) == 1)
        b = inv
        for shift in range(1, 5):
            b ^= ((inv << shift) | (inv >> (8 - shift))) & 0xFF
        table[x] = b ^ 0x63
    return table


SBOX = _sbox()
MUL2 = np.array([_gmul(x, 2) for x in range(256)], np.uint8)
MUL3 = np.array([_gmul(x, 3) for x in range(256)], np.uint8)
INV_SBOX = np.argsort(SBOX).astype(np.uint8)
MUL9, MUL11, MUL13, MUL14 = (np.array([_gmul(x, m) for x in range(256)],
                                      np.uint8) for m in (9, 11, 13, 14))
# ShiftRows: new byte (r, c) is old byte (r, c + r mod 4); InvShiftRows
# undoes it.
SHIFT = np.array([(i % 4) + 4 * ((i // 4 + i % 4) % 4) for i in range(16)])
INV_SHIFT = np.argsort(SHIFT)


def to_bytes(x: int) -> np.ndarray:
    """A 128-bit int as its 16 bytes, most significant first."""
    return np.frombuffer((x % (1 << 128)).to_bytes(16, "big"), np.uint8)


def key_expansion(key: int) -> np.ndarray:
    """The 11 round keys of a 128-bit key: [11, 16] uint8."""
    w = [list(to_bytes(key)[4 * i:4 * i + 4]) for i in range(4)]
    for i in range(4, 44):
        temp = list(w[i - 1])
        if i % 4 == 0:
            temp = [int(SBOX[b]) for b in temp[1:] + temp[:1]]
            temp[0] ^= RCON[i // 4 - 1]
        w.append([a ^ b for a, b in zip(w[i - 4], temp)])
    return np.array(w, np.uint8).reshape(11, 16)


def _mix_columns(st: np.ndarray) -> np.ndarray:
    cols = st.reshape(-1, 4, 4)                 # [n, column, row]
    a0, a1, a2, a3 = (cols[..., r] for r in range(4))
    out = np.stack([MUL2[a0] ^ MUL3[a1] ^ a2 ^ a3,
                    a0 ^ MUL2[a1] ^ MUL3[a2] ^ a3,
                    a0 ^ a1 ^ MUL2[a2] ^ MUL3[a3],
                    MUL3[a0] ^ a1 ^ a2 ^ MUL2[a3]], axis=-1)
    return out.reshape(-1, 16)


def encrypt_blocks(round_keys: np.ndarray, blocks: np.ndarray) -> np.ndarray:
    """AES-128 of blocks [n, 16] uint8 under round_keys [11, 16]."""
    st = blocks ^ round_keys[0]
    for rnd in range(1, 11):
        st = SBOX[st][:, SHIFT]
        if rnd < 10:
            st = _mix_columns(st)
        st = st ^ round_keys[rnd]
    return st


def _inv_mix_columns(st: np.ndarray) -> np.ndarray:
    cols = st.reshape(-1, 4, 4)                 # [n, column, row]
    a0, a1, a2, a3 = (cols[..., r] for r in range(4))
    out = np.stack([MUL14[a0] ^ MUL11[a1] ^ MUL13[a2] ^ MUL9[a3],
                    MUL9[a0] ^ MUL14[a1] ^ MUL11[a2] ^ MUL13[a3],
                    MUL13[a0] ^ MUL9[a1] ^ MUL14[a2] ^ MUL11[a3],
                    MUL11[a0] ^ MUL13[a1] ^ MUL9[a2] ^ MUL14[a3]], axis=-1)
    return out.reshape(-1, 16)


def decrypt_blocks(round_keys: np.ndarray, blocks: np.ndarray) -> np.ndarray:
    """The inverse cipher (FIPS-197 5.3) of blocks [n, 16] uint8 under
    round_keys [11, 16]."""
    st = blocks ^ round_keys[10]
    for rnd in range(9, -1, -1):
        st = INV_SBOX[st[:, INV_SHIFT]] ^ round_keys[rnd]
        if rnd:
            st = _inv_mix_columns(st)
    return st


def ctr_keystream(key: int, iv: int, offset: int, n_blocks: int) -> np.ndarray:
    """AES(key, iv + offset + t mod 2^128) for t < n_blocks: [n, 16]."""
    counters = np.stack([to_bytes(iv + offset + t) for t in range(n_blocks)])
    return encrypt_blocks(key_expansion(key), counters)


def bits_of(byts: np.ndarray) -> np.ndarray:
    """Bytes [...] -> their bits [..., 8], least significant first."""
    return (byts[..., None] >> np.arange(8, dtype=np.uint8)) & 1
