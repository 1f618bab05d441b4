"""Plaintext AES-128 oracle (numpy) — the framework's correctness anchor.

The reference verifies every FHE keystream block against the Rust `aes` crate
(client.rs:162-171); this module plays that role (validated against FIPS-197
vectors in tests).  Also used to cross-check FHE key expansion and decryption.
"""

from __future__ import annotations

import numpy as np

from . import tables


def _sub_word(w):
    return [int(tables.sbox()[b]) for b in w]


def key_expansion(key_bytes: list[int]) -> list[list[int]]:
    """16 key bytes -> 11 round keys x 16 bytes (FIPS-197 section 5.2)."""
    w = [key_bytes[4 * i:4 * i + 4] for i in range(4)]
    for i in range(4, 44):
        temp = list(w[i - 1])
        if i % 4 == 0:
            temp = temp[1:] + temp[:1]
            temp = _sub_word(temp)
            temp[0] ^= int(tables.RCON[i // 4 - 1])
        w.append([w[i - 4][j] ^ temp[j] for j in range(4)])
    return [sum((w[4 * i + j] for j in range(4)), []) for i in range(11)]


def _xtime_col(col, mult):
    t = tables.gf_mul_table(mult)
    return [int(t[b]) for b in col]


def encrypt_block(key_bytes: list[int], pt_bytes: list[int]) -> list[int]:
    """AES-128 encrypt one 16-byte block (column-major state, like the
    reference's Vec layout, shift_rows.rs:5-21)."""
    s = tables.sbox()
    m2, m3 = tables.gf_mul_table(2), tables.gf_mul_table(3)
    rks = key_expansion(key_bytes)
    st = [pt_bytes[i] ^ rks[0][i] for i in range(16)]
    for rnd in range(1, 10):
        st = [int(s[b]) for b in st]
        st = _shift_rows(st)
        st = _mix_columns(st, m2, m3)
        st = [st[i] ^ rks[rnd][i] for i in range(16)]
    st = [int(s[b]) for b in st]
    st = _shift_rows(st)
    return [st[i] ^ rks[10][i] for i in range(16)]


def decrypt_block(key_bytes: list[int], ct_bytes: list[int]) -> list[int]:
    si = tables.inv_sbox()
    m9, m11 = tables.gf_mul_table(9), tables.gf_mul_table(11)
    m13, m14 = tables.gf_mul_table(13), tables.gf_mul_table(14)
    rks = key_expansion(key_bytes)
    st = [ct_bytes[i] ^ rks[10][i] for i in range(16)]
    for rnd in range(9, 0, -1):
        st = _inv_shift_rows(st)
        st = [int(si[b]) for b in st]
        st = [st[i] ^ rks[rnd][i] for i in range(16)]
        st = _inv_mix_columns(st, m9, m11, m13, m14)
    st = _inv_shift_rows(st)
    st = [int(si[b]) for b in st]
    return [st[i] ^ rks[0][i] for i in range(16)]


# Column-major state: state[4*col + row].
_SHIFT = [0, 5, 10, 15, 4, 9, 14, 3, 8, 13, 2, 7, 12, 1, 6, 11]
_INV_SHIFT = [_SHIFT.index(i) for i in range(16)]


def _shift_rows(st):
    return [st[_SHIFT[i]] for i in range(16)]


def _inv_shift_rows(st):
    return [st[_INV_SHIFT[i]] for i in range(16)]


def _mix_columns(st, m2, m3):
    out = []
    for c in range(4):
        a = st[4 * c:4 * c + 4]
        out += [
            int(m2[a[0]]) ^ int(m3[a[1]]) ^ a[2] ^ a[3],
            a[0] ^ int(m2[a[1]]) ^ int(m3[a[2]]) ^ a[3],
            a[0] ^ a[1] ^ int(m2[a[2]]) ^ int(m3[a[3]]),
            int(m3[a[0]]) ^ a[1] ^ a[2] ^ int(m2[a[3]]),
        ]
    return out


def _inv_mix_columns(st, m9, m11, m13, m14):
    out = []
    for c in range(4):
        a = st[4 * c:4 * c + 4]
        out += [
            int(m14[a[0]]) ^ int(m11[a[1]]) ^ int(m13[a[2]]) ^ int(m9[a[3]]),
            int(m9[a[0]]) ^ int(m14[a[1]]) ^ int(m11[a[2]]) ^ int(m13[a[3]]),
            int(m13[a[0]]) ^ int(m9[a[1]]) ^ int(m14[a[2]]) ^ int(m11[a[3]]),
            int(m11[a[0]]) ^ int(m13[a[1]]) ^ int(m9[a[2]]) ^ int(m14[a[3]]),
        ]
    return out


def u128_to_bytes_be(x: int) -> list[int]:
    return [(x >> (8 * (15 - i))) & 0xFF for i in range(16)]


def bytes_be_to_u128(bs) -> int:
    out = 0
    for i, b in enumerate(bs):
        out |= int(b) << (8 * (15 - i))
    return out


def ctr_keystream(key_u128: int, iv_u128: int, n_blocks: int) -> list[int]:
    """Keystream block i = AES(key, iv + i), as u128 list (reference CTR,
    main.rs:55-64 / client_decrypt_and_verify)."""
    kb = u128_to_bytes_be(key_u128)
    out = []
    for i in range(n_blocks):
        msg = (iv_u128 + i) % (1 << 128)
        out.append(bytes_be_to_u128(encrypt_block(kb, u128_to_bytes_be(msg))))
    return out
