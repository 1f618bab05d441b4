"""FHE AES-128 (CTR) on the batched WoPBS layer (torch, eager).

Counterpart of the main path of tfhe_aes_tpu/models/fhe_aes.py: the state
is [B, 16, 8, big+1] u64 words (B CTR blocks, 16 bytes column-major, 8
one-bit blocks per byte LSB first).  XOR is word addition; all
nonlinearity runs through many-LUT WoPBS with the GF(2^8) multiples fused
into the S-box LUTs.  Rounds and ripple-carry steps are Python loops.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.distributed as dist

from . import aes_plain, luts, tables
from ..ops import wopbs
from ..ops.keys import DeviceKeys
from ..utils import torus

# Column-major ShiftRows permutation: new[i] = old[SHIFT[i]].
SHIFT = tuple(aes_plain._SHIFT)
INV_SHIFT = tuple(aes_plain._INV_SHIFT)

# MixColumns as (byte index, variant) gathers over the fused-LUT outputs
# [x, mul2(x), mul3(x)]: row r of column c sums variants per [2 3 1 1].
_MC_VAR = np.array([[1, 2, 0, 0],
                    [0, 1, 2, 0],
                    [0, 0, 1, 2],
                    [2, 0, 0, 1]])
# InvMixColumns over the variants [mul9, mul11, mul13, mul14]: rows
# (14 11 13 9; 9 14 11 13; 13 9 14 11; 11 13 9 14).
_IMC_VAR = np.array([[3, 1, 2, 0],
                     [0, 3, 1, 2],
                     [2, 0, 3, 1],
                     [1, 2, 0, 3]])


def _mix_indices(var_table: np.ndarray):
    byte_idx = np.zeros((16, 4), dtype=np.int64)
    var_idx = np.zeros((16, 4), dtype=np.int64)
    for col in range(4):
        for row in range(4):
            o = 4 * col + row
            byte_idx[o] = 4 * col + np.arange(4)
            var_idx[o] = var_table[row]
    return byte_idx, var_idx


@functools.lru_cache(maxsize=None)
def _fwd_luts(params) -> np.ndarray:
    """3 fused LUTs {SBOX, mul2 o SBOX, mul3 o SBOX} -> [1, 24, C, N]."""
    s = tables.sbox()
    return luts.lut_polys_from_tables(
        params, np.stack([s, tables.gf_mul_table(2)[s],
                          tables.gf_mul_table(3)[s]]), 8)


@functools.lru_cache(maxsize=None)
def _inv_mul_luts(params) -> np.ndarray:
    """4 LUTs {mul9, mul11, mul13, mul14} (decrypt path) -> [1, 32, C, N]."""
    return luts.lut_polys_from_tables(
        params, np.stack([tables.gf_mul_table(c) for c in (9, 11, 13, 14)]), 8)


@functools.lru_cache(maxsize=None)
def _sbox_lut(params, inv: bool) -> np.ndarray:
    t = tables.inv_sbox() if inv else tables.sbox()
    return luts.lut_polys_from_tables(params, t[None], 8)


@functools.lru_cache(maxsize=None)
def _identity_lut(params) -> np.ndarray:
    """Noise-refresh LUT of the pk-RCON key expansion."""
    return luts.lut_polys_from_tables(
        params, np.arange(256, dtype=np.uint64)[None], 8)


@functools.lru_cache(maxsize=None)
def _refresh_sbox_lut(params) -> np.ndarray:
    """Fused {identity, SBOX} stack for the 1-WoPBS key-expansion round:
    L 0..7 = refreshed input bits, L 8..15 = SBOX output bits."""
    return luts.lut_polys_from_tables(
        params, np.stack([np.arange(256, dtype=np.uint64), tables.sbox()]), 8)


def _on(lut: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torus.from_u64(lut, device=like.device)


def add_round_key(state, rk):
    """XOR = componentwise u64 LWE addition."""
    return state + rk


def shift_rows(state):
    return state[:, list(SHIFT)]


def inv_shift_rows(state):
    return state[:, list(INV_SHIFT)]


def _byte_wopbs(keys: DeviceKeys, state, lut, byte_group=None):
    """Apply a LUT stack to every byte: [B,16,8,big+1] -> [B,16,L,big+1].

    byte_group: a process group over whose ranks the byte axis is split:
    each rank runs the WoPBS of its contiguous 16/n bytes, and the outputs
    are all-gathered back into the whole byte axis.
    """
    if byte_group is not None:
        n, r = dist.get_world_size(byte_group), dist.get_rank(byte_group)
        w = state.shape[1] // n
        if keys.shard is not None:      # the ranks' batches now differ
            keys = dataclasses.replace(
                keys, shard=dataclasses.replace(keys.shard, split_batch=True))
        mine = _byte_wopbs(keys, state[:, r * w:(r + 1) * w], lut)
        parts = [torch.empty_like(mine) for _ in range(n)]
        dist.all_gather(parts, mine.contiguous(), group=byte_group)
        return torch.cat(parts, dim=1)
    B, nb = state.shape[:2]
    out = wopbs.many_wopbs(keys, state.reshape((B * nb,) + state.shape[2:]),
                           lut)
    return out.reshape((B, nb) + out.shape[1:])


def _mix(mul_state, var_table):
    """mul_state [B,16,V,8,big+1] -> state [B,16,8,big+1] via 4-term sums."""
    byte_idx, var_idx = _mix_indices(var_table)
    dev = mul_state.device
    gathered = mul_state[:, torch.as_tensor(byte_idx, device=dev),
                         torch.as_tensor(var_idx, device=dev)]
    return gathered.sum(dim=2)


def aes_encrypt(keys: DeviceKeys, round_keys, state, *, byte_group=None):
    """Batched AES-128 encryption.  round_keys [11, 16, 8, big+1]; state
    [B, 16, 8, big+1].  byte_group: split each round's WoPBS over the byte
    axis (see _byte_wopbs); every rank of the group gets the whole state
    back before ShiftRows and MixColumns."""
    p = keys.params
    fwd_l = _on(_fwd_luts(p), state)
    state = add_round_key(state, round_keys[0])
    for rnd in range(1, 10):
        mul = _byte_wopbs(keys, state, fwd_l, byte_group)  # [B,16,24,big+1]
        mul = mul.reshape(mul.shape[:2] + (3, 8) + mul.shape[3:])
        state = add_round_key(_mix(shift_rows(mul), _MC_VAR), round_keys[rnd])
    out = _byte_wopbs(keys, state, _on(_sbox_lut(p, False), state),
                      byte_group)
    return add_round_key(shift_rows(out), round_keys[10])


def aes_decrypt(keys: DeviceKeys, round_keys, state):
    """Batched AES-128 decryption: 9 rounds of InvSubBytes (one WoPBS,
    L = 8), AddRoundKey, then the mul9/11/13/14 multiples (a second WoPBS,
    L = 32) summed into InvMixColumns; the round key sits between the two
    nonlinear passes, so a round costs two WoPBS where encryption's costs
    one."""
    p = keys.params
    inv_sbox_l = _on(_sbox_lut(p, True), state)
    inv_mul_l = _on(_inv_mul_luts(p), state)
    state = add_round_key(state, round_keys[10])
    for rnd in range(10, 1, -1):
        st = _byte_wopbs(keys, inv_shift_rows(state), inv_sbox_l)
        st = add_round_key(st, round_keys[rnd - 1])
        mul = _byte_wopbs(keys, st, inv_mul_l)           # [B,16,32,big+1]
        mul = mul.reshape(mul.shape[:2] + (4, 8) + mul.shape[3:])
        state = _mix(mul, _IMC_VAR)
    state = _byte_wopbs(keys, inv_shift_rows(state), inv_sbox_l)
    return add_round_key(state, round_keys[0])


def trivial_rcon(params) -> np.ndarray:
    """RCON bytes as trivial (noiseless) LWE encodings: [10, 8, big+1] u64."""
    out = np.zeros((10, 8, params.big_lwe_dimension + 1), np.uint64)
    for i, r in enumerate(tables.RCON):
        for j in range(8):
            out[i, j, -1] = np.uint64((int(r) >> j) & 1) << np.uint64(63)
    return out


def _expand_glue(prev_rk, sub, rcon):
    """Leveled chain of one trivial-RCON expansion round (n0..n3)."""
    temp = sub.clone()
    temp[0] += rcon
    w = prev_rk.reshape(4, 4, 8, prev_rk.shape[-1])
    n0 = w[0] + temp
    n1 = w[1] + n0
    n2 = w[2] + n1
    n3 = w[3] + n2
    return torch.cat([n0, n1, n2, n3], dim=0)


def aes_key_expansion(keys: DeviceKeys, enc_key, rcon_cts=None, *,
                      rcon_fresh: bool | None = None):
    """enc_key [16, 8, big+1] -> round keys [11, 16, 8, big+1].

    rcon_cts [10, 8, big+1]: None takes the trivial noise-free encodings
    (trivial_rcon); public-key-encrypted RCON (fresh, noise level 1)
    selects the 3-WoPBS round, ``rcon_fresh`` overrides that choice.

    Trivial RCON, one WoPBS per round: n0 = w0 + sub (level 2), n1 = w1 +
    n0 (3), n2 = w2 + n1 (4), n3 = w3 + n2 (5 = the budget); one 16-byte
    WoPBS with the {identity, SBOX} stack refreshes all four words and
    yields the next round's SubWord from n3's bytes.  Fresh RCON would put
    n3 at 6, so n0..n2 (3, 4, 5) are refreshed first and n3 = w3 + n2'
    (2) by a third WoPBS, after the SubWord's own.

    The trivial schedule gives the words of the JAX package's
    aes_key_expansion_staged (which exists there only to compile one
    WoPBS shape); its prologue WoPBS takes just the 4 RotWord bytes.
    """
    p = keys.params
    if rcon_fresh is None:
        rcon_fresh = rcon_cts is not None
    if rcon_cts is None:
        rcon_cts = _on(trivial_rcon(p), enc_key)
    sbox_l = _on(_sbox_lut(p, False), enc_key)
    rk = enc_key
    rks = [enc_key]
    if rcon_fresh:
        ident = _on(_identity_lut(p), enc_key)
        for r in range(10):
            w = rk.reshape(4, 4, 8, rk.shape[-1])
            temp = wopbs.many_wopbs(keys, w[3][[1, 2, 3, 0]], sbox_l)
            temp[0] += rcon_cts[r]                       # level 2
            n0 = w[0] + temp                             # 3 (byte 0)
            n1 = w[1] + n0                               # 4
            n2 = w[2] + n1                               # 5 = budget
            fresh = wopbs.many_wopbs(keys, torch.cat([n0, n1, n2]), ident)
            n3 = wopbs.many_wopbs(keys, w[3] + fresh[8:12], ident)
            rk = torch.cat([fresh, n3])
            rks.append(rk)
    else:
        refresh_sbox_l = _on(_refresh_sbox_lut(p), enc_key)
        w3 = rk.reshape(4, 4, 8, rk.shape[-1])[3]
        sub = wopbs.many_wopbs(keys, w3[[1, 2, 3, 0]], sbox_l)
        for r in range(10):
            out = wopbs.many_wopbs(keys, _expand_glue(rk, sub, rcon_cts[r]),
                                   refresh_sbox_l)
            rk = out[:, :8]
            sub = out[[13, 14, 15, 12], 8:]
            rks.append(rk)
    return torch.stack(rks)


def add_scalar_luts(params, i_bytes: np.ndarray):
    """Host LUTs for the ripple-carry add: per-block {sum, carry} tables.

    i_bytes: [B, 16] MSB-first counter-offset bytes.  Returns
    (lut_lsb [B,9,C8,N], luts_rest [15,B,9,C9,N]) u64.
    """
    x8 = np.arange(256)
    i_lsb = i_bytes[:, 15].astype(np.uint64)
    t_sum = ((x8[None] + i_lsb[:, None]) % 256).astype(np.uint64)
    t_car = ((x8[None] + i_lsb[:, None]) > 255).astype(np.uint64)
    lut_lsb = np.concatenate([
        luts.lut_polys_per_batch(params, t_sum[:, None], 8, out_bits=8),
        luts.lut_polys_per_batch(params, t_car[:, None], 8, out_bits=1)],
        axis=1)
    x9 = np.arange(512)
    rest = []
    for idx in range(14, -1, -1):
        ib = i_bytes[:, idx].astype(np.uint64)
        val = (x9[None] & 0xFF) + (x9[None] >> 8) + ib[:, None]
        t_sum = (val % 256).astype(np.uint64)
        t_car = (val > 255).astype(np.uint64)
        rest.append(np.concatenate([
            luts.lut_polys_per_batch(params, t_sum[:, None], 9, out_bits=8),
            luts.lut_polys_per_batch(params, t_car[:, None], 9, out_bits=1)],
            axis=1))
    return lut_lsb, np.stack(rest)


def add_scalar_device(keys: DeviceKeys, state, lut_lsb, luts_rest):
    """Ripple-carry add: state [B,16,8,big+1] += counters, 16 sequential
    9-bit many-LUT WoPBS steps (exact per-byte carry)."""
    state = state.clone()
    out = wopbs.many_wopbs(keys, state[:, 15], lut_lsb)
    state[:, 15] = out[:, :8]
    carry = out[:, 8:9]
    for step in range(15):
        idx = 14 - step
        bits9 = torch.cat([state[:, idx], carry], dim=1)
        out = wopbs.many_wopbs(keys, bits9, luts_rest[step])
        state[:, idx] = out[:, :8]
        carry = out[:, 8:9]
    return state


def add_scalar(keys: DeviceKeys, state, i_bytes: np.ndarray):
    """Build the LUTs on the host, run the ripple add on state's device."""
    lut_lsb, luts_rest = add_scalar_luts(keys.params, i_bytes)
    return add_scalar_device(keys, state, _on(lut_lsb, state),
                             _on(luts_rest, state))


def ctr_step(keys: DeviceKeys, round_keys, enc_iv, lut_lsb, luts_rest):
    """One CTR batch: broadcast IV -> ripple-add counters -> AES."""
    B = lut_lsb.shape[0]
    state = enc_iv[None].expand((B,) + enc_iv.shape)
    state = add_scalar_device(keys, state, lut_lsb, luts_rest)
    return aes_encrypt(keys, round_keys, state)


def ctr_keystream(keys: DeviceKeys, round_keys, enc_iv, n_blocks: int,
                  offset: int = 0):
    """FHE keystream blocks AES(key, iv + offset + t), t < n_blocks, as one
    batch (the WoPBS tails chunk themselves by device memory)."""
    lut_lsb, luts_rest = add_scalar_luts(keys.params,
                                         counter_bytes(n_blocks, offset))
    return ctr_step(keys, round_keys, enc_iv, _on(lut_lsb, enc_iv),
                    _on(luts_rest, enc_iv))


def counter_bytes(n_blocks: int, offset: int = 0) -> np.ndarray:
    """[B, 16] MSB-first byte decomposition of offsets offset..offset+B-1."""
    return np.stack([
        np.array(aes_plain.u128_to_bytes_be((offset + t) % (1 << 128)),
                 dtype=np.uint64)
        for t in range(n_blocks)])
