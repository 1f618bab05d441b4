"""FHE AES-128 (CTR) on the batched WoPBS layer (torch).

Counterpart of the main path of tfhe_aes_tpu/models/fhe_aes.py: the state
is [B, 16, 8, big+1] u64 words (B CTR blocks, 16 bytes column-major, 8
one-bit blocks per byte LSB first).  XOR is word addition; all
nonlinearity runs through many-LUT WoPBS with the GF(2^8) multiples fused
into the S-box LUTs.  Rounds and ripple-carry steps are Python loops; each
WoPBS goes through wopbs.many_wopbs_jit, as the JAX circuits' go through
their jitted WoPBS: on a card, the replay of a graph captured once per key
set and shape (ops/graphs.py).  The LUT stacks, RCON encodings and gather
indices are tensors made once a device (utils/device.constant), so no
call copies a constant to the card.

The JAX package also compiles five whole functions (add_scalar_device_jit,
ctr_step_jit, aes_encrypt_jit, aes_decrypt_jit, aes_key_expansion_jit);
their counterparts here graph the whole function once per key set and
shape, every WoPBS inside it inline, and the server, ctr_keystream and
add_scalar dispatch through them as the JAX callers do; so does the mesh
(parallel/mesh.sharded_ctr_fn, ctr_step_jit with its bytes split over a
process group).
"""

from __future__ import annotations

import collections
import dataclasses
import functools
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from . import aes_plain, luts, tables
from ..ops import graphs, wopbs
from ..ops.keys import DeviceKeys
from ..utils import device as device_mod
from ..utils import noise_asserts, profiling, torus

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


def _on(like: torch.Tensor, make, params, *args) -> torch.Tensor:
    """The host table make(params, *args) (u64 words) on like's device,
    made once there."""
    return device_mod.constant(
        ("fhe_aes table", make, params) + args, like.device,
        lambda dev: torus.from_u64(make(params, *args), dev))


def _index(like: torch.Tensor, idx: tuple) -> torch.Tensor:
    """A gather index on like's device, made once there."""
    return device_mod.constant(("fhe_aes index", idx), like.device,
                               lambda dev: torch.tensor(idx, device=dev))


def add_round_key(state, rk):
    """XOR = componentwise u64 LWE addition."""
    return state + rk


def shift_rows(state):
    return state[:, _index(state, SHIFT)]


def inv_shift_rows(state):
    return state[:, _index(state, INV_SHIFT)]


def _byte_wopbs(keys: DeviceKeys, state, lut, byte_group=None):
    """Apply a LUT stack to every byte: [B,16,8,big+1] -> [B,16,L,big+1].

    byte_group: a process group over whose ranks the byte axis is split:
    each rank runs the WoPBS of its contiguous 16/n bytes, and the outputs
    are all-gathered back into the whole byte axis, a device op into one
    tensor (a graph holds it over NCCL).
    """
    if byte_group is not None:
        n, r = dist.get_world_size(byte_group), dist.get_rank(byte_group)
        w = state.shape[1] // n
        if keys.shard is not None:      # the ranks' batches now differ
            keys = keys.split_batch_keys
        mine = _byte_wopbs(keys, state[:, r * w:(r + 1) * w], lut)
        # Byte-major, so that the ranks' parts lie one after another.
        mine = mine.movedim(1, 0).contiguous()          # [w, B, L, big+1]
        whole = mine.new_empty((n * w,) + tuple(mine.shape[1:]))
        dist.all_gather_into_tensor(whole, mine, group=byte_group)
        return whole.movedim(0, 1)
    B, nb = state.shape[:2]
    out = wopbs.many_wopbs_jit(
        keys, state.reshape((B * nb,) + state.shape[2:]), lut)
    return out.reshape((B, nb) + out.shape[1:])


def _mix(mul_state, var_table):
    """mul_state [B,16,V,8,big+1] -> state [B,16,8,big+1] via 4-term sums."""
    byte_idx, var_idx = (
        _index(mul_state, tuple(map(tuple, t.tolist())))
        for t in _mix_indices(var_table))
    gathered = mul_state[:, byte_idx, var_idx]
    return gathered.sum(dim=2)


def aes_encrypt(keys: DeviceKeys, round_keys, state, *, byte_group=None):
    """Batched AES-128 encryption.  round_keys [11, 16, 8, big+1]; state
    [B, 16, 8, big+1].  byte_group: split each round's WoPBS over the byte
    axis (see _byte_wopbs); every rank of the group gets the whole state
    back before ShiftRows and MixColumns."""
    p = keys.params
    fwd_l = _on(state, _fwd_luts, p)
    state = add_round_key(state, round_keys[0])
    for rnd in range(1, 10):
        mul = _byte_wopbs(keys, state, fwd_l, byte_group)  # [B,16,24,big+1]
        mul = mul.reshape(mul.shape[:2] + (3, 8) + mul.shape[3:])
        state = add_round_key(_mix(shift_rows(mul), _MC_VAR), round_keys[rnd])
    out = _byte_wopbs(keys, state, _on(state, _sbox_lut, p, False),
                      byte_group)
    return add_round_key(shift_rows(out), round_keys[10])


def aes_decrypt(keys: DeviceKeys, round_keys, state):
    """Batched AES-128 decryption: 9 rounds of InvSubBytes (one WoPBS,
    L = 8), AddRoundKey, then the mul9/11/13/14 multiples (a second WoPBS,
    L = 32) summed into InvMixColumns; the round key sits between the two
    nonlinear passes, so a round costs two WoPBS where encryption's costs
    one."""
    p = keys.params
    inv_sbox_l = _on(state, _sbox_lut, p, True)
    inv_mul_l = _on(state, _inv_mul_luts, p)
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
    selects the 3-WoPBS round, ``rcon_fresh`` overrides that choice.  A
    round a row of rcon_cts, as the JAX schedule scans over them.

    Trivial RCON, one WoPBS per round: n0 = w0 + sub (level 2), n1 = w1 +
    n0 (3), n2 = w2 + n1 (4), n3 = w3 + n2 (5 = the budget); one 16-byte
    WoPBS with the {identity, SBOX} stack refreshes all four words and
    yields the next round's SubWord from n3's bytes.  Fresh RCON would put
    n3 at 6, so n0..n2 (3, 4, 5) are refreshed first and n3 = w3 + n2'
    (2) by a third WoPBS, after the SubWord's own.

    The trivial schedule gives the words of aes_key_expansion_staged,
    whose prologue WoPBS runs on all 16 bytes to share the rounds' shape;
    this one's takes just the 4 RotWord bytes.  With pk-RCON the three
    WoPBS of a round take 4, 12 and 4 bytes: three shapes, two graphs
    (the 4-byte S-box and identity stacks are one shape), replayed over
    the 10 rounds.
    """
    p = keys.params
    if rcon_fresh is None:
        rcon_fresh = rcon_cts is not None
    if rcon_cts is None:
        rcon_cts = _on(enc_key, trivial_rcon, p)
    profiling.mark(enc_key, open=("key_expansion",))
    sbox_l = _on(enc_key, _sbox_lut, p, False)
    rot_word = _index(enc_key, (1, 2, 3, 0))
    rk = enc_key
    rks = [enc_key]
    if rcon_fresh:
        ident = _on(enc_key, _identity_lut, p)
        for r in range(rcon_cts.shape[0]):
            w = rk.reshape(4, 4, 8, rk.shape[-1])
            temp = wopbs.many_wopbs_jit(keys, w[3][rot_word], sbox_l)
            temp[0] += rcon_cts[r]                       # level 2
            n0 = w[0] + temp                             # 3 (byte 0)
            n1 = w[1] + n0                               # 4
            n2 = w[2] + n1                               # 5 = budget
            fresh = wopbs.many_wopbs_jit(keys, torch.cat([n0, n1, n2]), ident)
            n3 = wopbs.many_wopbs_jit(keys, w[3] + fresh[8:12], ident)
            rk = torch.cat([fresh, n3])
            rks.append(rk)
    else:
        w3 = rk.reshape(4, 4, 8, rk.shape[-1])[3]
        sub = wopbs.many_wopbs_jit(keys, w3[rot_word], sbox_l)
        rks += _expand_rounds(keys, rk, sub, rcon_cts)
    out = torch.stack(rks)
    profiling.mark(out, close=("key_expansion",))
    return out


def _expand_rounds(keys: DeviceKeys, rk, sub, rcon_cts) -> list:
    """The trivial-RCON rounds (a row of rcon_cts each) from round key 0
    and its SubWord: one 16-byte {identity, S-box} WoPBS a round."""
    refresh_sbox_l = _on(rk, _refresh_sbox_lut, keys.params)
    last_word = _index(rk, (13, 14, 15, 12))
    rks = []
    for r in range(rcon_cts.shape[0]):
        with profiling.span("glue"):
            words = _expand_glue(rk, sub, rcon_cts[r])
        out = wopbs.many_wopbs_jit(keys, words, refresh_sbox_l)
        with profiling.span("glue"):
            rk = out[:, :8]
            sub = out[last_word, 8:]
        rks.append(rk)
    return rks


def aes_key_expansion_staged(keys: DeviceKeys, enc_key):
    """Trivial-RCON key expansion as 11 dispatches of ONE WoPBS shape:
    the port of tfhe_aes_tpu/models/fhe_aes.aes_key_expansion_staged, the
    words of aes_key_expansion(rcon_cts=None).

    The prologue SubWord is padded from 4 to 16 bytes, the rounds' shape:
    it runs on the whole input key reordered as [0..11, 13, 14, 15, 12],
    with the rounds' {identity, S-box} stack, and keeps outputs [12:16,
    8:], the S-box of RotWord(w3).  So all 11 WoPBS replay one captured
    graph (ops/graphs.py), at the cost of one 128-bit rotate in place of
    a 32-bit one in the prologue.  The eager work between the replays is
    the host span "glue" (utils/profiling.py), the whole the device span
    "key_expansion".
    """
    p = keys.params
    refresh_sbox_l = _on(enc_key, _refresh_sbox_lut, p)
    order = _index(enc_key, tuple(range(12)) + (13, 14, 15, 12))
    profiling.mark(enc_key, open=("key_expansion",))
    with profiling.span("glue"):
        words = enc_key[order]
    out = wopbs.many_wopbs_jit(keys, words, refresh_sbox_l)
    with profiling.span("glue"):
        sub = out[12:16, 8:]
    rks = [enc_key] + _expand_rounds(keys, enc_key, sub,
                                     _on(enc_key, trivial_rcon, p))
    with profiling.span("glue"):
        out = torch.stack(rks)
    profiling.mark(out, close=("key_expansion",))
    return out


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
    many-LUT WoPBS steps (exact per-byte carry): the 8-bit first step, then
    15 of one 9-bit shape."""
    state = state.clone()
    out = wopbs.many_wopbs_jit(keys, state[:, 15], lut_lsb)
    state[:, 15] = out[:, :8]
    carry = out[:, 8:9]
    for step in range(15):
        idx = 14 - step
        bits9 = torch.cat([state[:, idx], carry], dim=1)
        out = wopbs.many_wopbs_jit(keys, bits9, luts_rest[step])
        state[:, idx] = out[:, :8]
        carry = out[:, 8:9]
    return state


def ctr_step(keys: DeviceKeys, round_keys, enc_iv, lut_lsb, luts_rest,
             byte_group=None):
    """One CTR batch: broadcast IV -> ripple-add counters -> AES, each
    round's bytes split over byte_group (aes_encrypt) when given.  Device
    marks (utils/profiling.py) split the span "ctr_step" into
    "ripple_add" and "aes_rounds"."""
    B = lut_lsb.shape[0]
    state = enc_iv[None].expand((B,) + enc_iv.shape)
    profiling.mark(enc_iv, open=("ctr_step", "ripple_add"))
    state = add_scalar_device(keys, state, lut_lsb, luts_rest)
    profiling.mark(state, close=("ripple_add",), open=("aes_rounds",))
    out = aes_encrypt(keys, round_keys, state, byte_group=byte_group)
    profiling.mark(out, close=("aes_rounds", "ctr_step"))
    return out


# -- the whole-function dispatch units -----------------------------------------
# The WoPBS each unit runs, {(bytes, LUT outputs, bits a byte): count}: the
# shapes whose chunk caps it decides before its capture.

def _ripple_wopbs(lut_lsb, luts_rest) -> collections.Counter:
    """The ripple add's: the 8-bit first step, then one 9-bit step a
    carried byte (the LUTs' leading axes: blocks, steps)."""
    B = lut_lsb.shape[0]
    return collections.Counter({(B, lut_lsb.shape[1], 8): 1,
                                (B, luts_rest.shape[2], 9):
                                luts_rest.shape[0]})


def _encrypt_wopbs(n_blocks: int, byte_group=None) -> collections.Counter:
    """AES encryption's: 9 rounds of the fused {S-box, x2, x3} stack (L =
    24), the final round's S-box (L = 8), each over 16 bytes a block, or
    this rank's 16 / n of them when byte_group's n ranks split them."""
    n_bytes = 16 * n_blocks
    if byte_group is not None:
        n_bytes //= dist.get_world_size(byte_group)
    return collections.Counter({(n_bytes, 24, 8): 9, (n_bytes, 8, 8): 1})


def _decrypt_wopbs(n_blocks: int) -> collections.Counter:
    """AES decryption's: 10 inverse S-boxes (L = 8), 9 InvMixColumns
    multiple stacks (L = 32)."""
    return collections.Counter({(16 * n_blocks, 8, 8): 10,
                                (16 * n_blocks, 32, 8): 9})


def _key_expansion_wopbs(rcon_cts, rcon_fresh: bool) -> collections.Counter:
    """The key schedule's, a round a row of rcon_cts: pk-RCON, a 4-byte
    S-box, a 12-byte and a 4-byte refresh a round; trivial RCON, the
    4-byte SubWord, then one 16-byte {identity, S-box} WoPBS a round."""
    rounds = rcon_cts.shape[0]
    if rcon_fresh:
        return collections.Counter({(4, 8, 8): 2 * rounds,
                                    (12, 8, 8): rounds})
    return collections.Counter({(4, 8, 8): 1, (16, 16, 8): rounds})


@dataclasses.dataclass(frozen=True)
class _Unit:
    """A whole function as a compiled dispatch unit (ops/graphs.py).

    fn(keys, *args): the function, args its tensors then its static
    arguments.  wopbs(*args): the WoPBS it runs (the Counters above).
    first(*args): the arguments of its warm-up call, the first block of
    every batch-leading tensor (the key schedule's: its first round).
    name: the unit's, for its counts (utils/profiling)."""
    name: str
    fn: Callable
    wopbs: Callable
    first: Callable

    def __call__(self, keys: DeviceKeys, *args):
        """fn under the WoPBS caps decided for it (args end with them)."""
        *args, caps = args
        with wopbs.decided_caps(caps):
            return self.fn(keys, *args)

    def warm(self, keys: DeviceKeys, *args):
        """The eager call before a capture, outside the graphs' pool: it
        builds the kernel libraries and tiles, cuBLAS's handles and every
        _on / _index constant (made once a device: the first making
        synchronises the stream, which a capture may not)."""
        args = self.first(*args[:-1])
        return self(keys, *args, wopbs.decide_caps(keys, self.wopbs(*args)))

    def dispatch(self, keys: DeviceKeys, tensors: tuple, static=(),
                 groups=()):
        """fn(keys, *tensors, *static), graphed (graphs.GRAPHS): its WoPBS
        caps decided first (on sharded keys, agreed over the shard's
        group) and part of the graph's key.  groups: the process groups
        of fn's own collectives.  Eager (each WoPBS through
        many_wopbs_jit) where a collective runs over a group a capture
        cannot hold (the keys' shard's or one of groups: gloo, see
        graphs.capturable), and while utils/noise_asserts is armed, whose
        checks read each WoPBS's input and output on the host."""
        capturable = wopbs.graphable(keys) and all(map(graphs.capturable,
                                                       groups))
        if not capturable or noise_asserts.enabled():
            return self.fn(keys, *tensors, *static)
        caps = wopbs.decide_caps(keys, self.wopbs(*tensors, *static))
        return graphs.GRAPHS(self, keys, tensors, static + (caps,),
                             warm=self.warm, name=self.name)


def _key_expansion(keys: DeviceKeys, enc_key, rcon_cts, rcon_fresh: bool):
    return aes_key_expansion(keys, enc_key, rcon_cts, rcon_fresh=rcon_fresh)


_ADD_SCALAR = _Unit(
    "add_scalar", add_scalar_device,
    lambda state, lut_lsb, luts_rest: _ripple_wopbs(lut_lsb, luts_rest),
    lambda state, lut_lsb, luts_rest: (state[:1], lut_lsb[:1],
                                       luts_rest[:, :1]))
_CTR_STEP = _Unit(
    "ctr_step", ctr_step,
    lambda rks, iv, lut_lsb, luts_rest, *group: (
        _ripple_wopbs(lut_lsb, luts_rest)
        + _encrypt_wopbs(lut_lsb.shape[0], *group)),
    lambda rks, iv, lut_lsb, luts_rest, *group: (rks, iv, lut_lsb[:1],
                                                 luts_rest[:, :1], *group))
_ENCRYPT = _Unit("encrypt", aes_encrypt,
                 lambda rks, state: _encrypt_wopbs(state.shape[0]),
                 lambda rks, state: (rks, state[:1]))
_DECRYPT = _Unit("decrypt", aes_decrypt,
                 lambda rks, state: _decrypt_wopbs(state.shape[0]),
                 lambda rks, state: (rks, state[:1]))
_KEY_EXPANSION = _Unit(
    "key_expansion", _key_expansion,
    lambda enc_key, rcon_cts, rcon_fresh: _key_expansion_wopbs(rcon_cts,
                                                               rcon_fresh),
    lambda enc_key, rcon_cts, rcon_fresh: (enc_key, rcon_cts[:1],
                                           rcon_fresh))


def add_scalar_device_jit(keys: DeviceKeys, state, lut_lsb, luts_rest):
    """add_scalar_device as a compiled dispatch unit: the counterpart of
    tfhe_aes_tpu/models/fhe_aes.add_scalar_device_jit.  Warms up on the
    first block."""
    return _ADD_SCALAR.dispatch(keys, (state, lut_lsb, luts_rest))


def ctr_step_jit(keys: DeviceKeys, round_keys, enc_iv, lut_lsb, luts_rest,
                 *, byte_group=None):
    """ctr_step as a compiled dispatch unit (tfhe_aes_tpu's ctr_step_jit):
    its 16 ripple WoPBS and 10 AES rounds one graph a key set and batch.
    Warms up on the first block.

    byte_group: each AES round's bytes split over the group's ranks
    (ctr_step(byte_group=)), a static argument, its all-gathers in the
    graph: the unit of parallel/mesh.sharded_ctr_fn, the counterpart of
    the JAX mesh's jitted CTR function.  Every rank of the group (and of
    the keys' shard's group) must make the same calls: the caps are
    agreed, and the warm-up call runs each collective once, in step."""
    static = () if byte_group is None else (byte_group,)
    return _CTR_STEP.dispatch(keys, (round_keys, enc_iv, lut_lsb, luts_rest),
                              static, groups=static)


def aes_encrypt_jit(keys: DeviceKeys, round_keys, state):
    """aes_encrypt as a compiled dispatch unit (tfhe_aes_tpu's
    aes_encrypt_jit).  Warms up on the first block."""
    return _ENCRYPT.dispatch(keys, (round_keys, state))


def aes_decrypt_jit(keys: DeviceKeys, round_keys, state):
    """aes_decrypt as a compiled dispatch unit (tfhe_aes_tpu's
    aes_decrypt_jit).  Warms up on the first block."""
    return _DECRYPT.dispatch(keys, (round_keys, state))


def aes_key_expansion_jit(keys: DeviceKeys, enc_key, rcon_cts=None, *,
                          rcon_fresh: bool | None = None):
    """aes_key_expansion as a compiled dispatch unit (tfhe_aes_tpu's
    aes_key_expansion_jit, rcon_fresh static): one graph a key set and
    schedule.  rcon_cts None takes the trivial encodings (made before the
    capture).  Its warm-up call is the schedule's first round (the first
    row of rcon_cts): every op of the other nine, at a tenth of the
    cost."""
    if rcon_fresh is None:
        rcon_fresh = rcon_cts is not None
    if rcon_cts is None:
        rcon_cts = _on(enc_key, trivial_rcon, keys.params)
    return _KEY_EXPANSION.dispatch(keys, (enc_key, rcon_cts), (rcon_fresh,))


def add_scalar(keys: DeviceKeys, state, i_bytes: np.ndarray):
    """Build the LUTs on the host, run the ripple add on state's device
    (add_scalar_device_jit)."""
    lut_lsb, luts_rest = add_scalar_luts(keys.params, i_bytes)
    return add_scalar_device_jit(keys, state,
                                 torus.from_u64(lut_lsb, state.device),
                                 torus.from_u64(luts_rest, state.device))


def ctr_keystream(keys: DeviceKeys, round_keys, enc_iv, n_blocks: int,
                  offset: int = 0, *, block_chunk: int | None = None):
    """FHE keystream blocks AES(key, iv + offset + t), t < n_blocks.

    block_chunk=None: one batch, ctr_step_jit (the WoPBS tails chunk
    themselves by device memory).  An integer gives the JAX package's
    chunked path (tfhe_aes_tpu/models/fhe_aes.ctr_keystream): up to
    block_chunk blocks as one batch; above, the ripple add once at the
    full batch (add_scalar_device_jit), then AES (aes_encrypt_jit) in
    balanced chunks of at most block_chunk blocks, the ragged last one
    wrap-padded with the first blocks, so every chunk replays one graph.
    Both give the same words.  The LUTs are built on the host, outside
    every unit (the host spans "luts" and "lut_upload")."""
    with profiling.span("luts"):
        lut_lsb, luts_rest = add_scalar_luts(keys.params,
                                             counter_bytes(n_blocks, offset))
    with profiling.span("lut_upload"):
        lut_lsb, luts_rest = (torus.from_u64(t, enc_iv.device)
                              for t in (lut_lsb, luts_rest))
    if block_chunk is None or n_blocks <= block_chunk:
        return ctr_step_jit(keys, round_keys, enc_iv, lut_lsb, luts_rest)
    state = enc_iv[None].expand((n_blocks,) + enc_iv.shape)
    state = add_scalar_device_jit(keys, state, lut_lsb, luts_rest)
    bc = wopbs._chunk_size(n_blocks, block_chunk)
    outs = []
    for lo in range(0, n_blocks, bc):
        sl = state[lo:lo + bc]
        pad = bc - sl.shape[0]
        if pad:
            sl = torch.cat([sl, state[:pad]])
        outs.append(aes_encrypt_jit(keys, round_keys, sl)[:bc - pad])
    return torch.cat(outs)


def counter_bytes(n_blocks: int, offset: int = 0) -> np.ndarray:
    """[B, 16] MSB-first byte decomposition of offsets offset..offset+B-1."""
    return np.stack([
        np.array(aes_plain.u128_to_bytes_be((offset + t) % (1 << 128)),
                 dtype=np.uint64)
        for t in range(n_blocks)])
