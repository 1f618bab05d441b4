"""Many-LUT WoPBS: extract bits -> circuit bootstrap -> vertical packing.

Counterpart of tfhe_aes_tpu/ops/wopbs.py.  The circuit-bootstrap blind
rotates run at the full bit batch; the packing-keyswitch / NTT-staging /
vertical-packing tail runs over balanced byte chunks in a Python loop,
capped by the memory the device can give.  ``many_wopbs`` runs it eagerly;
``many_wopbs_jit``, the counterpart of the JAX package's jitted entry
point, replays a CUDA graph captured once per key set and shape
(ops/graphs.py), or runs inline inside a whole-function unit's.
"""

from __future__ import annotations

import contextlib
import threading

import torch

from ..utils import noise_asserts, profiling
from . import cbs as cbs_mod
from . import graphs, keyswitch, vertical_packing
from .keys import ContractionShard, DeviceKeys


def extract_bits(keys: DeviceKeys, byte_bits_big: torch.Tensor) -> torch.Tensor:
    """[..., nbits, big+1] -> [..., nbits, n+1] small-LWE bits (one
    keyswitch per bit with 1-bit radix blocks)."""
    return keyswitch.keyswitch(keys.params, keys.ksk_limbs, byte_bits_big,
                               keys.shard)


def circuit_bootstrap_bits(keys: DeviceKeys,
                           bits_small: torch.Tensor) -> torch.Tensor:
    """[B, nbits, n+1] -> GGSW NTT stack [nbits, P, B, R2, k+1, N]."""
    B, nbits = bits_small.shape[0], bits_small.shape[1]
    g = cbs_mod.circuit_bootstrap(keys, bits_small.reshape(B * nbits, -1))
    return g.reshape((g.shape[0], B, nbits) + g.shape[2:]).movedim(2, 0)


def _stage_and_pack(keys: DeviceKeys, bigs: torch.Tensor, nbytes: int,
                    nbits: int, lut_polys: torch.Tensor) -> torch.Tensor:
    """CBS tail + VP for one byte chunk: bigs [lev, nbytes*nbits, big+1]."""
    g = cbs_mod.cbs_stage_ggsw(keys, bigs)       # [P, nbytes*nbits, ...]
    g = g.reshape((g.shape[0], nbytes, nbits) + g.shape[2:])
    ggsw = g.movedim(2, 0).contiguous()           # [nbits, P, nbytes, ...]
    profiling.mark(ggsw, close=("staging",), open=("vp",))
    return vertical_packing.vertical_packing(keys, ggsw, lut_polys)


def chunk_bytes(keys: DeviceKeys, n_bytes: int, n_luts: int,
                nbits: int) -> int:
    """Bytes per WoPBS tail chunk: everything on the CPU; on a card, as
    many as fit a third of what it can give this process by a per-byte
    working-set bound.  That is its free memory and the allocator's free
    blocks (its cache, and the graph pools' intermediates, which a replay
    holds only while it runs): what the live tensors leave, whatever
    earlier runs left cached, so a graph's cap is the eager call's.  A
    third, as half of the free memory was while the cache held a WoPBS's
    intermediates: the graphs' pool and the eager work between WoPBS each
    keep their own cache."""
    if keys.device.type != "cuda":
        return n_bytes
    p = keys.params
    kp1, n = p.glwe_dimension + 1, p.polynomial_size
    ggsw_words = nbits * p.cbs_level * kp1 * kp1 * n
    # A word of the VP accumulators holds 8 bytes in each of three live
    # copies (the LUT accumulator, the kernel's clone, the result), ~3
    # bytes of digit limbs and 2 bytes a prime of X: counted twice over.
    vp_bytes = n_luts * kp1 * n * 2 * (24 + 4 + 2 * keys.plan.n_primes)
    per_byte = 160 * ggsw_words + vp_bytes             # bytes, generous
    free, _ = torch.cuda.mem_get_info(keys.device)
    free += (torch.cuda.memory_reserved(keys.device)
             - torch.cuda.memory_allocated(keys.device))
    return max(1, min(n_bytes, free // 3 // per_byte))


def graphable(keys: DeviceKeys) -> bool:
    """Whether a graph can hold a WoPBS on these keys: keys without a
    contraction shard, or with one whose group's collectives a capture
    can hold (graphs.capturable: NCCL)."""
    shard = keys.shard
    return shard is None or (isinstance(shard, ContractionShard)
                             and graphs.capturable(shard.group))


def _agreed(keys: DeviceKeys, cap: int) -> int:
    """cap, or on keys with a contraction shard the least of its ranks'
    caps: every chunk's products are summed over the shard's group, so
    its ranks must cut the same chunks.  A collective read on the host:
    never inside a capture."""
    if keys.shard is None:
        return cap
    return keys.shard.agree_min(cap, keys.device)


def _cap_key(keys: DeviceKeys, shape: tuple, vp_chunk: int | None) -> tuple:
    """The memo key of a WoPBS shape's chunk cap: shape is (bytes, LUT
    outputs, bits a byte)."""
    return ("wopbs chunk cap",) + tuple(shape) + (vp_chunk, keys.device)


def decide_caps(keys: DeviceKeys, shapes) -> tuple:
    """The chunk cap of each WoPBS shape (bytes, LUT outputs, bits a byte)
    of a whole-function unit, decided before its capture: ((shape, cap),
    ...) sorted, a static argument of the unit's graph.  Each is decided
    once per key set and shape, shared with many_wopbs_jit.  On keys with
    a contraction shard each is agreed over the shard's group (_agreed):
    its ranks decide the same shapes in the same order, so they take
    these collectives in step, and each then cuts the same chunks in
    every replay.

    On a card an undecided cap is read after emptying the allocator's
    cache: a capture allocates from the graphs' pool, which cannot take
    the default pool's cached blocks that chunk_bytes counts as free."""
    emptied = False

    def make(shape):
        nonlocal emptied
        if keys.device.type == "cuda" and not emptied:
            torch.cuda.empty_cache()
            emptied = True
        return _agreed(keys, chunk_bytes(keys, *shape))
    return tuple(
        (shape, graphs.GRAPHS.memo(keys, _cap_key(keys, shape, None),
                                   lambda shape=shape: make(shape)))
        for shape in sorted(set(shapes)))


_unit = threading.local()


@contextlib.contextmanager
def decided_caps(caps: tuple):
    """The caps (decide_caps) that many_wopbs_jit takes inside a unit's
    warm-up call and capture, on this thread, while the block runs."""
    was = getattr(_unit, "caps", None)
    _unit.caps = dict(caps)
    try:
        yield
    finally:
        _unit.caps = was


def _decided_cap(shape: tuple) -> int:
    """A WoPBS's cap inside a unit: decided before the capture (nothing in
    a capture reads the free memory)."""
    cap = (getattr(_unit, "caps", None) or {}).get(shape)
    if cap is None:
        raise RuntimeError(f"no chunk cap was decided for a WoPBS of shape "
                           f"{shape} (bytes, LUT outputs, bits) before its "
                           f"unit's capture")
    return cap


def _chunk_size(b: int, target: int) -> int:
    """Balanced chunk size <= target: ceil(b / ceil(b / target)), as
    tfhe_aes_tpu/ops/wopbs._chunk_size (the last chunk may be shorter by
    less than the number of chunks)."""
    if b <= target:
        return b
    nc = -(-b // target)
    return -(-b // nc)


def _check_input(byte_bits_big: torch.Tensor, *_) -> None:
    """The armed noise check of a WoPBS input (the LUT stack, which the
    graph cache also passes, is not checked)."""
    if noise_asserts.enabled():
        noise_asserts.check_big_lwe("wopbs_input", byte_bits_big, "input")


def _check_output(out: torch.Tensor) -> None:
    """The armed noise check of a WoPBS output."""
    if noise_asserts.enabled():
        noise_asserts.check_big_lwe("wopbs_output", out, "fresh")


def _many_wopbs(keys: DeviceKeys, byte_bits_big: torch.Tensor,
                lut_polys: torch.Tensor, cap: int) -> torch.Tensor:
    """many_wopbs under a resolved chunk cap, without the noise checks:
    on the card, every op is a device op (no host copy, no sync), so the
    whole of it can be captured, with the collectives of a contraction
    shard over NCCL.  Device marks split it into its stages (utils/
    profiling.py): extract, cbs_rotate, then staging and vp a chunk."""
    B, nbits = byte_bits_big.shape[0], byte_bits_big.shape[1]
    profiling.count(("wopbs", B, lut_polys.shape[1], nbits))
    profiling.mark(byte_bits_big, open=("wopbs", "extract"))
    small = extract_bits(keys, byte_bits_big)
    profiling.mark(small, close=("extract",), open=("cbs_rotate",))
    bigs = cbs_mod.cbs_pbs_levels(keys, small.reshape(B * nbits, -1))
    lev, np1 = bigs.shape[0], bigs.shape[-1]
    bigs = bigs.reshape(lev, B, nbits, np1)
    bc = _chunk_size(B, cap)
    outs, stage = [], "cbs_rotate"
    for lo in range(0, B, bc):
        hi = min(B, lo + bc)
        luts = lut_polys if lut_polys.shape[0] == 1 else lut_polys[lo:hi]
        profiling.mark(bigs, close=(stage,), open=("staging",))
        outs.append(_stage_and_pack(
            keys, bigs[:, lo:hi].reshape(lev, (hi - lo) * nbits, np1),
            hi - lo, nbits, luts))
        stage = "vp"
    out = torch.cat(outs) if len(outs) > 1 else outs[0]
    profiling.mark(out, close=("vp", "wopbs"))
    return out


def _one_byte(keys: DeviceKeys, byte_bits_big: torch.Tensor,
              lut_polys: torch.Tensor, cap: int) -> torch.Tensor:
    """The first byte of a call, run eagerly before its capture: it builds
    what a capture cannot (the kernel libraries, their tiles, cuBLAS's
    handles) with a byte's memory, not the call's."""
    return _many_wopbs(keys, byte_bits_big[:1], lut_polys[:1], cap)


def many_wopbs(keys: DeviceKeys, byte_bits_big: torch.Tensor,
               lut_polys: torch.Tensor, *,
               vp_chunk: int | None = None) -> torch.Tensor:
    """Evaluate L LUT output polynomials on a batch of radix "bytes".

    byte_bits_big: [B, nbits, big+1] u64 words, LSB first.
    lut_polys:     [B or 1, L, C, N] u64 words.
    Returns [B, L, big+1] fresh big-LWEs of each output bit.
    vp_chunk: the most bytes a tail chunk (default: chunk_bytes); the
    chunks are balanced under it (_chunk_size).  On keys with a
    contraction shard every chunk's products are summed over the shard's
    group, so its ranks first take the least of their caps, and every
    rank cuts the same chunks.
    When utils/noise_asserts is armed, the input and the output are
    checked against the noise model.
    """
    _check_input(byte_bits_big)
    B, nbits = byte_bits_big.shape[0], byte_bits_big.shape[1]
    cap = _agreed(keys, vp_chunk
                  or chunk_bytes(keys, B, lut_polys.shape[1], nbits))
    out = _many_wopbs(keys, byte_bits_big, lut_polys, cap)
    _check_output(out)
    return out


def many_wopbs_jit(keys: DeviceKeys, byte_bits_big: torch.Tensor,
                   lut_polys: torch.Tensor, *,
                   vp_chunk: int | None = None) -> torch.Tensor:
    """many_wopbs as a compiled dispatch unit: the counterpart of
    tfhe_aes_tpu/ops/wopbs.many_wopbs_jit, compiled there once per (key
    shapes, batch, LUT stack) and reused across AES rounds, key-expansion
    words and CTR ripple steps.

    On CUDA tensors the first call of a key set and shape runs its first
    byte eagerly, captures a CUDA graph and replays it; later calls replay
    it (graphs.GRAPHS).  The chunk cap is decided at that first call
    (vp_chunk, else chunk_bytes from the memory the live tensors leave
    then) and is part of the graph's key, as vp_chunk is a static argument
    in JAX: no replay reads the free memory.  The
    same words as many_wopbs; the same noise checks when utils/
    noise_asserts is armed, on the static input before a replay and on
    the output after it, one of each a call, as in the eager run.
    CPU tensors run eagerly.  Keys with a contraction shard are graphed
    when a capture can hold their group's collectives (graphable: NCCL),
    the cap agreed over the group at the first call (_agreed), outside
    the capture; over gloo the WoPBS runs eagerly (many_wopbs), its cap
    agreed each call.
    Inside a whole-function unit's warm-up call or capture
    (graphs.GRAPHS.inside()) it runs _many_wopbs inline under the cap the
    unit decided (decided_caps), without the noise checks: the unit's
    graph holds it.  A unit runs eagerly while the checks are armed.
    """
    if not graphable(keys):
        return many_wopbs(keys, byte_bits_big, lut_polys, vp_chunk=vp_chunk)
    B, nbits = byte_bits_big.shape[0], byte_bits_big.shape[1]
    shape = (B, lut_polys.shape[1], nbits)
    if graphs.GRAPHS.inside():
        return _many_wopbs(keys, byte_bits_big, lut_polys,
                           vp_chunk or _decided_cap(shape))
    cap = graphs.GRAPHS.memo(
        keys, _cap_key(keys, shape, vp_chunk),
        lambda: _agreed(keys, vp_chunk or chunk_bytes(keys, *shape)))
    return graphs.GRAPHS(_many_wopbs, keys, (byte_bits_big, lut_polys),
                         (cap,), warm=_one_byte, before=_check_input,
                         after=_check_output, name="wopbs")
