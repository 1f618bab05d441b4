"""LUT-polynomial builders for WoPBS (reference: gen_lut, gen_lut.rs:9-42).

A LUT over an nbits-value with 8 output bits becomes 8 torus polynomials, one
per output bit, each of total length max(2^nbits, N) split into C = 2^max(0,
nbits - log2 N) chunk polynomials (C > 1 engages the vertical-packing CMux
tree).  Entry semantics match the reference: entry idx of output-bit ob is
((f(recompose(idx)) >> ob) & 1) << 63 with idx recomposed LSB-block-first —
for 1-bit blocks that is simply f(idx & (2^nbits_f - 1)).
"""

from __future__ import annotations

import numpy as np

from ..params import ParamSet

U64 = np.uint64


def lut_polys_from_tables(params: ParamSet, tables: np.ndarray,
                          nbits: int, out_bits: int = 8) -> np.ndarray:
    """tables: [T, 2^m] uint (m <= nbits; higher selector bits wrap).

    Returns u64 [1, T*out_bits, C, N]; L index = t*out_bits + ob (ob = output
    bit, LSB first — radix block order).
    """
    n = params.polynomial_size
    size = max(1 << nbits, n)
    C = size // n
    tables = np.asarray(tables)
    T, m_sz = tables.shape
    idx = np.arange(size) % m_sz                       # wrap like gen_lut
    vals = tables[:, idx]                              # [T, size]
    out = np.zeros((1, T * out_bits, C, n), dtype=np.uint64)
    for t in range(T):
        for ob in range(out_bits):
            bits = ((vals[t] >> ob) & 1).astype(np.uint64) << U64(63)
            out[0, t * out_bits + ob] = bits.reshape(C, n)
    return out


def lut_polys_per_batch(params: ParamSet, tables: np.ndarray,
                        nbits: int, out_bits: int = 8) -> np.ndarray:
    """tables: [B, T, 2^m] — per-batch-element LUTs (CTR add_scalar needs
    LUTs that depend on the per-block counter).  Returns [B, T*out_bits, C, N].

    Fully vectorized over B (an earlier per-b Python loop was O(B) host
    time on the CTR hot path — the bench builds these per batch).
    """
    n = params.polynomial_size
    size = max(1 << nbits, n)
    C = size // n
    tables = np.asarray(tables)
    B, T, m_sz = tables.shape
    idx = np.arange(size) % m_sz                       # wrap like gen_lut
    vals = tables[:, :, idx]                           # [B, T, size]
    ob = np.arange(out_bits, dtype=tables.dtype)
    bits = (vals[:, :, None, :] >> ob[None, None, :, None]) & 1
    out = bits.astype(np.uint64) << U64(63)            # [B, T, OB, size]
    return out.reshape(B, T * out_bits, C, n)
