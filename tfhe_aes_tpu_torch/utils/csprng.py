"""ChaCha20-based CSPRNG for key, mask and noise sampling.

The reference pulls cryptographic randomness from the tfhe-csprng crate
(Cargo.lock; SURVEY.md 2b).  Here the generator is ChaCha20 (RFC 8439)
keystream in counter mode: the native multithreaded implementation lives in
runtime/native.cpp (chacha20_fill_u64), with a vectorized numpy fallback of
the SAME algorithm below — both validated against the RFC 8439 2.3.2 test
vector (tests/test_csprng.py), so the fallback is equally cryptographic,
just slower.

``Csprng`` exposes the subset of the numpy Generator API the framework's
sampling code uses (integers / normal / bytes / random), so it drops into
every ``rng:`` parameter.  Client(seed=None) routes all randomness through
it, seeded from OS entropy; an integer seed selects numpy PCG64 instead —
reproducible but NOT cryptographically secure, for tests and benches only
(client/client.py).
"""

from __future__ import annotations

import os
import secrets

import numpy as np


def _chacha20_blocks_numpy(key_words: np.ndarray, nonce_words: np.ndarray,
                           counter0: int, n_blocks: int) -> np.ndarray:
    """Pure-numpy ChaCha20: n_blocks keystream blocks -> [n_blocks*8] u64.

    Vectorized over the block axis; bit-exact vs the native path (the RFC
    keystream is fully determined by key/nonce/counter).
    """
    u32 = np.uint32

    def rotl(x, k):
        return (x << u32(k)) | (x >> u32(32 - k))

    state = np.empty((16, n_blocks), dtype=np.uint32)
    state[0:4, :] = np.array([0x61707865, 0x3320646e, 0x79622d32,
                              0x6b206574], dtype=np.uint32)[:, None]
    state[4:12, :] = key_words.astype(np.uint32)[:, None]
    state[12, :] = (np.uint64(counter0)
                    + np.arange(n_blocks, dtype=np.uint64)).astype(np.uint32)
    state[13:16, :] = nonce_words.astype(np.uint32)[:, None]

    x = state.copy()

    def quarter(a, b, c, d):
        x[a] += x[b]; x[d] ^= x[a]; x[d] = rotl(x[d], 16)
        x[c] += x[d]; x[b] ^= x[c]; x[b] = rotl(x[b], 12)
        x[a] += x[b]; x[d] ^= x[a]; x[d] = rotl(x[d], 8)
        x[c] += x[d]; x[b] ^= x[c]; x[b] = rotl(x[b], 7)

    for _ in range(10):  # 20 rounds = 10 double rounds
        quarter(0, 4, 8, 12); quarter(1, 5, 9, 13)
        quarter(2, 6, 10, 14); quarter(3, 7, 11, 15)
        quarter(0, 5, 10, 15); quarter(1, 6, 11, 12)
        quarter(2, 7, 8, 13); quarter(3, 4, 9, 14)
    x += state
    # Little-endian serialization: u64 word w = block[2w] | block[2w+1]<<32.
    out = (x[0::2].astype(np.uint64)
           | (x[1::2].astype(np.uint64) << np.uint64(32)))  # [8, n_blocks]
    return out.T.reshape(-1)


def chacha20_keystream_u64(key32: bytes, nonce12: bytes, counter0: int,
                           n_words: int) -> np.ndarray:
    """n_words u64 of RFC 8439 keystream (native if available)."""
    assert len(key32) == 32 and len(nonce12) == 12
    n_blocks = (n_words + 7) // 8
    key_words = np.frombuffer(key32, dtype="<u4")
    nonce_words = np.frombuffer(nonce12, dtype="<u4")

    from ..runtime import get_lib
    lib = get_lib()
    if lib is not None:
        import ctypes
        out = np.empty(n_blocks * 8, dtype=np.uint64)
        kw = np.ascontiguousarray(key_words)
        nw = np.ascontiguousarray(nonce_words)
        lib.chacha20_fill_u64(out.ctypes.data, ctypes.c_int64(n_blocks),
                              kw.ctypes.data, nw.ctypes.data,
                              ctypes.c_uint32(counter0))
    else:
        out = _chacha20_blocks_numpy(key_words, nonce_words, counter0,
                                     n_blocks)
    return out[:n_words]


class Csprng:
    """ChaCha20 generator with the numpy-Generator surface we sample with.

    One instance = one (key, nonce) stream; the 32-bit block counter advances
    monotonically (2^32 blocks = 256 GiB per stream; the nonce's first word
    bumps on wrap so long-lived instances never reuse a block).
    """

    def __init__(self, key32: bytes | None = None):
        self._key = key32 if key32 is not None else secrets.token_bytes(32)
        assert len(self._key) == 32
        self._stream = 0
        self._counter = 0

    # -- raw streams ---------------------------------------------------------
    def _nonce(self) -> bytes:
        return int(self._stream).to_bytes(4, "little") + b"\0" * 8

    def _u64(self, n: int) -> np.ndarray:
        n_blocks = (n + 7) // 8
        if self._counter + n_blocks >= (1 << 32):
            self._stream += 1
            self._counter = 0
        out = chacha20_keystream_u64(self._key, self._nonce(), self._counter,
                                     n)
        self._counter += n_blocks
        return out

    @staticmethod
    def _size_to_n(size) -> tuple[int, tuple]:
        if size is None:
            return 1, ()
        shape = (size,) if isinstance(size, int) else tuple(size)
        n = 1
        for s in shape:
            n *= int(s)
        return n, shape

    # -- numpy-Generator-compatible sampling surface --------------------------
    def integers(self, low, high=None, size=None, dtype=np.int64,
                 endpoint=False):
        if high is None:
            low, high = 0, low
        span = int(high) - int(low) + (1 if endpoint else 0)
        assert span > 0 and (span & (span - 1)) == 0, (
            "Csprng.integers supports power-of-two ranges (keys/masks are "
            "bits and full-torus words); got span %d" % span)
        n, shape = self._size_to_n(size)
        u = self._u64(n)
        if span < (1 << 64):
            u = u & np.uint64(span - 1)
        vals = (u.astype(np.uint64) + np.uint64(int(low) % (1 << 64)))
        out = vals.reshape(shape).astype(dtype)
        return out if shape else out[()]

    def random(self, size=None):
        """Uniform f64 in [0, 1): 53 high bits of the keystream."""
        n, shape = self._size_to_n(size)
        u = self._u64(n) >> np.uint64(11)
        out = u.astype(np.float64) * (2.0 ** -53)
        return out.reshape(shape) if shape else out[0]

    def normal(self, loc=0.0, scale=1.0, size=None):
        """Box-Muller from keystream uniforms.

        Tail bound: u1 is built from 53 keystream bits, so the largest
        magnitude this transform can emit is sqrt(-2 ln 2^-53) ~ 8.57 sigma.
        That truncation only REMOVES noise mass beyond 8.57 sigma (~1e-18 of
        it), i.e. generated noise is never larger than an ideal Gaussian's —
        conservative relative to the p_fail ~ 2^-64 (~9.15 sigma) decryption
        margin the parameters were optimized for (client.rs:26-30), which
        bounds the |accumulated noise| of *evaluated* ciphertexts, not a
        single fresh sample.  tfhe-rs's Box-Muller sampling has the same
        property."""
        n, shape = self._size_to_n(size)
        m = (n + 1) // 2
        # u1 in (0, 1]: never 0, so log(u1) is finite.
        u1 = (self._u64(m) >> np.uint64(11)).astype(np.float64)
        u1 = (u1 + 1.0) * (2.0 ** -53)
        u2 = (self._u64(m) >> np.uint64(11)).astype(np.float64) * (2.0 ** -53)
        r = np.sqrt(-2.0 * np.log(u1))
        z = np.concatenate([r * np.cos(2 * np.pi * u2),
                            r * np.sin(2 * np.pi * u2)])[:n]
        out = loc + scale * z
        return out.reshape(shape) if shape else out[0]

    def bytes(self, n: int) -> bytes:
        return self._u64((n + 7) // 8).tobytes()[:n]


def default_rng(seed: int | None = None):
    """seed=None -> ChaCha20 CSPRNG from OS entropy (production);
    integer seed -> numpy PCG64, reproducible but NOT secure (tests only)."""
    if seed is None:
        return Csprng()
    return np.random.default_rng(seed)
