"""Exact numpy reference backend ("golden model") for the TFHE/WoPBS stack.

This module is the correctness anchor of the framework:

  * it implements every cryptographic primitive the TPU kernels provide —
    LWE/GLWE/GGSW encryption, gadget decomposition, external product, CMux,
    blind rotation, sample extraction, LWE keyswitch, private functional
    packing keyswitch, circuit bootstrap, bit extraction, vertical packing —
    in plain numpy with bit-exact u64 torus arithmetic (numpy uint64 wraps
    mod 2^64, matching the reference's native ciphertext modulus,
    reference src/client/client.rs:55);
  * it is used directly for key generation (host side) and as the golden
    oracle in the unit tests that validate the JAX/Pallas device kernels.

Primitive semantics mirror the tfhe-rs surface the reference consumes
(SURVEY.md section 2b); internal sign/ordering conventions are our own and are
validated end-to-end against the plaintext AES oracle.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..params import ParamSet
from ..utils import host_torus as torus

U64 = np.uint64

# Torus arithmetic *is* wraparound mod 2^64 — numpy's overflow warnings are
# expected behavior here, not bugs.
np.seterr(over="ignore")


# ---------------------------------------------------------------------------
# Exact negacyclic polynomial arithmetic on Z_{2^64}
# ---------------------------------------------------------------------------

def negacyclic_mul_u64(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Exact negacyclic product (mod x^N + 1, coefficients mod 2^64).

    a, b: [..., N] uint64 (broadcastable).  Schoolbook via N shifted
    accumulations — exact because numpy uint64 arithmetic wraps mod 2^64.
    """
    a = np.asarray(a, dtype=np.uint64)
    b = np.asarray(b, dtype=np.uint64)
    n = a.shape[-1]
    out = np.zeros(np.broadcast_shapes(a.shape, b.shape), dtype=np.uint64)
    for j in range(n):
        bj = b[..., j:j + 1]
        # a * b_j * x^j : rotate a up by j with sign flip on wraparound.
        hi = a[..., :n - j] * bj          # lands on coefficients j..N-1
        lo = a[..., n - j:] * bj          # wraps: -1 * coefficients 0..j-1
        out[..., j:] += hi
        out[..., :j] -= lo
    return out


_NEG_MAT_CACHE: dict[bytes, np.ndarray] = {}


def _negacyclic_matrix(s: np.ndarray) -> np.ndarray:
    """{-1,0,1} negacyclic matrix of a binary poly (cached by content)."""
    key = s.astype(np.uint8).tobytes()
    mat = _NEG_MAT_CACHE.get(key)
    if mat is None:
        n = s.shape[-1]
        idx = (np.arange(n)[None, :] - np.arange(n)[:, None]) % n
        sign = np.where(np.arange(n)[None, :] >= np.arange(n)[:, None], 1, -1)
        mat = (s.astype(np.int64)[idx] * sign).astype(np.float64)
        if len(_NEG_MAT_CACHE) > 64:
            _NEG_MAT_CACHE.clear()
        _NEG_MAT_CACHE[key] = mat
    return mat


def negacyclic_mul_binary(a: np.ndarray, s: np.ndarray) -> np.ndarray:
    """Exact negacyclic product of u64 polys a[..., N] with binary poly s[N].

    Fast path for key material (secret polys are 0/1): split a into two u32
    halves, multiply each with the {-1,0,1} negacyclic matrix of s in float64
    (products <= 2^32, sums over N <= 1024 terms < 2^42 — exactly
    representable in f64), then recombine mod 2^64.
    """
    a = np.asarray(a, dtype=np.uint64)
    mat = _negacyclic_matrix(np.asarray(s))
    lo = (a & U64(0xFFFFFFFF)).astype(np.float64)
    hi = (a >> U64(32)).astype(np.float64)
    lo_out = lo @ mat
    hi_out = hi @ mat
    # |lo_out| < 2^42 exact; convert via int64 (safe range) then wrap.
    lo_u = lo_out.astype(np.int64).astype(np.uint64)
    hi_u = hi_out.astype(np.int64).astype(np.uint64)
    return lo_u + (hi_u << U64(32))


# ---------------------------------------------------------------------------
# Key material
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SecretKeys:
    """Client-side secret key material (binary keys, tfhe-rs style)."""
    params: ParamSet
    lwe_key: np.ndarray        # [n] uint64 in {0,1}        (small LWE key)
    glwe_key: np.ndarray       # [k, N] uint64 in {0,1}     (GLWE key)

    @property
    def big_lwe_key(self) -> np.ndarray:
        """Flattened GLWE key = key of sample-extracted big-LWE ciphertexts."""
        return self.glwe_key.reshape(-1)


def gen_secret_keys(params: ParamSet, rng: np.random.Generator) -> SecretKeys:
    lwe_key = rng.integers(0, 2, size=params.lwe_dimension, dtype=np.uint64)
    glwe_key = rng.integers(
        0, 2, size=(params.glwe_dimension, params.polynomial_size),
        dtype=np.uint64)
    return SecretKeys(params, lwe_key, glwe_key)


# ---------------------------------------------------------------------------
# LWE
# ---------------------------------------------------------------------------

def lwe_encrypt(key: np.ndarray, m: np.ndarray, std: float,
                rng: np.random.Generator) -> np.ndarray:
    """Encrypt torus values m[...] under binary key[n] -> ct[..., n+1].

    Layout: mask a[0..n-1] then body b = <a, s> + m + e  (body LAST,
    matching tfhe-rs container order).
    """
    m = np.asarray(m, dtype=np.uint64)
    n = key.shape[0]
    a = rng.integers(0, 1 << 64, size=m.shape + (n,), dtype=np.uint64)
    e = torus.sample_gaussian_torus(rng, std, m.shape)
    b = (a * key).sum(axis=-1, dtype=np.uint64) + m + e
    return np.concatenate([a, b[..., None]], axis=-1)


def lwe_phase(key: np.ndarray, ct: np.ndarray) -> np.ndarray:
    """b - <a, s>  = m + e  (mod 2^64)."""
    a, b = ct[..., :-1], ct[..., -1]
    return b - (a * key).sum(axis=-1, dtype=np.uint64)


def lwe_decrypt_bit(key: np.ndarray, ct: np.ndarray) -> np.ndarray:
    """Decrypt a bit encoded at delta=2^63: round(phase / 2^63) mod 2."""
    ph = lwe_phase(key, ct)
    return ((ph + U64(1 << 62)) >> U64(63)).astype(np.uint64) & U64(1)


def lwe_trivial(m: np.ndarray, n: int) -> np.ndarray:
    m = np.asarray(m, dtype=np.uint64)
    ct = np.zeros(m.shape + (n + 1,), dtype=np.uint64)
    ct[..., -1] = m
    return ct


# ---------------------------------------------------------------------------
# GLWE
# ---------------------------------------------------------------------------

def glwe_encrypt(glwe_key: np.ndarray, m_poly: np.ndarray, std: float,
                 rng: np.random.Generator) -> np.ndarray:
    """Encrypt torus polys m[..., N] under glwe_key[k, N] -> [..., k+1, N].

    Layout: masks A_0..A_{k-1}, then body B = sum A_i*S_i + M + E (body last).
    """
    m_poly = np.asarray(m_poly, dtype=np.uint64)
    k, n = glwe_key.shape
    a = rng.integers(0, 1 << 64, size=m_poly.shape[:-1] + (k, n),
                     dtype=np.uint64)
    e = torus.sample_gaussian_torus(rng, std, m_poly.shape)
    b = m_poly + e
    for i in range(k):
        b = b + negacyclic_mul_binary(a[..., i, :], glwe_key[i])
    return np.concatenate([a, b[..., None, :]], axis=-2)


def glwe_phase(glwe_key: np.ndarray, ct: np.ndarray) -> np.ndarray:
    k = glwe_key.shape[0]
    b = ct[..., -1, :].copy()
    for i in range(k):
        b = b - negacyclic_mul_binary(ct[..., i, :], glwe_key[i])
    return b


def glwe_trivial(m_poly: np.ndarray, k: int) -> np.ndarray:
    m_poly = np.asarray(m_poly, dtype=np.uint64)
    ct = np.zeros(m_poly.shape[:-1] + (k + 1, m_poly.shape[-1]),
                  dtype=np.uint64)
    ct[..., -1, :] = m_poly
    return ct


# ---------------------------------------------------------------------------
# GGSW + external product + CMux
# ---------------------------------------------------------------------------

def ggsw_encrypt(glwe_key: np.ndarray, m: int, base_log: int, levels: int,
                 std: float, rng: np.random.Generator) -> np.ndarray:
    """GGSW encryption of small integer m -> [levels, k+1, k+1, N].

    Row (l, u) is a GLWE encryption of  m * sigma_u * 2^(64 - base_log*(l+1))
    with sigma_u = -S_u for u < k and sigma_k = +1; realized by adding the
    gadget constant to mask/body component u of a fresh zero encryption.
    """
    k, n = glwe_key.shape
    zeros = glwe_encrypt(glwe_key, np.zeros((levels, k + 1, n), np.uint64),
                         std, rng)
    for l in range(levels):
        g = U64((m % (1 << 64)) * (1 << (64 - base_log * (l + 1))) % (1 << 64))
        for u in range(k + 1):
            zeros[l, u, u, 0] += g
    return zeros


def external_product(ggsw: np.ndarray, glwe: np.ndarray, base_log: int,
                     levels: int) -> np.ndarray:
    """GGSW(m) x GLWE(v) -> GLWE(m*v).   ggsw: [levels, k+1, k+1, N]."""
    kp1, n = glwe.shape[-2], glwe.shape[-1]
    digits = torus.gadget_decompose(glwe, base_log, levels)  # [..,k+1,N,lev]
    out = np.zeros(glwe.shape, dtype=np.uint64)
    for l in range(levels):
        for u in range(kp1):
            d = digits[..., u, :, l].astype(np.uint64)  # [..., N]
            for j in range(kp1):
                out[..., j, :] += negacyclic_mul_u64(d, ggsw[l, u, j, :])
    return out


def cmux(ggsw_bit: np.ndarray, ct0: np.ndarray, ct1: np.ndarray,
         base_log: int, levels: int) -> np.ndarray:
    """ct0 + GGSW(b) x (ct1 - ct0):  selects ct1 when b=1."""
    return ct0 + external_product(ggsw_bit, ct1 - ct0, base_log, levels)


def polynomial_rotate(poly: np.ndarray, amount: np.ndarray | int) -> np.ndarray:
    """Multiply poly[..., N] by X^amount (negacyclic, amount mod 2N)."""
    poly = np.asarray(poly, dtype=np.uint64)
    n = poly.shape[-1]
    amount = int(amount) % (2 * n)
    ext = np.concatenate([poly, (U64(0) - poly)], axis=-1)  # [..., 2N]
    out = np.roll(ext, amount, axis=-1)[..., :n]
    return out


# ---------------------------------------------------------------------------
# Bootstrapping: modswitch, blind rotate, sample extract
# ---------------------------------------------------------------------------

def modswitch(ct: np.ndarray, two_n: int) -> np.ndarray:
    """Round torus values to Z_{2N}: round(x * 2N / 2^64)."""
    shift = 64 - int(np.log2(two_n))
    return (((ct + (U64(1) << U64(shift - 1))) >> U64(shift))
            % U64(two_n)).astype(np.int64)


def bsk_gen(sk: SecretKeys, rng: np.random.Generator) -> np.ndarray:
    """Bootstrapping key: GGSW(s_i) for every small-LWE key bit.

    -> [n, pbs_level, k+1, k+1, N] uint64.  Batched: one GLWE-encrypt call
    produces all n * levels * (k+1) zero rows, then gadget constants are
    added in place (sigma_u convention as in ggsw_encrypt).
    """
    p = sk.params
    k, n = p.glwe_dimension, p.polynomial_size
    lev = p.pbs_level
    zeros = glwe_encrypt(
        sk.glwe_key,
        np.zeros((p.lwe_dimension, lev, k + 1, n), np.uint64),
        p.glwe_noise_std, rng)                 # [n_lwe, lev, k+1, k+1, N]
    for l in range(lev):
        g = U64((1 << (64 - p.pbs_base_log * (l + 1))) % (1 << 64))
        for u in range(k + 1):
            zeros[:, l, u, u, 0] += sk.lwe_key * g
    return zeros


def blind_rotate(bsk: np.ndarray, lwe_ct: np.ndarray, test_glwe: np.ndarray,
                 base_log: int, levels: int) -> np.ndarray:
    """acc = X^{-b~} * v;  acc = CMux(BSK_i, acc, X^{a~_i} * acc) for all i."""
    n_glwe_poly = test_glwe.shape[-1]
    two_n = 2 * n_glwe_poly
    tilde = modswitch(lwe_ct, two_n)
    a_t, b_t = tilde[..., :-1], tilde[..., -1]
    acc = polynomial_rotate(test_glwe, int(two_n - b_t) % two_n)
    for i in range(a_t.shape[-1]):
        rot = polynomial_rotate(acc, int(a_t[..., i]) % two_n)
        acc = cmux(bsk[i], acc, rot, base_log, levels)
    return acc


def sample_extract(glwe: np.ndarray, coeff: int = 0) -> np.ndarray:
    """Extract LWE(coefficient `coeff`) under the flattened big key.

    big_key[i*N + j] = S_i[j];  a'_{iN+j} = A_i[coeff-j] for j <= coeff,
    -A_i[N+coeff-j] for j > coeff;  b' = B[coeff].
    """
    kp1, n = glwe.shape[-2], glwe.shape[-1]
    k = kp1 - 1
    masks = glwe[..., :k, :]  # [..., k, N]
    j = np.arange(n)
    idx = (coeff - j) % n
    sign = np.where(j <= coeff, U64(1), U64(0) - U64(1))
    a = masks[..., idx] * sign  # [..., k, N]
    a = a.reshape(glwe.shape[:-2] + (k * n,))
    b = glwe[..., k, coeff]
    return np.concatenate([a, b[..., None]], axis=-1)


# ---------------------------------------------------------------------------
# Keyswitching (big LWE -> small LWE)
# ---------------------------------------------------------------------------

def ksk_gen(sk: SecretKeys, rng: np.random.Generator) -> np.ndarray:
    """KSK[t, l] = LWE_small( bigkey_t * 2^(64 - ks_base_log*(l+1)) ).

    -> [big_dim, ks_level, n+1] uint64.
    """
    p = sk.params
    big = sk.big_lwe_key
    msgs = np.zeros((p.big_lwe_dimension, p.ks_level), dtype=np.uint64)
    for l in range(p.ks_level):
        msgs[:, l] = big * U64((1 << (64 - p.ks_base_log * (l + 1))) % (1 << 64))
    return lwe_encrypt(sk.lwe_key, msgs, p.lwe_noise_std, rng)


def keyswitch(ksk: np.ndarray, ct: np.ndarray, base_log: int,
              levels: int) -> np.ndarray:
    """Switch ct[..., big+1] under big key to [..., n+1] under small key."""
    a, b = ct[..., :-1], ct[..., -1]
    digits = torus.gadget_decompose(a, base_log, levels)  # [..., big, lev]
    n_out = ksk.shape[-1] - 1
    out = np.zeros(ct.shape[:-1] + (n_out + 1,), dtype=np.uint64)
    out[..., -1] = b
    # out -= sum_{t,l} d_{t,l} * KSK[t,l]
    d = digits.astype(np.uint64)
    out -= np.einsum("...tl,tlj->...j", d, ksk, dtype=np.uint64,
                     casting="unsafe").astype(np.uint64)
    return out


# ---------------------------------------------------------------------------
# Private functional packing keyswitch (PFPKSK) — CBS building block
# ---------------------------------------------------------------------------

def pfpksk_gen(sk: SecretKeys, rng: np.random.Generator) -> np.ndarray:
    """PFPKSK list for functions f_u(m) = m * sigma_u (sigma_u = -S_u, +1).

    -> [k+1, big_dim+1, pfks_level, k+1, N] uint64.
    Key element [u, t, l] = GLWE( f_u(-bigkey_t) * g_l ) for t < big_dim and
    [u, big_dim, l] = GLWE( f_u(1) * g_l ), g_l = 2^(64 - pfks_base*(l+1)).
    """
    p = sk.params
    k, n = p.glwe_dimension, p.polynomial_size
    big = p.big_lwe_dimension
    bigkey = sk.big_lwe_key
    msgs = np.zeros((k + 1, big + 1, p.pfks_level, n), dtype=np.uint64)
    for u in range(k + 1):
        # sigma_u as a polynomial: -S_u for u<k, else constant 1.
        if u < k:
            sigma = (U64(0) - sk.glwe_key[u])  # -S_u (0/1 coeffs negated)
        else:
            sigma = np.zeros(n, dtype=np.uint64)
            sigma[0] = U64(1)
        for l in range(p.pfks_level):
            g = U64((1 << (64 - p.pfks_base_log * (l + 1))) % (1 << 64))
            msgs[u, :big, l] = (U64(0) - bigkey[:, None]) * sigma[None, :] * g
            msgs[u, big, l] = sigma * g
    return glwe_encrypt(sk.glwe_key, msgs, p.glwe_noise_std, rng)


def pfpksk_apply(pfpksk_u: np.ndarray, ct: np.ndarray, base_log: int,
                 levels: int) -> np.ndarray:
    """Apply one PFPKSK to big-LWE ct[..., big+1] -> GLWE(sigma_u * m).

    out = sum_t sum_l d_l(a_t) * Key[t, l]  +  sum_l d_l(b) * Key[big, l]
    """
    digits = torus.gadget_decompose(ct, base_log, levels)  # [..., big+1, lev]
    d = digits.astype(np.uint64)
    # pfpksk_u: [big+1, lev, k+1, N]
    return np.einsum("...tl,tljn->...jn", d, pfpksk_u, dtype=np.uint64,
                     casting="unsafe").astype(np.uint64)


# ---------------------------------------------------------------------------
# Circuit bootstrap (bit LWE -> GGSW) and bit extraction
# ---------------------------------------------------------------------------

def cbs_test_glwe(params: ParamSet, out_scale_log: int) -> np.ndarray:
    """Trivial GLWE test vector for boolean PBS -> {0, 2^out_scale_log}.

    Constant polynomial -2^(out_scale_log-1); caller adds the same constant
    to the extracted body (half-box offset handled in `pbs_boolean`).
    """
    n = params.polynomial_size
    v = np.full(n, U64((1 << (out_scale_log - 1))), dtype=np.uint64)
    v = U64(0) - v
    return glwe_trivial(v, params.glwe_dimension)


def pbs_boolean(bsk: np.ndarray, lwe_ct: np.ndarray, params: ParamSet,
                out_scale_log: int) -> np.ndarray:
    """PBS a bit at delta=2^63 into a fresh big-LWE of b * 2^out_scale_log.

    Adds the q/4 half-box offset to the body so the blind rotation lands
    mid-box regardless of noise sign, then extracts and re-centers.
    """
    ct = lwe_ct.copy()
    ct[..., -1] += U64(1 << 62)
    test = cbs_test_glwe(params, out_scale_log)
    acc = blind_rotate(bsk, ct, test, params.pbs_base_log, params.pbs_level)
    out = sample_extract(acc, 0)
    out[..., -1] += U64(1 << (out_scale_log - 1))
    return out


def circuit_bootstrap_bit(bsk: np.ndarray, pfpksk: np.ndarray,
                          lwe_ct: np.ndarray, params: ParamSet) -> np.ndarray:
    """CBS: small-LWE bit -> GGSW[cbs_level, k+1, k+1, N] of that bit.

    Per level l: PBS to b * 2^(64 - cbs_base_log*(l+1)), then pack through
    each of the k+1 PFPKSKs into the GGSW's level-l rows
    (reference call: many_wopbs.rs:253-261 -> tfhe-rs circuit_bootstrap_boolean).
    """
    p = params
    k, n = p.glwe_dimension, p.polynomial_size
    ggsw = np.empty((p.cbs_level, k + 1, k + 1, n), dtype=np.uint64)
    for l in range(p.cbs_level):
        scale_log = 64 - p.cbs_base_log * (l + 1)
        big_lwe = pbs_boolean(bsk, lwe_ct, p, scale_log)
        for u in range(k + 1):
            ggsw[l, u] = pfpksk_apply(pfpksk[u], big_lwe, p.pfks_base_log,
                                      p.pfks_level)
    return ggsw


def extract_bit_keyswitch(ksk: np.ndarray, big_lwe_ct: np.ndarray,
                          params: ParamSet) -> np.ndarray:
    """Bit extraction for 1-bit blocks (delta_log=63): a single keyswitch.

    The reference's extract_bits_assign (many_wopbs.rs:194-199) degenerates to
    one keyswitch per block when each radix block holds one bit — the
    shift is by 2^0 and no clearing PBS is needed (SURVEY.md section 2b).
    """
    return keyswitch(ksk, big_lwe_ct, params.ks_base_log, params.ks_level)


# ---------------------------------------------------------------------------
# Vertical packing: LUT evaluation from GGSW-encrypted selector bits
# ---------------------------------------------------------------------------

def vertical_packing(lut_poly: np.ndarray, ggsw_bits: list[np.ndarray],
                     params: ParamSet) -> np.ndarray:
    """Evaluate lut[value] where value = sum_j bit_j 2^j, bits GGSW-encrypted.

    ggsw_bits[j] encrypts bit j (LSB first).  lut_poly: [M, N] torus polys
    (M = 2^max(0, bits - log2 N) "chunks"); for bits <= log2(N) that is one
    poly and the evaluation is a pure CMux blind rotation; otherwise the high
    bits select a chunk through a CMux tree first (tfhe-rs vertical_packing,
    invoked at many_wopbs.rs:277).
    Returns one big-LWE of lut[value] (sample-extracted coefficient 0).
    """
    p = params
    n = p.polynomial_size
    nbits = len(ggsw_bits)
    log_n = p.log2_poly_size
    n_rot_bits = min(nbits, log_n)
    tree_bits = nbits - n_rot_bits  # high bits go through the CMux tree

    lut_poly = np.asarray(lut_poly, dtype=np.uint64)
    if lut_poly.ndim == 1:
        lut_poly = lut_poly[None, :]
    assert lut_poly.shape[0] == 1 << tree_bits

    # CMux tree over the high bits (MSB last): leaves are trivial GLWEs.
    layer = [glwe_trivial(lut_poly[i], p.glwe_dimension)
             for i in range(lut_poly.shape[0])]
    for t in range(tree_bits):
        g = ggsw_bits[n_rot_bits + t]
        layer = [cmux(g, layer[2 * i], layer[2 * i + 1],
                      p.cbs_base_log, p.cbs_level)
                 for i in range(len(layer) // 2)]
    acc = layer[0]

    # Blind rotation by the low bits: bit j contributes rotation X^(-2^j).
    for j in range(n_rot_bits):
        rot = polynomial_rotate(acc, 2 * n - (1 << j))
        acc = cmux(ggsw_bits[j], acc, rot, p.cbs_base_log, p.cbs_level)
    return sample_extract(acc, 0)
