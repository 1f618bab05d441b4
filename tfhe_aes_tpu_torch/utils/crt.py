"""CRT / NTT-prime machinery for exact negacyclic u64 polynomial products.

The reference's hot kernel multiplies torus polynomials with an approximate
f64 FFT (tfhe-fft ``c64``, reference src/server/sbox/many_wopbs.rs:22,263).
On TPU we instead do an *exact* residue-number-system NTT:

  * decomposition digits (int8-range) are transformed with matmul NTTs modulo
    several small primes p_k = 1 (mod 2048);
  * pointwise products/accumulation happen per prime in int32 (every operand
    < 2^16, products < 2^31, reduced with an f32-Barrett step);
  * the exact integer convolution (|coef| < prod(p_k)/2) is reconstructed with
    explicit CRT and reduced mod 2^64.

Primes are chosen < 2^15.5 so a*b fits a signed int32 and residues fit two
signed 8-bit limbs — int8 is the TPU MXU's native integer operand type.
"""

from __future__ import annotations

import functools

import numpy as np

# Need p = 1 (mod 2*N_max) so a primitive 2N-th root of unity exists for the
# negacyclic NTT.  N_max = 512 is the production polynomial size
# (client.rs:35); all smaller power-of-two sizes are covered too.
MAX_TWO_N = 1024


def _is_prime(n: int) -> bool:
    if n < 2:
        return False
    for p in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if n % p == 0:
            return n == p
    d, s = n - 1, 0
    while d % 2 == 0:
        d //= 2
        s += 1
    for a in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(s - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


@functools.lru_cache(maxsize=None)
def ntt_primes(count: int = 6, bound: int = 46340) -> tuple[int, ...]:
    """Largest `count` primes p < bound with p = 1 (mod MAX_TWO_N).

    bound default 46340 = floor(2^31 ** 0.5): guarantees p*p < 2^31 so modular
    products of residues fit a signed int32 on the TPU VPU.
    """
    out = []
    p = (bound // MAX_TWO_N) * MAX_TWO_N + 1
    while len(out) < count and p > MAX_TWO_N:
        if _is_prime(p):
            out.append(p)
        p -= MAX_TWO_N
    assert len(out) == count, "not enough NTT primes under bound"
    return tuple(out)


def rotate_primes(q_bits: int, poly_n: int, base_log: int,
                  glwe_dim: int, levels: int) -> tuple[int, ...]:
    """Smallest big-prime RNS basis covering the mod-2^q_bits blind rotate.

    The rotate accumulator lives mod q' = 2^(base_log*levels) (the gadget
    decomposition is then EXACT), so the CRT only has to cover the true
    integer convolution of balanced digits (|d| <= 2^(base_log-1)) with
    balanced mod-q' BSK representatives (|b| <= 2^(q-1)), times 2 for the
    (X^a - 1) twiddle:  need  M/2 > 2 * R*N * 2^(blog-1) * 2^(q-1).

    Primes come from a LARGER window than ntt_primes' (bound 65023): with the
    twiddle product clamped to |prod| <= p/2 in the kernel, every int32 bound
    holds for p < 2^16 (see ops/pallas_blind_rotate.py bound comments), and
    fewer, bigger primes mean proportionally fewer MXU dots / Barrett chains /
    BSK bytes.  At PARAM_OPT (q' = 48, ops/keys.make_rotate_plan) this is
    5 primes vs the mod-2^64 domain's 6: log2 M = 79.2 vs the required
    68.64.  (4 primes would cover only q' <= 40, whose staging noise fails
    the GGSW budget — measured dead end, PERF.md round 3.)
    """
    r_rows = (glwe_dim + 1) * levels
    import math
    need = 2.0 + math.log2(r_rows * poly_n) + (base_log - 1) + (q_bits - 1)
    out: list[int] = []
    total = 0.0
    p = (65023 // MAX_TWO_N) * MAX_TWO_N + 1
    while total <= need and p > MAX_TWO_N:
        if _is_prime(p):
            out.append(p)
            total += math.log2(p)
        p -= MAX_TWO_N
    assert total > need, "not enough rotate primes under bound"
    return tuple(out)


def _primitive_root(p: int) -> int:
    # factor p-1
    n, fac = p - 1, []
    d = 2
    while d * d <= n:
        if n % d == 0:
            fac.append(d)
            while n % d == 0:
                n //= d
        d += 1
    if n > 1:
        fac.append(n)
    for g in range(2, p):
        if all(pow(g, (p - 1) // q, p) != 1 for q in fac):
            return g
    raise ValueError(f"no primitive root for {p}")


@functools.lru_cache(maxsize=None)
def root_of_unity(p: int, order: int) -> int:
    """A primitive `order`-th root of unity mod p (order | p-1)."""
    assert (p - 1) % order == 0
    g = _primitive_root(p)
    w = pow(g, (p - 1) // order, p)
    assert pow(w, order, p) == 1 and pow(w, order // 2, p) == p - 1
    return w


# ---------------------------------------------------------------------------
# Host (numpy) negacyclic NTT per prime — golden model for the device kernels
# and workhorse for key preprocessing.
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def ntt_matrices(p: int, n: int) -> tuple[np.ndarray, np.ndarray]:
    """(forward, inverse) negacyclic NTT matrices mod p, shape [n, n] int64.

    Forward:  ahat[j] = sum_i a[i] * psi^(i*(2j+1))  (mod p)
    Inverse:  a[i]    = n^-1 * sum_j ahat[j] * psi^(-i*(2j+1))  (mod p)

    where psi is a primitive 2n-th root of unity.  With this convention the
    pointwise product of two forward transforms is the negacyclic (mod x^n+1)
    convolution — verified in tests against exact schoolbook u64 products.
    Layout note: both used as right-multiplied matrices, i.e. a @ F with
    F[i, j] = psi^(i*(2j+1)).
    """
    psi = root_of_unity(p, 2 * n)
    i = np.arange(n, dtype=object)[:, None]
    j = np.arange(n, dtype=object)[None, :]
    exp_f = (i * (2 * j + 1)) % (2 * n)
    psi_pows = np.array([pow(psi, int(e), p) for e in range(2 * n)], dtype=np.int64)
    fwd = psi_pows[exp_f.astype(np.int64)]
    psi_inv = pow(psi, 2 * n - 1, p)
    psi_inv_pows = np.array([pow(psi_inv, int(e), p) for e in range(2 * n)],
                            dtype=np.int64)
    # inv[j, i] = psi^{-i(2j+1)} = transpose of the forward exponent pattern.
    inv = psi_inv_pows[exp_f.T.astype(np.int64)]
    n_inv = pow(n, p - 2, p)
    inv = (inv * n_inv) % p
    return fwd.astype(np.int64), inv.astype(np.int64)


def _matmul_mod_f64(a: np.ndarray, m: np.ndarray, p: int) -> np.ndarray:
    """Exact (a @ m) mod p via BLAS f64: p^2 * n < 2^41 << 2^53."""
    prod = a.astype(np.float64) @ m.astype(np.float64)
    return np.mod(prod, float(p)).astype(np.int64) % p


def ntt_fwd_host(a: np.ndarray, p: int) -> np.ndarray:
    """Forward negacyclic NTT mod p of int64 rows a[..., n] (values any int)."""
    a = np.asarray(a, dtype=np.int64) % p
    fwd, _ = ntt_matrices(p, a.shape[-1])
    return _matmul_mod_f64(a, fwd, p)


def ntt_inv_host(ahat: np.ndarray, p: int) -> np.ndarray:
    ahat = np.asarray(ahat, dtype=np.int64) % p
    _, inv = ntt_matrices(p, ahat.shape[-1])
    return _matmul_mod_f64(ahat, inv, p)


@functools.lru_cache(maxsize=None)
def crt_constants(primes: tuple[int, ...], q_bits: int = 64):
    """Precomputed explicit-CRT constants for reconstruction mod 2^q_bits.

    Given residues y_k of a signed integer x (|x| < M/2, M = prod p_k):
        z_k   = y_k * c_k mod p_k            (c_k = (M/p_k)^-1 mod p_k)
        alpha = round(sum_k z_k / p_k)
        x     = sum_k z_k * (M/p_k)  -  alpha * M          (exact integer)
        x mod 2^q = sum_k z_k * Mk64_k - alpha * M64       (mod 2^q)
    Returns dict with c_k, Mk mod 2^q, M mod 2^q, and fixed-point 1/p_k.
    (Field names keep the historical "64" suffix; they are mod 2^q_bits.)
    """
    M = 1
    for p in primes:
        M *= p
    c = []
    mk64 = []
    for p in primes:
        Mk = M // p
        c.append(pow(Mk % p, p - 2, p))
        mk64.append(Mk % (1 << q_bits))
    # fixed point floor(2^40 / p): z_k < 2^16 so z_k * fp < 2^56 fits u64/i64;
    # total alpha error < count * 2^-40 * 2^16 << 1/2.
    fp_shift = 40
    fp = [(1 << fp_shift) // p for p in primes]
    return {
        "primes": primes,
        "M": M,
        "q_bits": q_bits,
        "c": np.array(c, dtype=np.int64),
        "mk64": np.array(mk64, dtype=np.uint64),
        "m64": np.uint64(M % (1 << q_bits)),
        "fp": np.array(fp, dtype=np.int64),
        "fp_shift": fp_shift,
    }


def crt_reconstruct_u64_host(residues: np.ndarray, primes: tuple[int, ...],
                             q_bits: int = 64) -> np.ndarray:
    """Reconstruct x mod 2^q_bits from residues[..., k] (int64, in [0, p_k))."""
    cst = crt_constants(primes, q_bits)
    zs = []
    for k, p in enumerate(primes):
        zs.append((residues[..., k].astype(np.int64) * int(cst["c"][k])) % p)
    z = np.stack(zs, axis=-1)  # [..., k] each < p_k < 2^16
    acc = np.zeros(z.shape[:-1], dtype=np.uint64)
    alpha_fx = np.zeros(z.shape[:-1], dtype=np.int64)
    for k in range(len(primes)):
        acc = acc + z[..., k].astype(np.uint64) * cst["mk64"][k]
        alpha_fx = alpha_fx + z[..., k] * int(cst["fp"][k])
    alpha = (alpha_fx + (1 << (cst["fp_shift"] - 1))) >> cst["fp_shift"]
    acc = acc - alpha.astype(np.uint64) * cst["m64"]
    if q_bits < 64:
        acc = acc & np.uint64((1 << q_bits) - 1)
    return acc
