"""Negacyclic NTT: exact u64 polynomial products via RNS + int8 products.

Counterpart of tfhe_aes_tpu/ops/ntt.py, in two halves:

  * host (numpy): the plan and the staged matrix operands — the forward and
    inverse transforms as int8-limb matrices, the CRT constants, the
    rotation twiddles, and the prime-merged layouts the CUDA kernels read;
  * device (torch): the plain transforms, MACs and explicit-CRT
    reconstruction used by the CPU path and checked word for word against
    the jnp functions.

Every int8 x int8 product accumulates in int32 (``int8_dot``), never in
int8: ``torch.mm`` on int8 wraps.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..utils import crt, torus
from . import modular

I32 = torch.int32


# ---------------------------------------------------------------------------
# Host half: plan and staged operands (numpy)
# ---------------------------------------------------------------------------

def _host_limb_matrices(primes, n: int, inverse: bool, fold_crt: bool):
    """Twiddle matrices as int8 limbs [P, n_scale=2, n_limb=2, N, N].

    Scale index i: input limb i (matrix pre-scaled by 2^(8i)); limb index j:
    output 8-bit limb of the balanced matrix entries.
    """
    cst = crt.crt_constants(tuple(primes))
    mats = []
    for k, p in enumerate(primes):
        fwd, inv = crt.ntt_matrices(p, n)
        m = inv if inverse else fwd
        if fold_crt:
            m = (m * int(cst["c"][k])) % p
        per_scale = []
        for i in range(2):
            scaled = (m * pow(2, 8 * i, p)) % p
            bal = modular.host_balanced(scaled, p)
            per_scale.append(modular.host_balanced_limbs2(bal))  # [N,N,2]
        mats.append(np.stack(per_scale))
    arr = np.stack(mats)                                   # [P,2,N,N,2]
    return np.ascontiguousarray(arr.transpose(0, 1, 4, 2, 3))


@dataclasses.dataclass(frozen=True, eq=False)
class NttPlan:
    """Host constants for one polynomial size and prime basis.

    eq=False: hashed by identity, so the lru-cached operand builders below
    key on the (cached) plan object.
    """
    n: int
    primes: tuple[int, ...]
    q_bits: int                  # accumulator modulus 2^q_bits
    fwd_limbs: np.ndarray        # int8 [P, 2, 2, N, N]
    inv_limbs: np.ndarray        # int8 [P, 2, 2, N, N]  (n^-1 folded)
    inv_crt_limbs: np.ndarray    # int8 [P, 2, 2, N, N]  (n^-1 and c_k folded)
    p_i32: np.ndarray            # int32 [P]
    inv_f32: np.ndarray          # float32 [P]
    mk64: np.ndarray             # uint64 [P]   (M/p_k mod 2^q)
    m64: np.uint64               # M mod 2^q
    fp: np.ndarray               # int64 [P]    floor(2^40 / p_k)
    fp_shift: int
    pow2_8i: np.ndarray          # int32 [P, 8] balanced (2^(8i) mod p_k)
    rot_table: np.ndarray        # int32 [P, 2N, N] balanced psi^(a*(2j+1))

    @property
    def n_primes(self) -> int:
        return len(self.primes)


def _host_rot_table(primes, n: int) -> np.ndarray:
    """rot_table[p, a, j] = balanced(psi^(a*(2j+1)) mod p), a in [0, 2N):
    multiplication by X^a in the negacyclic NTT domain."""
    j = np.arange(n, dtype=np.int64)
    a = np.arange(2 * n, dtype=np.int64)[:, None]
    e = (a * (2 * j + 1)) % (2 * n)
    out = []
    for p in primes:
        psi = crt.root_of_unity(p, 2 * n)
        pows = np.array([pow(psi, int(t), p) for t in range(2 * n)],
                        dtype=np.int64)
        out.append(modular.host_balanced(pows[e], p))
    return np.stack(out).astype(np.int32)


@functools.lru_cache(maxsize=None)
def make_plan(n: int, primes: tuple[int, ...] | None = None,
              q_bits: int = 64) -> NttPlan:
    """Plan constructor, cached per (n, primes, q_bits)."""
    primes = primes or crt.ntt_primes()
    cst = crt.crt_constants(tuple(primes), q_bits)
    pow2 = np.stack([
        modular.host_balanced([pow(2, 8 * i, p) for i in range(8)], p)
        for p in primes]).astype(np.int32)
    return NttPlan(
        n=n,
        primes=tuple(primes),
        q_bits=q_bits,
        fwd_limbs=_host_limb_matrices(primes, n, inverse=False, fold_crt=False),
        inv_limbs=_host_limb_matrices(primes, n, inverse=True, fold_crt=False),
        inv_crt_limbs=_host_limb_matrices(primes, n, inverse=True,
                                          fold_crt=True),
        p_i32=np.array(primes, dtype=np.int32),
        inv_f32=(1.0 / np.array(primes, np.float64)).astype(np.float32),
        mk64=cst["mk64"],
        m64=cst["m64"],
        fp=cst["fp"],
        fp_shift=cst["fp_shift"],
        pow2_8i=pow2,
        rot_table=_host_rot_table(primes, n),
    )


@functools.lru_cache(maxsize=None)
def inv_crt_full_host(plan: NttPlan) -> np.ndarray:
    """Block INTT matrices [P, 2N, 2N] int8, x @ M orientation: row blocks
    = input limbs (hi scale folded in), column blocks = output 8-bit limbs."""
    m = plan.inv_crt_limbs
    top = np.concatenate([m[:, 0, 0], m[:, 0, 1]], axis=2)
    bot = np.concatenate([m[:, 1, 0], m[:, 1, 1]], axis=2)
    return np.ascontiguousarray(np.concatenate([top, bot], axis=1))


@functools.lru_cache(maxsize=None)
def fwd_full_host(plan: NttPlan) -> np.ndarray:
    """Forward digit-NTT matrices [P, N, 2N] int8 (single int8 input limb)."""
    m = plan.fwd_limbs
    return np.ascontiguousarray(np.concatenate([m[:, 0, 0], m[:, 0, 1]],
                                               axis=2))


@functools.lru_cache(maxsize=None)
def fwd_full_wide_host(plan: NttPlan) -> np.ndarray:
    """Block forward-NTT matrices [P, 2N, 2N] int8 for WIDE digits: row
    blocks = the two base-2^6 input limbs (|limb| <= 32, the 2^6 scale of
    the hi limb folded in), column blocks = output 8-bit limbs."""
    outs = []
    for p in plan.primes:
        fwd, _ = crt.ntt_matrices(p, plan.n)
        rows = []
        for scale in (1, 64):
            bal = modular.host_balanced((fwd * scale) % p, p)
            lo, hi = np.moveaxis(modular.host_balanced_limbs2(bal), -1, 0)
            rows.append(np.concatenate([lo, hi], axis=1))
        outs.append(np.concatenate(rows, axis=0))
    return np.ascontiguousarray(np.stack(outs))


def fwd_full_for(plan: NttPlan, pbs_base_log: int) -> np.ndarray:
    """[P, N, 2N] single-limb matrices for int8 digits, [P, 2N, 2N] block
    matrices for wide (pbs_base_log > 8) digits."""
    return fwd_full_wide_host(plan) if pbs_base_log > 8 else \
        fwd_full_host(plan)


@functools.lru_cache(maxsize=None)
def fwd_cat_for(plan: NttPlan, pbs_base_log: int) -> np.ndarray:
    """Prime-merged forward digit-NTT matrix [dn, 2*P*N] int8: columns
    [0, P*N) are the lo output limbs (prime k at k*N), [P*N, 2*P*N) the hi
    limbs; rows are the digit limb planes (dn = N, or 2N for wide digits)."""
    per = fwd_full_for(plan, pbs_base_log)
    n = plan.n
    lo = np.concatenate([per[k, :, :n] for k in range(plan.n_primes)], axis=1)
    hi = np.concatenate([per[k, :, n:] for k in range(plan.n_primes)], axis=1)
    return np.ascontiguousarray(np.concatenate([lo, hi], axis=1))


@functools.lru_cache(maxsize=None)
def fwd_cat3_host(plan: NttPlan) -> np.ndarray:
    """Prime-merged forward-NTT matrix [3N, 2*P*N] int8 for 15-bit digits
    split into three base-2^5 limbs (scales 1, 32, 1024 folded into the
    row blocks); columns as fwd_cat_for."""
    n = plan.n
    los, his = [], []
    for p in plan.primes:
        fwd, _ = crt.ntt_matrices(p, n)
        rows_lo, rows_hi = [], []
        for scale in (1, 32, 1024):
            bal = modular.host_balanced((fwd * scale) % p, p)
            lo, hi = np.moveaxis(modular.host_balanced_limbs2(bal), -1, 0)
            rows_lo.append(lo)
            rows_hi.append(hi)
        los.append(np.concatenate(rows_lo, axis=0))
        his.append(np.concatenate(rows_hi, axis=0))
    return np.ascontiguousarray(np.concatenate(los + his, axis=1))


@functools.lru_cache(maxsize=None)
def rot_table_merged(plan: NttPlan) -> np.ndarray:
    """Prime-merged twiddle table [2N, P*N] int16: row a = the X^a
    twiddles of all primes side by side (prime k at lanes k*N)."""
    t = plan.rot_table
    merged = np.ascontiguousarray(t.transpose(1, 0, 2).reshape(
        t.shape[1], -1))
    if np.abs(merged).max() >= (1 << 15):
        raise ValueError("twiddles do not fit int16")
    return merged.astype(np.int16)


# ---------------------------------------------------------------------------
# Device half: plain torch transforms
# ---------------------------------------------------------------------------

def int8_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[M, K] int8 @ [K, N] int8 -> exact int32 [M, N].

    torch._int_mm on the bulk (it wants M > 16 and K, N multiples of 8, so
    M and N are zero-padded), plus elementwise terms for the K % 8 tail.
    """
    m, k = a.shape
    n = b.shape[1]
    k8 = k - k % 8
    out = None
    if k8:
        aa = a[:, :k8]
        bb = b[:k8]
        if n % 8:
            bb = F.pad(bb, (0, 8 - n % 8))
        if m <= 16:
            aa = F.pad(aa, (0, 0, 0, 17 - m))
        out = torch._int_mm(aa.contiguous(), bb.contiguous())[:m, :n]
    for i in range(k8, k):
        term = a[:, i, None].to(I32) * b[None, i].to(I32)
        out = term if out is None else out + term
    return out


def _apply_limb_matrices(x_limbs: list[torch.Tensor], mats: torch.Tensor,
                         k: int, p, inv_p) -> torch.Tensor:
    """sum_i x_i @ (2^(8i) * M) for prime k; balanced int32 [..., N].

    x_limbs[i]: int8 [..., N]; mats: int8 [P, 2, 2, N, N].
    """
    shape = x_limbs[0].shape
    acc = None
    for i, xi in enumerate(x_limbs):
        x2 = xi.reshape(-1, shape[-1])
        lo = int8_dot(x2, mats[k, i, 0])
        hi = int8_dot(x2, mats[k, i, 1])
        term = modular.barrett_reduce(lo + (hi << 8), p, inv_p)
        acc = term if acc is None else acc + term
    if len(x_limbs) > 1:
        acc = modular.barrett_reduce(acc, p, inv_p)
    return acc.reshape(shape)


def _per_prime(plan: NttPlan, fn) -> torch.Tensor:
    return torch.stack([fn(k, int(plan.p_i32[k]), float(plan.inv_f32[k]))
                        for k in range(plan.n_primes)])


def ntt_fwd_digits(plan: NttPlan, digits_i8: torch.Tensor,
                   fwd_limbs: torch.Tensor) -> torch.Tensor:
    """Forward NTT of int8 gadget digits -> balanced int32 [P, ..., N]."""
    return _per_prime(plan, lambda k, p, ip: _apply_limb_matrices(
        [digits_i8], fwd_limbs, k, p, ip))


def split2(x: torch.Tensor) -> list[torch.Tensor]:
    """Balanced int32 (|x| <= ~2^15) -> two int8 limbs [lo, hi]."""
    return list(modular.to_balanced_limbs2(x))


def ntt_fwd_wide(plan: NttPlan, vals_i32: torch.Tensor,
                 fwd_limbs: torch.Tensor) -> torch.Tensor:
    """Forward NTT of balanced values |v| < 2^15 (e.g. 12- or 15-bit
    gadget digits)."""
    limbs = split2(vals_i32)
    return _per_prime(plan, lambda k, p, ip: _apply_limb_matrices(
        limbs, fwd_limbs, k, p, ip))


def ntt_fwd_residues(plan: NttPlan, res: torch.Tensor,
                     fwd_limbs: torch.Tensor) -> torch.Tensor:
    """Forward NTT of per-prime balanced residues [P, ..., N]."""
    return _per_prime(plan, lambda k, p, ip: _apply_limb_matrices(
        split2(res[k]), fwd_limbs, k, p, ip))


def _prime_consts(plan: NttPlan, rank: int, device):
    """Per-prime constants shaped [P, 1, 1, ...] for broadcasting."""
    sh = (plan.n_primes,) + (1,) * (rank - 1)
    p = torch.as_tensor(plan.p_i32, device=device).reshape(sh)
    inv = torch.as_tensor(plan.inv_f32, device=device).reshape(sh)
    c16 = torch.as_tensor(np.stack([
        modular.host_balanced(1 << 16, int(q)) for q in plan.primes]
    ).astype(np.int32), device=device).reshape(sh)
    return p, inv, c16


def _combine_limb_dots(plan: NttPlan, s_ll, s_mid, s_hh) -> torch.Tensor:
    """value = s_ll + 2^8 s_mid + 2^16 s_hh, reduced mod p (each partial
    sum < 2^20, the shifted terms reduced before scaling: int32-exact)."""
    p, inv, c16 = _prime_consts(plan, s_ll.dim(), s_ll.device)
    r_mid = modular.barrett_reduce(s_mid, p, inv)
    r_mid = modular.barrett_reduce(r_mid * 256, p, inv)
    r_hh = modular.barrett_reduce(s_hh, p, inv)
    r_hh = modular.barrett_reduce(r_hh * c16, p, inv)
    return modular.barrett_reduce(s_ll + r_mid + r_hh, p, inv)


def mac_shared(plan: NttPlan, dhat: torch.Tensor,
               ghat: torch.Tensor) -> torch.Tensor:
    """out[p,m,j,n] = sum_r dhat[p,m,r,n] * ghat[p,r,j,n] (balanced).

    One operand shared by every row m (keygen: one secret key, many
    masks): dhat [P, M, R, N], ghat [P, R, J, N].  R = k <= 4 terms, too
    short a contraction for a matmul (batched over (p, n) it would need an
    N-fold block-diagonal operand), so an unrolled elementwise limb MAC.
    """
    dl, dh = (x.to(I32) for x in modular.to_balanced_limbs2(dhat))
    gl, gh = (x.to(I32) for x in modular.to_balanced_limbs2(ghat.to(I32)))
    P, M, _, n = dhat.shape
    shape = (P, M, ghat.shape[-2], n)
    s_ll, s_mid, s_hh = (torch.zeros(shape, dtype=I32, device=dhat.device)
                         for _ in range(3))
    for r in range(ghat.shape[-3]):
        dlr = dl[:, :, r, None, :]                      # [P,M,1,N]
        dhr = dh[:, :, r, None, :]
        glr = gl[:, None, r]                            # [P,1,J,N]
        ghr = gh[:, None, r]
        s_ll.addcmul_(dlr, glr)
        s_mid.addcmul_(dlr, ghr).addcmul_(dhr, glr)
        s_hh.addcmul_(dhr, ghr)
    return _combine_limb_dots(plan, s_ll, s_mid, s_hh)


def mac_batched(plan: NttPlan, dhat: torch.Tensor,
                ghat: torch.Tensor) -> torch.Tensor:
    """out[p,b,f,j,n] = sum_r dhat[p,b,f,r,n] * ghat[p,b,r,j,n] (balanced).

    Per-batch GGSW (vertical packing): dhat [P, B, F, R, N]; ghat
    [P, B, R, J, N].  Unrolled elementwise limb MAC over r.
    """
    dl, dh = (x.to(I32) for x in modular.to_balanced_limbs2(dhat))
    gl, gh = (x.to(I32) for x in modular.to_balanced_limbs2(ghat.to(I32)))
    P, B, F, _, n = dhat.shape
    shape = (P, B, F, ghat.shape[-2], n)
    s_ll, s_mid, s_hh = (torch.zeros(shape, dtype=I32, device=dhat.device)
                         for _ in range(3))
    for r in range(ghat.shape[-3]):
        dlr = dl[..., r, None, :]                       # [P,B,F,1,N]
        dhr = dh[..., r, None, :]
        glr = gl[..., r, :, :][..., None, :, :]         # [P,B,1,J,N]
        ghr = gh[..., r, :, :][..., None, :, :]
        s_ll.addcmul_(dlr, glr)
        s_mid.addcmul_(dlr, ghr).addcmul_(dhr, glr)
        s_hh.addcmul_(dhr, ghr)
    return _combine_limb_dots(plan, s_ll, s_mid, s_hh)


def mac_rows(plan: NttPlan, dl: torch.Tensor, dh: torch.Tensor,
             g_rows: torch.Tensor, j_out: int) -> torch.Tensor:
    """NTT-domain external-product MAC against row-major key limbs.

    dl, dh: int8 [P, B, R, N] (dhat limbs); g_rows: int8 [P, R*2J, N]
    (row r*2J + j: lo limb of component j, + J: hi limb).  Returns
    balanced int32 [P, B, J, N].  The contraction over r is an unrolled
    elementwise sum (R <= 25 terms of int8 x int8 stay < 2^20).
    """
    pcount, rr2j, n = g_rows.shape
    g = g_rows.reshape(pcount, rr2j // (2 * j_out), 2 * j_out, n).to(I32)
    dl, dh = dl.to(I32), dh.to(I32)
    shape = (pcount, dl.shape[1], 2 * j_out, n)
    s_lo = torch.zeros(shape, dtype=I32, device=dl.device)
    s_hi = torch.zeros(shape, dtype=I32, device=dl.device)
    for r in range(g.shape[1]):
        gr = g[:, None, r]                              # [P, 1, 2J, N]
        s_lo.addcmul_(dl[:, :, r, None, :], gr)         # [P, B, 2J, N]
        s_hi.addcmul_(dh[:, :, r, None, :], gr)
    return _combine_limb_dots(plan, s_lo[..., :j_out, :],
                              s_lo[..., j_out:, :] + s_hi[..., :j_out, :],
                              s_hi[..., j_out:, :])


def barrett_rotate_delta(plan: NttPlan, prod: torch.Tensor, tw: torch.Tensor,
                         p_c, inv_c) -> torch.Tensor:
    """(X^a - 1) * prod in the NTT domain: balanced((tw - 1) . prod).

    prod: balanced int32 [P, B, J, N]; tw: balanced twiddles [P, B, N].
    """
    t = tw[:, :, None, :] * prod - prod
    return modular.barrett_reduce(t, p_c, inv_c)


def intt_crt_u64(plan: NttPlan, res: torch.Tensor,
                 inv_crt_limbs: torch.Tensor) -> torch.Tensor:
    """Inverse NTT + explicit-CRT reconstruction -> u64 words (int64) [..., N].

    res: balanced int32 [P, ..., N].  Per prime z_k = (x * c_k) mod p_k, and
        x mod 2^q = sum_k z_k * (M/p_k)  -  round(sum_k z_k/p_k) * M.
    """
    acc = alpha_fx = None
    for k in range(plan.n_primes):
        p = int(plan.p_i32[k])
        ip = float(plan.inv_f32[k])
        z = _apply_limb_matrices(split2(res[k]), inv_crt_limbs, k, p, ip)
        z = modular.barrett_reduce(z, p, ip)
        y = torch.where(z < 0, z + p, z).to(torch.int64)   # canonical [0,p)
        term = y * torus.signed(int(plan.mk64[k]))
        afx = y * int(plan.fp[k])
        acc = term if acc is None else acc + term
        alpha_fx = afx if alpha_fx is None else alpha_fx + afx
    alpha = (alpha_fx + (1 << (plan.fp_shift - 1))) >> plan.fp_shift
    acc = acc - alpha * torus.signed(int(plan.m64))
    if plan.q_bits < 64:
        acc = acc & ((1 << plan.q_bits) - 1)
    return acc


def u64_to_residues(plan: NttPlan, x: torch.Tensor) -> torch.Tensor:
    """u64 words (int64) -> balanced residues int32 [P, ...], via 8 signed
    8-bit limbs dotted with (2^(8i) mod p): |sum| < 2^25, one Barrett."""
    limbs = []
    carry = torch.zeros_like(x)
    for i in range(8):
        t = (torus.shr(x, 8 * i) & 0xFF) + carry
        c = (t >= 128).to(torch.int64)
        limbs.append((t - (c << 8)).to(I32))
        carry = c
    lim = torch.stack(limbs, dim=-1)                      # int32 [..., 8]
    pow2 = torch.as_tensor(plan.pow2_8i, device=x.device)
    return _per_prime(plan, lambda k, p, ip: modular.barrett_reduce(
        (lim * pow2[k]).sum(dim=-1, dtype=I32), p, ip))
