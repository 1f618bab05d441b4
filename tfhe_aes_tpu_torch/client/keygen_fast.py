"""Device keygen: the GLWE mask products and the BSK staging on a device.

Counterpart of tfhe_aes_tpu/client/keygen_fast.py.  Masks and noise are
sampled on the host in the JAX order (per call all of ``a``, then ``e``;
the calls in the order BSK, KSK, PFPKSK), so one seed gives the same keys
word for word.  The exact u64 products a_i * S_i run through the RNS-NTT
pipeline of ops/ntt.py on ``device`` in 4096-row chunks; messages and
noise are added on the host, as are the BSK's mask-rounding cancellation
and the KSK.  There is no kernel here: the JAX package computes these
products with XLA dot_general, this one with torch._int_mm (``int8_dot``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..backend import numpy_backend as nb
from ..params import ParamSet
from ..ops import keys as keys_mod
from ..ops import modular, ntt
from ..utils import crt, host_torus, torus
from ..utils import device as device_mod

U64 = np.uint64


def _key_ntt(plan: ntt.NttPlan, glwe_key: np.ndarray, device) -> torch.Tensor:
    """Balanced NTT residues of the GLWE key polynomials: [P, k, 1, N]."""
    shat = np.stack([
        modular.host_balanced(crt.ntt_fwd_host(glwe_key.astype(np.int64), p),
                              p) for p in plan.primes]).astype(np.int32)
    return torch.from_numpy(shat)[:, :, None, :].to(device)


def mask_dot(plan: ntt.NttPlan, a: torch.Tensor, shat: torch.Tensor,
             fwd_limbs: torch.Tensor, inv_crt_limbs: torch.Tensor):
    """a [M, k, N] u64 words -> sum_i a_i * S_i mod 2^64, [M, N] words."""
    res = ntt.u64_to_residues(plan, a)                   # [P, M, k, N]
    ahat = ntt.ntt_fwd_residues(plan, res, fwd_limbs)
    prod = ntt.mac_shared(plan, ahat, shat)              # [P, M, 1, N]
    return ntt.intt_crt_u64(plan, prod, inv_crt_limbs)[:, 0]


def glwe_encrypt_fast(plan: ntt.NttPlan, glwe_key: np.ndarray,
                      msgs: np.ndarray, std: float, rng: np.random.Generator,
                      chunk: int = 4096, device=None) -> np.ndarray:
    """nb.glwe_encrypt with the mask products on `device`:
    msgs [..., N] u64 -> [..., k+1, N] u64."""
    k, n = glwe_key.shape
    lead = msgs.shape[:-1]
    m = int(np.prod(lead)) if lead else 1
    a = rng.integers(0, 1 << 64, size=(m, k, n), dtype=np.uint64)
    e = host_torus.sample_gaussian_torus(rng, std, (m, n))
    device = device_mod.resolve(device)
    shat = _key_ntt(plan, glwe_key, device)
    fwd = torch.from_numpy(plan.fwd_limbs).to(device)
    inv_crt = torch.from_numpy(plan.inv_crt_limbs).to(device)
    b = msgs.reshape(m, n) + e
    for lo in range(0, m, chunk):
        conv = mask_dot(plan, torus.from_u64(a[lo:lo + chunk], device), shat,
                        fwd, inv_crt)
        b[lo:lo + chunk] += torus.to_u64(conv)
    out = np.concatenate([a, b[:, None, :]], axis=1)     # [m, k+1, N]
    return out.reshape(lead + (k + 1, n))


def bsk_gen_fast(sk: nb.SecretKeys, rng: np.random.Generator,
                 plan: ntt.NttPlan, device=None) -> np.ndarray:
    """BSK [n, lev, k+1, k+1, N] u64: GGSW encryptions of the LWE key bits."""
    p = sk.params
    k, n = p.glwe_dimension, p.polynomial_size
    lev = p.pbs_level
    ggsw = glwe_encrypt_fast(
        plan, sk.glwe_key,
        np.zeros((p.lwe_dimension, lev, k + 1, n), np.uint64),
        p.glwe_noise_std, rng, device=device)
    for l in range(lev):
        g = U64((1 << (64 - p.pbs_base_log * (l + 1))) % (1 << 64))
        for u in range(k + 1):
            ggsw[:, l, u, u, 0] += sk.lwe_key * g
    return ggsw


def pfpksk_gen_fast(sk: nb.SecretKeys, rng: np.random.Generator,
                    plan: ntt.NttPlan, device=None) -> np.ndarray:
    """PFPKSK [k+1, big+1, lev, k+1, N] u64 (the circuit bootstrap's
    private functional packing keyswitch keys)."""
    p = sk.params
    k, n = p.glwe_dimension, p.polynomial_size
    big = p.big_lwe_dimension
    bigkey = sk.big_lwe_key
    msgs = np.zeros((k + 1, big + 1, p.pfks_level, n), dtype=np.uint64)
    for u in range(k + 1):
        if u < k:
            sigma = U64(0) - sk.glwe_key[u]
        else:
            sigma = np.zeros(n, dtype=np.uint64)
            sigma[0] = U64(1)
        for l in range(p.pfks_level):
            g = U64((1 << (64 - p.pfks_base_log * (l + 1))) % (1 << 64))
            msgs[u, :big, l] = (U64(0) - bigkey[:, None]) * sigma[None, :] * g
            msgs[u, big, l] = sigma * g
    return glwe_encrypt_fast(plan, sk.glwe_key, msgs, p.glwe_noise_std, rng,
                             device=device)


def stage_bsk_rows(rplan: ntt.NttPlan, x: torch.Tensor,
                   rfwd: torch.Tensor) -> torch.Tensor:
    """BSK rows [M, N] u64 words -> balanced NTT residues [P, M, N] int16
    of the rows rounded to q' bits (as keys.pack_bsk stages them on the
    host): round, residues of the value scaled back by 2^(64-q'), unscale
    by (2^(64-q'))^-1 mod p, forward NTT."""
    q = rplan.q_bits
    if q < 64:
        x = torus.shr(x + (1 << (63 - q)), 64 - q) << (64 - q)
    res = ntt.u64_to_residues(rplan, x)                  # [P, M, N]
    if q < 64:     # |res * inv2| <= (p/2)^2 < 2^30: one Barrett
        inv2 = np.stack([modular.host_balanced(
            pow(pow(2, 64 - q, pk), pk - 2, pk), pk) for pk in rplan.primes])
        sh = (-1, 1, 1)
        res = modular.barrett_reduce(
            res * torch.as_tensor(inv2.astype(np.int32),
                                  device=x.device).reshape(sh),
            torch.as_tensor(rplan.p_i32, device=x.device).reshape(sh),
            torch.as_tensor(rplan.inv_f32, device=x.device).reshape(sh))
    return ntt.ntt_fwd_residues(rplan, res, rfwd).to(torch.int16)


def pack_device_keys(p: ParamSet, glwe_key: np.ndarray, bsk: np.ndarray,
                     ksk: np.ndarray, pfp: np.ndarray, plan: ntt.NttPlan,
                     device=None) -> keys_mod.DeviceKeys:
    """Host keys -> DeviceKeys on `device`, the BSK staged there.

    The mask rounding errors are cancelled into the bodies on the host
    (exact f64 convolutions, keys.cancel_mask_rounding); the rounding to
    q' bits, the residues and the forward NTT run on `device`."""
    device = device_mod.resolve(device)
    rplan = keys_mod.make_rotate_plan(p)
    n_lwe, lev, kp1, _, n = bsk.shape
    rows = bsk.transpose(0, 2, 1, 3, 4).reshape(-1, kp1, n)
    rows = keys_mod.cancel_mask_rounding(rows, glwe_key,
                                         rplan.q_bits).reshape(-1, n)
    rfwd = torch.from_numpy(rplan.fwd_limbs).to(device)
    chunk = 16384
    res = torch.cat([stage_bsk_rows(rplan,
                                    torus.from_u64(rows[lo:lo + chunk],
                                                   device), rfwd)
                     for lo in range(0, rows.shape[0], chunk)], dim=1)
    bsk_ntt = res.reshape(rplan.n_primes, n_lwe, kp1 * lev, kp1,
                          n).permute(1, 0, 2, 3, 4)
    keys = keys_mod._keys_from_arrays(p, plan, rplan, dict(
        bsk_limbs=keys_mod.bsk_residues_to_device(bsk_ntt),
        ksk_limbs=keys_mod.pack_ksk(p, ksk),
        pfpksk_limbs=keys_mod.pack_pfpksk(p, pfp),
        **keys_mod.host_leaves(plan, rplan, p)))
    return keys.to(device)


def make_device_keys_fast(sk: nb.SecretKeys, rng: np.random.Generator,
                          primes=None, device=None) -> keys_mod.DeviceKeys:
    """Device keygen: the same keys as keys.make_device_keys's layout from
    the JAX fast path's draws, every leaf on `device` (default: the card;
    raises without one unless device="cpu")."""
    device = device_mod.resolve(device)
    p = sk.params
    plan = ntt.make_plan(p.polynomial_size, primes or crt.ntt_primes())
    bsk = bsk_gen_fast(sk, rng, plan, device)
    ksk = nb.ksk_gen(sk, rng)
    pfp = pfpksk_gen_fast(sk, rng, plan, device)
    return pack_device_keys(p, sk.glwe_key, bsk, ksk, pfp, plan, device)
