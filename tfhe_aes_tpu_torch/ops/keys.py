"""Evaluation keys: host numpy keygen + packing -> torch device layouts.

Counterpart of tfhe_aes_tpu/ops/keys.py.  The packers are the same numpy
code (re-homed here because that module imports jax), so the same secret
keys and RNG give the same staged words; ``DeviceKeys`` holds the same
leaves in the same layouts, as torch tensors, with an explicit ``.to``.
The leaves that depend only on the parameters (the NTT matrices and
twiddles, CONSTANT_LEAVES) are made once per device and shared by every
key set there (``constant_leaves``), so the kernels' tiles of them
(ops/cuda_build.derived) are made once too.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.distributed as dist

from .. import runtime
from ..backend import numpy_backend as nb
from ..params import ParamSet
from ..utils import crt
from ..utils import device as device_mod
from . import modular, ntt

# Names of the tensor leaves, in the order of tfhe_aes_tpu.ops.keys.DeviceKeys.
KEY_LEAVES = ("bsk_limbs", "ksk_limbs", "pfpksk_limbs", "fwd_limbs",
              "inv_crt_limbs", "rfwd_limbs", "rinv_crt_limbs", "fwd_full",
              "inv_crt_full", "rot_table", "vp_fwd3", "vp_inv_full")
# The key material, and the leaves made from the plans alone.
MATERIAL_LEAVES = KEY_LEAVES[:3]
CONSTANT_LEAVES = KEY_LEAVES[3:]


@dataclasses.dataclass(frozen=True)
class ContractionShard:
    """This rank's share of the keyswitch keys' contraction rows, made by
    parallel.mesh.shard_keys: the keys hold only rows `ksk_rows` of
    ksk_limbs and `pfpksk_rows` of pfpksk_limbs, and every int8 product
    against them is summed over `group`.

    split_batch: each rank of `group` holds a batch of its own (of one
    size on every rank) rather than the same batch (split_batch_keys).
    """
    group: object
    ksk_rows: slice
    pfpksk_rows: slice
    split_batch: bool = False

    def agree_min(self, n: int, device: torch.device) -> int:
        """The least of every rank's n over the group: a size that the
        group's ranks must all use, whatever each one chose alone."""
        t = torch.tensor([n], dtype=torch.int64, device=device)
        dist.all_reduce(t, op=dist.ReduceOp.MIN, group=self.group)
        return int(t.item())

    def int8_dot(self, digits: torch.Tensor, key_limbs: torch.Tensor,
                 rows: slice) -> torch.Tensor:
        """[M, T] int8 digits against this rank's key rows `rows` of the
        T, summed over the group: the whole product [M, C] int32 (exact:
        every partial sum is a sum of the whole product's terms, which
        fits int32)."""
        if self.split_batch:
            n = dist.get_world_size(self.group)
            whole = digits.new_empty((n * digits.shape[0],)
                                     + tuple(digits.shape[1:]))
            dist.all_gather_into_tensor(whole, digits.contiguous(),
                                        group=self.group)
            digits = whole
        m = ntt.int8_dot(digits[:, rows], key_limbs)
        dist.all_reduce(m, group=self.group)
        if self.split_batch:
            m = m.chunk(n)[dist.get_rank(self.group)]
        return m


@dataclasses.dataclass
class DeviceKeys:
    """Evaluation keys as torch tensors plus host metadata.

    `plan` is the mod-2^64 torus-domain NTT plan (CBS staging, vertical
    packing); `rplan` the mod-2^q' rotate-domain plan (blind rotate).
    `shard` is set only on keys whose contraction rows are split over a
    mesh (parallel.mesh.shard_keys); it is not a key leaf.
    """
    params: ParamSet
    plan: ntt.NttPlan
    rplan: ntt.NttPlan
    bsk_limbs: torch.Tensor       # int8  [n_pad, R*2(k+1), Pr*N]
    ksk_limbs: torch.Tensor       # int8  [big*ks_lev, (n+1)*8]
    pfpksk_limbs: torch.Tensor    # int8  [(big+1)*pfks_lev, (k+1)^2*N*8]
    fwd_limbs: torch.Tensor       # int8  [P, 2, 2, N, N]   (64-domain)
    inv_crt_limbs: torch.Tensor   # int8  [P, 2, 2, N, N]   (64-domain)
    rfwd_limbs: torch.Tensor      # int8  [Pr, 2, 2, N, N]  (rotate)
    rinv_crt_limbs: torch.Tensor  # int8  [Pr, 2, 2, N, N]  (rotate)
    fwd_full: torch.Tensor        # int8  [dn, 2*Pr*N] (ntt.fwd_cat_for)
    inv_crt_full: torch.Tensor    # int8  [Pr, 2N, 2N]
    rot_table: torch.Tensor       # int16 [2N, Pr*N]
    vp_fwd3: torch.Tensor         # int8  [3N, 2*P*N]
    vp_inv_full: torch.Tensor     # int8  [P, 2N, 2N]
    shard: ContractionShard | None = None

    @property
    def device(self) -> torch.device:
        return self.bsk_limbs.device

    @functools.cached_property
    def split_batch_keys(self) -> "DeviceKeys":
        """These keys with their shard's split_batch set (each rank of the
        shard's group holds a batch of its own), made once a key set: a
        graph is held by the key object it ran on (ops/graphs.py), so
        every round of every call must pass the same one."""
        return dataclasses.replace(self, shard=dataclasses.replace(
            self.shard, split_batch=True))

    def to(self, device) -> "DeviceKeys":
        """A copy with every tensor leaf on `device`: the key material
        copied, the constant leaves the ones shared there."""
        return dataclasses.replace(
            self, **constant_leaves(self.plan, self.rplan, self.params,
                                    device),
            **{name: getattr(self, name).to(device)
               for name in MATERIAL_LEAVES})


def poly_to_ntt_residues_host(primes, polys_u64: np.ndarray,
                              q_bits: int = 64) -> np.ndarray:
    """mod-2^q_bits polys [..., N] -> balanced NTT residues [P, ..., N].

    The BALANCED representative (x - 2^q if x >= 2^(q-1)); for q < 64 the
    mod-2^64 residue path is reused by scaling x by 2^(64-q) and unscaling
    the residues, through the native runtime.
    """
    n = polys_u64.shape[-1]
    flat = np.ascontiguousarray(polys_u64, dtype=np.uint64).reshape(-1, n)
    if q_bits < 64:
        flat = flat << np.uint64(64 - q_bits)
    outs = []
    for p in primes:
        res = runtime.balanced_residues(flat, p)
        if q_bits < 64:
            inv2 = pow(pow(2, 64 - q_bits, p), p - 2, p)
            res = modular.host_balanced(
                res.astype(np.int64) * inv2, p).astype(np.int32)
        mat, _ = crt.ntt_matrices(p, n)
        out = runtime.ntt_rows_mod(res, mat.astype(np.int32), p)
        outs.append(out.reshape(polys_u64.shape))
    return np.stack(outs)


def round_to_q(v_u64: np.ndarray, q_bits: int) -> np.ndarray:
    """round(v / 2^(64-q)) mod 2^q (the u64 wrap is the reduction)."""
    if q_bits >= 64:
        return v_u64
    h = np.uint64(1) << np.uint64(63 - q_bits)
    return (v_u64 + h) >> np.uint64(64 - q_bits)


def cancel_mask_rounding(rows_u64: np.ndarray, glwe_key: np.ndarray,
                         q_bits: int) -> np.ndarray:
    """Fold each GLWE row's mask rounding errors into its body (exact):
    b += sum_u e_u (*) S_u with e_u = round_to_q(a_u)*2^(64-q) - a_u."""
    if q_bits >= 64:
        return rows_u64
    rows = np.ascontiguousarray(rows_u64, np.uint64).copy()
    k = glwe_key.shape[0]
    s = np.uint64(64 - q_bits)
    adj = np.zeros(rows.shape[:-2] + rows.shape[-1:], np.float64)
    for u in range(k):
        a = rows[..., u, :]
        e = ((round_to_q(a, q_bits) << s) - a).astype(np.int64)
        adj += e.astype(np.float64) @ nb._negacyclic_matrix(glwe_key[u])
    rows[..., k, :] += adj.astype(np.int64).astype(np.uint64)
    return rows


def pack_bsk(params: ParamSet, rplan: ntt.NttPlan, bsk_u64: np.ndarray,
             glwe_key: np.ndarray | None = None) -> np.ndarray:
    """Golden BSK [n, lev, k+1(u), k+1(j), N] -> [n, Pr, R, k+1, N] int16
    balanced NTT residues of the mod-2^q' rounded key (R = u*lev + l)."""
    n_lwe, lev, kp1, _, n = bsk_u64.shape
    rows = bsk_u64.transpose(0, 2, 1, 3, 4).reshape(n_lwe, kp1 * lev, kp1, n)
    rows = np.ascontiguousarray(rows, np.uint64)
    if glwe_key is not None:
        rows = cancel_mask_rounding(rows, glwe_key, rplan.q_bits)
    rows = round_to_q(rows, rplan.q_bits)
    res = poly_to_ntt_residues_host(rplan.primes, rows, rplan.q_bits)
    return np.ascontiguousarray(res.transpose(1, 0, 2, 3, 4).astype(np.int16))


# Step granularity the staged BSK is zero-padded to (padded steps are
# exact no-ops: a zero GGSW row yields a zero delta).
BSK_STEP_PAD = 16


def bsk_residues_to_device(res16: torch.Tensor) -> torch.Tensor:
    """[n, P, R, k+1, N] int16 -> [n_pad, R*2(k+1), P*N] int8 limb planes,
    on res16's device.

    Row r*2(k+1) + j holds component j's lo limb (hi limb at j + k+1),
    the P primes side by side on the lane axis.
    """
    n_lwe, pcount, r_rows, kp1, n = res16.shape
    x = res16.to(torch.int16)
    hi8 = ((x + 128) >> 8).to(torch.int8)
    lo8 = (x - (hi8.to(torch.int16) << 8)).to(torch.int8)
    cat = torch.cat([lo8, hi8], dim=3)                 # [n,P,R,2(k+1),N]
    rows = cat.reshape(n_lwe, pcount, r_rows * 2 * kp1, n)
    merged = rows.permute(0, 2, 1, 3).reshape(n_lwe, r_rows * 2 * kp1,
                                              pcount * n)
    return pad_bsk_steps(merged)


def pad_bsk_steps(merged: torch.Tensor) -> torch.Tensor:
    """Zero-pad the merged BSK's step axis to a multiple of BSK_STEP_PAD."""
    n_lwe = merged.shape[0]
    n_pad = -(-n_lwe // BSK_STEP_PAD) * BSK_STEP_PAD
    if n_pad == n_lwe:
        return merged.contiguous()
    out = merged.new_zeros((n_pad,) + tuple(merged.shape[1:]))
    out[:n_lwe] = merged
    return out


def pack_ksk(params: ParamSet, ksk_u64: np.ndarray) -> np.ndarray:
    """Golden KSK [big, lev, n+1] -> int8 limbs [big*lev, (n+1)*8]."""
    big, lev, np1 = ksk_u64.shape
    limbs = runtime.signed_limbs(ksk_u64, 8)
    return np.ascontiguousarray(limbs.reshape(big * lev, np1 * 8))


def pack_pfpksk(params: ParamSet, pfpksk_u64: np.ndarray) -> np.ndarray:
    """Golden PFPKSK [k+1, big+1, lev, k+1, N] -> int8 limbs
    [(big+1)*lev, (k+1)_u * (k+1)_j * N * 8]."""
    kp1, bigp1, lev, _, n = pfpksk_u64.shape
    limbs = runtime.signed_limbs(pfpksk_u64, 8)        # [u, t, l, j, N, 8]
    limbs = limbs.transpose(1, 2, 0, 3, 4, 5)          # [t, l, u, j, N, 8]
    return np.ascontiguousarray(
        limbs.reshape(bigp1 * lev, kp1 * kp1 * n * 8))


def make_rotate_plan(p: ParamSet) -> ntt.NttPlan:
    """The blind-rotate plan: mod-2^48 domain, big-prime RNS basis
    (see tfhe_aes_tpu/ops/keys.make_rotate_plan for why 48)."""
    q = max(48, p.pbs_base_log * p.pbs_level)
    primes = crt.rotate_primes(q, p.polynomial_size, p.pbs_base_log,
                               p.glwe_dimension, p.pbs_level)
    return ntt.make_plan(p.polynomial_size, primes, q_bits=q)


def _keys_from_arrays(params: ParamSet, plan: ntt.NttPlan,
                      rplan: ntt.NttPlan, material: dict) -> DeviceKeys:
    """Key material (MATERIAL_LEAVES) and the shared constant leaves on
    the CPU: numpy leaves become CPU tensors, tensor leaves stay where
    they are."""
    return DeviceKeys(
        params=params, plan=plan, rplan=rplan,
        **constant_leaves(plan, rplan, params, "cpu"), **{
            name: material[name] if isinstance(material[name], torch.Tensor)
            else torch.from_numpy(np.ascontiguousarray(material[name]))
            for name in MATERIAL_LEAVES})


def host_leaves(plan: ntt.NttPlan, rplan: ntt.NttPlan, p: ParamSet) -> dict:
    """The key-independent leaves: NTT matrices and twiddles of the plans."""
    return dict(
        fwd_limbs=plan.fwd_limbs,
        inv_crt_limbs=plan.inv_crt_limbs,
        rfwd_limbs=rplan.fwd_limbs,
        rinv_crt_limbs=rplan.inv_crt_limbs,
        fwd_full=ntt.fwd_cat_for(rplan, p.pbs_base_log),
        inv_crt_full=ntt.inv_crt_full_host(rplan),
        rot_table=ntt.rot_table_merged(rplan),
        vp_fwd3=ntt.fwd_cat3_host(plan),
        vp_inv_full=ntt.inv_crt_full_host(plan))


def constant_leaves(plan: ntt.NttPlan, rplan: ntt.NttPlan, p: ParamSet,
                    device) -> dict:
    """The CONSTANT_LEAVES as tensors on `device`, made once per (plans,
    BSK base log, device) and shared by every key set there
    (utils/device.constant: a card's leaves are complete before they are
    published, so a reader on another stream than the maker's needs no
    wait).  Never written."""
    return dict(device_mod.constant(
        ("constant leaves", plan, rplan, p.pbs_base_log), device,
        lambda dev: {name: torch.from_numpy(np.ascontiguousarray(arr)).to(dev)
                     for name, arr in host_leaves(plan, rplan, p).items()}))


def device_keys_shapes(params: ParamSet, device=None) -> DeviceKeys:
    """Keys whose key material is shape and dtype only (meta tensors) and
    whose constant leaves are the shared ones on `device` (default: the
    card; raises without one unless device="cpu").

    Counterpart of tfhe_aes_tpu/ops/keys.device_keys_shapes: the leaves
    of real keys of `params`, before a key bit exists (utils/warmup.py).
    """
    device = device_mod.resolve(device)
    p = params
    plan = ntt.make_plan(p.polynomial_size, crt.ntt_primes())
    rplan = make_rotate_plan(p)
    k, n = p.glwe_dimension, p.polynomial_size
    kp1 = k + 1
    n_pad = -(-p.lwe_dimension // BSK_STEP_PAD) * BSK_STEP_PAD
    shapes = dict(
        bsk_limbs=(n_pad, kp1 * p.pbs_level * 2 * kp1, rplan.n_primes * n),
        ksk_limbs=(p.big_lwe_dimension * p.ks_level,
                   (p.lwe_dimension + 1) * 8),
        pfpksk_limbs=((p.big_lwe_dimension + 1) * p.pfks_level,
                      kp1 * kp1 * n * 8))
    return DeviceKeys(
        params=p, plan=plan, rplan=rplan,
        **constant_leaves(plan, rplan, p, device),
        **{name: torch.empty(shape, dtype=torch.int8, device="meta")
           for name, shape in shapes.items()})


def make_device_keys(sk: nb.SecretKeys, rng: np.random.Generator,
                     primes=None) -> DeviceKeys:
    """Generate (numpy golden) + pack all evaluation keys, on the CPU.

    Draws from `rng` in the order of tfhe_aes_tpu.ops.keys.make_device_keys.
    """
    p = sk.params
    plan = ntt.make_plan(p.polynomial_size, primes or crt.ntt_primes())
    rplan = make_rotate_plan(p)
    bsk = nb.bsk_gen(sk, rng)
    ksk = nb.ksk_gen(sk, rng)
    pfp = nb.pfpksk_gen(sk, rng)
    return _keys_from_arrays(p, plan, rplan, dict(
        bsk_limbs=bsk_residues_to_device(torch.from_numpy(
            pack_bsk(p, rplan, bsk, glwe_key=sk.glwe_key))),
        ksk_limbs=pack_ksk(p, ksk),
        pfpksk_limbs=pack_pfpksk(p, pfp)))


def keys_from_numpy(dkeys) -> DeviceKeys:
    """The JAX package's DeviceKeys -> this package's, on the CPU.

    Its leaves are numpy arrays when made with
    ``Client.make_device_keys(fast=False)``; ``np.asarray`` covers device
    arrays too.  The plans are rebuilt here from the same primes and q,
    and the constant leaves are this package's shared ones of them.
    """
    p = dkeys.params
    plan = ntt.make_plan(dkeys.plan.n, tuple(dkeys.plan.primes),
                         dkeys.plan.q_bits)
    rplan = ntt.make_plan(dkeys.rplan.n, tuple(dkeys.rplan.primes),
                          dkeys.rplan.q_bits)
    return _keys_from_arrays(p, plan, rplan, {
        name: np.asarray(getattr(dkeys, name)) for name in MATERIAL_LEAVES})
