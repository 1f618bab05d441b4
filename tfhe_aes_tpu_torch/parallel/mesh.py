"""Device mesh: FHE-AES CTR over several processes, one device each.

Counterpart of tfhe_aes_tpu/parallel/mesh.py.  The mesh has two axes:

  * 'dp' -- CTR blocks, pure data parallel (no collective in the hot loop);
  * 'mp' -- optionally the keyswitch keys' contraction rows
    (shard_contractions: each int32 partial product is all-reduced over
    'mp'), and the 16 state bytes of each AES round's WoPBS (shard_bytes:
    the outputs are all-gathered over 'mp' before ShiftRows/MixColumns).

GSPMD inserts those collectives in the JAX package; here each one is an
explicit torch.distributed call, on one process per device (torch's
model).  Evaluation keys are broadcast from global rank 0 once, at
staging: the all-gather-at-init pattern.  The CTR function is one
compiled unit a rank, as the JAX package's is one jitted program: on the
card a CUDA graph that holds its NCCL collectives (sharded_ctr_fn).
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..models import fhe_aes
from ..ops.keys import (MATERIAL_LEAVES, ContractionShard, DeviceKeys,
                        constant_leaves)
from ..utils import device as device_mod


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (dp, mp) device mesh seen from one rank."""
    device_mesh: DeviceMesh
    dp_group: dist.ProcessGroup
    mp_group: dist.ProcessGroup
    dp_rank: int
    mp_rank: int
    device: torch.device

    @property
    def shape(self) -> tuple[int, int]:
        return tuple(self.device_mesh.shape)

    @property
    def axis_names(self) -> tuple[str, str]:
        return tuple(self.device_mesh.mesh_dim_names)

    @property
    def n_dp(self) -> int:
        return self.shape[0]

    @property
    def n_mp(self) -> int:
        return self.shape[1]


def make_mesh(n_dp: int | None = None, n_mp: int = 1, device=None,
              backend: str | None = None) -> Mesh:
    """This rank's view of an (n_dp, n_mp) mesh over the process group.

    The process group comes from torchrun's environment (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR, MASTER_PORT) unless one is initialised
    already; its backend is NCCL on the card and gloo on the CPU unless
    `backend` says otherwise.  `device` is the card (cuda:LOCAL_RANK)
    unless the caller asks for the CPU; it raises without a card.
    n_dp defaults to world // n_mp.
    """
    dev = device_mod.resolve(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
        # NCCL binds its communicator to this rank's card.
        dist.init_process_group(
            backend, device_id=dev if backend == "nccl" else None)
    world = dist.get_world_size()
    n_dp = n_dp or world // n_mp
    if n_dp * n_mp != world:
        raise ValueError(f"a {n_dp} x {n_mp} mesh needs {n_dp * n_mp} "
                         f"ranks; the process group has {world}")
    dm = init_device_mesh(dev.type, (n_dp, n_mp),
                          mesh_dim_names=("dp", "mp"))
    return Mesh(device_mesh=dm, dp_group=dm.get_group("dp"),
                mp_group=dm.get_group("mp"),
                dp_rank=dm.get_local_rank("dp"),
                mp_rank=dm.get_local_rank("mp"), device=dev)


def _row_share(t: torch.Tensor, n: int, r: int) -> tuple[slice, torch.Tensor]:
    """Rank r's contiguous rows of t, split n ways as torch.tensor_split
    does (ragged: the first rows % n parts get one more row)."""
    parts = torch.tensor_split(t, n)
    start = sum(p.shape[0] for p in parts[:r])
    return slice(start, start + parts[r].shape[0]), parts[r].clone()


def shard_keys(mesh: Mesh, keys: DeviceKeys,
               shard_contractions: bool = False) -> DeviceKeys:
    """Stage evaluation keys on this rank's device.

    The key material is broadcast from global rank 0, so rank 0's keys
    are the ones every rank uses; the constant leaves are the ones shared
    on this rank's device (keys.constant_leaves: every rank makes the same
    from the same plans).  With shard_contractions, each 'mp' rank keeps
    only its rows of the keyswitch keys' contraction axes (ksk_limbs
    [big*ks_level, ...], pfpksk_limbs [(big+1)*pfks_level, ...]); the
    returned keys' `shard` records the 'mp' group and the rows, and
    keyswitch / packing keyswitch sum their int32 products over 'mp'.
    The BSK stays whole on every rank, as in the JAX package.
    """
    leaves = constant_leaves(keys.plan, keys.rplan, keys.params, mesh.device)
    for name in MATERIAL_LEAVES:
        t = getattr(keys, name).to(mesh.device, copy=True).contiguous()
        dist.broadcast(t, src=0)
        leaves[name] = t
    shard = None
    if shard_contractions:
        ksk_rows, leaves["ksk_limbs"] = _row_share(
            leaves["ksk_limbs"], mesh.n_mp, mesh.mp_rank)
        pfpksk_rows, leaves["pfpksk_limbs"] = _row_share(
            leaves["pfpksk_limbs"], mesh.n_mp, mesh.mp_rank)
        shard = ContractionShard(mesh.mp_group, ksk_rows, pfpksk_rows)
    return dataclasses.replace(keys, shard=shard, **leaves)


def sharded_ctr_fn(mesh: Mesh, keys: DeviceKeys, n_blocks: int,
                   shard_bytes: bool = False):
    """The CTR keystream of n_blocks blocks with the batch split over 'dp'
    (and, with shard_bytes, each AES round's bytes over 'mp').

    Returns fn(round_keys, enc_iv, lut_lsb, luts_rest) -> (blocks, first):
    this rank's blocks [n_blocks / n_dp, 16, 8, big+1] on its device and
    the global index of the first.  The LUT stacks are the global ones of
    fhe_aes.add_scalar_luts (as int64 tensors, on any device); fn slices
    its dp range from them.  The ripple add is dp-only: every 'mp' rank of
    a dp row runs it.

    The counterpart of the JAX mesh's jitted function: fn dispatches one
    unit a rank (fhe_aes.ctr_step_jit on its dp slice, the bytes split
    over 'mp' with shard_bytes), on the card a CUDA graph captured at the
    first call and replayed by later ones, the keys' and the bytes'
    collectives inside it when their groups are NCCL's
    (graphs.capturable).  Over gloo, on the CPU and under armed noise
    checks it runs eagerly.  Every rank of the mesh calls fn in step:
    the first call agrees the WoPBS caps over the keys' shard, then a
    warm-up call on the first block of the slice runs each collective
    once eagerly (NCCL makes a sub-group's communicator at its first
    collective, which a capture cannot).  gather_blocks, outside fn,
    stands for the JAX function's out_shardings.
    """
    if n_blocks % mesh.n_dp:
        raise ValueError(f"{n_blocks} blocks do not split over "
                         f"{mesh.n_dp} dp ranks")
    if shard_bytes and 16 % mesh.n_mp:
        raise ValueError(f"16 state bytes do not split over {mesh.n_mp} "
                         f"mp ranks")
    per = n_blocks // mesh.n_dp
    lo, hi = mesh.dp_rank * per, (mesh.dp_rank + 1) * per
    byte_group = mesh.mp_group if shard_bytes else None

    def fn(round_keys, enc_iv, lut_lsb, luts_rest):
        dev = mesh.device
        return fhe_aes.ctr_step_jit(
            keys, round_keys.to(dev), enc_iv.to(dev), lut_lsb[lo:hi].to(dev),
            luts_rest[:, lo:hi].to(dev), byte_group=byte_group), lo

    return fn


def gather_blocks(mesh: Mesh, local: torch.Tensor) -> torch.Tensor:
    """Every dp rank's blocks, in block order, on every rank."""
    parts = [torch.empty_like(local) for _ in range(mesh.n_dp)]
    dist.all_gather(parts, local.contiguous(), group=mesh.dp_group)
    return torch.cat(parts)
