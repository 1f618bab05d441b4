"""Key cache: secret and packed evaluation keys in one npz file.

Counterpart of tfhe_aes_tpu/utils/serialization.py, one format for both
packages: the same file names, fields and ``KEY_FORMAT``, the same
``TFHE_AES_TPU_CACHE`` directory rule, so a file either package writes
loads in the other to the same keys.  ``load_keys`` returns CPU tensors,
the constant leaves the shared ones (keys.constant_leaves); move them
with ``DeviceKeys.to``.
"""

from __future__ import annotations

import os
import pathlib

import numpy as np
import torch

from ..backend.numpy_backend import SecretKeys
from ..params import (PARAM_OPT, PARAM_TOY, PARAM_TOY_N512, PARAM_TOY_WIDE,
                      PARAM_TPU, ParamSet)
from ..ops import keys as keys_mod
from ..ops import ntt

_PARAM_SETS = {p.name: p for p in (PARAM_OPT, PARAM_TPU, PARAM_TOY,
                                    PARAM_TOY_WIDE, PARAM_TOY_N512)}

# The packed-key layout version (v4: BSK in the mod-2^48 rotate domain
# over the big-prime basis, mask rounding cancelled).
KEY_FORMAT = 4


def default_cache_dir() -> pathlib.Path:
    return pathlib.Path(os.environ.get(
        "TFHE_AES_TPU_CACHE", os.path.expanduser("~/.cache/tfhe_aes_tpu")))


def cache_path(params: ParamSet, seed) -> pathlib.Path:
    """Key-cache location for (params, seed) at KEY_FORMAT."""
    return default_cache_dir() / f"{params.name}_seed{seed}_v{KEY_FORMAT}.npz"


def save_keys(path, sk: SecretKeys, dkeys: keys_mod.DeviceKeys, *,
              interchange: bool = False) -> None:
    """Write secret + packed evaluation keys (atomically: tmp + rename).

    Default: the BSK in its device layout (int8 limb planes), so a load
    does no math.  ``interchange=True``: the BSK as int16 NTT residues
    [n, P, R, k+1, N], independent of the device layout.  Keys sharded
    over a mesh (`dkeys.shard` set) hold only a slice of their keyswitch
    keys and are refused.
    """
    if dkeys.shard is not None:
        raise ValueError("these keys hold one rank's rows of the keyswitch "
                         "keys (parallel.mesh.shard_keys); save the keys "
                         "they were sharded from")
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    if interchange:
        bsk_fields = dict(bsk_ntt=_bsk_limbs_to_residues(dkeys))
    else:
        bsk_fields = dict(bsk_limbs=dkeys.bsk_limbs.cpu().numpy())
    tmp = path.parent / (path.name + ".tmp.npz")
    np.savez(
        tmp,
        params_name=np.array(sk.params.name),
        primes=np.array(dkeys.plan.primes, dtype=np.int64),
        rprimes=np.array(dkeys.rplan.primes, dtype=np.int64),
        q_bits=np.array(dkeys.rplan.q_bits, dtype=np.int64),
        lwe_key=sk.lwe_key,
        glwe_key=sk.glwe_key,
        ksk_limbs=dkeys.ksk_limbs.cpu().numpy(),
        pfpksk_limbs=dkeys.pfpksk_limbs.cpu().numpy(),
        **bsk_fields,
    )
    os.replace(tmp, path)


def _bsk_limbs_to_residues(dkeys: keys_mod.DeviceKeys) -> np.ndarray:
    """The inverse of keys.bsk_residues_to_device."""
    merged = dkeys.bsk_limbs.cpu().numpy()     # [n_pad, R*2(k+1), Pr*N]
    p = dkeys.params
    kp1 = p.glwe_dimension + 1
    n = p.polynomial_size
    pcount = dkeys.rplan.n_primes
    rows = merged.shape[1]
    limbs = (merged[:p.lwe_dimension]          # strip the step padding
             .reshape(p.lwe_dimension, rows, pcount, n)
             .transpose(0, 2, 1, 3)            # [n, P, R*2(k+1), N]
             .astype(np.int16))
    limbs = limbs.reshape(p.lwe_dimension, pcount, rows // (2 * kp1),
                          2 * kp1, n)
    return np.ascontiguousarray(
        limbs[..., :kp1, :] + (limbs[..., kp1:, :] << 8))


def _bsk_to_device_layout(bsk: np.ndarray) -> torch.Tensor:
    """A stored BSK in the merged device layout: the current
    [n_pad, R*2(k+1), P*N] as is, the older per-prime [n, P, R*2(k+1), N]
    merged and step-padded."""
    bsk = torch.from_numpy(np.ascontiguousarray(bsk))
    if bsk.ndim == 3:
        return keys_mod.pad_bsk_steps(bsk)
    n_lwe, pcount, rows, n = bsk.shape
    return keys_mod.pad_bsk_steps(
        bsk.permute(0, 2, 1, 3).reshape(n_lwe, rows, pcount * n))


def load_keys(path) -> tuple[SecretKeys, keys_mod.DeviceKeys]:
    """(secret keys, evaluation keys as CPU tensors) from a cache file."""
    z = np.load(path)
    if "rprimes" not in z.files:
        raise ValueError(
            f"stale key cache {path} (pre-rotate-domain format); regenerate")
    params = _PARAM_SETS[str(z["params_name"])]
    sk = SecretKeys(params, np.asarray(z["lwe_key"]),
                    np.asarray(z["glwe_key"]))
    plan = ntt.make_plan(params.polynomial_size,
                         tuple(int(p) for p in z["primes"]))
    rplan = ntt.make_plan(params.polynomial_size,
                          tuple(int(p) for p in z["rprimes"]),
                          q_bits=int(z["q_bits"]))
    if "bsk_limbs" in z.files:                 # device layout
        bsk_limbs = _bsk_to_device_layout(z["bsk_limbs"])
    else:                                      # interchange: int16 residues
        bsk_limbs = keys_mod.bsk_residues_to_device(
            torch.from_numpy(np.ascontiguousarray(z["bsk_ntt"])))
    return sk, keys_mod._keys_from_arrays(params, plan, rplan, dict(
        bsk_limbs=bsk_limbs,
        ksk_limbs=z["ksk_limbs"],
        pfpksk_limbs=z["pfpksk_limbs"]))
