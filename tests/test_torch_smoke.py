"""What the port does where there is no card (CPU).

The CUDA wrappers refuse CPU tensors instead of running the plain version,
the kernel build refuses to run without nvcc, and chip_smoke.py exits
non-zero, printing no result line, without a CUDA device or without the
rest of the repository.
"""

import dataclasses
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

from tfhe_aes_tpu.params import PARAM_TOY
from tfhe_aes_tpu_torch.client.client import Client
from tfhe_aes_tpu_torch.ops import cuda_blind_rotate, cuda_build, cuda_vp

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
PARAM_TOY_VP = dataclasses.replace(PARAM_TOY, name="PARAM_TOY_VP",
                                   cbs_level=1, cbs_base_log=15)


@pytest.fixture(scope="module")
def toy_keys():
    return Client(PARAM_TOY_VP, seed=11).make_device_keys(fast=False,
                                                          device="cpu")


def test_blind_rotate_wrapper_refuses_cpu_tensors(toy_keys):
    k, p = toy_keys, PARAM_TOY_VP
    lwe = torch.zeros((3, p.lwe_dimension + 1), dtype=torch.int64)
    test = torch.zeros((p.glwe_dimension + 1, p.polynomial_size),
                       dtype=torch.int64)
    before = cuda_blind_rotate.blind_rotate_cuda.launches
    with pytest.raises(ValueError, match="want CUDA"):
        cuda_blind_rotate.blind_rotate_cuda(k.rplan, p, k.bsk_limbs, lwe, test,
                                            k.fwd_full, k.inv_crt_full,
                                            k.rot_table)
    assert cuda_blind_rotate.blind_rotate_cuda.launches == before


def test_vp_wrapper_refuses_cpu_tensors(toy_keys):
    k, p = toy_keys, PARAM_TOY_VP
    kp1, n = p.glwe_dimension + 1, p.polynomial_size
    acc = torch.zeros((2, 8, kp1, n), dtype=torch.int64)
    ggsw = torch.zeros((7, k.plan.n_primes, 2, kp1, kp1, n), dtype=torch.int32)
    before = cuda_vp.vp_rotations_cuda.launches
    with pytest.raises(ValueError, match="want CUDA"):
        cuda_vp.vp_rotations_cuda(k, acc, ggsw)
    assert cuda_vp.vp_rotations_cuda.launches == before


def test_kernel_build_needs_nvcc(monkeypatch):
    monkeypatch.setattr(cuda_build, "_libs", {})
    monkeypatch.setattr(cuda_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(cuda_build.os.path, "exists", lambda _: False)
    monkeypatch.setattr(cuda_build, "BUILD_DIR",
                        REPO / "tfhe_aes_tpu_torch" / "_build" / "absent")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.load("blind_rotate")
    assert not cuda_build.BUILD_DIR.exists()


def _run_smoke(cwd, env):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = _run_smoke(REPO, env)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and '"kernels"' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = _run_smoke(tmp_path, env)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and '"kernels"' not in proc.stdout
