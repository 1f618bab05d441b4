"""The torch port's multi-process CTR launcher
(tfhe_aes_tpu_torch.parallel.multihost_ctr) on the CPU: two gloo workers at
PARAM_DRYRUN, each verifying its own block."""

import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from tfhe_aes_tpu_torch.parallel import multihost_ctr

REPO = pathlib.Path(__file__).resolve().parent.parent


def test_two_cpu_workers_verify_every_block():
    r = subprocess.run(
        [sys.executable, "-m", "tfhe_aes_tpu_torch.parallel.multihost_ctr",
         "--procs", "2", "--blocks", "2", "--params", "dryrun",
         "--device", "cpu", "--timeout", "300"],
        capture_output=True, text=True, timeout=360, cwd=REPO,
        env={k: v for k, v in os.environ.items() if k != "RANK"}
        | {"OMP_NUM_THREADS": "1"})
    assert r.returncode == 0, r.stdout + r.stderr
    assert "# procs=2:" in r.stdout
    assert "2/2 blocks verified" in r.stdout, r.stdout
    records = [json.loads(ln) for ln in r.stdout.splitlines()
               if ln.startswith("{")]
    assert sorted(rec["process"] for rec in records) == [0, 1]
    assert all(rec["device"] == "cpu" and rec["procs"] == 2
               for rec in records)
    assert sorted(b for rec in records for b in rec["verified_local"]) == \
        [0, 1]


def test_launcher_wants_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("RANK", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost_ctr.main(["--procs", "1", "--blocks", "1"])


def test_launcher_refuses_more_ranks_than_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.delenv("RANK", raising=False)
    with pytest.raises(ValueError, match="NCCL"):
        multihost_ctr.main(["--procs", "2", "--blocks", "2"])
