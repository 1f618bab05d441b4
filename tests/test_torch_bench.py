"""The torch port's bench entry (tfhe_aes_tpu_torch/bench.py) on the CPU at
PARAM_DRYRUN: its JSON line, its refusal without a card, and the key-cache
write that outlives a failed verification."""

import json
import time

import pytest
import torch

from tfhe_aes_tpu_torch import bench
from tfhe_aes_tpu_torch.client.client import Client
from tfhe_aes_tpu_torch.parallel.multihost_ctr import tiny_params
from tfhe_aes_tpu_torch.server import Server
from tfhe_aes_tpu_torch.utils import serialization

torch.set_num_threads(1)

# The keys of the root bench.py's JSON line.
JAX_KEYS = {"metric", "value", "unit", "vs_baseline", "params", "blocks"}


@pytest.fixture
def cache_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("TFHE_AES_TPU_CACHE", str(tmp_path))
    return tmp_path


def test_run_cpu_prints_the_json_line_and_verifies(cache_dir, capsys):
    record = bench.run(tiny_params(), blocks=1, repeats=1, device="cpu")
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert line == record
    assert set(line) == JAX_KEYS | {"device"}
    assert line["device"] == "cpu"
    assert line["metric"] == "aes128_ctr_blocks_per_min"
    assert line["params"] == "PARAM_DRYRUN" and line["blocks"] == 1
    assert line["value"] > 0 and line["unit"] == "blocks/min"
    assert "# verified 1 blocks bit-exact" in err
    assert serialization.cache_path(tiny_params(), 0).exists()


def test_cuda_without_a_card_raises(cache_dir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--params", "toy", "--blocks", "1"])
    assert not list(cache_dir.iterdir())


def test_failed_verify_still_writes_the_cache(cache_dir, monkeypatch):
    """Verification raises while the key-cache save is still running: the
    save completes and leaves no temporary file."""
    save = serialization.save_keys

    def slow_save(*args, **kwargs):
        time.sleep(1.0)
        save(*args, **kwargs)

    def fake_keystream(self, rks, enc_iv, n_blocks, offset=0):
        return enc_iv[None].expand((n_blocks,) + enc_iv.shape).clone()

    def bad_verify(*args, **kwargs):
        raise AssertionError("CTR block 0 differs")

    monkeypatch.setattr(serialization, "save_keys", slow_save)
    monkeypatch.setattr(Server, "aes_key_expansion",
                        lambda self, k: k[None].expand((11,) + k.shape))
    monkeypatch.setattr(Server, "ctr_keystream", fake_keystream)
    monkeypatch.setattr(Client, "fetch_and_verify_ctr", bad_verify)
    with pytest.raises(AssertionError, match="differs"):
        bench.run(tiny_params(), blocks=1, repeats=1, device="cpu")
    assert serialization.cache_path(tiny_params(), 0).exists()
    assert not list(cache_dir.glob("*.tmp.npz"))
