"""Rules of the port (CPU): it imports nothing of the JAX package, its entry
points default to the card, and a kernel library is keyed on every source
file it could include."""

import ast
import pathlib
import shutil

import numpy as np
import pytest
import torch

from tfhe_aes_tpu_torch import cli, noise_study
from tfhe_aes_tpu_torch.client import keygen_fast
from tfhe_aes_tpu_torch.client.client import Client
from tfhe_aes_tpu_torch.ops import cuda_build
from tfhe_aes_tpu_torch.params import PARAM_TOY
from tfhe_aes_tpu_torch.utils import device

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "tfhe_aes_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "tests" / "test_torch_cuda.py",
    REPO / "scripts" / "vp_card_check.py", REPO / "scripts" / "vp_stage_cut.py"]


def _imported_modules(path: pathlib.Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return names


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_file_imports_no_jax_package(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("tfhe_aes_tpu", "jax", "jaxlib")]
    assert not bad, f"{path.name} imports {bad}"


@pytest.mark.parametrize("entry", ["client", "keygen_fast", "test_harness",
                                   "noise_study"])
def test_entry_points_default_to_the_card(monkeypatch, entry):
    """With no device given, each entry point wants the card and raises
    when there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    client = Client(PARAM_TOY, seed=1)
    calls = {
        "client": lambda: client.make_device_keys(),
        "keygen_fast": lambda: keygen_fast.make_device_keys_fast(
            client.sk, client.rng),
        "test_harness": lambda: cli.run_test_harness(PARAM_TOY, 0, seed=1,
                                                     use_cache=False),
        "noise_study": lambda: noise_study.main(["--params", "toy"]),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


def test_device_resolution(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert device.resolve() == torch.device("cuda")
    assert device.resolve("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert device.resolve(torch.device("cpu")).type == "cpu"
    with pytest.raises(RuntimeError):
        device.resolve("cuda")


def test_library_path_follows_every_csrc_file(monkeypatch, tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC, csrc)
    monkeypatch.setattr(cuda_build, "CSRC", csrc)
    before = {name: cuda_build.library_path(name)
              for name in ("blind_rotate", "vertical_packing")}
    assert before == {name: cuda_build.library_path(name) for name in before}
    for header in sorted(csrc.glob("*.cuh")):
        text = header.read_text()
        header.write_text(text + "\n// edited\n")
        for name, path in before.items():
            assert cuda_build.library_path(name) != path, (header.name, name)
        header.write_text(text)
    assert before == {name: cuda_build.library_path(name) for name in before}


def test_cpu_keys_stay_on_the_cpu():
    keys = Client(PARAM_TOY, seed=1).make_device_keys(device="cpu")
    assert keys.device.type == "cpu"
    assert np.asarray(keys.bsk_limbs).dtype == np.int8
