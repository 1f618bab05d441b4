"""The control on the card: the session cell at its own shapes, the
program as the configuration states it and with the configuration's
control switched on (the bootstrap key's gadget one level shorter), a
short window each.  Runs only with a card:

    python -m pytest --noconftest -m cuda benchmark/tests/test_bench_card.py
"""

from __future__ import annotations

import pytest
import torch

from benchmark import harness

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.parametrize("control", [False, True])
def test_session_cell_control_is_not_correct(card, control):
    cell = harness.load_cell("opt-session-1blk")
    override = None
    if control:
        override = {k: v for k, v in cell.config["control"].items()
                    if k != "why"}
    res = harness.run_cell(cell, 2 ** 31 + 99, 1.0, False, device=card,
                           override=override, log=lambda _: None)
    assert res["correct"] is not control
    share = res["checks"]["noise_share"]["value"]
    assert (share > 1.0) if control else (share < 0.5)
