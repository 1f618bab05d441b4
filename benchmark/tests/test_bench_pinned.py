"""The cells that were there before the traffic could choose the circuit
draw and price what they drew then: a digest of what each existing traffic
file draws at seed 1 (the inputs and the first three requests), and the
traced work of each existing cell, both computed before the public-key
RCON schedule and the inverse cipher were added."""

from __future__ import annotations

import hashlib
import json

import numpy as np
import pytest

from benchmark import generator, harness

HERE = harness.ROOT / "benchmark"
DIGESTS = {
    "bulk": "6094bbd441b9c7ef96a22d7c120163a4f582057cb8bed76e885c2f7bd602895f",
    "bulk64":
        "8d2e23067d73c07aa58c14a672fd5bac68d3d7fbfadaef3007b2e107f448a1c4",
    "session":
        "878a4c630eb97e8124d48c5b0a3e6a393f4bebe663c5d6b7aad818eb78c47e36"}
BULK16_WORK = {"rotate_s": 1.4123527121948458, "vp_s": 0.030477733045619,
               "rotate_calls": 26, "rotate_steps": 17394, "vp_bits": 223}
WORK = {"opt-ctr-bulk16": BULK16_WORK,
        "opt-session-1blk": {"rotate_s": 0.3393169947165235,
                             "vp_s": 0.0064466401625135564,
                             "rotate_calls": 74, "rotate_steps": 49506,
                             "vp_bits": 622},
        "opt-ctr-dp4": BULK16_WORK}


def digest(inputs: generator.Inputs, requests: list) -> str:
    """SHA-256 over what a run is given, in a fixed order."""
    h = hashlib.sha256()

    def put(*xs):
        for x in xs:
            h.update(np.ascontiguousarray(x).tobytes()
                     if isinstance(x, np.ndarray) else repr(x).encode())

    put(inputs.lwe_key, inputs.glwe_key, inputs.keygen_seed, inputs.std,
        sorted(inputs.checked))
    for s in [inputs.warm] + inputs.sessions:
        put(s.key, s.iv, s.enc_key, s.enc_iv)
    for r in [inputs.warm_request] + requests:
        put(r.session, r.offset, r.blocks)
    return h.hexdigest()


@pytest.mark.parametrize("traffic", sorted(DIGESTS))
def test_existing_traffic_draws_what_it_drew(traffic):
    params = json.loads((HERE / "configs" / "param_opt.json").read_text())[
        "params"]
    tr = json.loads((HERE / "traffic" / f"{traffic}.json").read_text())
    inputs = generator.make_inputs(params, tr, 1)
    reqs = generator.requests(tr, inputs)
    first = [next(reqs) for _ in range(3)]
    assert digest(inputs, first) == DIGESTS[traffic]
    assert all(r.plain is None for r in [inputs.warm_request] + first)


@pytest.mark.parametrize("workload", sorted(WORK))
def test_existing_cells_price_the_work_they_priced(workload):
    cell = harness.load_cell(workload)
    inputs = generator.make_inputs(cell.config["params"], cell.traffic, 1)
    reqs = generator.requests(cell.traffic, inputs)
    traced = [next(reqs) for _ in range(cell.traffic["trace_requests"])]
    assert harness._traced_work(cell, traced) == WORK[workload]
