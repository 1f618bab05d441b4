"""The one traffic generator: reads a traffic file (benchmark/traffic/<name>
.json) and draws, from the run's seed, everything the program is given.

A traffic file holds:
  blocks_per_request  keystream blocks a request;
  key_per_session     false: one session whose key schedule runs in
                      set-up, then keystream requests at consecutive
                      counter offsets; true: a request is a session, a
                      fresh encrypted key and IV, its key schedule, then
                      its keystream at offset 0;
  rcon                "trivial": the schedule's RCON as noiseless
                      encodings;
  sessions            the sessions drawn at a time: once in set-up, and
                      again whenever the window has used them all (the
                      harness leaves that drawing out of the window);
  checked_schedules   how many sessions' round keys are judged, drawn from
                      the seed among the first 2 x that many;
  trace_requests      the requests a traced run profiles.

The seed draws the binary secret keys, the seed of the program's key
generation, each session's AES key and IV and their LWE encryptions.
The sessions come from one stream, so a seed gives the same sessions
however many draws they take.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .reference import aes, lwe


@dataclasses.dataclass
class Session:
    key: int
    iv: int
    enc_key: np.ndarray      # [16, 8, k N + 1] u64, bytes most significant first
    enc_iv: np.ndarray


@dataclasses.dataclass
class Request:
    session: int             # index into Inputs.sessions
    offset: int              # counter offset of the first block
    blocks: int


@dataclasses.dataclass
class Inputs:
    lwe_key: np.ndarray
    glwe_key: np.ndarray
    keygen_seed: int
    sessions: list           # the window's sessions drawn so far
    warm: Session            # the set-up's session
    warm_request: Request    # the set-up's request, on `warm`
    checked: set             # window sessions whose round keys are judged
    rng: np.random.Generator  # draws further sessions
    std: float               # their noise

    @property
    def big_key(self) -> np.ndarray:
        return self.glwe_key.reshape(-1)

    def draw(self, n: int) -> None:
        """n more sessions for the window."""
        self.sessions += [_session(self.rng, self.big_key, self.std)
                          for _ in range(n)]


def _session(rng: np.random.Generator, key: np.ndarray,
             std: float) -> Session:
    k, iv = (int.from_bytes(rng.bytes(16), "big") for _ in range(2))
    enc = [lwe.encrypt_bits(key, aes.bits_of(aes.to_bytes(x)), std, rng)
           for x in (k, iv)]
    return Session(k, iv, *enc)


def make_inputs(params: dict, traffic: dict, seed: int) -> Inputs:
    """Everything the seed decides, drawn on the host in a few bulk
    calls."""
    if traffic["rcon"] != "trivial":
        raise ValueError(f"unknown rcon {traffic['rcon']!r}")
    keys_ss, sess_ss, gen_ss, pick_ss = np.random.SeedSequence(
        seed % (1 << 128)).spawn(4)
    lwe_key, glwe_key = lwe.draw_secret_keys(
        np.random.default_rng(keys_ss), params["lwe_dimension"],
        params["glwe_dimension"], params["polynomial_size"])
    std = params["glwe_noise_std"]
    rng = np.random.default_rng(sess_ss)
    warm = _session(rng, glwe_key.reshape(-1), std)
    n = traffic["blocks_per_request"]
    warm_request = Request(0, 0, n)
    n_checked = traffic["checked_schedules"]
    pool = 2 * n_checked if traffic["key_per_session"] else 1
    checked = {int(i) for i in np.random.default_rng(pick_ss).choice(
        pool, size=min(n_checked, pool), replace=False)}
    keygen_seed = int(gen_ss.generate_state(1, np.uint64)[0])
    inputs = Inputs(lwe_key, glwe_key, keygen_seed, [], warm, warm_request,
                    checked, rng, std)
    if traffic["key_per_session"]:
        inputs.draw(max(traffic["sessions"], pool))
    else:
        inputs.sessions = [warm]
    return inputs


def requests(traffic: dict, inputs: Inputs):
    """The window's requests, one after another, for as long as asked; a
    session request may name a session not drawn yet (Inputs.draw)."""
    n = traffic["blocks_per_request"]
    offset = inputs.warm_request.blocks
    j = 0
    while True:
        if traffic["key_per_session"]:
            yield Request(j, 0, n)
        else:
            yield Request(0, offset, n)
            offset += n
        j += 1
