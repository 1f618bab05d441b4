"""The one traffic generator: reads a traffic file (benchmark/traffic/<name>
.json) and draws, from the run's seed, everything the program is given.

A traffic file holds:
  blocks_per_request  AES blocks a request;
  key_per_session     false: one session whose key schedule runs in
                      set-up, then requests on it; true: a request is a
                      session, a fresh encrypted key and IV, its key
                      schedule, then its blocks;
  rcon                the key schedule's RCON: "trivial", noiseless
                      encodings (the port's staged schedule); "pk", the
                      server encrypts RCON itself under the client's
                      public key every session (the reference's own
                      schedule, a WoPBS a word);
  op                  what a request runs (absent: "ctr"): "ctr", the
                      keystream of its blocks at consecutive counter
                      offsets (offset 0 in a session); "decrypt", the
                      inverse cipher of its blocks, AES-128 ciphertexts of
                      plaintexts drawn from the seed under the session's
                      key, handed to the program as noiseless encodings
                      (made before the request's clock starts);
  sessions            the sessions drawn at a time: once in set-up, and
                      again whenever the window has used them all (the
                      harness leaves that drawing out of the window);
  checked_schedules   how many sessions' round keys are judged, drawn from
                      the seed among the first 2 x that many;
  trace_requests      the requests a traced run profiles.

The seed draws the binary secret keys, the seed of the program's key
generation, each session's AES key and IV and their LWE encryptions, the
server's randomness (pk RCON) and the plaintexts of decrypt requests, each
from a stream of its own.  The sessions come from one stream, so a seed
gives the same sessions however many draws they take.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .reference import aes, lwe

RCON = ("trivial", "pk")
OPS = ("ctr", "decrypt")


@dataclasses.dataclass
class Session:
    key: int
    iv: int
    enc_key: np.ndarray      # [16, 8, k N + 1] u64, bytes most significant first
    enc_iv: np.ndarray


@dataclasses.dataclass
class Request:
    session: int             # index into Inputs.sessions
    offset: int              # counter offset of the first block (decrypt:
                             # its place in the session's message)
    blocks: int
    plain: np.ndarray | None = None   # decrypt: its plaintexts [blocks, 16]


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
    server_rng: np.random.Generator   # the server's, for pk RCON
    plain_rng: np.random.Generator    # draws decrypt requests' plaintexts

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


def op(traffic: dict) -> str:
    return traffic.get("op", "ctr")


def check(traffic: dict) -> None:
    """Raise on a traffic value the generator does not draw."""
    if traffic["rcon"] not in RCON:
        raise ValueError(f"unknown rcon {traffic['rcon']!r}")
    if op(traffic) not in OPS:
        raise ValueError(f"unknown op {op(traffic)!r}")


def _plain(rng: np.random.Generator, n: int) -> np.ndarray:
    return np.frombuffer(rng.bytes(16 * n), np.uint8).reshape(n, 16)


def make_inputs(params: dict, traffic: dict, seed: int) -> Inputs:
    """Everything the seed decides, drawn on the host in a few bulk
    calls."""
    check(traffic)
    # Streams added later are spawned after the first four, which they
    # leave as they were.
    keys_ss, sess_ss, gen_ss, pick_ss, server_ss, plain_ss = \
        np.random.SeedSequence(seed % (1 << 128)).spawn(6)
    lwe_key, glwe_key = lwe.draw_secret_keys(
        np.random.default_rng(keys_ss), params["lwe_dimension"],
        params["glwe_dimension"], params["polynomial_size"])
    std = params["glwe_noise_std"]
    rng = np.random.default_rng(sess_ss)
    warm = _session(rng, glwe_key.reshape(-1), std)
    n = traffic["blocks_per_request"]
    plain_rng = np.random.default_rng(plain_ss)
    warm_request = Request(0, 0, n, _plain(plain_rng, n)
                           if op(traffic) == "decrypt" else None)
    n_checked = traffic["checked_schedules"]
    pool = 2 * n_checked if traffic["key_per_session"] else 1
    checked = {int(i) for i in np.random.default_rng(pick_ss).choice(
        pool, size=min(n_checked, pool), replace=False)}
    keygen_seed = int(gen_ss.generate_state(1, np.uint64)[0])
    inputs = Inputs(lwe_key, glwe_key, keygen_seed, [], warm, warm_request,
                    checked, rng, std, np.random.default_rng(server_ss),
                    plain_rng)
    if traffic["key_per_session"]:
        inputs.draw(max(traffic["sessions"], pool))
    else:
        inputs.sessions = [warm]
    return inputs


def requests(traffic: dict, inputs: Inputs):
    """The window's requests, one after another, for as long as asked; a
    session request may name a session not drawn yet (Inputs.draw)."""
    n = traffic["blocks_per_request"]
    decrypt = op(traffic) == "decrypt"
    offset = inputs.warm_request.blocks
    j = 0
    while True:
        plain = _plain(inputs.plain_rng, n) if decrypt else None
        if traffic["key_per_session"]:
            yield Request(j, 0, n, plain)
        else:
            yield Request(0, offset, n, plain)
            offset += n
        j += 1


def ciphertexts(session: Session, req: Request) -> np.ndarray:
    """A decrypt request's input: AES-128 of its plaintexts under the
    session's key, public, lifted as noiseless encodings (mask 0, the body
    a bit times 2^63) [blocks, 16, 8, k N + 1] u64, bytes most significant
    first."""
    cts = aes.encrypt_blocks(aes.key_expansion(session.key), req.plain)
    out = np.zeros(cts.shape + session.enc_key.shape[1:], np.uint64)
    out[..., -1] = aes.bits_of(cts).astype(np.uint64) << np.uint64(63)
    return out
