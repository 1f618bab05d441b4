"""Measured noise study: decrypt-phase error of the port's bootstraps.

    python -m tfhe_aes_tpu_torch.noise_study [--params {prod,tpu,toy}]
        [--pbs 4096] [--wopbs-bytes 512] [--classic N] [--seed 0]
        [--device {cuda,cpu}] [--out PATH]

Counterpart of scripts/noise_study.py (its bare ``tpu`` argument is
accepted as ``--params tpu``).  On the keys of the key cache
(utils/serialization.cache_path(params, seed), else device keygen saved
there) it measures the signed phase error of

  * boolean PBS (blind rotate + sample extract), --pbs bits in one batch;
  * the many-LUT WoPBS (keyswitch -> circuit bootstrap -> vertical
    packing) of the identity LUT on --wopbs-bytes bytes: the fresh
    ciphertexts the AES circuit consumes;
  * with --classic N > 0 (default 8, 0 at tpu): N bootstraps of the
    golden model's classic CMux (backend/numpy_backend: mod 2^64, the
    rotated difference decomposed, no BSK rounding) on the host, every
    accumulator coefficient a sample: the baseline that the device
    rotate's two deltas, the twiddle rotation and the mod-2^q_bits rotate
    domain (q_bits from the keys' rotate plan), are measured against.

Budget: the parameter set promises p_fail ~ 2^-64 a bootstrap, which for
Gaussian phase error needs sigma <= 2^62 / 9.15 at the decryption
threshold 2^62; circuit outputs sit at noise level <= 5 (five summed fresh
ciphertexts), so fresh outputs need sigma <= 2^62 / 9.15 / sqrt(5) =
2^57.65.  Both measured sigmas must stay at or under it; without classic
samples they must also stay at or under the analytic model
(utils/noise_model.budget).  The exit code is 0 when they do, else 1.

The report goes to --out, by default NOISE_REPORT_H100_<set>.md at the
repo root (NOISE_REPORT_CPU_<set>.md on the CPU); its Device line is the
card's name and power limit as nvidia-smi gives them, or "cpu".  The run
uses the card unless --device cpu, and raises without one.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

from .backend import numpy_backend as nb
from .cli import PARAMS, client_and_keys
from .models import luts
from .ops import cbs, wopbs
from .params import ParamSet
from .utils import device as device_mod
from .utils import noise_model, torus

REPO = pathlib.Path(__file__).resolve().parent.parent
U64 = np.uint64

# erfc(y) = 6.1e-20  =>  y ~ 6.47;  |e|/sigma threshold = y*sqrt(2) ~ 9.15
SIGMA_FACTOR = 9.15
THRESHOLD = 2.0 ** 62          # decryption succeeds while |e| < 2^62
MAX_LEVEL = 5                  # <=5 leveled additions between bootstraps
BUDGET_FRESH = math.log2(THRESHOLD / SIGMA_FACTOR / math.sqrt(MAX_LEVEL))
RNG_SEED = 123                 # the draws of the reference's study


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def signed_err(phase_u64: np.ndarray, want_u64: np.ndarray) -> np.ndarray:
    return (phase_u64 - want_u64).astype(np.int64).astype(np.float64)


def pbs_inputs(p: ParamSet, sk, n: int, rng) -> tuple[np.ndarray, np.ndarray]:
    """(bits, small-LWE encryptions of bits at delta 2^63) of a PBS batch."""
    bits = rng.integers(0, 2, n).astype(U64)
    return bits, nb.lwe_encrypt(sk.lwe_key, bits << U64(63), p.lwe_noise_std,
                                rng)


def pbs_errors(keys, sk, n: int, rng) -> np.ndarray:
    """Phase errors of n boolean PBS (one batch, output delta 2^62)."""
    bits, small = pbs_inputs(keys.params, sk, n, rng)
    out = torus.to_u64(cbs.pbs_boolean(
        keys, torus.from_u64(small, keys.device), 62))
    return signed_err(nb.lwe_phase(sk.big_lwe_key, out), bits << U64(62))


def wopbs_errors(keys, sk, n_bytes: int, rng) -> np.ndarray:
    """Phase errors of the 8 output bits of n_bytes identity-LUT WoPBS."""
    p = keys.params
    byts = rng.integers(0, 256, n_bytes).astype(np.int64)
    bb = ((byts[:, None] >> np.arange(8)) & 1).astype(U64)
    cts = nb.lwe_encrypt(sk.big_lwe_key, bb << U64(63), p.glwe_noise_std,
                         rng)
    ident = luts.lut_polys_from_tables(
        p, np.arange(256, dtype=np.uint64)[None], 8)
    out = torus.to_u64(wopbs.many_wopbs(
        keys, torus.from_u64(cts, keys.device),
        torus.from_u64(ident, keys.device)))
    return signed_err(nb.lwe_phase(sk.big_lwe_key, out), bb << U64(63))


def classic_errors(sk, n: int, rng) -> np.ndarray:
    """Phase errors of n classic-CMux bootstraps of the golden model, every
    accumulator coefficient a sample: the expected accumulator is
    X^(sum a~_i s_i - b~) * test, computed from sk."""
    p = sk.params
    bits = rng.integers(0, 2, n).astype(U64)
    small = nb.lwe_encrypt(sk.lwe_key, bits << U64(63), p.lwe_noise_std, rng)
    bsk = nb.bsk_gen(sk, np.random.default_rng(0))  # fresh golden BSK
    two_n = 2 * p.polynomial_size
    test = nb.cbs_test_glwe(p, 62)
    errs = []
    t0 = time.perf_counter()
    for i in range(n):
        ct = small[i].copy()
        ct[-1] += U64(1) << U64(62)                 # half-box offset
        acc = nb.blind_rotate(bsk, ct, test, p.pbs_base_log, p.pbs_level)
        tilde = nb.modswitch(ct, two_n)
        rot = (int((tilde[:-1] * sk.lwe_key.astype(np.int64)).sum())
               - int(tilde[-1])) % two_n
        errs.append(signed_err(nb.glwe_phase(sk.glwe_key, acc),
                               nb.polynomial_rotate(test[-1], rot)))
        log(f"#   classic {i + 1}/{n}: {time.perf_counter() - t0:.1f}s")
    return np.concatenate(errs)


def predicted_device_sigma(p: ParamSet, sig_classic: float,
                           q_bits: int) -> tuple[float, float]:
    """(predicted device-PBS sigma, var_round) from the classic sigma and
    the device rotate's two deltas: the twiddle rotation passes BSK noise
    through (X^a - 1), variance x2; the mod-2^q_bits BSK rounding with
    mask-error cancellation leaves a body-only uniform +-2^(63-q_bits)
    through the same (X^a - 1) product over n steps."""
    r_rows = (p.glwe_dimension + 1) * p.pbs_level
    var_round = (2.0 * p.lwe_dimension * p.polynomial_size * r_rows
                 * ((1 << p.pbs_base_log) ** 2 / 12.0)
                 * ((2.0 ** (64 - q_bits)) ** 2 / 12.0))
    return math.sqrt(2.0 * sig_classic ** 2 + var_round), var_round


@dataclasses.dataclass(frozen=True)
class Stage:
    """One stage's samples, sigma and largest |error|, both in log2."""
    samples: int
    sigma: float
    max_err: float

    @classmethod
    def of(cls, err: np.ndarray) -> "Stage":
        return cls(err.size, math.log2(float(np.std(err))),
                   math.log2(float(np.max(np.abs(err)))))


def budget_ok(p: ParamSet, pbs: Stage, wop: Stage, with_classic: bool) -> bool:
    """The study's checks: both sigmas at or under the fresh budget, and
    without classic samples also at or under the analytic model."""
    ok = pbs.sigma <= BUDGET_FRESH and wop.sigma <= BUDGET_FRESH
    if not with_classic:
        ok = (ok and pbs.sigma <= noise_model.budget(p).sigma_pbs
              and wop.sigma <= noise_model.budget(p, vp_steps=8).sigma_wopbs)
    return ok


def render_report(p: ParamSet, device_line: str, pbs: Stage, wop: Stage,
                  classic: Stage | None = None,
                  q_bits: int | None = None) -> str:
    """The markdown report; `q_bits` (the rotate plan's) is needed with
    classic samples."""
    def row(label, s, margin):
        return (f"| {label} | {s.samples} | {s.sigma:.2f} | {s.max_err:.2f} "
                f"| {BUDGET_FRESH:.2f} | {margin} |")

    wopbs_sig = 2.0 ** wop.sigma
    over = THRESHOLD / wopbs_sig / (SIGMA_FACTOR * math.sqrt(MAX_LEVEL))
    lines = [f"# Measured noise at {p.name} (budget: p_fail ~ 2^-64)", "",
             f"Device: {device_line}", "",
             "| stage | samples | sigma (log2) | max err (log2) | "
             "budget sigma (log2) | margin |", "|---|---|---|---|---|---|",
             row("boolean PBS (device, twiddle)", pbs,
                 f"{BUDGET_FRESH - pbs.sigma:.2f}"),
             row("many-LUT WoPBS output (device)", wop,
                 f"{BUDGET_FRESH - wop.sigma:.2f}")]
    if classic is None:
        lines += [
            "",
            f"Analytic model (utils/noise_model, conservative): sigma_pbs "
            f"2^{noise_model.budget(p).sigma_pbs:.2f}, sigma_wopbs(8-step) "
            f"2^{noise_model.budget(p, vp_steps=8).sigma_wopbs:.2f}; "
            f"measured must sit at or below these.",
            "",
            f"Decryption threshold: 2^62; measured fresh-WoPBS margin "
            f"{THRESHOLD / wopbs_sig:.1f} sigma ({over:.1f}x over the "
            f"level-{MAX_LEVEL} p_fail budget).",
        ]
        return "\n".join(lines) + "\n"
    pred, var_round = predicted_device_sigma(p, 2.0 ** classic.sigma, q_bits)
    lines += [
        row("boolean PBS (golden, classic CMux, mod 2^64)", classic, "—"),
        "",
        f"Decryption threshold: 2^62.  A fresh-WoPBS failure needs "
        f"|err| >= {THRESHOLD / wopbs_sig:.1f} sigma of the measured "
        f"distribution (p_fail needs only >= {SIGMA_FACTOR} sigma after "
        f"{MAX_LEVEL} leveled additions) — measured margin {over:.1f}x over "
        f"the budget.",
        "",
        f"Device-vs-golden decomposition: the device rotate differs from the "
        f"classic mod-2^64 CMux by (a) the twiddle rotation (BSK-noise "
        f"variance x2) and (b) the mod-2^{q_bits} rotate domain (BSK rounded "
        f"to {q_bits} bits at staging with mask-error cancellation + one "
        f"accumulator mod-switch).  Predicted device sigma "
        f"sqrt(2*sigma_classic^2 + var_round) = 2^{math.log2(pred):.2f} "
        f"(var_round = 2^{math.log2(var_round):.2f}); measured "
        f"2^{pbs.sigma:.2f}.  The exact-NTT pipeline has no analog of the "
        f"reference's f64-FFT rounding noise, which the parameter "
        f"optimization already budgets for.",
        "",
        f"Budget model: p_fail 2^-64 needs sigma <= 2^62/9.15 = 2^58.81 at "
        f"decryption; outputs decrypt at noise level <= {MAX_LEVEL} "
        f"(circuit-derived audit, utils/noise.py), so fresh outputs need "
        f"sigma <= 2^{BUDGET_FRESH:.2f}.",
    ]
    return "\n".join(lines) + "\n"


def device_line(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or cpu."""
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]


def default_report_path(p: ParamSet, device: torch.device) -> pathlib.Path:
    kind = "H100" if device.type == "cuda" else "CPU"
    return REPO / f"NOISE_REPORT_{kind}_{p.name}.md"


@dataclasses.dataclass
class Study:
    """One run's samples, verdict and report."""
    pbs: np.ndarray
    wopbs: np.ndarray
    classic: np.ndarray | None
    ok: bool
    report: str


def run(p: ParamSet, *, n_pbs: int = 4096, n_wopbs_bytes: int = 512,
        n_classic: int = 8, seed: int = 0, device=None,
        out: pathlib.Path | None = None) -> Study:
    """The study on the keys of (p, seed); writes the report to `out`
    (default_report_path when None).  `device` is the card unless the
    caller asks for the CPU; raises without a card."""
    device = device_mod.resolve(device)
    client, keys = client_and_keys(p, seed, device, use_cache=True)
    sk = client.sk
    rng = np.random.default_rng(RNG_SEED)

    t0 = time.perf_counter()
    err_pbs = pbs_errors(keys, sk, n_pbs, rng)
    pbs = Stage.of(err_pbs)
    log(f"# PBS x{n_pbs}: {time.perf_counter() - t0:.1f}s  "
        f"sigma=2^{pbs.sigma:.2f}  max=2^{pbs.max_err:.2f}")
    t0 = time.perf_counter()
    err_wop = wopbs_errors(keys, sk, n_wopbs_bytes, rng)
    wop = Stage.of(err_wop)
    log(f"# WoPBS x{n_wopbs_bytes * 8} bits: {time.perf_counter() - t0:.1f}s"
        f"  sigma=2^{wop.sigma:.2f}  max=2^{wop.max_err:.2f}")
    err_c = classic = None
    if n_classic:
        t0 = time.perf_counter()
        err_c = classic_errors(sk, n_classic, rng)
        classic = Stage.of(err_c)
        log(f"# classic CMux x{n_classic} ({err_c.size} coefficient "
            f"samples, golden, host): {time.perf_counter() - t0:.1f}s  "
            f"sigma=2^{classic.sigma:.2f}")

    report = render_report(p, device_line(device), pbs, wop, classic,
                           keys.rplan.q_bits)
    out = default_report_path(p, device) if out is None else pathlib.Path(out)
    out.write_text(report)
    ok = budget_ok(p, pbs, wop, classic is not None)
    return Study(err_pbs, err_wop, err_c, ok, report)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m tfhe_aes_tpu_torch.noise_study",
        description="Measured decrypt-phase noise of boolean PBS and the "
                    "many-LUT WoPBS against the p_fail 2^-64 budget")
    ap.add_argument("legacy", nargs="?", choices=["tpu"],
                    help="the reference script's form of --params tpu")
    ap.add_argument("--params", choices=sorted(PARAMS), default=None,
                    help="prod = PARAM_OPT (default); tpu = PARAM_TPU; "
                         "toy = PARAM_TOY (no security)")
    ap.add_argument("--pbs", type=int, default=4096,
                    help="boolean PBS samples, one batch")
    ap.add_argument("--wopbs-bytes", type=int, default=512,
                    help="identity-LUT WoPBS bytes (8 samples a byte)")
    ap.add_argument("--classic", type=int, default=None,
                    help="golden classic-CMux bootstraps on the host, N "
                         "samples each (default 8, 0 at tpu)")
    ap.add_argument("--seed", type=int, default=0,
                    help="the key cache's seed (keygen's when it is missing)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda needs a card and fails without one; cpu "
                         "runs the plain torch versions")
    ap.add_argument("--out", type=pathlib.Path, default=None,
                    help="report path (default NOISE_REPORT_H100_<set>.md "
                         "at the repo root, _CPU_ on the CPU)")
    args = ap.parse_args(argv)
    if args.legacy and args.params not in (None, "tpu"):
        ap.error(f"'tpu' and --params {args.params} disagree")
    if args.params is None:
        args.params = args.legacy or "prod"
    if args.classic is None:
        args.classic = 0 if args.params == "tpu" else 8
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    study = run(PARAMS[args.params], n_pbs=args.pbs,
                n_wopbs_bytes=args.wopbs_bytes, n_classic=args.classic,
                seed=args.seed, device=args.device, out=args.out)
    print(study.report, flush=True)
    print(f"# budget check: {'PASS' if study.ok else 'FAIL'}", flush=True)
    return 0 if study.ok else 1


if __name__ == "__main__":
    sys.exit(main())
