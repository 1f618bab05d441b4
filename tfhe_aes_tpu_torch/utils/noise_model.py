"""Analytic noise model: closed-form variances for the TPU WoPBS pipeline.

Certifies p_fail <= 2^-64 for the MODIFIED scheme this framework ships —
the reference's parameters carry optimizer provenance only for the classic
scheme (reference src/client/client.rs:26-30, README.md:174-180); this
build changes the noise behavior in three ways, each modeled below:

  1. twiddle rotation  acc += (X^a - 1) * (G^-1(acc) (x) BSK_i)
     (ops/blind_rotate.py item 1): BSK noise and decomposition error enter
     through the two-coefficient polynomial (X^a - 1) -> variance x2;
  2. mod-2^48 rotate domain (ops/keys.make_rotate_plan): the BSK is rounded
     once to q' bits at staging with each row's mask rounding errors
     cancelled into its body (keys.cancel_mask_rounding), so the staged row
     phase carries ONLY the body's own uniform +-2^(63-q') residual; the
     input accumulator is rounded once to q' bits on entry;
  3. exact RNS-NTT products (ops/ntt.py): ZERO transform noise, where the
     reference's tfhe-fft f64 path (many_wopbs.rs:263) adds rounding noise
     the optimizer budgeted for.  Every formula here therefore has no
     FFT term — the one place this build is strictly below the classic
     noise model.

Conventions: all variances are in the 2^64 torus scale (same units as
NOISE_REPORT.md's measured sigmas).  Secret keys are uniform binary
(E[s] = 1/2, E[s^2] = 1/2); gadget digits of pseudo-uniform values are
balanced base-B with E[d^2] = B^2/12; a value rounded to a 2^t grid has
uniform error of variance 2^(2t)/12.  The model is CONSERVATIVE: each
heuristic rounds up (e.g. the decomposition-error term is charged on every
blind-rotate step although it only fires when the BSK bit s_i = 1), and
tests/test_noise_model.py pins the prediction within [1, 2.8x] of the
measured sigmas (NOISE_REPORT.md) so it can neither underestimate reality
nor drift into meaningless overestimation.

Failure points certified (the two analog thresholds in the whole pipeline;
vertical-packing rotations are by exact powers X^(+-2^j) and GGSW selector
bits carry additive — not positional — noise, so neither adds a threshold):

  * decryption of a circuit output: bit at delta 2^63, fails iff
    |err| >= 2^62, err at noise level <= max_noise_level (the
    circuit-derived audit utils/noise.py pins the level);
  * a blind-rotate input (extract-bits keyswitch output): the half-torus
    step test polynomial decodes correctly iff the total phase error —
    leveled WoPBS noise + big->small keyswitch + 2N mod-switch — stays
    under 2^62.

p_fail 2^-64 corresponds to 9.15 sigma (erfc(9.15/sqrt(2)) = 6.1e-20, the
reference's published figure, client.rs:27).
"""

from __future__ import annotations

import dataclasses
import math

from ..params import ParamSet

# 2^-64 = erfc(x/sqrt(2)) at x = 9.15 — the sigma multiple decryption
# failure requires (README.md:177, client.rs:26-30).
PFAIL_SIGMAS = 9.15


def _var_round(grid_log2: int) -> float:
    """Variance of a uniform rounding error onto a 2^grid_log2 grid."""
    if grid_log2 <= 0:
        return 0.0
    return 2.0 ** (2 * grid_log2) / 12.0


@dataclasses.dataclass(frozen=True)
class NoiseBudget:
    """log2 sigmas of every stage + the certified failure margins."""
    sigma_bsk_eff: float      # per-coefficient BSK row phase error (staged)
    sigma_pbs: float          # boolean PBS / blind-rotate output
    sigma_ggsw: float         # circuit-bootstrap GGSW rows (PBS + PFPKSK)
    sigma_wopbs: float        # fresh many-LUT WoPBS output (worst: 9-bit)
    sigma_decrypt: float      # at decryption, noise level = max_noise_level
    sigma_pbs_input: float    # at a blind-rotate input (KS + modswitch)
    margin_decrypt: float     # 2^62 / sigma_decrypt, in sigmas
    margin_pbs_input: float   # 2^62 / sigma_pbs_input, in sigmas

    @property
    def certified(self) -> bool:
        return min(self.margin_decrypt, self.margin_pbs_input) >= PFAIL_SIGMAS

    def log2_pfail_per_bit(self) -> float:
        """Upper bound on per-event failure probability (worst margin)."""
        m = min(self.margin_decrypt, self.margin_pbs_input)
        # erfc(m/sqrt(2)) <= exp(-m^2/2):  log2 p <= -m^2/2 * log2(e)
        return -(m * m / 2.0) * math.log2(math.e)


def budget(p: ParamSet, rotate_q_bits: int | None = None,
           vp_steps: int | None = None) -> NoiseBudget:
    """Evaluate the analytic model for one parameter set.

    rotate_q_bits: the blind-rotate accumulator modulus (48 at PARAM_OPT,
    ops/keys.make_rotate_plan); None = derive as the shipped code does.
    vp_steps: CMux layers per vertical packing; default 9 = the deepest LUT
    the AES circuit evaluates (the 9-bit ripple-carry adds, C=2 tree).
    """
    if rotate_q_bits is None:
        rotate_q_bits = max(48, p.pbs_base_log * p.pbs_level)
    if vp_steps is None:
        vp_steps = 9

    n = p.lwe_dimension
    k = p.glwe_dimension
    N = p.polynomial_size
    kN = k * N
    two_n = 2 * N

    s_lwe = p.lwe_noise_std * 2.0 ** 64
    s_glwe = p.glwe_noise_std * 2.0 ** 64

    # -- staged BSK row: key noise + mod-q' body rounding residual ----------
    # (mask rounding errors are cancelled exactly, keys.cancel_mask_rounding)
    var_bsk = s_glwe ** 2 + _var_round(64 - rotate_q_bits)

    # -- blind rotate (the twiddle kernel) ----------------------------------
    # Per step, x2 for the two +-1 coefficients of (X^a - 1):
    #   key term:    l(k+1)N * (B^2/12) * var_bsk        (GGSW row noise)
    #   decomp term: (kN/2 + 1) * var_round              (error x GLWE key;
    #     charged every step although it fires only when s_i = 1 — x2
    #     conservative)
    # plus the one-time entry rounding of the accumulator to q' bits.
    b_pbs = 2.0 ** p.pbs_base_log
    rows = (k + 1) * p.pbs_level
    dec_grid = 64 - p.pbs_base_log * p.pbs_level   # classic shift-8 rounding
    var_pbs = n * 2.0 * (
        rows * N * (b_pbs ** 2 / 12.0) * var_bsk
        + (kN / 2.0 + 1.0) * _var_round(dec_grid)
    ) + (kN / 2.0 + 1.0) * _var_round(63 - rotate_q_bits)

    # -- circuit bootstrap: PBS output through all k+1 PFPKSKs --------------
    b_pf = 2.0 ** p.pfks_base_log
    var_pfpksk = (
        (kN + 1) * p.pfks_level * (b_pf ** 2 / 12.0) * s_glwe ** 2
        + (kN / 2.0 + 1.0) * _var_round(64 - p.pfks_base_log * p.pfks_level)
    )
    var_ggsw = var_pbs + var_pfpksk

    # -- vertical packing: vp_steps CMux external products ------------------
    # (static X^(2^j) rotations are exact; no twiddle factor here)
    b_cbs = 2.0 ** p.cbs_base_log
    var_wopbs = vp_steps * (
        (k + 1) * p.cbs_level * N * (b_cbs ** 2 / 12.0) * var_ggsw
        + (kN / 2.0 + 1.0) * _var_round(64 - p.cbs_base_log * p.cbs_level)
    )

    # -- big->small keyswitch (extract-bits) --------------------------------
    b_ks = 2.0 ** p.ks_base_log
    var_ks = (
        kN * p.ks_level * (b_ks ** 2 / 12.0) * s_lwe ** 2
        + (kN / 2.0) * _var_round(64 - p.ks_base_log * p.ks_level)
    )

    # -- 2N mod-switch at a blind-rotate input ------------------------------
    var_ms = (n / 2.0 + 1.0) * _var_round(int(round(64 - math.log2(two_n))))

    lvl = p.max_noise_level
    var_decrypt = lvl * var_wopbs
    var_pbs_in = lvl * var_wopbs + var_ks + var_ms

    thr = 2.0 ** 62

    def lg(v):
        return 0.5 * math.log2(v) if v > 0 else float("-inf")

    return NoiseBudget(
        sigma_bsk_eff=lg(var_bsk),
        sigma_pbs=lg(var_pbs),
        sigma_ggsw=lg(var_ggsw),
        sigma_wopbs=lg(var_wopbs),
        sigma_decrypt=lg(var_decrypt),
        sigma_pbs_input=lg(var_pbs_in),
        margin_decrypt=thr / math.sqrt(var_decrypt),
        margin_pbs_input=thr / math.sqrt(var_pbs_in),
    )
