"""Parameter sets for the TPU-native TFHE/WoPBS stack.

The production set mirrors the reference's ``PARAM_OPT``
(reference src/client/client.rs:31-57): a WoPBS parameter context with
128-bit security and decryption-failure probability ~2^-64, produced by Zama's
concrete-optimizer.  The toy set is for fast unit tests only (no security).

All ciphertexts live on the discretized torus Z_{2^64} (native u64 modulus,
client.rs:55).  Messages are single bits encoded at delta = 2^63
(message_modulus = 2, carry_modulus = 1, no padding bit, client.rs:53-54).
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class ParamSet:
    """One TFHE/WoPBS parameter context.

    Field names follow the reference's ``WopbsParameters``
    (reference src/client/client.rs:31-57).
    """

    name: str
    # -- dimensions --------------------------------------------------------
    lwe_dimension: int          # n: small-LWE mask length
    glwe_dimension: int         # k: number of GLWE mask polynomials
    polynomial_size: int        # N: coefficients per polynomial (power of 2)
    # -- noise (standard deviations relative to the torus, i.e. *2^64) -----
    lwe_noise_std: float
    glwe_noise_std: float
    # -- gadget decompositions ---------------------------------------------
    pbs_base_log: int           # bootstrap key decomposition
    pbs_level: int
    ks_base_log: int            # big->small LWE keyswitch
    ks_level: int
    pfks_base_log: int          # private functional packing keyswitch (CBS)
    pfks_level: int
    cbs_base_log: int           # circuit-bootstrap output GGSW decomposition
    cbs_level: int
    # -- message encoding ---------------------------------------------------
    message_modulus: int = 2
    carry_modulus: int = 1
    # -- noise budget: max leveled additions between bootstraps -------------
    max_noise_level: int = 5    # log norm2 = 5 (client.rs:92, README.md:179)

    # ----------------------------------------------------------------------
    @property
    def big_lwe_dimension(self) -> int:
        """k*N: dimension of LWE samples extracted from GLWE ciphertexts."""
        return self.glwe_dimension * self.polynomial_size

    @property
    def glwe_size(self) -> int:
        return self.glwe_dimension + 1

    @property
    def log2_poly_size(self) -> int:
        return int(math.log2(self.polynomial_size))

    @property
    def message_bits(self) -> int:
        return int(math.log2(self.message_modulus * self.carry_modulus))

    @property
    def delta_log(self) -> int:
        """Bit position of the (single) message bit: delta = 2^63."""
        return 64 - self.message_bits

    def __post_init__(self):
        assert self.polynomial_size & (self.polynomial_size - 1) == 0
        assert self.message_modulus == 2 and self.carry_modulus == 1, (
            "this framework targets the reference's 1-bit-per-block WoPBS "
            "context (client.rs:53-54)")


# Production parameters == reference PARAM_OPT (client.rs:31-57).
# 128-bit security, p_fail = 6.1e-20 ~ 2^-64 (client.rs:26-30).
PARAM_OPT = ParamSet(
    name="PARAM_OPT",
    lwe_dimension=669,
    glwe_dimension=4,
    polynomial_size=512,
    lwe_noise_std=3.0517578125e-05,
    glwe_noise_std=3.162026630747649e-16,
    pbs_base_log=8,
    pbs_level=5,
    ks_base_log=2,
    ks_level=6,
    pfks_base_log=12,
    pfks_level=3,
    cbs_base_log=15,
    cbs_level=1,
)

# TPU-native production parameters: identical SECURITY surface to PARAM_OPT
# (same dimensions and noise distributions -> same 128-bit hardness; those
# are what security depends on) but a coarser bootstrap-key decomposition:
# base 2^12 x 3 levels instead of the reference's 2^8 x 5.  The reference's
# optimizer budgeted for tfhe-fft f64 rounding noise the exact RNS-NTT
# pipeline does not have, which buys decomposition headroom: the analytic
# model (utils/noise_model.py, conservative by ~0.9 bits vs measurement)
# certifies p_fail <= 2^-64 with 12.1/11.5 sigma margins vs the required
# 9.15 (tests/test_noise_model.py pins this).  Why it is faster: the GGSW
# row count (k+1)*pbs_level drops 25 -> 15, which is -40% on the blind-
# rotate MAC — the dominant VPU cost of the whole cipher (PERF.md) — and
# -40% bootstrap-key bytes.  Digits are 12-bit, so the fused kernel feeds
# the forward NTT as two int8 limbs (pallas_blind_rotate 'wide' path).
PARAM_TPU = ParamSet(
    name="PARAM_TPU",
    lwe_dimension=669,
    glwe_dimension=4,
    polynomial_size=512,
    lwe_noise_std=3.0517578125e-05,
    glwe_noise_std=3.162026630747649e-16,
    pbs_base_log=12,
    pbs_level=3,
    ks_base_log=2,
    ks_level=6,
    pfks_base_log=12,
    pfks_level=3,
    cbs_base_log=15,
    cbs_level=1,
)

# Toy parameters: fast, zero security, generous noise margins.  Used by the
# unit-test suite so the full WoPBS/AES pipeline runs in seconds on CPU.
PARAM_TOY = ParamSet(
    name="PARAM_TOY",
    lwe_dimension=32,
    glwe_dimension=2,
    polynomial_size=128,
    lwe_noise_std=2.0 ** -25,
    glwe_noise_std=2.0 ** -40,
    pbs_base_log=8,
    pbs_level=4,
    ks_base_log=4,
    ks_level=4,
    pfks_base_log=12,
    pfks_level=3,
    cbs_base_log=10,
    cbs_level=2,
)

# Toy set exercising the WIDE (pbs_base_log > 8, two-int8-limb digit) blind-
# rotate path that PARAM_TPU uses in production.
PARAM_TOY_WIDE = ParamSet(
    name="PARAM_TOY_WIDE",
    lwe_dimension=32,
    glwe_dimension=2,
    polynomial_size=128,
    lwe_noise_std=2.0 ** -25,
    glwe_noise_std=2.0 ** -40,
    pbs_base_log=12,
    pbs_level=3,
    ks_base_log=4,
    ks_level=4,
    pfks_base_log=12,
    pfks_level=3,
    cbs_base_log=10,
    cbs_level=2,
)

# Slightly larger toy set whose polynomial size matches production (useful for
# testing 8/9-bit LUT vertical packing where lut_size = max(2^bits, N)).
PARAM_TOY_N512 = ParamSet(
    name="PARAM_TOY_N512",
    lwe_dimension=32,
    glwe_dimension=2,
    polynomial_size=512,
    lwe_noise_std=2.0 ** -25,
    glwe_noise_std=2.0 ** -40,
    pbs_base_log=8,
    pbs_level=4,
    ks_base_log=4,
    ks_level=4,
    pfks_base_log=12,
    pfks_level=3,
    cbs_base_log=10,
    cbs_level=2,
)
