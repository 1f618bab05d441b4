"""The least time the card could take for the work of a cell: the bounds of
the two hand-written kernels, from the cell's shapes alone.

Bound = max(int8 operations / the int8 peak, bytes / the memory rate), on
the published dense peaks of one H100 SXM at its 700 W limit (a card set
lower says so in its power limit, which the harness prints).  The
representation of the design that the count prices is frozen here: the
rotation's residue products over 5 CRT primes (its mod-2^48 domain), the
packing's over 6 (mod 2^64), int8 limbs, a digit of a base above 2^8 fed
as two limbs.  It is
not read from the program, so the count reads the same work whatever
implements it; a kernel with a cheaper transform may read over 100% of
it, and the benchmark is then rebased.

The work of a circuit is its list of many-LUT WoPBS, each (bytes, LUT
outputs L, bits a byte): each runs one blind rotation of bytes x bits x
cbs_level LWE bits and vertical packing of bytes x L accumulators over
`bits` selector bits.
"""

from __future__ import annotations

PEAK_INT8_OPS = 1979e12     # int8 operations a second, dense
PEAK_BYTES = 3.35e12        # HBM bytes a second
ROTATE_PRIMES = 5           # CRT primes of the rotation's products
VP_PRIMES = 6               # and of vertical packing's
ROTATE_KERNELS = ("br_decompose_kernel", "br_forward_mac_kernel",
                  "br_inverse_crt_kernel")
VP_KERNELS = ("vp_digits_kernel", "vp_forward_mac_kernel",
              "vp_inverse_crt_kernel")


def _bound(ops: float, nbytes: float) -> float:
    return max(ops / PEAK_INT8_OPS, nbytes / PEAK_BYTES)


def rotate_seconds(p: dict, n_bits: int) -> float:
    """A blind rotation of n_bits LWE bits: per step the forward product
    [bits R, dn] x [dn, 2 P N] and P inverse products [bits (k+1), 2N] x
    [2N, 2N] (int8, R = (k+1) levels GGSW rows, dn = N, or 2N for two
    limbs a digit); it reads the LWE batch, the test polynomial, a step's
    BSK rows each step, the NTT matrices and twiddles, and writes the
    accumulators."""
    n, kp1 = p["polynomial_size"], p["glwe_dimension"] + 1
    rows, steps = kp1 * p["pbs_level"], p["lwe_dimension"]
    pc = ROTATE_PRIMES
    pn = pc * n
    dn = 2 * n if p["pbs_base_log"] > 8 else n
    ops = steps * (2 * n_bits * rows * dn * 2 * pn
                   + 2 * n_bits * kp1 * 2 * n * 2 * n * pc)
    nbytes = (n_bits * (steps + 1) * 8 + kp1 * n * 8
              + steps * rows * 2 * kp1 * pn + dn * 2 * pn
              + pc * 4 * n * n + 2 * n * pn * 2 + n_bits * kp1 * n * 8)
    return _bound(ops, nbytes)


def vp_seconds(p: dict, n_bytes: int, luts: int, nbits: int) -> float:
    """Vertical packing of n_bytes x luts accumulators over nbits selector
    bits: per bit the forward product [M, 2N] x [2N, 2 P N] (a digit as two
    int8 limbs) and P inverse products [M, 2N] x [2N, 2N], M = n_bytes
    luts (k+1); it reads and writes the accumulators and reads the GGSW
    residues and the NTT matrices."""
    n, kp1, pc = p["polynomial_size"], p["glwe_dimension"] + 1, VP_PRIMES
    m, pn = n_bytes * luts * kp1, pc * n
    ops = nbits * (2 * m * 2 * n * 2 * pn + 2 * m * 2 * n * 2 * n * pc)
    nbytes = (2 * m * n * 8 + nbits * pc * n_bytes * kp1 * kp1 * n * 4
              + 2 * n * 2 * pn + pc * 4 * n * n)
    return _bound(ops, nbytes)


def ctr_step_wopbs(blocks: int) -> list[tuple[int, int, int]]:
    """A CTR keystream request of `blocks` blocks: the ripple-carry counter
    add (an 8-bit step, then 15 of 9 bits, each {sum, carry} = 9 LUTs a
    byte), 9 rounds of the fused {S-box, x2, x3} stack (24 LUTs) and the
    last round's S-box (8), over 16 bytes a block."""
    return ([(blocks, 9, 8)] + [(blocks, 9, 9)] * 15
            + [(16 * blocks, 24, 8)] * 9 + [(16 * blocks, 8, 8)])


def decrypt_wopbs(blocks: int) -> list[tuple[int, int, int]]:
    """The inverse cipher of `blocks` blocks: 9 rounds of the inverse S-box
    (8 LUTs), then, past the round key, the {x9, x11, x13, x14} stack of
    InvMixColumns (32), and the last round's inverse S-box, over 16 bytes
    a block."""
    return ([(16 * blocks, 8, 8), (16 * blocks, 32, 8)] * 9
            + [(16 * blocks, 8, 8)])


def key_expansion_wopbs(rcon: str = "trivial") -> list[tuple[int, int, int]]:
    """The homomorphic key schedule.  Trivial RCON: the S-box of RotWord's
    4 bytes (a program may pad it to a round's shape: its padding is not
    work the inputs need), then 10 rounds of 16 bytes with the {identity,
    S-box} stack (16 LUTs).  RCON encrypted under the public key ("pk"),
    the reference's schedule: a round the S-box of RotWord's 4 bytes, then
    the identity of the new words' bytes, the last word's 4 after the
    other 12 (fresh RCON would put it over the noise budget)."""
    if rcon == "pk":
        return [(4, 8, 8), (12, 8, 8), (4, 8, 8)] * 10
    return [(4, 8, 8)] + [(16, 16, 8)] * 10


def work(p: dict, wopbs: list) -> dict:
    """The bounds of a list of WoPBS, in seconds, and the launches of each
    kernel that they take: a rotation launches its forward and inverse
    kernels once a step, vertical packing its three once a selector bit."""
    bits = [b * nbits * p["cbs_level"] for b, _, nbits in wopbs]
    return {"rotate_s": sum(rotate_seconds(p, n) for n in bits),
            "vp_s": sum(vp_seconds(p, b, luts, nbits)
                        for b, luts, nbits in wopbs),
            "rotate_calls": len(wopbs),
            "rotate_steps": len(wopbs) * p["lwe_dimension"],
            "vp_bits": sum(nbits for _, _, nbits in wopbs)}
