"""rotate_roofline.session: the blind rotation kernels against their
bound for the traced sessions (key schedule and one block)."""

from benchmark import reduce


def read(trace):
    return reduce.roofline(trace, "rotate")
