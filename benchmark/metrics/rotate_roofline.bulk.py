"""rotate_roofline.bulk: the blind rotation kernels (K1, K2 and the
digit split) against their bound for the traced keystream requests."""

from benchmark import reduce


def read(trace):
    return reduce.roofline(trace, "rotate")
