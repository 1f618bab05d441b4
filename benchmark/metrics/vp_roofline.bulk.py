"""vp_roofline.bulk: the vertical packing kernels (digits, V1, V2)
against their bound for the traced keystream requests."""

from benchmark import reduce


def read(trace):
    return reduce.roofline(trace, "vp")
