"""outside_kernels_share.bulk: the share of the traced device time spent
outside the rotate and VP kernels (keyswitch and packing-keyswitch
products, NTT staging, element-wise work)."""

from benchmark import reduce


def read(trace):
    return reduce.outside_kernels_share(trace)
