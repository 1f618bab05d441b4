"""idle_share.bulk: the share of the traced keystream requests in which
the device runs nothing."""

from benchmark import reduce


def read(trace):
    return reduce.idle_share(trace)
