"""idle_share.session: the share of the traced sessions in which the
device runs nothing."""

from benchmark import reduce


def read(trace):
    return reduce.idle_share(trace)
