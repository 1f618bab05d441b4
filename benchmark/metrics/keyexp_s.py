"""keyexp_s: the median host seconds of a session's key schedule, from its
issue to a device fence after it, over the traced run's sessions."""

from benchmark import reduce


def read(trace):
    return reduce.median_keyexp_s(trace)
