"""rank_skew.dp4: (slowest - fastest) / fastest of the ranks' median
device seconds of a window's mesh.sharded_ctr_fn call (each rank's CUDA
events around its call, sent to rank 0 after the window): how far the
slowest rank, which sets every request's pace, lags.  None on one rank
or without device records."""

from benchmark import reduce


def read(trace):
    return reduce.rank_skew(trace)
