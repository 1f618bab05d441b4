"""gather_share.dp4: the share of rank 0's traced device time that its
NCCL records take: the all-gather of the answer (mesh.gather_blocks,
inside the harness's gather span), rank 0's wait there for the slowest
rank included.  The dp-only mesh function's graph holds no collective,
so every NCCL record of the traced request is the gather's.  None where
the trace holds no NCCL record or no gather span."""

from benchmark import reduce


def read(trace):
    return reduce.collective_share(trace, "gather")
