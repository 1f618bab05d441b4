"""lut_build_s.dp4: the median host seconds, on rank 0, of a traced
request's counter LUTs (the harness's span luts around
fhe_aes.add_scalar_luts of the request's global counters, which
mesh.sharded_ctr_fn slices): every rank builds all of the request's
LUTs to use its dp share, and its card waits meanwhile.  None where the
trace holds no luts span."""

import statistics


def read(trace):
    spans = [end - start for name, start, end in trace.spans
             if name == "luts"]
    return statistics.median(spans) if spans else None
