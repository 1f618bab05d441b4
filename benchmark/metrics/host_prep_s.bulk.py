"""host_prep_s.bulk: the median host seconds of a traced keystream request
(the program's top-level host span ctr_keystream) before its graph's
replay is launched: the counter LUTs built on the host (luts), their
upload (lut_upload) and the copies into the graph's static buffers
(copy_in), from the program's host spans
(tfhe_aes_tpu_torch/utils/profiling.py).  In this closed loop the device
is idle meanwhile.  None where the trace holds no device record, where
the program has no tracing, or where the profile's mark records are not
the marks the program logged."""

import statistics

from tfhe_aes_tpu_torch.utils import profiling


def read(trace):
    report = getattr(profiling, "report", None)
    if report is None or not trace.ops:
        return None
    rep = report()
    if not rep["marks_logged"] \
            or trace.count(profiling.MARK_KERNEL) != rep["marks_logged"]:
        return None
    prep = profiling.request_seconds(rep, "ctr_keystream",
                                     ("luts", "lut_upload", "copy_in"))
    return statistics.median(prep) if prep else None
