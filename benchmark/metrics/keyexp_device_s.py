"""keyexp_device_s: the median device seconds of a traced session's key
schedule, its device span key_expansion from the first mark to the last,
from the program's device marks (tfhe_aes_tpu_torch/utils/profiling.py):
the inside counterpart of keyexp_s.  None where the trace holds no device
record, where the program has no tracing, or where the profile's mark
records are not the marks the program logged."""

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
    spans = profiling.device_seconds(rep, "key_expansion")
    return statistics.median(spans) if spans else None
