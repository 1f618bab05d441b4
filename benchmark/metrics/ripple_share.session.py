"""ripple_share.session: the share of the traced sessions' one-block CTR
steps (device span ctr_step) that the ripple-carry counter add (its child
ripple_add) takes, from the program's device marks
(tfhe_aes_tpu_torch/utils/profiling.py).  None where the trace holds no
device record, where the program has no tracing, or where the profile's
mark records are not the marks the program logged."""

from tfhe_aes_tpu_torch.utils import profiling


def read(trace):
    report = getattr(profiling, "report", None)
    if report is None or not trace.ops:
        return None
    rep = report()
    if not rep["marks_logged"] \
            or trace.count(profiling.MARK_KERNEL) != rep["marks_logged"]:
        return None
    return profiling.device_share(rep, "ripple_add", "ctr_step")
