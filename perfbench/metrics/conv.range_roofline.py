"""Share (%) of the sparse convs' least time (each call's larger of its
counted products over the peak and its counted bytes over the HBM
bandwidth, from `count/work.py`) in the device time launched inside the
port's `conv/fwd`, `conv/dgrad` and `conv/wgrad` spans of the traced steps:
the conv work found by its role, whichever kernels run it."""
from perfbench.spans import CONV, seconds_in


def read(run):
    if run.red is None:
        return None
    t = seconds_in(run.red, CONV)
    if not t:
        return None
    return run.info["traced_conv_least_s"] / t * 100.0
