"""Share (%) of the sparse convs' least time (each call's larger of its
counted products over the peak and its counted bytes over the HBM
bandwidth, from `count/work.py`) in the device time of the conv kernels
(`gather_conv`, `window_conv`, `gather_wgrad` and their weight-fragment
and reduction kernels) of the traced steps."""
from perfbench.trace import seconds_of

CONV_KERNELS = ("gather_conv_kernel", "window_conv_kernel",
                "gather_wgrad_kernel", "w_frag_kernel", "wgrad_reduce_kernel")


def read(run):
    if run.red is None:
        return None
    t = seconds_of(run.red, CONV_KERNELS)
    if t <= 0:
        return None
    return run.info["traced_conv_least_s"] / t * 100.0
