"""Device ms per scan launched inside the port's `conv/fwd` spans: the
sparse conv kernels of the forward, whichever kernel runs them."""
from perfbench.spans import CONV_FWD, ms_per_sample


def read(run):
    return ms_per_sample(run, (CONV_FWD,))
