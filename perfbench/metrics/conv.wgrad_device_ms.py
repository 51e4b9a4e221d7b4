"""Device ms per scan launched inside the port's `conv/wgrad` spans: the
sparse convs' weight gradients, with their casts to the weight's dtype."""
from perfbench.spans import CONV_WGRAD, ms_per_sample


def read(run):
    return ms_per_sample(run, (CONV_WGRAD,))
