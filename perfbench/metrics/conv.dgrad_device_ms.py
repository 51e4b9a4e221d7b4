"""Device ms per scan launched inside the port's `conv/dgrad` spans: the
sparse convs' feature gradients, with their weights' transposes."""
from perfbench.spans import CONV_DGRAD, ms_per_sample


def read(run):
    return ms_per_sample(run, (CONV_DGRAD,))
