"""Device ms per scan launched inside the port's `loss/forward` and
`loss/backward` spans: the cross-entropy and Lovasz-softmax criterion."""
from perfbench.spans import LOSS, ms_per_sample


def read(run):
    return ms_per_sample(run, LOSS)
