"""Device ms per scan launched inside the port's `elk/forward` and
`elk/backward` spans: the whole ELK block, its convs, plans and, under
remat, its replay included."""
from perfbench.spans import ELK, ms_per_sample


def read(run):
    return ms_per_sample(run, ELK)
