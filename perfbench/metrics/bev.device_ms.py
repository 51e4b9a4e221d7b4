"""Device ms per frame launched inside the port's `bev/forward` and
`bev/backward` spans: the detector's dense BEV neck (RPN) and its
CenterHead, forward and backward."""
from perfbench.spans import ms_per_sample

BEV = ("bev/forward", "bev/backward")


def read(run):
    return ms_per_sample(run, BEV)
