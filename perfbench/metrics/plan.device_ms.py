"""Device ms per scan launched inside the port's `sparse/plan` spans: every
kernel-map build (coordinate sorts and dedup, key tables, joins, inverse
maps, weight-gradient work lists), the join sites included."""
from perfbench.spans import PLAN, ms_per_sample


def read(run):
    return ms_per_sample(run, (PLAN,))
