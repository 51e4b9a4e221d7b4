"""Device ms per sample launched inside the port's join-site ranges
(`sparse/join_site`, `sparse/join_inputs`)."""
from perfbench.trace import seconds_in


def read(run):
    if run.red is None:
        return None
    return seconds_in(run.red, run.info["join_ranges"]) * 1e3 / run.info[
        "samples_traced"]
