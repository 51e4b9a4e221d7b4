"""Device ms per scan launched inside the trainer's backward range."""
from perfbench.trace import seconds_in


def read(run):
    if run.red is None:
        return None
    return seconds_in(run.red, (run.info["backward_range"],)) * 1e3 / run.info[
        "samples_traced"]
