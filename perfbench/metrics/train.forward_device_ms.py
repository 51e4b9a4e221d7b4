"""Device ms per scan launched inside the trainer's forward range."""
from perfbench.trace import seconds_in


def read(run):
    if run.red is None:
        return None
    return seconds_in(run.red, (run.info["forward_range"],)) * 1e3 / run.info[
        "samples_traced"]
