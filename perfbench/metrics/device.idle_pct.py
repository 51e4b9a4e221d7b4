"""Share (%) of an untraced step's time in which no device operation ran:
1 - (the traced steps' device busy time a sample, the union of their
operations' intervals) / (the window's seconds a sample). The profiler
slows the host's dispatch, so the traced steps' own wall time would count
its overhead as idle; the device's busy time it leaves as it is."""


def read(run):
    if run.red is None or not run.attempted:
        return None
    busy = run.red["busy_s"] / run.info["samples_traced"]
    step = run.info["window_s"] / run.attempted
    return (1.0 - busy / step) * 100.0
