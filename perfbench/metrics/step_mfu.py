"""The window's counted model FLOPs (`count/work.py`, from the inputs
handed in the window) over the window's seconds times the peak of the
configuration's precision, in %."""


def read(run):
    if "window_flops" not in run.info:
        return None
    return run.info["window_flops"] / (run.info["window_s"]
                                       * run.info["peak_flops"]) * 100.0
