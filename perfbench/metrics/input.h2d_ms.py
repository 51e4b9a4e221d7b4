"""Device ms per sample of the copies from host to device in the traced
steps."""


def read(run):
    if run.red is None:
        return None
    return run.red["h2d_s"] * 1e3 / run.info["samples_traced"]
