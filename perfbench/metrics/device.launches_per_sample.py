"""Device operations (kernels, copies, fills) per sample in the traced
steps."""


def read(run):
    if run.red is None:
        return None
    return run.red["n_launches"] / run.info["samples_traced"]
