"""setup_s: seconds from the process start to the end of the warm-up (loading,
building on a checkout's first run, weights, inputs, captures)."""


def read(run):
    return run.setup_s
