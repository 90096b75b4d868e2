"""Device-busy ms per million served states in the traced window."""


def read(run):
    return 1e3 * run.trace.busy_s / (run.counts["states"] / 1e6)
