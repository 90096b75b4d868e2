"""Mean host ms of a rollout request inside the program, traced: the
``dnnpde.rollout.request`` span of ``predict_paths_fast``, to the return of
K3's launch (the read-back to the host is the caller's)."""

from benchmark.metrics._spans import mean_ms


def read(run):
    return mean_ms("dnnpde.rollout.request")
