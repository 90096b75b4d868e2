"""Mean host ms a rollout request spends before K3's launch, traced: the
``dnnpde.rollout.prepare`` span (the checks, the weights re-laid for the
kernel, x0 onto the device)."""

from benchmark.metrics._spans import mean_ms


def read(run):
    return mean_ms("dnnpde.rollout.prepare")
