"""Mean host ms of a served request inside the program, traced: the
``dnnpde.serve.request`` span of ``ServedSolution.u_and_grad_device``, its
inputs and the graph's dispatch, with no synchronize."""

from benchmark.metrics._spans import mean_ms


def read(run):
    return mean_ms("dnnpde.serve.request")
