"""CUDA-graph captures of the training iteration over the whole run, set-up
and window (the program's ``train.graph_captures`` counter): 1 when every
iteration after set-up's first replays the one graph; read where the
program kept ``dnnpde.train`` spans in the traced window."""

from benchmark.metrics._spans import closed, store


def read(run):
    got = store()
    if got is None or not closed(got[0], "dnnpde.train"):
        return None
    return got[1].get("train.graph_captures", 0)
