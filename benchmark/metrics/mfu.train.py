"""% of the card's peak in the configuration's precision that the whole
training step reaches: model FLOPs an iteration (``roofline.train_flops``)
times the iterations of the traced window, over its seconds."""

from benchmark.roofline import PEAK_FLOPS, train_flops


def read(run):
    flops = train_flops(run.cfg["layers"], run.mix["M"], run.cfg["N"]) * run.counts["iterations"]
    return 100.0 * flops / run.trace.window_s / PEAK_FLOPS[run.cfg["precision"]]
