"""% of the card's peak in the configuration's precision that the whole
NAIS-Net training step reaches: model FLOPs an iteration
(``roofline.nais.train_nais_flops``: 12F at each point and the blocks'
projections) times the iterations of the traced window, over its seconds."""

from benchmark.roofline import PEAK_FLOPS
from benchmark.roofline.nais import train_nais_flops


def read(run):
    flops = train_nais_flops(run.cfg["layers"], run.mix["M"], run.cfg["N"]) \
        * run.counts["iterations"]
    return 100.0 * flops / run.trace.window_s / PEAK_FLOPS[run.cfg["precision"]]
