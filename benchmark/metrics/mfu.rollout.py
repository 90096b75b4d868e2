"""% of the bf16 peak that the rollout reaches: 2·M·(N+1)·F model FLOPs a
request times the requests of the traced window, over its seconds."""

from benchmark.roofline import PEAK_FLOPS, rollout_flops


def read(run):
    flops = rollout_flops(run.cfg["layers"], run.mix["M"], run.cfg["N"]) * run.counts["requests"]
    return 100.0 * flops / run.trace.window_s / PEAK_FLOPS["bf16"]
