"""K3 (``csrc/rollout.cu``): % of its bound, one launch a request of M
paths and N steps."""

from benchmark.core.readers import roofline
from benchmark.roofline import k3_work


def read(run):
    return roofline(run, ["rollout_kernel"], run.counts["requests"],
                    k3_work(run.cfg["layers"], run.mix["M"], run.cfg["N"]))
