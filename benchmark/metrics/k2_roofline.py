"""K2 (``csrc/mlp_u_z_bwd.cu``, its row chain and weight-gradient kernels
together): % of its bound at the training shape, N + 1 launches an
iteration."""

from benchmark.core.readers import roofline
from benchmark.roofline import k2_work


def read(run):
    launches = (run.cfg["N"] + 1) * run.counts["iterations"]
    return roofline(run, ["mlp_u_z_bwd_rows", "mlp_u_z_bwd_wgrad"], launches,
                    k2_work(run.cfg["layers"], run.mix["M"]))
