"""K2's NAIS form (its row chain ``mlp_u_z_bwd_rows_nais`` and the
weight-gradient kernel together): % of its bound at the training shape,
N + 1 launches an iteration."""

from benchmark.core.readers import roofline
from benchmark.roofline.nais import k2_work


def read(run):
    launches = (run.cfg["N"] + 1) * run.counts["iterations"]
    return roofline(run, ["mlp_u_z_bwd_rows_nais", "mlp_u_z_bwd_wgrad"], launches,
                    k2_work(run.cfg["layers"], run.mix["M"]))
