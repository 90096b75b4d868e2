"""K1's NAIS form (``mlp_u_z_fwd_nais_kernel``): % of its bound at the
training shape, B = M rows a launch, N + 1 launches an iteration."""

from benchmark.core.readers import roofline
from benchmark.roofline.nais import k1_work


def read(run):
    launches = (run.cfg["N"] + 1) * run.counts["iterations"]
    return roofline(run, ["mlp_u_z_fwd_nais_kernel"], launches,
                    k1_work(run.cfg["layers"], run.mix["M"]))
