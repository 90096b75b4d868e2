"""Device ms an iteration in operations that are not the port's
hand-written kernels (ATen, cuBLAS, copies and sets)."""

from benchmark.core.readers import HAND_KERNELS


def read(run):
    seconds = sum(s for name, (_, s) in run.trace.kernels.items()
                  if not any(p in name for p in HAND_KERNELS))
    return 1e3 * seconds / run.counts["iterations"]
