"""The benchmark of ``dnnpde_tpu_torch`` on one NVIDIA H100 (see README.md).

Nothing here imports the port at import time; the drivers import it inside
the functions that run a cell.
"""
