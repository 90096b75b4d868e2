"""Meshes and sharding over ``torch.distributed`` ranks: the data-parallel
path axis "dp" and the tensor-parallel model axis "tp", the counterpart of
``dnnpde_tpu/parallel/``."""

from dnnpde_tpu_torch.parallel.model_sharding import (
    TP_AXIS,
    make_mesh_2d,
    plan_tp_specs,
    shard_params_tp,
    tp_sharding_summary,
)
from dnnpde_tpu_torch.parallel.distributed import (
    global_device_summary,
    init_distributed,
    is_multi_host,
)
from dnnpde_tpu_torch.parallel.shard_map_step import make_shard_map_train_step
from dnnpde_tpu_torch.parallel.mesh import (
    DP_AXIS,
    batch_sharding,
    check_divisible,
    make_mesh,
    replicated,
)

__all__ = [
    "DP_AXIS",
    "batch_sharding",
    "check_divisible",
    "make_mesh",
    "replicated",
    "TP_AXIS",
    "make_mesh_2d",
    "plan_tp_specs",
    "shard_params_tp",
    "tp_sharding_summary",
    "make_shard_map_train_step",
    "global_device_summary",
    "init_distributed",
    "is_multi_host",
]
