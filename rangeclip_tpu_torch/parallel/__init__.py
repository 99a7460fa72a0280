"""Parallelism (``rangeclip_tpu/parallel/``): a grid of devices for
data-parallel, class-sharded predict in one process, and a process group for
``--distributed`` training (one process per GPU; gradients and BatchNorm
statistics mean-all-reduced by explicit collectives).  JAX's global-batch
partitioning of the kernels (``kernel_shard.py``) and its 'spatial' axis are
ROADMAP item 10b."""

from rangeclip_tpu_torch.parallel.mesh import (
    Mesh,
    init_distributed,
    is_main,
    make_mesh,
    rank,
    replicate,
    world,
)
from rangeclip_tpu_torch.parallel.predict import (
    make_sharded_predict,
    pad_class_table,
    shard_predict_inputs,
)

__all__ = [
    "Mesh",
    "init_distributed",
    "is_main",
    "make_mesh",
    "make_sharded_predict",
    "pad_class_table",
    "rank",
    "replicate",
    "shard_predict_inputs",
    "world",
]
