"""Parallelism (``rangeclip_tpu/parallel/``): a grid of devices for
data-parallel, class-sharded predict in one process, and a process group for
``--distributed`` training (one process per GPU, by explicit collectives):
JAX's global-batch step, whose kernels combine their per-rank results in
``kernel_shard.py``, or the ``ddp_parity`` step.  JAX's 'spatial' axis and
model-sharded training tables are ROADMAP item 10b."""

from rangeclip_tpu_torch.parallel.mesh import (
    Mesh,
    init_distributed,
    is_main,
    make_mesh,
    rank,
    replicate,
    shard_class_tables,
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
    "shard_class_tables",
    "shard_predict_inputs",
    "world",
]
