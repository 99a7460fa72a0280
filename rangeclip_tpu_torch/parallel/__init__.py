"""Parallelism (``rangeclip_tpu/parallel/``): a grid of devices for
data-parallel, class-sharded predict in one process, and a process group for
``--distributed`` training (one process per GPU, by explicit collectives):
JAX's global-batch step, whose kernels combine their per-rank results in
``kernel_shard.py``, or the ``ddp_parity`` step.  JAX's three-axis mesh is a
process grid (``mesh.make_grid``: data x spatial x model): the step and
predict run on it, the UNet's layers exchanging halo rows over the
'spatial' axis (``halo.py``) and the class tables split over 'model'."""

from rangeclip_tpu_torch.parallel.mesh import (
    Grid,
    Mesh,
    init_distributed,
    is_main,
    make_grid,
    make_mesh,
    rank,
    replicate,
    shard_class_tables,
    world,
)
from rangeclip_tpu_torch.parallel.predict import (
    gather_label_blocks,
    make_grid_predict,
    make_sharded_predict,
    pad_class_table,
    shard_predict_inputs,
)

__all__ = [
    "Grid",
    "Mesh",
    "gather_label_blocks",
    "init_distributed",
    "is_main",
    "make_grid",
    "make_grid_predict",
    "make_mesh",
    "make_sharded_predict",
    "pad_class_table",
    "rank",
    "replicate",
    "shard_class_tables",
    "shard_predict_inputs",
    "world",
]
