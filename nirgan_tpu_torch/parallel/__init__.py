"""Data parallelism over ``torch.distributed`` (``parallel/mesh.py``) and
the H-sharded single tile (``parallel/spatial.py``: ``predict_large_tile``,
``predict_tiles_2d`` over a (data, spatial) ``Grid``), counterparts of
``nirgan_tpu/parallel``.  On the CPU the processes join a gloo group
(``initialize_multihost(init_method=..., backend="gloo", device="cpu")``);
on cards, one process a card under ``torchrun --nproc-per-node N``
(``initialize_multihost()``, NCCL)."""

from nirgan_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather,
    all_gather_rows,
    all_reduce_grads,
    all_reduce_sum,
    barrier,
    broadcast_object,
    cli_mesh,
    create_mesh,
    initialize_multihost,
    launched_by_torchrun,
    pad_batch,
    release,
    replicate,
    shard_batch,
    sum_across,
)

__all__ = ["Mesh", "all_gather", "all_gather_rows", "all_reduce_grads", "all_reduce_sum", "barrier",
           "broadcast_object", "cli_mesh", "create_mesh", "initialize_multihost",
           "launched_by_torchrun", "pad_batch", "release", "replicate",
           "shard_batch", "sum_across"]
