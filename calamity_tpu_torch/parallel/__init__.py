"""The batched time-parallel fit and the warm-started time scan of
calamity_tpu_torch, on one device or sharded over a ('data', 'bl') device
mesh of processes joined by torch.distributed (port of
calamity_tpu.parallel)."""

from .batched import (
    BatchedFitResult,
    batched_chunk_losses,
    batched_chunk_losses_sum_regularized,
    batched_fit_checkpointed,
    batched_fit_core,
    batched_fit_segment,
    check_initial_loss,
    host_batched_losses,
    loss_guard_factor,
    loss_guard_floor,
    scanned_warmstart_fit_core,
)
from .mesh import MeshShard, fit_shardings, make_mesh, shard_chunk

__all__ = [
    "BatchedFitResult",
    "MeshShard",
    "batched_chunk_losses",
    "batched_chunk_losses_sum_regularized",
    "batched_fit_checkpointed",
    "batched_fit_core",
    "batched_fit_segment",
    "check_initial_loss",
    "fit_shardings",
    "host_batched_losses",
    "loss_guard_factor",
    "loss_guard_floor",
    "make_mesh",
    "scanned_warmstart_fit_core",
    "shard_chunk",
]
