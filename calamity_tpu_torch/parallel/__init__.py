"""The batched time-parallel fit and the warm-started time scan of
calamity_tpu_torch (port of calamity_tpu.parallel, one device; the device
mesh is not ported yet)."""

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

__all__ = [
    "BatchedFitResult",
    "batched_chunk_losses",
    "batched_chunk_losses_sum_regularized",
    "batched_fit_checkpointed",
    "batched_fit_core",
    "batched_fit_segment",
    "check_initial_loss",
    "host_batched_losses",
    "loss_guard_factor",
    "loss_guard_floor",
    "scanned_warmstart_fit_core",
]
