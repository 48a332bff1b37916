"""dense_loss_roofline: the dense loss kernel's share of its bound, %.

The bound (``dense_layout.loss_ms``) of every dense chunk of the
deployment's operators, each baseline with its own operator's modes
(``dense_layout.chunks``), summed over the steps of the profiled fit that
ran the loss, each at its phase's comps precision, over the kernel's
measured time (layer: Dense loss kernel). Nothing where the run's frozen
layout is not that of the configuration the count is frozen for.
"""

from calbench import dense_layout
from calbench import layout
from calbench import trace

NAMES = ("fused_chunk_loss",)


def read(run):
    if run.trace is None:
        return None
    sec, n = trace.group(run.trace, NAMES)
    if not n:
        return None
    op_nvecs, op_sizes = dense_layout.operators(dense_layout.CONFIG, run.nfreqs)
    if layout.chunks(op_nvecs, op_sizes) != list(run.chunks):
        return None
    chunks = dense_layout.chunks(op_nvecs, op_sizes)
    bound_ms = sum(ph["loss_steps"] * sum(
        dense_layout.loss_ms(c, run.nbatch, run.nfreqs, ph["comps_itemsize"], run.wgts_itemsize)
        for c in chunks) for ph in run.phases)
    return 100.0 * bound_ms / (1e3 * sec)
