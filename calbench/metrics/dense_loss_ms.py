"""dense_loss_ms: device ms a recorded step in the dense loss kernel.

Every device operation whose name holds ``fused_chunk_loss`` (the kernel
of a chunk whose groups each have their own basis, and its wide-row
variant), over the profiled fit's recorded steps (layer: Dense loss
kernel).
"""

from calbench import trace

NAMES = ("fused_chunk_loss",)


def read(run):
    if run.trace is None:
        return None
    sec, n = trace.group(run.trace, NAMES)
    return 1e3 * sec / run.steps if n else None
