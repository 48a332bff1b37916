"""shared_loss_ms: device ms a recorded step in the shared-basis loss kernels.

Every device operation whose name holds ``shared_chunk_loss`` (the kernel
and its sliced variant past 64 modes), over the profiled fit's recorded
steps (layer: Loss kernel).
"""

from calbench import trace

NAMES = ("shared_chunk_loss",)


def read(run):
    if run.trace is None:
        return None
    sec, n = trace.group(run.trace, NAMES)
    return 1e3 * sec / run.steps if n else None
