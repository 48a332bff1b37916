"""gain_kernels_ms: device ms a recorded step in the gain kernels.

Every device operation whose name holds ``gain_products`` or ``gain_grad``,
over the profiled fit's recorded steps (layer: Gain products).
"""

from calbench import trace

NAMES = ("gain_products", "gain_grad")


def read(run):
    if run.trace is None:
        return None
    sec, n = trace.group(run.trace, NAMES)
    return 1e3 * sec / run.steps if n else None
