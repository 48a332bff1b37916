"""adamax_ms: device ms a recorded step in the Adamax update and the carry.

Every device operation whose name holds ``adamax_step`` or
``descent_carry``, over the profiled fit's recorded steps (layer:
Optimizer and carry).
"""

from calbench import trace

NAMES = ("adamax_step", "descent_carry")


def read(run):
    if run.trace is None:
        return None
    sec, n = trace.group(run.trace, NAMES)
    return 1e3 * sec / run.steps if n else None
