"""capture_s: the host's seconds in the profiled fit's step-graph captures.

The self time of the fit's ``graph.capture`` spans (``solver/graph.py``,
``StepGraph._capture``: the device drained, the allocator's cache emptied,
the step captured into a CUDA graph), their ``device.sync`` waits taken
out (layer: Step graph).
"""

from calbench import spans


def read(run):
    fit = spans.profiled_fit(run)
    return None if fit is None else spans.self_seconds(fit, "graph.capture")
