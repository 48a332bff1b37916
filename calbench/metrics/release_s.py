"""release_s: the host's seconds in the profiled fit's step-graph releases.

The self time of the fit's ``graph.release`` spans (``solver/graph.py``,
``StepGraph.close``: the graph reset and its pool handed back to the
device, once a phase), their ``device.sync`` waits taken out (layer: Step
graph).
"""

from calbench import spans


def read(run):
    fit = spans.profiled_fit(run)
    return None if fit is None else spans.self_seconds(fit, "graph.release")
