"""phase_host_s: the profiled fit's seconds outside its blocks of steps and releases.

The ``fit`` spans' seconds less those their ``descent.steps`` (a block of
up to 16 steps, captures and polls included) and ``graph.release`` spans
cover: the comps' conversion, each phase's entry (buffers, optimizer
state, the batched warm-up step), the polls before a phase's first block
and the readbacks of its history (layer: Descent entry).
"""

from calbench import spans


def read(run):
    fit = spans.profiled_fit(run)
    if fit is None:
        return None
    whole = sum(spans.seconds(f) for f in fit[0])
    return whole - spans.covered_seconds(fit, ("descent.steps", "graph.release"))
