"""shared_loss_roofline: the shared-basis loss kernels' share of their bound, %.

The bound (``roofline.shared_chunk_ms``) of every chunk of the frozen
layout, summed over the steps of the profiled fit that ran the loss, each
at its phase's comps precision, over the kernels' measured time (layer:
Loss kernel).
"""

from calbench import roofline
from calbench import trace

NAMES = ("shared_chunk_loss",)


def read(run):
    if run.trace is None:
        return None
    sec, n = trace.group(run.trace, NAMES)
    if not n:
        return None
    bound_ms = sum(ph["loss_steps"] * sum(
        roofline.shared_chunk_ms(c, run.nbatch, run.nfreqs, ph["comps_itemsize"],
                                 run.wgts_itemsize) for c in run.chunks)
        for ph in run.phases)
    return 100.0 * bound_ms / (1e3 * sec)
