"""gain_kernels_roofline: the gain kernels' share of their bound, %.

The bounds of the products and of their gradient over every chunk's valid
rows (``roofline.gain_products_ms``, ``roofline.gain_grad_ms``), summed
over the steps of the profiled fit that ran the loss, over the kernels'
measured time (layer: Gain products).
"""

from calbench import roofline
from calbench import trace

NAMES = ("gain_products", "gain_grad")


def read(run):
    if run.trace is None:
        return None
    sec, n = trace.group(run.trace, NAMES)
    if not n:
        return None
    per_step = sum(roofline.gain_products_ms(c, run.nbatch, run.nants, run.nfreqs)
                   + roofline.gain_grad_ms(c, run.nbatch, run.nants, run.nfreqs)
                   for c in run.chunks)
    steps = sum(ph["loss_steps"] for ph in run.phases)
    return 100.0 * steps * per_step / (1e3 * sec)
