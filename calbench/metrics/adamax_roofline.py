"""adamax_roofline: the Adamax update's and the carry's share of their bound, %.

Every parameter of every slice, as the frozen layout packs them, read and
written once an update (28 bytes a float32 element, 32 where the slice's
loss improved on its best; ``roofline.adamax_ms``) and the carry's bytes
(``roofline.carry_ms``), summed over the profiled fit's updates, over the
two kernels' measured time (layer: Optimizer and carry).
"""

from calbench import roofline
from calbench import trace

NAMES = ("adamax_step", "descent_carry")


def read(run):
    if run.trace is None:
        return None
    sec, n = trace.group(run.trace, NAMES)
    if not n:
        return None
    per_row = roofline.leaf_elements(run.chunks, run.nants, run.nfreqs)
    updates = sum(ph["adamax_steps"] for ph in run.phases)
    improved = sum(ph["improved"] for ph in run.phases)
    carry = roofline.carry_ms(None if run.mode == "serial" else run.nbatch)
    bound_ms = roofline.adamax_ms(updates * run.nbatch * per_row, improved * per_row) \
        + updates * carry
    return 100.0 * bound_ms / (1e3 * sec)
