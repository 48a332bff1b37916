"""other_kernels_ms: device ms a recorded step outside the named kernels.

Every device operation whose name holds none of ``shared_chunk_loss``,
``gain_products``, ``gain_grad``, ``adamax_step`` and ``descent_carry``:
the torch launches of the loss's glue and autograd, copies and sets
(layer: Loss glue).
"""

from calbench import trace

NAMED = ("shared_chunk_loss", "gain_products", "gain_grad", "adamax_step", "descent_carry")


def read(run):
    if run.trace is None:
        return None
    named, _ = trace.group(run.trace, NAMED)
    total = sum(s for s, _ in run.trace.by_name.values())
    return 1e3 * (total - named) / run.steps
