"""dense_pack_s: host seconds the set-up spends packing dense chunks.

The port's ``pack.dense`` spans (``solver/tensorize.py``,
``FitSpec.__init__``: a chunk whose groups each have their own basis,
built on the host and uploaded), summed (layer: Packing). Read in a run
on a card; None where the port records no such span.
"""

from calbench import spans


def read(run):
    found = spans.setup_spans(run, "pack.dense")
    return None if found is None else sum(spans.seconds(r) for r in found)
