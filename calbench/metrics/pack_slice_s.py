"""pack_slice_s: host seconds a slice's packing takes.

The port's ``pack.slice`` spans (``FitSpec.pack_data`` with its upload,
``pack_data_into`` on the batched set-up's four threads), their seconds
over their number: thread-seconds a slice (layer: Packing). Read in a run
on a card.
"""

from calbench import spans


def read(run):
    found = spans.setup_spans(run, "pack.slice")
    return None if found is None else sum(spans.seconds(r) for r in found) / len(found)
