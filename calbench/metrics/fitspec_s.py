"""fitspec_s: host seconds the set-up spends building ``FitSpec``.

The port's ``pack.fitspec`` spans (``solver/tensorize.py``,
``FitSpec.__init__``: the chunk layout, its row tables and the basis
uploaded), summed: the set-up builds one and no fit builds another
(layer: Packing). Read in a run on a card.
"""

from calbench import spans


def read(run):
    found = spans.setup_spans(run, "pack.fitspec")
    return None if found is None else sum(spans.seconds(r) for r in found)
