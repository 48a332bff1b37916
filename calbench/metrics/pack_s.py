"""pack_s: host seconds of the port's set-up of the cell's slices.

The harness's clock around ``FitSpec``, the packing of every slice and its
warm start, the device synchronised at the end (layer: Packing).
"""


def read(run):
    return run.pack_s
