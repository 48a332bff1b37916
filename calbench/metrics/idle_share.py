"""idle_share: share of the profiled fit's wall time with no device operation.

1 - busy / window, the window the profiled fit's span on the host's
clock, the device synchronised at its end (layer: Device).
"""


def read(run):
    if run.trace is None:
        return None
    return 1.0 - run.trace.busy_s / run.trace.window_s
