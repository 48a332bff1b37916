"""step_ms.serial: device ms a recorded step of the serial descent.

The union of the device operations' spans over the profiled fit (one
slice's mixed schedule: its warm-up step and captures included), over
its recorded steps (layer: Serial descent).
"""


def read(run):
    if run.trace is None or run.mode != "serial":
        return None
    return 1e3 * run.trace.busy_s / run.steps
