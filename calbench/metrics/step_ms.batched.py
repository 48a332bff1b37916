"""step_ms.batched: device ms a recorded batch step of the batched descent.

The union of the device operations' spans over the profiled fit (every
slice's mixed schedule in one descent a phase, warm-up steps and captures
included), over its recorded batch steps (layer: Batched descent).
"""


def read(run):
    if run.trace is None or run.mode != "batched":
        return None
    return 1e3 * run.trace.busy_s / run.steps
