"""launches_per_step: device operations of the profiled fit a recorded step.

Kernels, copies and sets, those of CUDA-graph replays included, as the
profiler's trace lists them (layer: Step graph).
"""


def read(run):
    if run.trace is None:
        return None
    return run.trace.ops / run.steps
