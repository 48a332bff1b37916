"""alloc_calls_per_fit: the caching allocator's device allocations and frees in the profiled fit.

``torch.cuda.memory_stats``' ``num_device_alloc`` + ``num_device_free``
(each a ``cudaMalloc`` or ``cudaFree``), noted by the port at both edges
of each ``fit`` span, the changes summed over the fit (layer: Device).
"""

from calbench import spans


def read(run):
    fit = spans.profiled_fit(run)
    if fit is None:
        return None
    edges = [f.notes.get("allocator_calls") for f in fit[0]]
    if not all(e and len(e) == 2 for e in edges):
        return None
    return sum((a1 - a0) + (f1 - f0) for (a0, f0), (a1, f1) in edges)
