#!/usr/bin/env python3
"""What the port's spans cost: ns per span with the profiler off and on, and spans per fit.

    python3 scripts/span_cost.py [--spans 100000] [--workload hera_core.fit1 --seed 7]

Times a loop of ``--spans`` empty spans (``calamity_tpu_torch._device``'s
``SpanRecorder``) on the host, with ``torch.profiler`` off and then on
(each span then also opens a ``record_function`` range). With
``--workload``, sets up that calbench cell on the card, runs its warm-up
fit, then one fit unprofiled and one profiled, and prints each fit's
spans and seconds, so that the spans' share of a fit is ns per span
times spans over the fit's seconds. Prints one JSON line.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def ns_per_span(n, profiled):
    import torch

    from calamity_tpu_torch._device import SpanRecorder

    rec = SpanRecorder()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts) if profiled else None
    if prof is not None:
        prof.__enter__()
    try:
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with rec.span("probe"):
                pass
        dt = time.perf_counter_ns() - t0
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    return dt / n


def fit_spans(workload, seed):
    """{"unprofiled"|"profiled": (spans, seconds)} of one fit of the cell."""
    import torch

    from calamity_tpu_torch._device import SPANS
    from calbench import harness, trace

    cell = harness.Cell(workload)
    ctx = harness.setup(cell, seed, "cuda", log=lambda m: print(m, file=sys.stderr))
    harness.warm_up(ctx)
    out = {}
    for kind in ("unprofiled", "profiled"):
        SPANS.reset()
        t0 = time.perf_counter()
        if kind == "profiled":
            trace.profiled(lambda: ctx.fits.fit(0))
        else:
            ctx.fits.fit(0)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        recs = SPANS.records()
        fits = {r.index for r in recs if r.name == "fit"}
        out[kind] = {"spans": sum(r.fit in fits for r in recs), "fit_s": seconds,
                     "dropped": SPANS.dropped}
    ctx.fits.close()
    harness.release_collector()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--spans", type=int, default=100_000)
    ap.add_argument("--workload", default=None)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    res = {"torch": torch.__version__,
           "ns_per_span_off": ns_per_span(args.spans, False),
           "ns_per_span_on": ns_per_span(args.spans, True)}
    if args.workload:
        res["workload"] = args.workload
        res.update(fit_spans(args.workload, args.seed))
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
