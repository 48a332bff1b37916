#!/usr/bin/env python3
"""The readings that a cell's correctness limits are set from, on the card.

    python3 calbench/control.py --workload hera_full.fit1 --seeds 1,2,3 \\
        [--control 0|1] [--faults phase2_frozen,carry_dropped] [--out FILE]

For each seed, in one process: the cell's set-up, one fit of every slice
(the window's own entry, steps and sizes), then, with ``--faults``, one
fit of the first slice (serial) or of the batch (batched) with each fault
of :mod:`faults` planted in turn; then the numbers the run compares
(:data:`harness.NUMBERS`) read for the program's fits against the plain
reference, for each fault's fit, and, with ``--control 1``, for the
control: the reference put in the program's place in the nearest
precision below the configuration's (float32 with every product's
operands in TF32; ``reference.py``), at the program's fitted parameters.
Prints a line a seed and, last, one JSON object: every reading, the
largest of the program's (the lower reading of a limit) and the smallest
of the control's and of each fault's (the upper readings). The
benchmark's runs do not run it.
"""

import time

T_PROCESS = time.perf_counter()  # noqa: E402

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _control_numbers(rows):
    # the control's end_rel at its least over the slices, as if each slice
    # were a run of its own; its other numbers as a run reads them
    from calbench import harness

    got = harness.numbers(rows)
    got["end_rel"] = min(r[1] for r in rows.values())
    return got


def readings(name, seeds, device="cuda", overrides=None, log=print, control=True, faults=()):
    """{seed: {"program": numbers, "control": numbers (with ``control``),
    "faults": {fault: numbers}, "steps_off"}} of a cell, each ``numbers``
    a dict of :data:`harness.NUMBERS`."""
    import torch

    from calbench import faults as fault_mod
    from calbench import harness

    cell = harness.Cell(name)
    out = {}
    for seed in seeds:
        t0 = time.perf_counter()
        ctx = harness.setup(cell, seed, device, overrides, log)
        _, _, last, off, _ = harness.window(ctx, 0.0, min_fits=ctx.nslices
                                            if ctx.mode == "serial" else 1)
        planted = {}
        for fault in faults:
            patches = fault_mod.Patches()
            fault_mod.FAULTS[fault](patches.setattr)
            try:
                gc.collect()
                res = ctx.fits.fit(0)
            finally:
                patches.undo()
            planted[fault] = {s: (res, row) for row, s in enumerate(res.slices)}
        ctx.fits.close()
        ctx.fits = None
        harness.release_collector()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        rec = {"program": harness.numbers(harness.compare(ctx, last, log=log)),
               "steps_off": len(off)}
        if control:
            rec["control"] = _control_numbers(harness.compare(ctx, last, control=True, log=log))
        rec["faults"] = {}
        for fault, fit_last in planted.items():
            log(f"calbench control: {fault}:")
            rec["faults"][fault] = harness.numbers(harness.compare(ctx, fit_last, log=log))
        out[seed] = rec
        log(f"calbench control: {name} seed {seed}: {json.dumps(rec)} "
            f"({time.perf_counter() - t0:.1f} s)")
        del ctx, last, planted
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    return out


def summary(name, got):
    """The lower and upper readings of every number, from :func:`readings`."""
    from calbench import harness

    first = next(iter(got.values()))
    upper = {}
    if "control" in first:
        upper["control"] = {k: min(v["control"][k] for v in got.values())
                            for k in harness.NUMBERS}
    for fault in first["faults"]:
        upper[fault] = {k: min(v["faults"][fault][k] for v in got.values())
                        for k in harness.NUMBERS}
    return {"workload": name, "readings": got,
            "lower": {k: max(v["program"][k] for v in got.values()) for k in harness.NUMBERS},
            "upper": upper}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--control", type=int, choices=(0, 1), default=1)
    ap.add_argument("--faults", default="", help="comma-separated names of calbench/faults.py")
    ap.add_argument("--out", default=None, help="also write the JSON summary here")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        sys.exit("calbench control: needs a CUDA card")
    seeds = [int(s) for s in args.seeds.split(",")]
    faults = [f for f in args.faults.split(",") if f]
    got = readings(args.workload, seeds, log=lambda m: print(m, file=sys.stderr, flush=True),
                   control=bool(args.control), faults=faults)
    result = summary(args.workload, got)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(result, fh, indent=1)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
