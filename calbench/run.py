#!/usr/bin/env python3
"""Run one cell of the calamity_tpu_torch benchmark on this machine's card.

    python3 calbench/run.py --workload hera_full.fit1 --seed 7 --seconds 30 --trace 0

Run from the root of a checkout. The last line on standard output is the
run's JSON result; everything else goes to standard error, the numbers
compared and their limits last. Exits with a code other than 0, and prints
no result, where the machine has fewer CUDA cards than the cell asks for
or the run loaded a JAX module. See calbench/README.md.
"""

import time

T_PROCESS = time.perf_counter()  # noqa: E402  (set-up is timed from here)

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # the kernel caches of the program and of torch inside the checkout, at
    # fixed paths (the port builds its own library under its _build/)
    cache = os.path.join(HERE, "_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, ROOT)
    from calbench import harness

    code, result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                               T_PROCESS)
    if result is not None:
        print(json.dumps(result), flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
