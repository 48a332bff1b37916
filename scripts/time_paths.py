"""Time one of chip_smoke.py's full-width paths for several checkouts in turns on one card.

    python3 scripts/time_paths.py [--scan] ROOT [ROOT ...]

Each ROOT is the root of a checkout of this repository: this one, or
another commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists. Each runs in a process of its own, in the order
given, so ``OLD NEW NEW OLD`` sets two versions side by side on one card
and shows how far the host clock drifts between runs of the same code.
A run simulates the path's file and calls that checkout's own
``chip_smoke`` phase:

- by default phase 4, the serial path (64 antennas, 1536 channels, 2
  times): ms/step per time and phase, the host seconds of each stage
  (``fit_s`` among them), peak device memory and kernel launches;
- with ``--scan`` phase 8, the warm-started time scan (4 times x 2
  polarizations): steps and ms/step per time, the ``scan_*`` seconds,
  peak device memory and kernel launches.

The kernel library is built on first use, inside the first fit of a
process whose checkout has not built it yet. Every run starts with the
card's name and power limit. Needs a CUDA card.
"""

import os
import subprocess
import sys
import tempfile
import time


def child(root, scan):
    sys.path.insert(0, root)
    os.environ.setdefault("TQDM_DISABLE", "1")
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        sys.exit("a CUDA card is needed")
    print(f"== {root}: {cs.nvidia_smi_line()}", flush=True)
    t0 = time.time()
    with tempfile.TemporaryDirectory(prefix="time_paths_") as tmp:
        path = os.path.join(tmp, "main.uvh5")
        if scan:
            uvd, _ = cs.make_corrupted_file(path, ntimes=cs.TP_NTIMES, npols=cs.TP_NPOLS)
        else:
            # two times: a process's first fit also builds the kernel library
            uvd, comps = cs.make_corrupted_file(path, ntimes=2)
        print(f"  set-up {time.time() - t0:.1f} s (host)", flush=True)
        if scan:
            cs.phase_scan(tmp, {"uvd": uvd, "path": path})
        else:
            cs.phase_main_path(tmp, path, uvd, comps)


def main(argv):
    if len(argv) >= 2 and argv[0] == "--child":
        child(os.path.abspath(argv[-1]), "--scan" in argv[1:-1])
        return 0
    scan = "--scan" in argv
    roots = [a for a in argv if a != "--scan"]
    if not roots:
        print(__doc__, file=sys.stderr)
        return 2
    rc = 0
    for root in roots:
        cmd = [sys.executable, os.path.abspath(__file__), "--child"]
        rc |= subprocess.run(cmd + (["--scan"] if scan else []) + [root]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
