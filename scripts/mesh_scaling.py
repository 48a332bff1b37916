"""The time-parallel path on one card and sharded over the cards of a node.

    python3 scripts/mesh_scaling.py [--shapes 1x4,4x1] [--device cuda|cpu]
                                    [--nfreqs 1536] [--maxsteps 3000]

Simulates ``chip_smoke.py``'s phase 7 file (64 antennas, 2016 baselines,
4 times x 2 polarizations, 8 slices; ``--nfreqs`` channels) and fits it
with ``read_calibrate_and_model_dpss(time_parallel=True)``: first
unsharded on the first card, then, for each mesh shape ``DxB``, in a world
of D*B processes joined by NCCL, rank r on card r, through
``make_mesh(D, B)``. Each run prints its ms per batch step, ``descent_s``,
the host seconds in collectives, peak device memory and kernel launches
per rank, and the sharded runs are held against the unsharded one as in
``chip_smoke.py`` phase 9 (first 200 losses of every slice within rel
1e-2, resid/data within 2x, steps per slice within 10%). Every line stands
beside the cards' names and power limits.

Needs as many CUDA cards as the largest mesh; ``--device cpu`` runs the
same on the CPU over gloo (at a small ``--nfreqs``, a check of the script).
"""

import argparse
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


def world_fit(rank, nprocs, path, mesh_shape, fit_kw):
    """One rank of a sharded run, on card ``rank`` (or the CPU)."""
    kw = dict(fit_kw)
    if kw["device"] == "cuda":
        kw["device"] = f"cuda:{rank}"
    return cs._mesh_fit(rank, path, None, mesh_shape, kw)


def report(tag, r, card):
    tm = r["timings"]
    steps, secs = tm["phase_steps"], tm["phase_seconds"]
    rates = ", ".join(f"{1e3 * s / max(n, 1):.3f}" for s, n in zip(secs, steps))
    coll = ""
    if "collective_s" in tm:
        coll = (f"; collectives {tm['collective_s']:.2f} s in {tm['collective_calls']} calls "
                f"({1e3 * tm['collective_s'] / max(sum(steps), 1):.3f} ms per recorded step)")
    cs.log(f"  {tag}: ms per batch step (bf16, f32) {rates} over {steps} steps; descent_s "
           f"{tm['descent_s']:.2f}{coll}; peak device memory {r['peak_gb']} GB; launches "
           f"{r['launches']}; resid/data {min(r['ratios'].values()):.3e} to "
           f"{max(r['ratios'].values()):.3e}; {card}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", default="1x4,4x1")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--nfreqs", type=int, default=cs.NFREQS)
    ap.add_argument("--maxsteps", type=int, default=cs.MAXSTEPS)
    args = ap.parse_args()
    os.environ.setdefault("TQDM_DISABLE", "1")
    import torch

    import calamity_tpu_torch  # noqa: F401

    cuda = args.device == "cuda"
    if cuda and not torch.cuda.is_available():
        sys.exit("a CUDA card is needed (or pass --device cpu)")
    card = cs.nvidia_smi_line() if cuda else "CPU"
    if cuda:
        cs.log(f"cards: {torch.cuda.device_count()} x {card}")
        cs.phase_build()
    shapes = [tuple(int(x) for x in s.split("x")) for s in args.shapes.split(",")]
    fit_kw = dict(device="cuda" if cuda else "cpu", maxsteps=args.maxsteps)
    with tempfile.TemporaryDirectory(prefix="mesh_scaling_") as tmp:
        path = os.path.join(tmp, "tp.uvh5")
        t0 = time.time()
        cs.make_corrupted_file(path, cs.TP_NTIMES, cs.TP_NPOLS, nfreqs=args.nfreqs)
        cs.log(f"simulated 64 antennas x {args.nfreqs} channels x {cs.TP_NTIMES} times x "
               f"{cs.TP_NPOLS} pols in {time.time() - t0:.1f} s")
        t0 = time.time()
        one = cs._mesh_fit(0, path, None, None, dict(fit_kw, device="cuda:0" if cuda else "cpu"))
        report(f"one {'card' if cuda else 'process'} ({time.time() - t0:.1f} s)", one, card)
        for shape in shapes:
            n = shape[0] * shape[1]
            t0 = time.time()
            ranks = cs.run_world(world_fit, n, "nccl" if cuda else "gloo", tmp, path, shape,
                                 fit_kw, timeout=900.0)
            wall = time.time() - t0
            for r in ranks:
                report(f"mesh {shape[0]}x{shape[1]} rank {r['rank']}", r, card)
            rel, dsteps = cs.compare_runs(f"mesh {shape}", ranks[0], one)
            cs.log(f"  mesh {shape[0]}x{shape[1]}: first 200 losses max rel {rel:.2e} against "
                   f"one {'card' if cuda else 'process'}, steps within {dsteps:.2%}; "
                   f"{wall:.1f} s with start-up")


if __name__ == "__main__":
    main()
