#!/usr/bin/env python
"""Where a descent step of calamity_tpu_torch spends its time, on one GPU.

    python3 scripts/profile_step_torch.py [--nbatch N | --scan | --hera [--nbatch N]
                                           | --hera-full [--nbatch 4]] [--sum] [--graph]

Run from the root of a checkout on a machine with a CUDA card. It builds
the main-path problem of ``chip_smoke.py`` (64 antennas, 2016 dense B=1
groups, 1536 channels) and packs it on the card: with ``--nbatch 1`` (the
default) the first time slice for the serial descent, with ``--nbatch N``
N (time, pol) slices (N / 2 times x 2 polarizations for even N) for the
batched time-parallel descent, each stepped as the driver steps it: the
descent's carry on the device (``solver.fit._Descent``,
``parallel.batched._BatchedDescent``), each step one replay of its CUDA
graph, blocks of ``calibration.POLL_EVERY`` steps between host polls. With
``--graph`` it profiles that replayed step and beside it, in the same run,
the same step uncaptured (``solver.graph.eager_steps``: PyTorch's ~200
launches a step issued from the host). With ``--scan`` the
first time slice through that batched descent at N = 1, which is how the
warm-started time scan steps each time. With ``--hera`` it profiles
the serial step of the HERA core instead (``scripts/hera_core_demo_torch.py``
at full width: 361 antennas, 4388 baselines, 1536 channels, the default
shared-basis packing), and with ``--hera --nbatch N`` its batched step over
N slices: the core's one slice and N - 1 copies of it with seeded noise of
1% of the data's rms added where the weights are not zero. With
``--hera-full`` it profiles the full HERA array's serial step
(``scripts/hera_full_demo_torch.py`` at full width: 331 antennas, 54,615
baselines, 1536 channels, 18 shared and shared-batched chunks), and with
``--hera-full --nbatch 4`` the batched step of the 4 times
``chip_smoke.py`` phase 13 builds (``FULL_NTIMES``). For the
bf16-comps and float32 phases of the mixed
schedule it times 48 descent steps (after 16 warm-up steps) under
``torch.profiler``: device time per step by kernel, kernels per step, the
launches and device time per step of the port's hand-written kernels
(``fused_chunk_loss``, ``fused_sum_combine``, ``shared_chunk_loss``,
``gain_grad``, ``gain_products``, ``adamax_step``, ``descent_carry``), and
the device's idle share against
the host clock.
It then times the same steps without the profiler, on the host clock and
between CUDA events (for a replayed step, which the host issues faster
than the card runs it, the events read the device's time). With ``--sum`` the
step is that of the "sum" flux prior (``model_regularization="sum"``, the
Python entry points' default; the sky model is the data, as the driver
sets it for identity gains) instead of the chi-square alone.
"""

import argparse
import os
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from calamity_tpu_torch import cal_utils  # noqa: E402
from calamity_tpu_torch.calibration import POLL_EVERY, _compress_freq_invariant_wgts  # noqa: E402
from calamity_tpu_torch.ops.lstsq import blocked_init_from_data, gram_cholesky_chunk  # noqa: E402
from calamity_tpu_torch.parallel import batched  # noqa: E402
from calamity_tpu_torch.solver import fit as fitmod  # noqa: E402
from calamity_tpu_torch.solver import graph  # noqa: E402
from calamity_tpu_torch.solver.optimizers import get_optimizer  # noqa: E402
from calamity_tpu_torch.solver.tensorize import FitSpec  # noqa: E402

NSTEPS = 48
NWARMUP = 16
# substrings of the hand-written kernels' names
KERNELS = ("fused_chunk_loss", "fused_sum_combine", "shared_chunk_loss", "gain_grad",
           "gain_products", "adamax_step", "descent_carry")


def sum_priors(dr, di, w, dims=None):
    """The "sum" prior's sums of a sky model equal to the data: sum(w * d)
    over every chunk, real and imaginary (per slice over ``dims``)."""
    return tuple(sum(torch.sum(d * x, dim=dims) for d, x in zip(ds, w)) for ds in (dr, di))


def serial_problem(spec, uvd, gains):
    """The first time slice of ``uvd`` packed on the spec's device as the
    serial driver packs it, with warm-started coefficients: (dr, di, w,
    g_r, g_i, fr, fi)."""
    t0 = spec.times[0]
    rows = np.isclose(uvd.time_array, t0, rtol=0.0, atol=1e-7)
    rms = np.sqrt(np.mean(np.abs(uvd.data_array[rows, 0, :, 0]) ** 2))
    dr, di, w = spec.pack_data(uvd, "xx", t0, data_scale_factor=rms)
    g_r, g_i = spec.pack_gains(gains, "xx", t0)
    return dr, di, w, g_r, g_i, tuple(spec.init_coeffs(dr, w)), tuple(spec.init_coeffs(di, w))


def _descent(make, capture):
    # a descent whose step is captured (as the driver runs it) or eager
    if capture:
        return make()
    with graph.eager_steps():
        return make()


def serial_stepper(chs, spec, uvd, gains, regularization=None, capture=True, problem=None):
    """POLL_EVERY serial descent steps (the first time slice, or
    ``problem``, a :func:`serial_problem`) per call, as the driver runs
    them: one replay of the captured step each (eager with
    ``capture=False``) and one host poll; with ``regularization="sum"`` the
    "sum" prior's step. Returns (step, steps a call, the descent)."""
    dr, di, w, g_r, g_i, fr, fi = problem or serial_problem(spec, uvd, gains)
    cfg = fitmod.FitConfig(tol=0.0, regularization=regularization)
    priors = sum_priors(dr, di, w) if regularization == "sum" else (None, None)
    loss_fn = fitmod.make_loss_fn(cfg, chs, dr, di, w, fr, fi, *priors)
    opt = get_optimizer("Adamax", learning_rate=1e-2)
    params = fitmod.init_params(cfg, g_r, g_i, fr, fi)
    d = _descent(lambda: fitmod._Descent(cfg, loss_fn, opt, params, opt.init(params),
                                         POLL_EVERY), capture)
    state = {"prev": d.big, "best": d.big, "since": 0}

    def step():
        _, _, _, state["prev"], state["best"], state["since"] = d.segment(
            POLL_EVERY, state["prev"], state["best"], state["since"])

    return step, POLL_EVERY, d


def batched_problem(spec, uvd, gains, nbatch=None):
    """Every slice of ``uvd`` packed on the spec's device as the
    time-parallel driver packs them, with warm-started coefficients: (dr, di, w, g_r,
    g_i, fr, fi); with ``nbatch`` larger than the file's slices, the first
    slice repeated to ``nbatch``, each copy with seeded noise (1% of the
    data's rms) where its weights are not zero."""
    slices = [(pol, t) for pol in uvd.get_pols() for t in spec.times]
    nfile = len(slices)
    if nbatch is not None and nbatch > nfile:
        slices += [slices[0]] * (nbatch - nfile)
    nb = len(slices)
    stacks = [[np.zeros((nb,) + m.conj.shape + (spec.nfreqs,), dtype=np.float32)
               for m in spec.meta] for _ in range(3)]
    g_r, g_i = [], []
    scale = np.sqrt(np.mean(np.abs(uvd.data_array) ** 2))
    for b, (pol, t) in enumerate(slices):
        spec.pack_data_into(uvd, pol, t, *stacks, b, data_scale_factor=scale)
        gr, gi = spec.pack_gains(gains, pol, t)
        g_r.append(gr)
        g_i.append(gi)
    for b in range(nfile, nb):
        rng = np.random.default_rng(chip_smoke.SEED + b)
        for d_r, d_i, ww in zip(*stacks):
            rms = np.sqrt(np.mean(d_r[0] ** 2 + d_i[0] ** 2))
            for d in (d_r, d_i):
                d[b] += np.where(ww[b] > 0, 0.01 * rms * rng.standard_normal(d[b].shape), 0.0)
    dev = spec.device
    # one weights plane per slice where every channel's weights are equal,
    # as the driver compresses them
    stacks[2] = [_compress_freq_invariant_wgts(x) for x in stacks[2]]
    dr, di, w = ([torch.as_tensor(x, device=dev) for x in s] for s in stacks)
    fr, fi = [], []
    for c_full, d_r, d_i, ww in zip(spec.device_chunks(), dr, di, w):
        chol, active = gram_cholesky_chunk(c_full[0])
        cr, ci, *_ = blocked_init_from_data(chol, active, c_full[0], d_r, d_i, ww, d_r.shape[1])
        fr.append(cr)
        fi.append(ci)
    return dr, di, w, torch.stack(g_r), torch.stack(g_i), fr, fi


def batched_stepper(chs, spec, uvd, gains, nbatch=None, regularization=None, capture=True,
                    problem=None):
    """POLL_EVERY batched descent steps over the slices of
    :func:`batched_problem` (or ``problem``, one made by it) per call, as
    the driver runs them (one replay of the captured step each, eager with
    ``capture=False``, and one host poll); with ``regularization="sum"`` the
    "sum" prior's step. Returns (step, steps a call, the descent)."""
    dr, di, w, g_r, g_i, fr, fi = problem or batched_problem(spec, uvd, gains, nbatch)
    cfg = fitmod.FitConfig(tol=0.0, maxsteps=10 ** 9, opt_kwargs=(("learning_rate", 1e-2),),
                           regularization=regularization)
    priors = (sum_priors(dr, di, w, dims=(1, 2, 3)) if regularization == "sum"
              else (None, None))
    opt, one_step = batched._batched_step_fn(cfg, chs, dr, di, w, fr, fi, *priors)
    params = fitmod.init_params(cfg, g_r, g_i, fr, fi)
    carry = batched._fresh_carry(cfg, g_r.shape[0], np.float32, g_r.device, None)
    d = _descent(lambda: batched._BatchedDescent(cfg, one_step, params, opt.init(params), carry,
                                                 POLL_EVERY), capture)
    state = {"step": 0}

    def step():
        state["step"] += d.segment(state["step"], POLL_EVERY, poll_every=POLL_EVERY)[1]

    return step, POLL_EVERY, d


def profile(step, per_call, nsteps=NSTEPS, nwarmup=NWARMUP):
    """``step`` (``per_call`` descent steps a call) after ``nwarmup`` warm-up
    steps: ``nsteps`` steps under ``torch.profiler``, then the same without
    it. Returns the host ms per step with and without the profiler
    (``wall_ms``, ``plain_ms``), the ms per step between CUDA events around
    the steps without the profiler (``event_ms``), the device ms per step
    summed over the kernels (``device_ms``), kernels per step, the idle
    share against the host clock without the profiler, and the 16 costliest
    kernels as (ms per step, launches per step, name); ``named``: each
    hand-written kernel's (device ms, launches) per step."""
    for _ in range(max(1, nwarmup // per_call)):
        step()
    calls = max(1, nsteps // per_call)
    nsteps = calls * per_call
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        start = time.perf_counter()
        for _ in range(calls):
            step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - start) / nsteps
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / nsteps
    # each hand-written kernel's (device ms, launches) per step, over its passes
    named = {name: (sum(e.self_device_time_total for e in kernels if name in e.key) / 1e3 / nsteps,
                    sum(e.count for e in kernels if name in e.key) / nsteps)
             for name in KERNELS}
    top = [(e.self_device_time_total / 1e3 / nsteps, e.count / nsteps, e.key)
           for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:16]]
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    start = time.perf_counter()
    events[0].record()
    for _ in range(calls):
        step()
    events[1].record()
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - start) / nsteps
    return {"wall_ms": wall_ms, "plain_ms": plain_ms, "device_ms": dev_ms,
            "event_ms": events[0].elapsed_time(events[1]) / nsteps,
            "kernels": sum(e.count for e in kernels) / nsteps,
            "idle_share": 1 - dev_ms / plain_ms, "top": top, "named": named}


def hera_problem():
    """The HERA core at full width, packed on the card with the default
    shared-basis packing: (the corrupted data, its FitSpec, blank gains)."""
    corrupted, comps, _ = chip_smoke.hera_core_build()
    gains = cal_utils.blank_uvcal_from_uvdata(corrupted)
    spec = FitSpec(corrupted, comps, {int(a): i for i, a in enumerate(gains.ant_array)},
                   device="cuda", nvec_bucketing=True, shared_basis=True)
    return corrupted, spec, gains


def kernels_line(out):
    """The hand-written kernels' launches and device ms per step, as one line."""
    return "; ".join(f"{name} x{n:.1f} {ms:.4f} ms" for name, (ms, n) in out["named"].items())


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nbatch", type=int, default=1,
                    help="slices per step: 1 profiles the serial step, N > 1 the batched one")
    ap.add_argument("--scan", action="store_true",
                    help="one slice through the batched descent, as the time scan steps it")
    ap.add_argument("--hera", action="store_true",
                    help="the serial (or, with --nbatch N, the batched) step of the HERA core "
                         "with the default packing")
    ap.add_argument("--hera-full", action="store_true",
                    help="the serial (or, with --nbatch 4, the batched) step of the full HERA "
                         "array with the default packing")
    ap.add_argument("--graph", action="store_true",
                    help="the replayed step and, beside it, the same step uncaptured")
    ap.add_argument("--sum", action="store_true",
                    help='the step of the "sum" flux prior (the default regularization of the '
                         "Python entry points)")
    args = ap.parse_args()
    regularization = "sum" if args.sum else None
    if args.scan and (args.nbatch != 1 or args.hera or args.hera_full):
        ap.error("--scan steps one slice of the disc array; leave --nbatch at 1, no --hera")
    if args.hera_full and args.nbatch not in (1, chip_smoke.FULL_NTIMES):
        ap.error(f"--hera-full steps one slice or its {chip_smoke.FULL_NTIMES} times")
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    if args.hera_full:
        full = chip_smoke.hera_full_build()
        uvd, spec, gains = full["corrupted"], full["spec"], full["gains"]
    elif args.hera:
        uvd, spec, gains = hera_problem()
    else:
        npols = 2 if args.nbatch % 2 == 0 else 1
        ntimes = max(1, args.nbatch // npols)
        with tempfile.TemporaryDirectory() as tmp:
            uvd, comps = chip_smoke.make_corrupted_file(os.path.join(tmp, "main.uvh5"), ntimes,
                                                        npols)
        gains = cal_utils.blank_uvcal_from_uvdata(uvd)
        spec = FitSpec(uvd, comps, {int(a): i for i, a in enumerate(gains.ant_array)},
                       device="cuda")
    chunks = spec.device_chunks()
    print(f"chunks {[tuple(c.shape) for c, _, _ in chunks]}; slices per step {args.nbatch}; "
          f"regularization {regularization}")
    phases = (("bf16", fitmod.convert_chunks_dtype(chunks, torch.bfloat16)), ("f32", chunks))
    for name, chs in phases:
        for capture in (True, False) if args.graph else (True,):
            if args.nbatch == 1 and not args.scan:
                step, per_call, d = serial_stepper(chs, spec, uvd, gains, regularization,
                                                   capture)
            else:
                step, per_call, d = batched_stepper(chs, spec, uvd, gains,
                                                    args.nbatch if args.hera else None,
                                                    regularization, capture)
            out = profile(step, per_call)
            kind = "replayed" if d.graph.capture else "eager"
            print(f"== {name} step, {kind}: host clock {out['wall_ms']:.3f} ms/step under the "
                  f"profiler; device {out['device_ms']:.3f} ms/step in {out['kernels']:.0f} "
                  f"kernels; idle share {1 - out['device_ms'] / out['wall_ms']:.3f}")
            for ms, count, key in out["top"]:
                print(f"  {ms:8.4f} ms/step x{count:<5.1f} {key[:90]}")
            print(f"  hand-written kernels per step: {kernels_line(out)}")
            print(f"  host clock without the profiler {out['plain_ms']:.3f} ms/step, between "
                  f"CUDA events {out['event_ms']:.3f} ms/step; idle share "
                  f"{out['idle_share']:.3f}")
            if d.graph.record is not None:
                r = d.graph.record
                print(f"  capture {r['seconds']:.3f} s, pool {r['pool_bytes']} bytes, "
                      f"{r['replays']} replays")
            d.close()
    print(chip_smoke.nvidia_smi_line())


if __name__ == "__main__":
    main()
