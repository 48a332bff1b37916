#!/usr/bin/env python
"""Smoke test of the PyTorch/CUDA port (calamity_tpu_torch) on one GPU.

    python3 chip_smoke.py [--phases 3,3g,3s,3a,4,5,6,7,8,9,10,11,12,13]

Run from the root of a checkout, on a machine with a CUDA card and nvcc.
It builds the port's CUDA kernels from the five sources in the checkout,
holds each against its plain PyTorch version, drives the port's main path (file read,
DPSS components, FitSpec packing, Cholesky warm start, Adamax descent,
uvh5/calfits write-back) at full width, and checks what comes out. Phases:

1. environment: torch, CUDA, the card and its power limit, nvcc, triton;
2. build of the kernel library;
3. every instance of the kernel (the loss only; with the gain-product
   gradients; with every gradient, in one comps read; and the "sum"
   prior's: its forward, the chi-square with the model flux sums M_r and
   M_i, held within 1e-5 of sum w |m|, and its one-pass forward with the
   pieces of the gain-product or every gradient, each piece held rel
   1e-4; the combine of those pieces at random cotangents and at a
   chi-square cotangent of 0 against the two-pass plain gradients; two
   launches equal to the bit) against its
   plain version: at the main path's chunk shape with N = 8 and 1 slices, at
   ragged shapes with N = 1, 3 and 9, on group-block views, at an unaligned
   comps offset, at wide bases (a smaller row tile, modes past the register
   slots, coefficients in scratch, rows too wide for any tile), float32 and
   bfloat16 comps and weights;
   at the main shape timed against the plain version, against its bound
   and against cuBLAS' batched matvec of the same comps; and (3g) the
   gain kernels: the gradient against its plain version (two launches
   bit-equal) and the products against the torch ops (equal to the bit) at
   phase 7's rows and the HERA core's, N = 1 and 8, timed against their
   bounds, the gradient against an ``index_add_``; the HERA core's packed
   chunks with their padding (the lists that leave it out against those
   that keep it, equal to the bit; one step's launches timed); a padded
   row and an antenna with no rows; a skewed list (two passes); float64,
   a ragged channel count and unaligned operands; and (3s) the shared-basis
   kernel at the HERA core's four packed chunk shapes with their padding
   (N = 1 and 8, float32 and bfloat16 comps), every instance against its
   plain version and against the emulation of its split TF32 products
   (``ops.shared.loss_and_grads_tf32``), two launches equal to the bit,
   the autograd Function against the torch ops it replaces, each case
   timed against its bound, the plain version, those torch ops and cuBLAS'
   batched matvec; a block of whole classes as views; ragged and wide
   shapes (past 64 modes the cluster's mode slices, up to 1024 modes, a
   cluster of 16); bfloat16 weights and a weight plane; the "sum"
   instances as in phase 3, also against the split TF32 emulation, each
   timed against its bound; and at the full HERA array's widths (phase
   13's packing): its six heaviest and narrowest chunks (V = 128, 256 and
   512) with their padding, N = 1 and 8, float32 and bfloat16 comps, the
   chi-square's instances against the plain version and two launches equal
   to the bit, each timed through the wrapper and the device alone beside
   its bound, the plain version and cuBLAS' matvec, with its launch plan
   (cluster, ring, shared memory, blocks an SM from the runtime's
   occupancy calculator) and its instance's registers and spills, and one
   step's 18 launches timed together; the launch plan (within a block's
   227 KB and a cluster of 16, ceil(V / 64) mode slices a tile of pairs,
   past 64 modes the sliced design's shared memory and blocks an SM,
   ``SLICED_SMEM`` and ``SLICED_BLOCKS``) at those chunks, the ragged shapes and
   every width from 65 modes to 600 / 720; a coefficient or a data value
   made NaN on the card gives a NaN loss or NaN gradients at V = 64 and
   128, both comps types; and (3a) the descents' Adamax update and carry
   (``csrc/adamax_step.cu``) at the full array's 38 parameter leaves, N = 1
   (the serial carry) and N = 8 (the batched carry, two rows frozen),
   float32 and float64: 50 steps of the kernels against their plain
   versions, each side advancing its own state, equal to the bit (a NaN
   and an inf gradient, a NaN loss, patience, the best parameters, the
   frozen rows untouched byte for byte), each kernel timed against its
   bound, its plain version and, for the update, ``torch._foreach_*`` ops;
4. the main path at full size: 64 antennas (2016 baselines), 1536 channels,
   1 time, through ``read_calibrate_and_model_dpss`` with every chunk dense
   (``shared_basis=False``), the CLI's ``post_hoc`` regularization and the
   default ``mixed`` schedule; then its packed slice fitted twice, equal to
   the bit, and a third time with the Adamax update's and the carry's
   plain versions, equal to the bit to the kernels' fit;
5. 50 recorded descent steps on that data with the chunks on the card and
   with a CPU copy (the plain version), histories compared; and the cost of
   the per-step host check of the stop conditions;
6. the port's CLI script with its default flags on a small Golomb file, and
   with ``--time_parallel --checkpoint_dir``: cut mid-fit, resumed, and
   held against an uninterrupted run; the warm-started time scan's CLI
   (``--time_parallel --init_guesses_from_previous_time_step --comps_precision
   mixed --checkpoint_dir``) on a 3-time Golomb file, stopped inside a time,
   resumed and held against an uninterrupted run; the DFT and mixed drivers
   once each on the small Golomb file; the CLI on files the port did not
   write (the h5py-written fixtures of ``tests/data`` and their copies with
   variable-length Header strings, the pyuvdata-layout fixture of
   ``tests/data_torch`` and its twin with HERA's integer visibilities), on
   the card against the CPU, the read seconds of the port's HDF5 reader
   (the HERA core's flags and nsamples under LZF, szip and n-bit), and the
   fixtures in the storage of the latest file format, HDF5's built-in
   filters (extensible-array chunk indices with paged data blocks, v2
   B-tree chunk indices, szip, scale-offset, n-bit) and the types h5py
   and pyuvdata write (variable-length strings, integer compounds) read
   against digests of h5py's reading;
7. the time-parallel path at full width: one ``read_calibrate_and_model_dpss``
   with ``time_parallel=True`` on 64 antennas, 1536 channels, 4 times and 2
   polarizations (8 slices in one batched descent), every step through the
   batched kernel; two of its slices against the serial path; then its 8
   slices packed once and fitted by the batched descent on the Adamax
   kernels and on their plain versions, equal to the bit;
8. the warm-started time scan at full width on phase 7's file and basis: each
   polarization's 4 times in order, each fit seeded by the one before, every
   step through the kernel with N = 1; each polarization's first time
   against the serial path;
9. the ('data', 'bl') device mesh, in child processes joined by
   ``torch.distributed`` (each world under its own time limit): (a) a world
   of 1 over NCCL, phase 7's file through ``mesh=make_mesh(1, 1)`` against
   phase 7's steps and histories, equal to the bit; (b) a world of 2 over
   gloo, both ranks on the one card, mesh (1, 2), the mixed schedule, on a
   smaller file (384 channels, 2 times, 1 polarization; each rank fits
   1008 of the 2016 groups), against (c)'s unsharded run of it; (c) mesh
   (2, 1) on the time-parallel path and the scan on (1, 2), on that file,
   in one world, each against its unsharded run; (d)
   ``calamity_tpu_torch.supervisor``: the CUDA probe, and a supervised run
   of the CLI; (e) the mixed driver with its covariance
   eigh on the card against the host numpy eigh;
10. the HERA core (``scripts/hera_core_demo_torch.py``: 361 antennas, 4388
   baselines, 1536 channels) with the default shared-basis packing at full
   width, every shared chunk through the shared-basis kernel, its idle
   share under the profiler, and at cut width fitted twice (equal to the
   bit) and against the dense packing (the shared-basis kernel against the
   fused one);
11. the entry points' default "sum" prior: (a) the HERA core at full width
   through ``calibrate_and_model_dpss`` as phase 10 runs it but with the
   "sum" prior and a step budget, fitted twice (equal to the bit), every shared chunk's "sum"
   forward and backward instances launched each step, no chunk on the
   plain terms, resid/data <= 1e-2, the step's device time and idle share
   under the profiler; (b) phase 7's file through
   ``read_calibrate_and_model_dpss`` with ``time_parallel=True,
   shared_basis=False`` and the "sum" prior (the fused kernel's one-pass
   "sum" instance at N = 8 and the combine: one read of comps a step),
   then 50 recorded batched steps on the card against a CPU copy of one
   slice (histories rel 1e-4);
12. the descent loop captured against the same loop uncaptured: every
   descent above runs as the entry points run it, its step one replay of a
   CUDA graph (``solver.graph``) with the stop test, history and argmin on
   the device and a host poll every 16 steps. Four descents are run that
   way and again uncaptured (``solver.graph.eager_steps``), on step
   budgets: (a) phase 4's packed slice, serial, the mixed schedule; (b)
   the HERA core's slice at full width with the demo's patience, use_min
   and the "sum" prior; (c) phase 7's 8 slices, batched, the "sum" prior;
   (d) a checkpointed serial fit, and the graphed one cut mid-fit and
   resumed. Each pair is equal to the bit (steps, histories, final
   parameters, launches); the host ms a step of both, the captures (seconds,
   pool bytes, replays), peak memory, and the replayed step under the
   profiler (device ms, idle share; (b)'s eager step too); (b)'s replayed
   step takes at most 1.3 times its device time on the host clock and at
   most a third of the eager step's;
13. the full HERA array (``scripts/hera_full_demo_torch.py``: 331 antennas,
   all 54,615 baselines, 1536 channels; 18 shared and shared-batched
   chunks of 77,748 groups, V up to 512) with the demo's arguments: (a) one
   slice on the serial path, every chunk through the shared-basis kernel
   each step, resid/data <= 1e-2, its step replayed under the profiler;
   (b) 4 slices on the time-parallel path with the campaign's RFI flags,
   bfloat16 weights and loss blocks, losses finite and falling, then the
   same slices packed once and stepped with and without the loss blocks
   (peak memory, ms a batch step).

Every phase resets the kernels' launch counters before it drives its path
and reads them after. ``--phases`` runs a subset (1 and 2 always run) and
then prints no kernels line and no result line. Any failure raises and
exits non-zero; there is no fallback to the CPU. It
imports nothing of jax or of the JAX package ``calamity_tpu`` and fails if
either was loaded. The last line is one JSON object naming the device.
"""

import json
import multiprocessing as mp
import os
import queue
import re
import runpy
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
import warnings

import numpy as np

SEED = 20261016
NANTS = 64
DISC_RADIUS_M = 50.0
MIN_SEPARATION_M = 4.0
NFREQS = 1536
F0_HZ = 100e6
DF_HZ = 100e3
NTIMES = 1  # phase 4's times: one, so that phase 9 fits in the time limit
TP_NTIMES = 4  # the time-parallel phase: 4 times x 2 polarizations = 8 slices
TP_NPOLS = 2
NSRC = 50
GAIN_ERR = 0.03
MIN_DLY_NS = 2.0 / 0.3  # = offset: the repo's tests' DPSS delay settings
MAXSTEPS = 3000  # per phase of the mixed schedule
TOL = 1e-11
N_LOOP_STEPS = 50
CUT_STEPS = 40  # where phase 6's checkpointed CLI run is cut
SCAN_NTIMES = 3  # the small multi-time file of phase 6's scan CLI run
SCAN_CK_EVERY = 10  # its checkpoint cadence; the cut is at time 1's first float32 save
KERNEL_REPLACES = "calamity_tpu/ops/fused.py:152"  # with its backward _bwd_xla, :223
KERNEL_SOURCE = "calamity_tpu_torch/csrc/fused_chunk_loss.cu"
# the combine forms the "sum" prior's gradients of a dense chunk, the
# backward the JAX package takes through _bwd_xla under jax.grad
COMBINE_REPLACES = "calamity_tpu/ops/fused.py:223"
# the gain gather and its gradient: jnp.take and XLA's scatter-add in its
# gradient (no Pallas kernel; the port's kernels compute the products in one
# launch and sum the gradient in a fixed order)
GAIN_KERNEL_REPLACES = "calamity_tpu/ops/loss.py:183"
GAIN_KERNEL_SOURCE = "calamity_tpu_torch/csrc/gain_grad.cu"
PROD_KERNEL_SOURCE = "calamity_tpu_torch/csrc/gain_products.cu"
# a shared-basis chunk's loss: the shared branches of fg_model and
# fg_model_batched (:108), data_model (:199), mse (:208) and their transposes
# under jax.grad, in XLA (no Pallas kernel)
SHARED_KERNEL_REPLACES = "calamity_tpu/ops/loss.py:62"
SHARED_KERNEL_SOURCE = "calamity_tpu_torch/csrc/shared_chunk_loss.cu"
MESH_NFREQS = 384  # phase 9 (c): the smaller file's channels, times and polarizations
MESH_NTIMES = 2
MESH_NPOLS = 1
MESH_TOL = 1e-9  # phase 9 (c)'s stop: fewer steps than phase 7's, both runs alike
WORLD_TIMEOUT_S = 300.0  # each phase 9 world's own time limit


def log(msg=""):
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_median_ms(fn, n=20, per_sample=5, warmup=3):
    """ms per call: the median of ``n`` samples, each a CUDA-event timing of
    ``per_sample`` back-to-back calls divided by their number (so the host's
    launch overhead overlaps the device work, as in a descent), after
    ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_sample):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / per_sample)
    return float(np.median(times))


def cuda_graph_ms(fn, n=20, per_sample=5):
    """The device's ms per call with no host cost: ``per_sample`` calls
    captured in a CUDA graph, the median of ``n`` CUDA-event timings of its
    replay divided by ``per_sample``. A short launch timed through its
    wrapper (:func:`cuda_median_ms`) reads the host's cost of the call
    instead."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_sample):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / per_sample)
    del graph
    return float(np.median(times))


# ---------------------------------------------------------------------- #
# phase 1 and 2
# ---------------------------------------------------------------------- #
def phase_environment():
    import torch

    from calamity_tpu_torch.ops._build import find_nvcc

    log("== phase 1: environment")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"torch.version.cuda {torch.version.cuda}")
    log(f"nvidia-smi: {nvidia_smi_line()}")
    nvcc = find_nvcc()
    ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True, check=True)
    log(f"nvcc: {nvcc}: {ver.stdout.strip().splitlines()[-1]}")
    try:
        import triton  # noqa: F401

        log(f"triton: importable, version {triton.__version__}")
    except ImportError as exc:
        log(f"triton: not importable ({exc})")
    log(f"device 0: {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")


def registers(log, kernel="fused_chunk_loss"):
    """'<instance>:<registers>r/<spill bytes>s' for each entry function of
    ``kernel``'s source in a ``-Xptxas -v`` report."""
    out, inst, spill = [], None, "?"
    for line in log.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
            m = re.search(r"_(kernel|wide|sliced)I(.*?)EEv", fn)
            inst = (f"{m.group(1)}:{m.group(2)}" if m else fn) if kernel in fn else None
        elif "spill stores" in line:
            spill = line.split(",")[1].strip().split()[0]
        elif "Used" in line and "registers" in line and inst:
            out.append(f"{inst}:{line.split('Used')[1].split()[0]}r/{spill}s")
    return out


def phase_build():
    from calamity_tpu_torch.ops import _build

    log("== phase 2: build")
    # build from the checkout's sources, never from an earlier build
    shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)
    lib = _build.load_kernels()
    check(lib.build_seconds > 0.0, "kernel library was not built from source")
    log(f"built {os.path.relpath(lib.path)} from {[os.path.relpath(s) for s in _build.sources()]}"
        f" in {lib.build_seconds:.2f} s")
    func = ""  # the entry function ptxas reports on, as <kernel>I<template arguments>
    for line in lib.build_log.splitlines():
        if "Function properties for" in line:
            func = line.split("Function properties for", 1)[1].strip()
            named = re.search(r"([a-z]+(?:_[a-z]+)*_(?:kernel|wide|sliced|partials|segments))I"
                              r"(.*?)EEv",
                              func)
            func = f"{named.group(1)}<{named.group(2)}>" if named else func[:96]
        if "registers" in line or "spill" in line or "error" in line.lower():
            log(f"  nvcc: {func}: {line.strip()}")
    return lib


# ---------------------------------------------------------------------- #
# phase 3: kernel against plain
# ---------------------------------------------------------------------- #
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores (the fused and gain kernels)
TF32_FLOPS = 495e12  # H100 SXM TF32 on the tensor cores, dense (the shared-basis kernel's
# products: each of its float32 multiply-adds takes two or three TF32 products)


def batched_inputs(nbatch, ngrps, nfreqs, nvecs, comps_dtype, wgts_dtype, seed, extra=0,
                   odd_offset=False, w_plane=False):
    """Inputs of the kernel; with ``extra`` > 0 the per-slice planes are
    views of (nbatch, ngrps + extra, nfreqs) cubes at groups
    [extra // 2, extra // 2 + ngrps), as a loss block reads them; with
    ``odd_offset`` comps starts one element into its storage (a span that
    is not 16-byte aligned: the kernel's cp.async path); with ``w_plane``
    the weights are one value a (slice, group), broadcast over the
    channels (a channel stride of 0, as a compressed weight plane)."""
    import torch

    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")
    gt = ngrps + extra

    def t(*shape):
        return torch.as_tensor(rng.standard_normal(shape, dtype=np.float32), device=dev)

    comps = t(ngrps, nfreqs, nvecs)
    comps /= torch.linalg.vector_norm(comps, dim=1, keepdim=True)
    comps = comps.to(comps_dtype)
    if odd_offset:
        store = torch.empty(comps.numel() + 1, dtype=comps_dtype, device=dev)
        store[1:] = comps.reshape(-1)
        comps = store[1:].view(comps.shape)
    coeffs2 = t(2, nbatch, ngrps, nvecs)
    pr, pi = 1 + 0.1 * t(nbatch, ngrps, nfreqs), 0.1 * t(nbatch, ngrps, nfreqs)
    dr, di = t(nbatch, gt, nfreqs), t(nbatch, gt, nfreqs)
    w = t(nbatch, gt, 1 if w_plane else nfreqs).abs()
    w /= w.sum(dim=(1, 2), keepdim=True) * (nfreqs if w_plane else 1)
    w = w.to(wgts_dtype).expand(nbatch, gt, nfreqs)
    g0 = extra // 2
    sl = slice(g0, g0 + ngrps)
    return [coeffs2, pr, pi, dr[:, sl], di[:, sl], w[:, sl], comps]


def nbytes(t):
    return t.numel() * t.element_size()


def bound(args, grads, sums=False):
    """The least time the card could take for the kernel's work on these
    inputs: the larger of the bytes it must move (each input read once,
    each output written once) over the memory rate and its float32
    operations over the float32 rate. ``grads``: False, "dp" (dpr and dpi
    alone) or True (every gradient). ``sums``: a "sum" instance (the
    forward writes M_r and M_i beside the loss, 4 more operations an
    entry; the backward reads three cotangents a slice, writes no loss and
    takes 4 more operations an entry for dm). Returns (ms, "bytes" |
    "operations", bytes)."""
    coeffs2, pr, pi, dr, di, w, comps = args
    nbatch, ngrps, nfreqs = pr.shape
    nvecs = comps.shape[-1]
    rows = nbatch * ngrps * nfreqs
    moved = sum(nbytes(x) for x in args) + 4 * nbatch  # inputs, losses
    # 2 FMAs per comps value and slice (re, im) in the matvec; per row and
    # slice 12 operations for the model, residual and weighted square
    flops = 4 * rows * nvecs + 12 * rows
    if sums:
        moved += 8 * nbatch
        flops += 4 * rows
    if grads:
        moved += 2 * nbytes(pr)  # dpr, dpi written
        flops += 16 * rows  # dm, dp, dv
    if grads is True:
        moved += nbytes(coeffs2)  # dcoeffs written
        flops += 4 * rows * nvecs  # the coefficient contraction
    t_bytes, t_ops = 1e3 * moved / HBM_BYTES_PER_S, 1e3 * flops / F32_FLOPS
    return (t_bytes, "bytes", moved) if t_bytes >= t_ops else (t_ops, "operations", moved)


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def sum_cotangents(nbatch, device, seed):
    """The "sum" backward's cotangents (3, N) of (chi-square, M_r, M_i):
    seeded random ones (a chi-square cotangent other than 1 for every
    slice), and the same with the chi-square's set to 0 (the flux sums'
    alone)."""
    import torch

    base = np.random.default_rng(seed).standard_normal((3, nbatch)).astype(np.float32)
    zero = base.copy()
    zero[0] = 0.0
    return {k: torch.as_tensor(v, device=device) for k, v in (("random", base), ("gx=0", zero))}


def flux_scale(args, valid=None):
    """(2, N): sum over a slice of w |m_r| and of w |m_i|, the scale the
    model flux sums M_r and M_i are held against (near a fit they are a
    small difference of large sums). Dense (comps (G, F, V)) and shared
    (comps (U, F, V)) layouts alike."""
    import torch

    coeffs2, pr, pi, dr, di, w, comps = args
    nu, (_, nbatch, ngrps, nvecs) = comps.shape[0], coeffs2.shape
    c = coeffs2.reshape(2, nbatch, nu, ngrps // nu, nvecs)
    v = torch.einsum("ufv,knugv->knugf", comps.float(), c).reshape(2, nbatch, ngrps, -1)
    mr, mi = pr * v[0] + pi * v[1], -pi * v[0] + pr * v[1]
    wf = w.float() if valid is None else w.float() * valid.reshape(1, -1, 1)
    return torch.stack([torch.sum(wf * mr.abs(), dim=(1, 2)), torch.sum(wf * mi.abs(), dim=(1, 2))])


def term_errors(got, want, scale):
    """(chi-square rel per slice, M_r and M_i rel to their scale), worst over
    the slices."""
    chi = float(((got[0] - want[0]).abs() / want[0].abs()).max())
    return chi, float(((got[1:] - want[1:]).abs() / scale).max())


def check_sum_instances(tag, op, args, extra=(), emulate=None, seed=0):
    """The "sum" instances of a chunk-loss kernel (``op``: ``ops.fused`` or
    ``ops.shared``; ``extra``: the shared kernel's mask) against their
    plain version: the forward's chi-square rel 1e-5 per slice, M_r and
    M_i within 1e-5 of sum w |m| (the flux scale); two launches of each
    equal to the bit. The shared kernel's "sum" backward: its gradients rel
    1e-4 at random cotangents and at a cotangent of the chi-square of 0.
    The fused kernel's one-pass instances: their terms as the forward's,
    each piece of the gradients (a plane or a coefficient set) rel 1e-4,
    and at each set of cotangents the combine of the kernel's pieces
    against the two-pass plain gradients rel 1e-4 (two combines equal to
    the bit). With ``emulate`` (the kernels' split TF32 emulation) also
    against that at the same tolerances. Returns (worst rel by name, the
    largest abs errors of the instances, worst rel against the emulation,
    the largest abs errors of the combine)."""
    import torch

    from calamity_tpu_torch.ops import fused

    scale = flux_scale(args, extra[0] if extra else None)
    worst, errs, emu, cerrs = {}, [], {}, []

    def hold(name, value, limit, into):
        check(value <= limit, f"{tag} {name}: rel {value} (limit {limit})")
        into[name] = max(into.get(name, 0.0), value)

    def twice(name, fn, *a, **kw):
        got, again = fn(*a, **kw), fn(*a, **kw)
        check(all((x is None and y is None) or torch.equal(x, y) for x, y in zip(got, again)),
              f"{tag} {name}: two launches differ")
        return got

    def run(mode, cot=None):
        kw = {} if cot is None else {"cot": cot}
        got = twice(fused.MODE_NAMES[mode], op.loss_and_grads_kernel, *args, *extra, mode=mode,
                    **kw)
        want = op.loss_and_grads_plain(*args, *extra, mode=mode, **kw)
        split = None if emulate is None else emulate(*args, *extra, mode=mode, **kw)
        torch.cuda.synchronize()
        return got, want, split

    def hold_terms(name, got, want, split):
        chi, flux = term_errors(got[0], want[0], scale)
        hold(f"{name} chi2", chi, 1e-5, worst)
        hold(f"{name} M", flux, 1e-5, worst)
        errs.append(float((got[0] - want[0]).abs().max()))
        if split is not None:
            chi, flux = term_errors(got[0], split[0], scale)
            hold(f"{name} chi2", chi, 1e-5, emu)
            hold(f"{name} M", flux, 1e-5, emu)

    got, want, split = run(fused.SUM_FWD)
    hold_terms("sum_fwd", got, want, split)
    check(all(g is None for g in got[1:]), f"{tag} sum_fwd: gradients returned")
    cots = sum_cotangents(args[0].shape[1], args[0].device, seed)
    names = ("dcoeffs", "dpr", "dpi")
    if op is fused:
        pieces = {"dcoeffs": ("D_re", "D_im", "C(w pr)", "C(w pi)"), "dpr": ("dpr_chi", "w v_r"),
                  "dpi": ("dpi_chi", "w v_i")}
        for one, two in ((fused.SUM_FWD_DP, fused.SUM_DP), (fused.SUM_FWD_ALL, fused.SUM_ALL)):
            mname = fused.MODE_NAMES[one]
            got, want, split = run(one)
            hold_terms(mname, got, want, split)
            for name, g, p, e in zip(names, got[1:], want[1:], (split or want)[1:]):
                check((g is None) == (p is None), f"{tag} {mname}: {name}")
                for q, piece in enumerate(pieces[name] if p is not None else ()):
                    hold(f"{mname} {piece}", rel(g[q], p[q]), 1e-4, worst)
                    errs.append(float((g[q] - p[q]).abs().max()))
                    if split is not None:
                        hold(f"{mname} {piece}", rel(g[q], e[q]), 1e-4, emu)
            for cot in cots.values():
                grads = twice(f"{fused.COMBINE_NAME} after {mname}", fused.combine_kernel,
                              *got[1:], cot)
                ref = fused.loss_and_grads_plain(*args, mode=two, cot=cot)[1:]
                emu_grads = None if split is None else fused.combine_plain(*split[1:], cot)
                for k, (name, g, p) in enumerate(zip(names, grads, ref)):
                    check((g is None) == (p is None), f"{tag} combine after {mname}: {name}")
                    if p is None:
                        continue
                    hold(f"combine after {mname} {name}", rel(g, p), 1e-4, worst)
                    cerrs.append(float((g - p).abs().max()))
                    if emu_grads is not None:
                        hold(f"combine after {mname} {name}", rel(g, emu_grads[k]), 1e-4, emu)
        return worst, errs, emu, cerrs
    for cname, cot in cots.items():
        for mode in (fused.SUM_DP, fused.SUM_ALL):
            got, want, split = run(mode, cot)
            check(got[0] is None, f"{tag} {fused.MODE_NAMES[mode]}: a loss returned")
            for name, g, p, e in zip(names, got[1:], want[1:], (split or want)[1:]):
                check((g is None) == (p is None), f"{tag} {fused.MODE_NAMES[mode]}: {name}")
                if p is None:
                    continue
                hold(f"{fused.MODE_NAMES[mode]} {name}", rel(g, p), 1e-4, worst)
                errs.append(float((g - p).abs().max()))
                if split is not None:
                    hold(f"{fused.MODE_NAMES[mode]} {name}", rel(g, e), 1e-4, emu)
            if extra and got[1] is not None:
                pad = ~extra[0]
                check(not bool(got[1][:, :, pad].any() or got[2][:, pad].any()),
                      f"{tag} {cname}: padding groups' gradients are not zero")
    return worst, errs, emu, cerrs


def sum_function_rel(args, terms_fn, plain_fn, extra=(), seed=0):
    """The "sum" terms' autograd Function against the plain terms under
    autograd at random cotangents of the three terms: rel of (dcoeffs,
    dpr, dpi)."""
    import torch

    cot = sum_cotangents(args[0].shape[1], args[0].device, seed + 1)["random"]

    def grads(fn):
        leaves = [a.detach().clone().requires_grad_(i < 3) for i, a in enumerate(args)]
        torch.sum(fn(*leaves, *extra) * cot).backward()
        return [leaves[i].grad for i in range(3)]

    return [rel(a, b) for a, b in zip(grads(terms_fn), grads(plain_fn))]


def time_sum_instances(op, args, extra, bound_fn):
    """CUDA-event ms of each "sum" instance of the shared kernel through
    the wrapper and, replayed from a CUDA graph, the device alone, beside
    its bound."""
    from calamity_tpu_torch.ops import fused

    cot = sum_cotangents(args[0].shape[1], args[0].device, 0)["random"]
    out = {}
    for mode, grads in ((fused.SUM_FWD, False), (fused.SUM_DP, "dp"), (fused.SUM_ALL, True)):
        call = lambda m=mode: op.loss_and_grads_kernel(  # noqa: E731
            *args, *extra, mode=m, cot=None if m == fused.SUM_FWD else cot)
        out[fused.MODE_NAMES[mode]] = {"ms": cuda_median_ms(call),
                                       "device_ms": cuda_graph_ms(call),
                                       "bound_ms": bound_fn(grads)[0]}
    return out


def one_pass_bound(args, grads):
    """:func:`bound` of a one-pass "sum" instance of the fused kernel
    (``grads`` "dp": frozen coefficients; True: every gradient): it reads
    the inputs once and writes the three terms, the 4 planes of the pieces
    of dpr and dpi and, with every gradient, 4 coefficient sets; its
    float32 operations (the matvec, the model, the loss, the sums, dm, the
    pieces) at the float32 rate plus, with every gradient, the four
    columns a slice of the coefficient sums on the tensor cores at the
    TF32 rate, three products each for float32 comps and two for
    bfloat16 (the two units run side by side: the longer of the two, as
    in :func:`_shared_bound`). Returns (ms, "bytes" | "operations",
    bytes)."""
    import torch

    coeffs2, pr, pi, dr, di, w, comps = args
    nbatch, ngrps, nfreqs = pr.shape
    nvecs = comps.shape[-1]
    rows = nbatch * ngrps * nfreqs
    moved = sum(nbytes(x) for x in args) + 12 * nbatch + 4 * nbytes(pr)
    flops = 4 * rows * nvecs + 36 * rows
    tf32 = 0
    if grads is True:
        moved += 2 * nbytes(coeffs2)
        tf32 = (3 if comps.dtype == torch.float32 else 2) * 8 * rows * nvecs
    t_bytes = 1e3 * moved / HBM_BYTES_PER_S
    t_ops = max(1e3 * flops / F32_FLOPS, 1e3 * tf32 / TF32_FLOPS)
    return (t_bytes, "bytes", moved) if t_bytes >= t_ops else (t_ops, "operations", moved)


def combine_bound(args, grads):
    """:func:`bound` of the combine after a one-pass instance: it reads 4
    planes, the cotangents and, with every gradient, 4 coefficient sets,
    and writes 2 planes (and 2 sets), 3 multiply-adds an entry written."""
    coeffs2, pr = args[0], args[1]
    moved = 6 * nbytes(pr) + 12 * pr.shape[0] + (3 * nbytes(coeffs2) if grads is True else 0)
    flops = 6 * 2 * pr.numel() + (6 * coeffs2.numel() if grads is True else 0)
    t_bytes, t_ops = 1e3 * moved / HBM_BYTES_PER_S, 1e3 * flops / F32_FLOPS
    return (t_bytes, "bytes", moved) if t_bytes >= t_ops else (t_ops, "operations", moved)


def time_fused_sum(args):
    """CUDA-event ms through the wrapper and, replayed from a CUDA graph,
    the device alone, beside the bound, of the fused kernel's "sum"
    instances, of the combine after each one-pass instance (and of its
    plain version), and of a "sum" step's chunk work: the one pass with
    every gradient plus its combine, and through the terms' autograd
    Function with the memory that allocates."""
    import torch

    from calamity_tpu_torch.ops import fused

    cot = sum_cotangents(args[0].shape[1], args[0].device, 0)["random"]
    out = {}
    for mode, grads in ((fused.SUM_FWD, False), (fused.SUM_FWD_DP, "dp"),
                        (fused.SUM_FWD_ALL, True)):
        call = lambda m=mode: fused.loss_and_grads_kernel(*args, mode=m)  # noqa: E731
        b = bound(args, False, sums=True) if mode == fused.SUM_FWD else one_pass_bound(args, grads)
        out[fused.MODE_NAMES[mode]] = {"ms": cuda_median_ms(call), "device_ms": cuda_graph_ms(call),
                                       "bound_ms": b[0], "bound_by": b[1]}
        if mode == fused.SUM_FWD:
            continue
        pieces = call()[1:]
        comb = lambda p=pieces: fused.combine_kernel(*p, cot)  # noqa: E731
        b = combine_bound(args, grads)
        out[f"combine_{'all' if grads is True else 'dp'}"] = {
            "ms": cuda_median_ms(comb), "device_ms": cuda_graph_ms(comb),
            "plain_ms": cuda_median_ms(lambda p=pieces: fused.combine_plain(*p, cot)),
            "bound_ms": b[0], "bound_by": b[1]}
        del pieces

    def step():
        return fused.combine_kernel(*fused.loss_and_grads_kernel(*args, mode=fused.SUM_FWD_ALL)[1:],
                                    cot)

    out["sum_step"] = {"ms": cuda_median_ms(step), "device_ms": cuda_graph_ms(step),
                       "bound_ms": out["sum_fwd_all"]["bound_ms"] + out["combine_all"]["bound_ms"]}
    # the terms' autograd Function, forward and backward, and the device
    # memory it allocates beyond its inputs (the saved pieces, the gradients)
    leaves = [a.detach().requires_grad_(i < 3) for i, a in enumerate(args)]

    def fwdbwd():
        torch.sum(fused.fused_chunk_terms_batched(*leaves) * cot).backward()

    ms = cuda_median_ms(fwdbwd)
    for a in leaves:
        a.grad = None
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fwdbwd()
    torch.cuda.synchronize()
    out["sum_function"] = {"ms": ms, "bound_ms": out["sum_step"]["bound_ms"],
                           "transient_gb": (torch.cuda.max_memory_allocated() - base) / 1e9}
    return out


def _sum_line(timed):
    return "; ".join(f"{k} {v['ms']:.4f} ms"
                     + (f" (the device alone {v['device_ms']:.4f})" if "device_ms" in v else "")
                     + f" against bound {v['bound_ms']:.4f}"
                     + (f", transient memory {v['transient_gb']:.3f} GB" if "transient_gb" in v
                        else "") for k, v in timed.items())


def compare(nbatch, shape, comps_dtype, wgts_dtype, timed=False, extra=0, odd_offset=False,
            w_plane=False):
    """Every instance of the kernel against the plain version on the same
    inputs (loss rel 1e-5, gradients rel 1e-4), and the autograd Function
    against the plain forward under autograd at a different cotangent per
    slice; with ``timed``, CUDA-event times."""
    import torch

    from calamity_tpu_torch.ops import fused

    ngrps, nfreqs, nvecs = shape
    args = batched_inputs(nbatch, ngrps, nfreqs, nvecs, comps_dtype, wgts_dtype,
                          SEED + 7 * nbatch + ngrps + nvecs, extra, odd_offset, w_plane)
    names = "/".join(str(d).replace("torch.", "") for d in (comps_dtype, wgts_dtype))
    tag = f"N={nbatch} {shape} comps/weights {names}"
    if extra:
        tag += f", group-block view of {ngrps + extra} groups"
    if odd_offset:
        tag += ", comps at an odd element offset"
    if w_plane:
        tag += ", weights broadcast over the channels (stride 0)"
    from calamity_tpu_torch.ops._build import load_kernels

    plan = load_kernels().plan(nbatch, ngrps, nfreqs, nvecs, int(comps_dtype != torch.float32),
                               fused.LOSS_ALL, args[6].data_ptr())
    errs, worst = [], {}
    for mode in (fused.LOSS_ONLY, fused.LOSS_DP, fused.LOSS_ALL):
        got = fused.loss_and_grads_kernel(*args, mode=mode)
        want = fused.loss_and_grads_plain(*args, mode=mode)
        torch.cuda.synchronize()
        loss_rel = float(((got[0] - want[0]).abs() / want[0].abs()).max())
        check(loss_rel <= 1e-5, f"{tag} mode {mode}: loss rel {loss_rel}")
        worst["loss"] = max(worst.get("loss", 0.0), loss_rel)
        errs.append(float((got[0] - want[0]).abs().max()))
        for name, g, p in zip(("dcoeffs", "dpr", "dpi"), got[1:], want[1:]):
            check((g is None) == (p is None), f"{tag} mode {mode}: {name} presence")
            if p is None:
                continue
            r = rel(g, p)
            check(r <= 1e-4, f"{tag} mode {mode}: {name} rel {r}")
            worst[name] = max(worst.get(name, 0.0), r)
            errs.append(float((g - p).abs().max()))
    # the autograd Function at a different cotangent per slice
    cot = torch.arange(1, nbatch + 1, device=args[0].device, dtype=torch.float32)

    def grads(fn):
        leaves = [a.detach().clone().requires_grad_(i < 3) for i, a in enumerate(args)]
        torch.sum(fn(*leaves) * cot).backward()
        return [leaves[i].grad for i in range(3)]

    g_rel = [rel(a, b) for a, b in zip(grads(fused.fused_chunk_loss_batched),
                                       grads(fused.fused_chunk_loss_batched_plain))]
    check(max(g_rel) <= 1e-4, f"{tag}: autograd gradients rel {g_rel}")
    # at the main chunk also against the split TF32 emulation of the one
    # pass's coefficient sums
    sum_worst, sum_errs, sum_emu, comb_errs = check_sum_instances(
        tag, fused, args, emulate=fused.loss_and_grads_tf32 if timed else None,
        seed=nbatch + ngrps)
    errs += sum_errs
    s_rel = sum_function_rel(args, fused.fused_chunk_terms_batched,
                             fused.fused_chunk_terms_batched_plain, seed=nbatch)
    check(max(s_rel) <= 1e-4, f"{tag}: the sum terms' autograd gradients rel {s_rel}")
    layout = ("the wide-row kernel" if plan["rows"] == 0 else
              f"rows {plan['rows']}, "
              f"{'bulk' if plan['bulk'] else 'cp.async'} copies, "
              f"{'pair' if plan['pairs'] else 'scalar'} reads, coefficients "
              f"{'in shared memory' if plan['coef_smem'] else 'in scratch'}")
    log(f"  {tag}: {layout}; max rel "
        + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
        + f"; autograd (coeffs, pr, pi) {', '.join(f'{x:.2e}' for x in g_rel)}; \"sum\" "
        "instances, two launches equal to the bit, max rel "
        + ", ".join(f"{k} {v:.2e}" for k, v in sum_worst.items())
        + (", against the split TF32 emulation "
           + ", ".join(f"{k} {v:.2e}" for k, v in sum_emu.items()) if sum_emu else "")
        + f"; their autograd {', '.join(f'{x:.2e}' for x in s_rel)}")
    out = {"max_abs_err": max(errs), "plan": plan, "sum_max_rel": sum_worst,
           "combine_max_abs_err": max(comb_errs)}
    if not timed:
        return out
    out["sum"] = time_fused_sum(args)
    log(f"    \"sum\" instances and the combine: {_sum_line(out['sum'])}; {nvidia_smi_line()}")

    def fwdbwd(fn):
        leaves = [a.detach().requires_grad_(i < 3) for i, a in enumerate(args)]
        return lambda: torch.sum(fn(*leaves)).backward()

    coeffs2, comps = args[0], args[6]
    # cuBLAS batched matvec over the same comps: (G, F, V) x (G, V, 2N)
    rhs = coeffs2.permute(2, 3, 0, 1).reshape(ngrps, nvecs, 2 * nbatch).to(comps.dtype)
    plain_loss = lambda: fused.loss_and_grads_plain(*args, mode=fused.LOSS_ONLY)  # noqa: E731
    plain_all = lambda: fused.loss_and_grads_plain(*args, mode=fused.LOSS_ALL)  # noqa: E731
    kern_loss = lambda: fused.loss_and_grads_kernel(*args, mode=fused.LOSS_ONLY)  # noqa: E731
    kern_all = lambda: fused.loss_and_grads_kernel(*args, mode=fused.LOSS_ALL)  # noqa: E731
    # in turns: plain, kernel, kernel, plain
    t = {}
    for key, fn in (("plain_grad_ms", plain_all), ("grad_ms", kern_all),
                    ("loss_only_ms", kern_loss), ("plain_ms", plain_loss),
                    ("matvec_library_ms", lambda: torch.bmm(comps, rhs)),
                    ("fwdbwd_ms", fwdbwd(fused.fused_chunk_loss_batched)),
                    ("plain_fwdbwd_ms", fwdbwd(fused.fused_chunk_loss_batched_plain))):
        t[key] = cuda_median_ms(fn)
    out.update(t)
    out["bound_ms"], out["bound_by"], moved = bound(args, grads=True)
    out["loss_only_bound_ms"] = bound(args, grads=False)[0]
    out["roofline_share"] = out["bound_ms"] / t["grad_ms"]
    # device memory a forward+backward through the Function allocates beyond
    # its inputs
    step = fwdbwd(fused.fused_chunk_loss_batched)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step()
    torch.cuda.synchronize()
    out["transient_gb"] = (torch.cuda.max_memory_allocated() - base) / 1e9
    log(f"    loss+gradients: kernel {t['grad_ms']:.4f} ms against bound {out['bound_ms']:.4f} "
        f"ms ({out['bound_by']}, {moved / 1e9:.3f} GB; share {out['roofline_share']:.3f}), "
        f"plain {t['plain_grad_ms']:.4f} ms; loss only: kernel {t['loss_only_ms']:.4f} ms "
        f"(bound {out['loss_only_bound_ms']:.4f}), plain {t['plain_ms']:.4f} ms; cuBLAS bmm "
        f"of comps {t['matvec_library_ms']:.4f} ms; forward+backward through the Function "
        f"{t['fwdbwd_ms']:.4f} ms, plain autograd {t['plain_fwdbwd_ms']:.4f} ms; transient "
        f"memory {out['transient_gb']:.3f} GB (comps {nbytes(comps) / 1e9:.3f} GB); median of "
        f"20 samples of 5 back-to-back calls; {nvidia_smi_line()}")
    return out


def hera_core_pairs(nside=19, spacing=14.6, bllen_max=45.0):
    """The HERA core's antenna pairs (``scripts/hera_core_demo_torch.py``):
    (a0, a1) of the 4388 baselines of a 19 x 19 grid up to 45 m."""
    pos = np.stack(np.meshgrid(np.arange(nside), np.arange(nside)), -1).reshape(-1, 2) * spacing
    i, j = np.triu_indices(len(pos), k=1)
    keep = np.linalg.norm(pos[j] - pos[i], axis=1) <= bllen_max
    return i[keep].astype(np.int32), j[keep].astype(np.int32), len(pos)


def _gain_operands(rng, nbatch, rows, nants, nfreqs, dtype, odd=False):
    """Cotangents (nbatch, rows, nfreqs) and gains (nbatch, nants, nfreqs)
    on the card; with ``odd`` each starts one element into its storage (not
    16-byte aligned: the products kernel's one-channel path)."""
    import torch

    dev = torch.device("cuda")

    def t(scale, offset, *shape):
        x = torch.as_tensor(offset + scale * rng.standard_normal(shape), dtype=dtype, device=dev)
        if not odd:
            return x
        store = torch.empty(x.numel() + 1, dtype=dtype, device=dev)
        store[1:] = x.reshape(-1)
        return store[1:].view(x.shape)

    return (t(1.0, 0.0, nbatch, rows, nfreqs), t(1.0, 0.0, nbatch, rows, nfreqs),
            t(0.03, 1.0, nbatch, nants, nfreqs), t(0.03, 0.0, nbatch, nants, nfreqs))


def _index_tensors(a0, a1, valid=None):
    """(rows, 1) int32 index tensors on the card, with the rows that hold a
    baseline recorded on ``a0`` (as at packing)."""
    import torch

    from calamity_tpu_torch.ops import gains

    ia0 = torch.as_tensor(np.asarray(a0, np.int32).reshape(-1, 1), device="cuda")
    ia1 = torch.as_tensor(np.asarray(a1, np.int32).reshape(-1, 1), device="cuda")
    if valid is not None:
        gains.mark_valid(ia0, np.asarray(valid, bool).reshape(-1, 1))
    return ia0, ia1


def _grad_bound(nbatch, nvalid, nants, nfreqs, itemsize):
    """(ms, "bytes" | "operations", bytes) of the gain gradient: the valid
    rows' cotangents and the gains read once, dg written once; 8 operations
    per entry (two a row) and channel."""
    moved = itemsize * nbatch * nfreqs * (2 * nvalid + 4 * nants)
    flops = 8 * 2 * nvalid * nfreqs * nbatch
    t_bytes, t_ops = 1e3 * moved / HBM_BYTES_PER_S, 1e3 * flops / F32_FLOPS
    return (t_bytes, "bytes", moved) if t_bytes >= t_ops else (t_ops, "operations", moved)


def _products_bound(nbatch, rows, nants, nfreqs, itemsize):
    """(ms, "bytes" | "operations", bytes) of the gain products: pr and pi
    written once, the gains and both index lists read once; 6 operations
    per value."""
    moved = itemsize * nbatch * nfreqs * (2 * rows + 2 * nants) + 8 * rows
    flops = 6 * nbatch * rows * nfreqs
    t_bytes, t_ops = 1e3 * moved / HBM_BYTES_PER_S, 1e3 * flops / F32_FLOPS
    return (t_bytes, "bytes", moved) if t_bytes >= t_ops else (t_ops, "operations", moved)


def _rel_limit(dtype):
    import torch

    return 1e-5 if dtype == torch.float32 else 1e-12


def compare_gain_grad(tag, nbatch, a0, a1, nants, timed=False, valid=None, dtype=None,
                      nfreqs=NFREQS, odd=False):
    """The gain-gradient kernel against its plain version (rel 1e-5 in
    float32, 1e-12 in float64), two launches on the same inputs bit-equal.
    With ``valid`` (the rows that hold a baseline) the padded rows'
    cotangents are zero, as in the descent, and the lists that leave them
    out give the gradient of the lists that keep them (the earlier design's
    lists, one segment an antenna), equal to the bit. With ``timed``, CUDA-event times of the
    kernel, the plain version (the products' gathers and their
    ``index_select`` backward under autograd) and one ``index_add_`` that
    scatters the per-entry contributions of every row, and the bound."""
    import torch

    from calamity_tpu_torch.ops import gains

    dtype = dtype or torch.float32
    rng = np.random.default_rng(SEED + nbatch + nants + len(a0))
    rows = len(a0)
    dpr, dpi, g_r, g_i = _gain_operands(rng, nbatch, rows, nants, nfreqs, dtype, odd)
    ia0, ia1 = _index_tensors(a0, a1, valid)
    if valid is not None:
        pad = torch.as_tensor(~np.asarray(valid, bool).reshape(-1), device="cuda")
        dpr[:, pad] = 0.0
        dpi[:, pad] = 0.0
    index = gains.antenna_csr(ia0, ia1, nants)
    got = gains.gain_grad_kernel(dpr, dpi, g_r, g_i, index)
    again = gains.gain_grad_kernel(dpr, dpi, g_r, g_i, index)
    want = gains.gain_grad_plain(dpr, dpi, g_r, g_i, ia0, ia1)
    torch.cuda.synchronize()
    errs = [rel(g, w) for g, w in zip(got, want)]
    limit = _rel_limit(dtype)
    check(max(errs) <= limit, f"gain_grad {tag}: rel {errs}")
    check(all(torch.equal(g, a) for g, a in zip(got, again)), f"gain_grad {tag}: two launches "
          "differ")
    used = np.zeros(nants, bool)
    keep = np.ones(rows, bool) if valid is None else np.asarray(valid, bool).reshape(-1)
    used[np.asarray(a0)[keep]] = used[np.asarray(a1)[keep]] = True
    check(all(bool(torch.all(g[:, ~torch.as_tensor(used, device="cuda")] == 0)) for g in got),
          f"gain_grad {tag}: an antenna with no rows has a gradient")
    counts = np.diff(index.offsets.cpu().numpy())
    out = {"max_abs_err": max(float((g - w).abs().max()) for g, w in zip(got, want)),
           "nvalid": int(keep.sum()), "rows": rows}
    line = (f"  gain_grad {tag}: N={nbatch}, {rows} rows ({int(keep.sum())} listed), {nants} "
            f"antennas, {nfreqs} channels, {str(dtype).replace('torch.', '')}"
            f"{', unaligned' if odd else ''}: lists of {counts.min()}-{counts.max()} entries, "
            f"{index.nseg} segments, {'two passes' if index.nmulti else 'one pass'}; max rel "
            f"{max(errs):.2e} (limit {limit:.0e}); two launches bit-equal")
    if valid is not None:
        listed = gains.GainIndex(ia0, ia1, nants, None, seg_len=2 * rows + 1)
        old = gains.gain_grad_kernel(dpr, dpi, g_r, g_i, listed)
        check(all(torch.equal(g, o) for g, o in zip(got, old)),
              f"gain_grad {tag}: padding listed and padding dropped differ")
        line += "; equal to the bit to the lists that keep the padding"
    log(line)
    if not timed:
        return out
    # one index_add_ over every row's (row, side) contributions, computed
    # beforehand: the scatter that the plain version's backward runs (as
    # four calls)
    ant = torch.cat([ia0.reshape(-1), ia1.reshape(-1)]).long()
    contrib = torch.as_tensor(rng.standard_normal((nbatch, 2 * rows, 2 * nfreqs)), dtype=dtype,
                              device="cuda")
    acc = torch.zeros(nbatch, nants, 2 * nfreqs, dtype=dtype, device="cuda")
    out.update({
        "ms": cuda_median_ms(lambda: gains.gain_grad_kernel(dpr, dpi, g_r, g_i, index)),
        "device_ms": cuda_graph_ms(lambda: gains.gain_grad_kernel(dpr, dpi, g_r, g_i, index)),
        "plain_ms": cuda_median_ms(lambda: gains.gain_grad_plain(dpr, dpi, g_r, g_i, ia0, ia1)),
        "library_ms": cuda_median_ms(lambda: acc.index_add_(1, ant, contrib)),
    })
    out["bound_ms"], out["bound_by"], moved = _grad_bound(nbatch, int(keep.sum()), nants, nfreqs,
                                                          g_r.element_size())
    log(f"    kernel {out['ms']:.4f} ms (the device alone {out['device_ms']:.4f}) against bound "
        f"{out['bound_ms']:.4f} ms ({out['bound_by']},"
        f" {moved / 1e9:.3f} GB); plain (gathers, products and their autograd backward) "
        f"{out['plain_ms']:.4f} ms; one index_add_ of every row's contributions "
        f"{out['library_ms']:.4f} ms; median of 20 samples of 5 back-to-back calls; "
        f"{nvidia_smi_line()}")
    return out


def compare_products(tag, nbatch, a0, a1, nants, timed=False, dtype=None, nfreqs=NFREQS,
                     odd=False):
    """The gain-products kernel against the torch ops (``_products``), equal
    to the bit; with ``timed``, CUDA-event times of the kernel, the torch
    ops and their four ``index_select`` gathers alone, and the bound."""
    import torch

    from calamity_tpu_torch.ops import gains

    dtype = dtype or torch.float32
    rng = np.random.default_rng(SEED + 3 * nbatch + nants + len(a0))
    rows = len(a0)
    _, _, g_r, g_i = _gain_operands(rng, nbatch, 1, nants, nfreqs, dtype, odd)
    ia0, ia1 = _index_tensors(a0, a1)
    index = gains.antenna_csr(ia0, ia1, nants)
    got = gains.gain_products_kernel(g_r, g_i, index)
    want = [x.reshape(nbatch, rows, nfreqs) for x in gains._products(g_r, g_i, ia0, ia1)]
    torch.cuda.synchronize()
    check(all(torch.equal(g, w) for g, w in zip(got, want)),
          f"gain_products {tag}: not equal to the torch ops: max abs "
          f"{[float((g - w).abs().max()) for g, w in zip(got, want)]}")
    out = {"max_abs_err": max(float((g - w).abs().max()) for g, w in zip(got, want))}
    log(f"  gain_products {tag}: N={nbatch}, {rows} rows, {nants} antennas, {nfreqs} channels, "
        f"{str(dtype).replace('torch.', '')}{', unaligned' if odd else ''}: equal to the torch "
        "ops to the bit")
    if not timed:
        return out
    i0, i1 = ia0.reshape(-1), ia1.reshape(-1)
    out.update({
        "ms": cuda_median_ms(lambda: gains.gain_products_kernel(g_r, g_i, index)),
        "device_ms": cuda_graph_ms(lambda: gains.gain_products_kernel(g_r, g_i, index)),
        "plain_ms": cuda_median_ms(lambda: gains._products(g_r, g_i, ia0, ia1)),
        "gathers_ms": cuda_median_ms(lambda: (g_r.index_select(1, i0), g_r.index_select(1, i1),
                                              g_i.index_select(1, i0), g_i.index_select(1, i1))),
        "library_ms": None,  # no single PyTorch call gathers and multiplies
    })
    out["bound_ms"], out["bound_by"], moved = _products_bound(nbatch, rows, nants, nfreqs,
                                                              g_r.element_size())
    log(f"    kernel {out['ms']:.4f} ms (the device alone {out['device_ms']:.4f}) against bound "
        f"{out['bound_ms']:.4f} ms ({out['bound_by']},"
        f" {moved / 1e9:.3f} GB); torch ops (4 index_select, 6 elementwise) "
        f"{out['plain_ms']:.4f} ms, of which the four gathers {out['gathers_ms']:.4f} ms; median "
        f"of 20 samples of 5 back-to-back calls; {nvidia_smi_line()}")
    return out


_HERA = {}  # the HERA core's simulation, built once for phases 3g and 10


def hera_core_build():
    """``scripts/hera_core_demo_torch.py``'s corrupted core and its
    components at full width, built once."""
    import hera_core_demo_torch as demo

    if not _HERA:
        t0 = time.time()
        _HERA["build"] = demo.build()
        _HERA["seconds"] = time.time() - t0
    return _HERA["build"]


def hera_packed_chunks():
    """The HERA core's chunks as the default packing (``shared_basis=True``,
    ``nvec_bucketing``) packs them on the card: [(a0, a1, valid), ...] as
    numpy, and the antenna count."""
    from calamity_tpu_torch import cal_utils
    from calamity_tpu_torch.ops import gains
    from calamity_tpu_torch.solver.tensorize import FitSpec

    corrupted, comps, _ = hera_core_build()
    cal = cal_utils.blank_uvcal_from_uvdata(corrupted)
    spec = FitSpec(corrupted, comps, {int(a): i for i, a in enumerate(cal.ant_array)},
                   device="cuda", nvec_bucketing=True, shared_basis=True)
    out = [(c.a0.cpu().numpy().reshape(-1), c.a1.cpu().numpy().reshape(-1),
            gains.valid_rows(c.a0).reshape(-1)) for c in spec.chunks]
    # each chunk's (U, F, V): the shared-basis kernel's shapes (phase 3s)
    _HERA["comps_shapes"] = [(c.comps.shape[0],) + tuple(c.comps.shape[2:]) for c in spec.chunks]
    check(all(np.array_equal(v, m.valid.reshape(-1)) for (_, _, v), m in zip(out, spec.meta)),
          "the chunks' index tensors do not carry ChunkMeta.valid")
    return out, spec.nants


def hera_packed_step(chunks, nants, nbatch):
    """The four gain-gradient launches and the four gain-products launches
    of one step of the HERA core's packed chunks, timed together (CUDA
    events), against the bound of their valid rows, their plain versions,
    four ``index_add_`` over every row (the padding too, as the torch
    backward scatters it) and the lists that keep the padding (the earlier
    design's: one segment an antenna; and cut into segments)."""
    import torch

    from calamity_tpu_torch.ops import gains

    rng = np.random.default_rng(SEED + 11 * nbatch)
    ops, idx = [], []
    for a0, a1, valid in chunks:
        dpr, dpi, g_r, g_i = _gain_operands(rng, nbatch, len(a0), nants, NFREQS, torch.float32)
        pad = torch.as_tensor(~valid, device="cuda")
        dpr[:, pad] = 0.0
        dpi[:, pad] = 0.0
        ia0, ia1 = _index_tensors(a0, a1, valid)
        ops.append((dpr, dpi, g_r, g_i))
        idx.append((ia0, ia1, gains.antenna_csr(ia0, ia1, nants),
                    gains.GainIndex(ia0, ia1, nants, None, seg_len=2 * len(a0) + 1),
                    gains.GainIndex(ia0, ia1, nants, None)))
    scatter = []
    for (dpr, _, _, _), (ia0, ia1, *_) in zip(ops, idx):
        ant = torch.cat([ia0.reshape(-1), ia1.reshape(-1)]).long()
        scatter.append((torch.zeros(nbatch, nants, 2 * NFREQS, device="cuda"), ant,
                        torch.as_tensor(rng.standard_normal((nbatch, len(ant), 2 * NFREQS)),
                                        dtype=torch.float32, device="cuda")))

    def grads(which):
        return lambda: [gains.gain_grad_kernel(*o, ix[which]) for o, ix in zip(ops, idx)]

    out = {
        "ms": cuda_median_ms(grads(2)),
        "device_ms": cuda_graph_ms(grads(2)),
        "listed_one_segment_ms": cuda_median_ms(grads(3)),
        "listed_segmented_ms": cuda_median_ms(grads(4)),
        "plain_ms": cuda_median_ms(lambda: [gains.gain_grad_plain(*o, ix[0], ix[1])
                                            for o, ix in zip(ops, idx)]),
        "library_ms": cuda_median_ms(lambda: [a.index_add_(1, i, c) for a, i, c in scatter]),
        "products_ms": cuda_median_ms(lambda: [gains.gain_products_kernel(o[2], o[3], ix[2])
                                               for o, ix in zip(ops, idx)]),
        "products_device_ms": cuda_graph_ms(lambda: [gains.gain_products_kernel(o[2], o[3], ix[2])
                                                     for o, ix in zip(ops, idx)]),
        "products_plain_ms": cuda_median_ms(lambda: [gains._products(o[2], o[3], ix[0], ix[1])
                                                     for o, ix in zip(ops, idx)]),
    }
    nvalid = sum(int(v.sum()) for _, _, v in chunks)
    rows = sum(len(a) for a, _, _ in chunks)
    out["bound_ms"] = sum(_grad_bound(nbatch, int(v.sum()), nants, NFREQS, 4)[0]
                          for _, _, v in chunks)
    out["bound_by"] = "bytes"
    out["products_bound_ms"] = sum(_products_bound(nbatch, len(a), nants, NFREQS, 4)[0]
                                   for a, _, _ in chunks)
    out["segments"] = [ix[2].nseg for ix in idx]
    log(f"  HERA packed step, N={nbatch} ({len(chunks)} chunks, {rows} rows, {nvalid} valid): "
        f"gain_grad x{len(chunks)} {out['ms']:.4f} ms (the device alone {out['device_ms']:.4f}) "
        f"against bound {out['bound_ms']:.4f} ms "
        f"(bytes of the valid rows); the lists that keep the padding: one segment an antenna "
        f"{out['listed_one_segment_ms']:.4f} ms, segmented {out['listed_segmented_ms']:.4f} ms; "
        f"plain {out['plain_ms']:.4f} ms; index_add_ of every row x{len(chunks)} "
        f"{out['library_ms']:.4f} ms. gain_products x{len(chunks)} {out['products_ms']:.4f} ms "
        f"(the device alone {out['products_device_ms']:.4f}) against bound "
        f"{out['products_bound_ms']:.4f} ms, torch ops "
        f"{out['products_plain_ms']:.4f} ms; {nvidia_smi_line()}")
    return out


def phase_gain_grad():
    """Phase 3's cases of the gain kernels (3g): the gradient at phase 7's
    shapes (2016 rows, 64 antennas) and the HERA core's rows (4388 rows,
    361 antennas), N = 1 and 8, timed; the HERA core's packed chunks with
    their padding (N = 1 and 8: each chunk, then one step's four launches
    timed); a padded row and an antenna with no rows; a skewed list (one
    antenna in more than 10 segments: two passes); float64, a channel count
    that is not a multiple of 4 and unaligned operands, for long lists and
    for short ones. The products kernel
    against the torch ops at the same shapes, equal to the bit."""
    import torch

    from calamity_tpu_torch.ops.gains import SEGMENT

    log("== phase 3 (gain kernels): gain_grad against plain (rel 1e-5, two launches bit-equal), "
        "gain_products against the torch ops (equal to the bit)")
    i, j = np.triu_indices(NANTS, k=1)
    h0, h1, hnants = hera_core_pairs()
    check(len(h0) == 4388 and hnants == 361, f"HERA core: {len(h0)} rows, {hnants} antennas")
    results, prods = {}, {}
    for n in (8, 1):
        results[("phase7", n)] = compare_gain_grad("phase 7's rows", n, i, j, NANTS, timed=True)
        results[("hera", n)] = compare_gain_grad("the HERA core's rows", n, h0, h1, hnants,
                                                 timed=True)
        prods[("phase7", n)] = compare_products("phase 7's rows", n, i, j, NANTS, timed=True)
        prods[("hera", n)] = compare_products("the HERA core's rows", n, h0, h1, hnants,
                                              timed=True)
    # a padded row (antenna 0 with itself, zero cotangent in the descent) and
    # an antenna (the last) in no row
    results["padded"] = compare_gain_grad("padded row, antenna with no rows", 8,
                                          np.append(i, 0), np.append(j, 0), NANTS + 1,
                                          valid=np.append(np.ones(len(i), bool), False))
    # one antenna in more than 10 segments, with non-zero cotangents
    extra = 10 * SEGMENT + 37
    s0 = np.concatenate([i, np.zeros(extra, np.int64)])
    s1 = np.concatenate([j, 1 + np.arange(extra) % (NANTS - 1)])
    for dt in (torch.float32, torch.float64):
        results[("skewed", dt)] = compare_gain_grad("skewed list", 8, s0, s1, NANTS, dtype=dt)
        results[("ragged", dt)] = compare_gain_grad("phase 7's rows", 3, i, j, NANTS, dtype=dt,
                                                    nfreqs=NFREQS - 5)
        results[("odd", dt)] = compare_gain_grad("skewed list", 3, s0, s1, NANTS, dtype=dt,
                                                 odd=True)
        prods[("f", dt)] = compare_products("phase 7's rows", 8, i, j, NANTS, dtype=dt)
        prods[("ragged", dt)] = compare_products("phase 7's rows", 3, i, j, NANTS, dtype=dt,
                                                 nfreqs=NFREQS - 5)
        prods[("odd", dt)] = compare_products("phase 7's rows", 3, i, j, NANTS, dtype=dt,
                                              odd=True)
    torch.cuda.empty_cache()
    chunks, nants = hera_packed_chunks()
    ngrps = sum(len(a) for a, _, _ in chunks)
    npad = sum(int((~v).sum()) for _, _, v in chunks)
    log(f"  the HERA core's packed chunks ({_HERA['seconds']:.1f} s to simulate): {len(chunks)} "
        f"chunks of {[len(a) for a, _, _ in chunks]} groups, {ngrps} in all, {npad} of them "
        "padding")
    check(len(chunks) == 4 and ngrps == 7168 and npad == 2780,
          f"HERA packed chunks: {len(chunks)} chunks, {ngrps} groups, {npad} padding")
    # short lists at a ragged channel count and on unaligned operands
    a0, a1, valid = chunks[1]
    for dt in (torch.float32, torch.float64):
        results[("packed_ragged", dt)] = compare_gain_grad(
            "HERA packed chunk 1", 3, a0, a1, nants, valid=valid, dtype=dt, nfreqs=NFREQS - 5)
        results[("packed_odd", dt)] = compare_gain_grad(
            "HERA packed chunk 1", 3, a0, a1, nants, valid=valid, dtype=dt, odd=True)
    hera_packed = {}
    for n in (1, 8):
        for c, (a0, a1, valid) in enumerate(chunks):
            results[("hera_packed", c, n)] = compare_gain_grad(
                f"HERA packed chunk {c}", n, a0, a1, nants, valid=valid)
            prods[("hera_packed", c, n)] = compare_products(f"HERA packed chunk {c}", n, a0, a1,
                                                            nants)
        hera_packed[n] = hera_packed_step(chunks, nants, n)
        torch.cuda.empty_cache()
    return {"grad": results, "products": prods, "hera_packed": hera_packed}


def phase_kernel_vs_plain(main_shape):
    import torch

    log("== phase 3: kernel against plain, every instance (loss rel 1e-5, gradients rel 1e-4)")
    f32, bf16 = torch.float32, torch.bfloat16
    results = {}
    ngrps, nfreqs, nvecs = main_shape
    for cdt in (f32, bf16):
        for n in (8, 1):
            results[(n, cdt)] = compare(n, main_shape, cdt, f32, timed=True)
            torch.cuda.empty_cache()
        results[(8, cdt, "w16")] = compare(8, main_shape, cdt, bf16)
        torch.cuda.empty_cache()
        for wdt in (f32, bf16):
            for n in (1, 3, 9):
                for shape in ((5, 37, 3), (7, 129, 130), (1, 1, 1), (3, 50, 300)):
                    results[(n, shape, cdt, wdt)] = compare(n, shape, cdt, wdt)
            results[("view", cdt, wdt)] = compare(3, (7, 129, 130), cdt, wdt, extra=5)
        results[("odd", cdt)] = compare(3, (7, 129, 118), cdt, f32, odd_offset=True)
        results[("w_plane", cdt)] = compare(3, (7, 129, 118), cdt, bf16, w_plane=True)
        results[("scratch", cdt)] = compare(8, (2, 16, 4000), cdt, f32)
        results[("rows8", cdt)] = compare(3, (3, 50, 700), cdt, f32)
        results[("wide", cdt)] = compare(3, (2, 3, 60000), cdt, f32)
    results["main_view"] = compare(8, (ngrps // 2, nfreqs, nvecs), f32, f32,
                                   extra=ngrps - ngrps // 2)
    torch.cuda.empty_cache()
    # two slice tiles, the second of one slice, at the main shape
    results["main_n9"] = compare(9, main_shape, f32, f32)
    torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------- #
# phase 3s: the shared-basis kernel against plain
# ---------------------------------------------------------------------- #
def shared_inputs(nbatch, nu, nfreqs, nvecs, valid, comps_dtype, seed, block=None,
                  wgts="float32", on_card=False):
    """Operands of the shared-basis kernel for a chunk of ``nu`` operators
    and ``len(valid)`` groups (padding groups: zero weight); with ``block``
    = (u0, u1) the operands are those of the classes [u0, u1) of that
    chunk, views of its tensors, as a group block or a mesh block takes
    them; ``wgts`` "bfloat16" gives bfloat16 weights, "plane" one weight a
    (slice, group) broadcast over the channels (a stride-0 view). The
    numbers come from numpy's generator or, with ``on_card``, from torch's
    on the card (the full array's planes: up to 180 M entries a stack).
    Returns (args for ``loss_and_grads_*`` without the mask, the mask)."""
    import torch

    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")
    ngrps = len(valid)
    gen = torch.Generator(device=dev).manual_seed(seed) if on_card else None

    def t(*shape):
        if on_card:
            return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        return torch.as_tensor(rng.standard_normal(shape, dtype=np.float32), device=dev)

    comps = t(nu, nfreqs, nvecs)
    comps /= torch.linalg.vector_norm(comps, dim=1, keepdim=True)
    comps = comps.to(comps_dtype)
    mask = torch.as_tensor(np.asarray(valid, bool), device=dev)
    coeffs2 = t(2, nbatch, ngrps, nvecs)
    pr, pi = 1 + 0.1 * t(nbatch, ngrps, nfreqs), 0.1 * t(nbatch, ngrps, nfreqs)
    dr, di = t(nbatch, ngrps, nfreqs), t(nbatch, ngrps, nfreqs)
    w = t(nbatch, ngrps, nfreqs).abs() * mask.reshape(1, -1, 1)
    w /= w.sum(dim=(1, 2), keepdim=True)
    if wgts == "bfloat16":
        w = w.to(torch.bfloat16)
    elif wgts == "plane":
        w = w[..., :1].expand(-1, -1, nfreqs)
    args = [coeffs2, pr, pi, dr, di, w, comps]
    if block is None:
        return args, mask
    gmax = ngrps // nu
    g = slice(block[0] * gmax, block[1] * gmax)
    # the dense operands are copies (the wrapper takes them contiguous, as
    # a block's gain products and stacked coefficients are); the data and
    # weights stay views
    return ([coeffs2[:, :, g].contiguous(), pr[:, g].contiguous(), pi[:, g].contiguous(),
             dr[:, g], di[:, g], w[:, g], comps[block[0]:block[1]]], mask[g])


def _shared_bound(args, mask, grads=True, sums=False):
    """(ms, "bytes" | "operations", bytes) of the shared-basis kernel's work
    on these inputs: comps and the coefficients read once, the planes of
    the groups that hold a baseline read once (padding's are not needed),
    the losses and (``grads``: "dp" or True) dpr, dpi and (True) dcoeffs
    written once; with ``sums`` as in :func:`bound`; per valid
    entry 4 V multiply-adds (8 V operations) of the products, on the tensor
    cores at the TF32 rate over the split products each takes (3 for
    float32 comps, 2 for bfloat16), and 28 others at the float32 rate; the
    two units run side by side, so the operations take the longer of the
    two."""
    import torch

    coeffs2, pr, pi, dr, di, w, comps = args
    nbatch, ngrps, nfreqs = pr.shape
    nvecs = comps.shape[-1]
    entries = nbatch * int(mask.sum()) * nfreqs
    moved = nbytes(comps) + nbytes(coeffs2) + entries * (16 + w.element_size()) + 4 * nbatch
    mma_flops, flops = entries * 4 * nvecs, entries * 12
    if sums:
        moved, flops = moved + 8 * nbatch, flops + entries * 4
    if grads:
        moved, flops = moved + 2 * nbytes(pr), flops + entries * 16
    if grads is True:
        moved, mma_flops = moved + nbytes(coeffs2), 2 * mma_flops
    products = 3 if comps.dtype == torch.float32 else 2
    t_bytes = 1e3 * moved / HBM_BYTES_PER_S
    t_ops = max(1e3 * mma_flops * products / TF32_FLOPS, 1e3 * flops / F32_FLOPS)
    return (t_bytes, "bytes", moved) if t_bytes >= t_ops else (t_ops, "operations", moved)


def _torch_ops_losses(coeffs2, pr, pi, dr, di, w, comps3):
    """The torch ops the kernel replaces, differentiable by autograd: the
    shared branches of ``fg_model_batched`` (a bfloat16 basis upcast to a
    float32 copy first), the gain-weighted model and the weighted sum."""
    import torch

    from calamity_tpu_torch.ops.loss import fg_model_batched

    vr, vi = fg_model_batched(coeffs2[0], coeffs2[1], comps3.unsqueeze(1))
    vr, vi = vr[:, :, 0], vi[:, :, 0]
    mr = pr * vr + pi * vi
    mi = -pi * vr + pr * vi
    return torch.sum(w.float() * ((dr - mr) ** 2 + (di - mi) ** 2), dim=(1, 2))


def _torch_ops_terms(coeffs2, pr, pi, dr, di, w, comps3, valid):
    """The torch ops the "sum" instances replace (``ops.loss._sum_terms``'
    model and sums on a shared chunk's operands), differentiable by
    autograd: (3, N) chi-square, M_r, M_i; padding groups' weights zeroed."""
    import torch

    from calamity_tpu_torch.ops.loss import fg_model_batched

    vr, vi = fg_model_batched(coeffs2[0], coeffs2[1], comps3.unsqueeze(1))
    vr, vi = vr[:, :, 0], vi[:, :, 0]
    mr = pr * vr + pi * vi
    mi = -pi * vr + pr * vi
    wf = w.float() * valid.reshape(1, -1, 1)
    return torch.stack([torch.sum(wf * ((dr - mr) ** 2 + (di - mi) ** 2), dim=(1, 2)),
                        torch.sum(wf * mr, dim=(1, 2)), torch.sum(wf * mi, dim=(1, 2))])


def compare_shared(tag, nbatch, nu, nfreqs, nvecs, valid, comps_dtype, timed=False,
                   block=None, wgts="float32"):
    """Every instance of the shared-basis kernel against its plain version
    (loss rel 1e-5, gradients rel 1e-4), two launches on the same inputs
    equal to the bit, and the autograd Function against the torch ops it
    replaces under autograd at a different cotangent per slice; with
    ``timed``, CUDA-event times through the wrapper and, replayed from a
    CUDA graph, of the device alone."""
    import torch

    from calamity_tpu_torch.ops import fused, shared

    args, mask = shared_inputs(nbatch, nu, nfreqs, nvecs, valid, comps_dtype,
                               SEED + 13 * nbatch + nu + nvecs, block, wgts)
    dt = str(comps_dtype).replace("torch.", "")
    tag = (f"{tag}: N={nbatch} U={args[6].shape[0]} G={args[1].shape[1]} F={nfreqs} V={nvecs} "
           f"{dt} comps" + (f", classes {block} of {nu} as views" if block else "")
           + ("" if wgts == "float32" else f", {wgts} weights"))
    errs, worst, emu = [], {}, {}
    for mode in (fused.LOSS_ONLY, fused.LOSS_DP, fused.LOSS_ALL):
        got = shared.loss_and_grads_kernel(*args, mask, mode)
        again = shared.loss_and_grads_kernel(*args, mask, mode)
        want = shared.loss_and_grads_plain(*args, mask, mode)
        # the kernel's split TF32 products emulated with torch ops
        split = shared.loss_and_grads_tf32(*args, mask, mode)
        torch.cuda.synchronize()
        for name, g, e in zip(("loss", "dcoeffs", "dpr", "dpi"), got, split):
            if e is not None:
                emu[name] = max(emu.get(name, 0.0), rel(g, e))
        check(all((a is None and b is None) or torch.equal(a, b) for a, b in zip(got, again)),
              f"{tag} mode {mode}: two launches differ")
        loss_rel = float(((got[0] - want[0]).abs() / want[0].abs()).max())
        check(loss_rel <= 1e-5, f"{tag} mode {mode}: loss rel {loss_rel}")
        worst["loss"] = max(worst.get("loss", 0.0), loss_rel)
        errs.append(float((got[0] - want[0]).abs().max()))
        for name, g, p in zip(("dcoeffs", "dpr", "dpi"), got[1:], want[1:]):
            check((g is None) == (p is None), f"{tag} mode {mode}: {name} presence")
            if p is None:
                continue
            r = rel(g, p)
            check(r <= 1e-4, f"{tag} mode {mode}: {name} rel {r}")
            worst[name] = max(worst.get(name, 0.0), r)
            errs.append(float((g - p).abs().max()))
        if got[1] is not None:
            pad = ~mask
            check(not bool(got[1][:, :, pad].any() or got[2][:, pad].any()),
                  f"{tag}: padding groups' gradients are not zero")
    cot = torch.arange(1, nbatch + 1, device=args[0].device, dtype=torch.float32)

    def grads(fn, *extra):
        leaves = [a.detach().clone().requires_grad_(i < 3) for i, a in enumerate(args)]
        torch.sum(fn(*leaves, *extra) * cot).backward()
        return [leaves[i].grad for i in range(3)]

    g_rel = [rel(a, b) for a, b in zip(grads(shared.shared_chunk_loss_batched, mask),
                                       grads(_torch_ops_losses))]
    check(max(g_rel) <= 1e-4, f"{tag}: autograd gradients rel {g_rel}")
    sum_worst, sum_errs, sum_emu, _ = check_sum_instances(
        tag, shared, args, (mask,), emulate=shared.loss_and_grads_tf32, seed=nbatch + nvecs)
    errs += sum_errs
    s_rel = sum_function_rel(args, shared.shared_chunk_terms_batched, _torch_ops_terms, (mask,),
                             seed=nbatch)
    check(max(s_rel) <= 1e-4, f"{tag}: the sum terms' autograd gradients rel {s_rel}")
    log(f"  {tag}: max rel " + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
        + "; against the split TF32 emulation " + ", ".join(f"{k} {v:.2e}" for k, v in emu.items())
        + f"; two launches equal to the bit; against the torch ops under autograd (coeffs, pr, "
        f"pi) {', '.join(f'{x:.2e}' for x in g_rel)}; \"sum\" instances max rel "
        + ", ".join(f"{k} {v:.2e}" for k, v in sum_worst.items()) + ", against the emulation "
        + ", ".join(f"{k} {v:.2e}" for k, v in sum_emu.items())
        + f", their autograd against the torch ops {', '.join(f'{x:.2e}' for x in s_rel)}")
    out = {"max_abs_err": max(errs), "max_rel": worst, "emulation_max_rel": emu,
           "sum_max_rel": sum_worst, "sum_emulation_max_rel": sum_emu}
    if not timed:
        return out
    out["sum"] = time_sum_instances(shared, args, (mask,),
                                    lambda g: _shared_bound(args, mask, g, sums=True))
    log(f"    \"sum\" instances: {_sum_line(out['sum'])}; {nvidia_smi_line()}")

    def fwdbwd(fn, *extra):
        leaves = [a.detach().requires_grad_(i < 3) for i, a in enumerate(args)]
        return lambda: torch.sum(fn(*leaves, *extra)).backward()

    coeffs2, comps = args[0], args[6]
    nu, ngrps = comps.shape[0], coeffs2.shape[2]
    # cuBLAS' batched matvec of the same operators: (U, F, V) x (U, V, 2 N gmax)
    rhs = (coeffs2.reshape(2, nbatch, nu, ngrps // nu, nvecs).permute(2, 4, 0, 1, 3)
           .reshape(nu, nvecs, -1).contiguous())
    comps_f = comps.float()
    kern = lambda: shared.loss_and_grads_kernel(*args, mask)  # noqa: E731
    t = {"plain_ms": cuda_median_ms(lambda: shared.loss_and_grads_plain(*args, mask)),
         "ms": cuda_median_ms(kern),
         "device_ms": cuda_graph_ms(kern),
         "loss_only_ms": cuda_median_ms(
             lambda: shared.loss_and_grads_kernel(*args, mask, fused.LOSS_ONLY)),
         "library_ms": cuda_median_ms(lambda: torch.bmm(comps_f, rhs)),
         "fwdbwd_ms": cuda_median_ms(fwdbwd(shared.shared_chunk_loss_batched, mask)),
         "torch_ops_fwdbwd_ms": cuda_median_ms(fwdbwd(_torch_ops_losses))}
    out.update(t)
    out["bound_ms"], out["bound_by"], moved = _shared_bound(args, mask)
    out["roofline_share"] = out["bound_ms"] / t["device_ms"]
    log(f"    loss+gradients: kernel {t['ms']:.4f} ms (the device alone {t['device_ms']:.4f}) "
        f"against bound {out['bound_ms']:.4f} ms ({out['bound_by']}, {moved / 1e9:.3f} GB; share "
        f"{out['roofline_share']:.3f}), plain {t['plain_ms']:.4f} ms; loss only "
        f"{t['loss_only_ms']:.4f} ms; cuBLAS bmm of the matvec {t['library_ms']:.4f} ms; "
        f"forward+backward through the Function {t['fwdbwd_ms']:.4f} ms, the torch ops it "
        f"replaces under autograd {t['torch_ops_fwdbwd_ms']:.4f} ms; {nvidia_smi_line()}")
    return out


# phase 3s's ragged shapes, (U, gmax, F, V[, the one comps dtype]): the
# tensor-core tiles' edges (a short last channel tile, F = 37, 100, 1500;
# modes not a whole number of k-steps, V = 3, 60, 130, or of the 64 a block
# holds; V = 64 exactly); past 64 modes a cluster of 64-mode slices (V = 65:
# one mode in the second; 130, 200, 557 with the last slice short; rows
# copied by plain loads); the widest bases of the gate before the slices
# (600 float32, 720 bfloat16: clusters of 10 and 12) and the widest now,
# 1024 modes (a cluster of 16)
SHARED_RAGGED = ((1, 2, 37, 3), (3, 5, 100, 130), (2, 7, 64, 557), (1, 33, 64, 200),
                 (1, 40, 1500, 60), (2, 24, 1500, 64), (3, 11, 37, 64), (1, 70, 1500, 3),
                 (2, 9, 100, 65), (1, 3, 100, 1024),
                 (1, 7, 1536, 600, "float32"), (1, 7, 1536, 720, "bfloat16"))


def ragged_cases(comps_dtype):
    """The (U, gmax, F, V) of :data:`SHARED_RAGGED` run with ``comps_dtype``."""
    name = str(comps_dtype).replace("torch.", "")
    return [case[:4] for case in SHARED_RAGGED if len(case) == 4 or case[4] == name]


def ragged_valid(nu, gmax):
    """The groups of a ragged case: with more than one class, each class's
    last group is padding."""
    valid = np.ones(nu * gmax, bool)
    if nu > 1:
        valid[gmax - 1::gmax] = False
    return valid


def phase_shared_kernel():
    """Phase 3s: the shared-basis kernel at the HERA core's four packed
    chunk shapes with their padding, N = 1 and 8, float32 and bfloat16
    comps, every instance against its plain version and repeated launches
    equal to the bit, each timed; one step's four launches at N = 1 summed;
    a block of whole classes as views; ragged shapes (channels not a whole
    number of tiles, short pair tiles, modes not a whole number of k-steps
    and past the register tiles, rows copied by plain loads, a one-tile
    ring); bfloat16 weights and a weight plane at chunk 2's shape."""
    import torch

    log("== phase 3s: the shared-basis kernel against plain (loss rel 1e-5, gradients rel "
        "1e-4, two launches bit-equal)")
    f32, bf16 = torch.float32, torch.bfloat16
    chunks, _ = hera_packed_chunks()
    shapes = _HERA["comps_shapes"]
    results = {}
    for c, ((nu, nfreqs, nvecs), (_, _, valid)) in enumerate(zip(shapes, chunks)):
        for cdt in (f32, bf16):
            for n in (1, 8):
                results[(c, n, cdt)] = compare_shared(f"HERA chunk {c}", n, nu, nfreqs, nvecs,
                                                      valid, cdt, timed=True)
                torch.cuda.empty_cache()
    for cdt in (f32, bf16):
        # chunk 1 (3 classes) cut to its middle class, as a group block or a
        # mesh rank takes it
        nu, nfreqs, nvecs = shapes[1]
        results[("view", cdt)] = compare_shared("HERA chunk 1", 8, nu, nfreqs, nvecs,
                                                chunks[1][2], cdt, block=(1, 2))
        for n in (1, 3):
            for nu, gmax, nf, nv in ragged_cases(cdt):
                results[(n, nu, gmax, nf, nv, cdt)] = compare_shared(
                    "ragged", n, nu, nf, nv, ragged_valid(nu, gmax), cdt)
        # the weights as bfloat16 and as one plane a (slice, group)
        nu, nfreqs, nvecs = shapes[2]
        for wgts in ("bfloat16", "plane"):
            for n in (1, 8):
                results[(wgts, n, cdt)] = compare_shared("HERA chunk 2", n, nu, nfreqs, nvecs,
                                                         chunks[2][2], cdt, wgts=wgts)
    for cdt in (f32, bf16):
        for n in (1, 8):
            step = [results[(c, n, cdt)] for c in range(len(shapes))]
            log(f"  HERA step of {len(step)} chunks, N={n} {str(cdt)[6:]} comps: kernel "
                f"{sum(r['ms'] for r in step):.4f} ms (the device alone "
                f"{sum(r['device_ms'] for r in step):.4f}) against bound "
                f"{sum(r['bound_ms'] for r in step):.4f} ms; the torch ops it replaces under "
                f"autograd {sum(r['torch_ops_fwdbwd_ms'] for r in step):.4f} ms; a \"sum\" step "
                "(forward and backward with every gradient): "
                + ", ".join(f"{k} {sum(r['sum'][m][k] for r in step for m in ('sum_fwd', 'sum_all')):.4f}"
                            for k in ("ms", "device_ms", "bound_ms")))
    torch.cuda.empty_cache()
    return results


# the full HERA array (``scripts/hera_full_demo_torch.py``, phase 13): its
# size, and the six chunks of its packing (U, gmax, V) that phase 3s times,
# the heaviest and the narrowest
FULL_CHUNKS = 18
FULL_GROUPS = 77748
FULL_SHAPES = ((22, 1024, 256), (24, 512, 256), (10, 2048, 128), (4, 256, 512), (9, 64, 512),
               (3, 16, 512))
# phase 13 (b)'s slices: the JAX package's campaign fitted 8 flagged
# poltimes; 4 here, for the script's time limit (its host stages, the
# extraction, the step-0 guard and the write-back, take 25-30 s a slice)
FULL_NTIMES = 4
_FULL = {}  # the full array's simulation and packing, built once for phases 3s and 13


def hera_full_build():
    """``scripts/hera_full_demo_torch.py``'s lattice at full width (331
    antennas, 54,615 baselines, 1536 channels) over :data:`FULL_NTIMES`
    times, built once, with its default packing on the card: a dict of
    ``corrupted``, ``comps``, ``facts``, ``spec`` (the FitSpec, whose chunks
    do not depend on the times), ``gains`` (blank) and ``seconds``."""
    import hera_full_demo_torch as demo
    from calamity_tpu_torch import cal_utils
    from calamity_tpu_torch.solver.tensorize import FitSpec

    if not _FULL:
        t0 = time.time()
        corrupted, comps, facts = demo.build(ntimes=FULL_NTIMES)
        gains = cal_utils.blank_uvcal_from_uvdata(corrupted)
        spec = FitSpec(corrupted, comps, {int(a): i for i, a in enumerate(gains.ant_array)},
                       device="cuda", nvec_bucketing=True, shared_basis=True)
        _FULL.update(corrupted=corrupted, comps=comps, facts=facts, spec=spec, gains=gains,
                     seconds=time.time() - t0)
        log(f"  (built the full array: {facts['nants']} antennas, {facts['nbls']} baselines, "
            f"{FULL_NTIMES} times, {len(spec.chunks)} chunks in {_FULL['seconds']:.1f} s, host; "
            + ", ".join(f"{k} {facts[k]:.2f}" for k in ("simulate_s", "basis_s", "corrupt_s"))
            + ")")
    return _FULL


def full_array_chunk(shape):
    """The full array's packed chunk of (U, gmax, V) ``shape``: (its index
    in the packing, its groups' validity as numpy)."""
    spec = hera_full_build()["spec"]
    for c, chunk in enumerate(spec.chunks):
        nu, nv = chunk.comps.shape[0], chunk.comps.shape[-1]
        if (nu, chunk.a0.shape[0] // nu, nv) == tuple(shape):
            return c, spec.meta[c].valid.reshape(-1)
    raise AssertionError(f"the full array packs no chunk {shape}")


def instance_registers(regs, comps_dtype, nvecs, mode=2):
    """The '<registers>r/<spill bytes>s' of the shared-basis instance a
    chunk of ``nvecs`` modes runs (``mode`` 2: every gradient), from
    :func:`registers`' list."""
    import torch

    design = "sliced" if nvecs > 64 else "kernel"
    ctype = "f" if comps_dtype == torch.float32 else "13__nv_bfloat16"
    for r in regs:
        if r.startswith(f"{design}:{ctype}Li{mode}E"):
            return r.rsplit(":", 1)[1]
    return "not in the report"


def compare_shared_full(nbatch, nu, nvecs, valid, comps_dtype, seed, regs=()):
    """The shared-basis kernel at one of the full array's chunks: the three
    chi-square instances against the plain version (loss rel 1e-5,
    gradients rel 1e-4, padding's gradients zero), two launches equal to the
    bit, and the three "sum" instances as :func:`check_sum_instances` holds
    them; the instance the descent runs (every gradient) timed through the
    wrapper and, replayed from a CUDA graph, the device alone, beside its
    bound, the plain version, cuBLAS' matvec and the launch plan (blocks an
    SM from the runtime's occupancy calculator)."""
    import torch

    from calamity_tpu_torch.ops import _build, fused, shared

    args, mask = shared_inputs(nbatch, nu, NFREQS, nvecs, valid, comps_dtype, seed,
                               on_card=True)
    dt = str(comps_dtype).replace("torch.", "")
    ngrps = len(valid)
    tag = (f"full array U={nu} gmax={ngrps // nu} V={nvecs}: N={nbatch} {dt} comps, "
           f"{int(mask.sum())} of {ngrps} groups valid")
    worst, errs = {}, []
    for mode in (fused.LOSS_ONLY, fused.LOSS_DP, fused.LOSS_ALL):
        got = shared.loss_and_grads_kernel(*args, mask, mode)
        again = shared.loss_and_grads_kernel(*args, mask, mode)
        want = shared.loss_and_grads_plain(*args, mask, mode)
        torch.cuda.synchronize()
        check(all((a is None and b is None) or torch.equal(a, b) for a, b in zip(got, again)),
              f"{tag} mode {mode}: two launches differ")
        loss_rel = float(((got[0] - want[0]).abs() / want[0].abs()).max())
        check(loss_rel <= 1e-5, f"{tag} mode {mode}: loss rel {loss_rel}")
        worst["loss"] = max(worst.get("loss", 0.0), loss_rel)
        errs.append(float((got[0] - want[0]).abs().max()))
        for name, g, p in zip(("dcoeffs", "dpr", "dpi"), got[1:], want[1:]):
            check((g is None) == (p is None), f"{tag} mode {mode}: {name} presence")
            if p is None:
                continue
            r = rel(g, p)
            check(r <= 1e-4, f"{tag} mode {mode}: {name} rel {r}")
            worst[name] = max(worst.get(name, 0.0), r)
            errs.append(float((g - p).abs().max()))
        if got[1] is not None:
            check(not bool(got[1][:, :, ~mask].any() or got[2][:, ~mask].any()),
                  f"{tag}: padding groups' gradients are not zero")
        del got, again, want
    sum_worst = check_sum_instances(tag, shared, args, (mask,), seed=nbatch + nvecs)[0]
    coeffs2, comps = args[0], args[6]
    rhs = (coeffs2.reshape(2, nbatch, nu, ngrps // nu, nvecs).permute(2, 4, 0, 1, 3)
           .reshape(nu, nvecs, -1).contiguous())
    comps_f = comps.float()
    kern = lambda: shared.loss_and_grads_kernel(*args, mask)  # noqa: E731
    out = {"max_abs_err": max(errs), "max_rel": worst, "sum_max_rel": sum_worst,
           "ms": cuda_median_ms(kern, n=5, per_sample=2),
           "device_ms": cuda_graph_ms(kern, n=5, per_sample=2),
           "plain_ms": cuda_median_ms(lambda: shared.loss_and_grads_plain(*args, mask), n=3,
                                      per_sample=1, warmup=1),
           "library_ms": cuda_median_ms(lambda: torch.bmm(comps_f, rhs), n=5, per_sample=2),
           "plan": _build.load_kernels().shared_plan(
               nbatch, ngrps, NFREQS, nvecs, nu, 0 if comps_dtype == torch.float32 else 1,
               fused.LOSS_ALL)}
    out["bound_ms"], out["bound_by"], moved = _shared_bound(args, mask)
    out["roofline_share"] = out["bound_ms"] / out["device_ms"]
    plan = out["plan"]
    log(f"  {tag}: max rel " + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
        + "; \"sum\" instances " + ", ".join(f"{k} {v:.2e}" for k, v in sum_worst.items())
        + f"; two launches equal to the bit; every gradient {out['ms']:.4f} ms (the device alone "
        f"{out['device_ms']:.4f}) against bound {out['bound_ms']:.4f} ms ({out['bound_by']}, "
        f"{moved / 1e9:.3f} GB; share {out['roofline_share']:.3f}), plain {out['plain_ms']:.4f} "
        f"ms, cuBLAS bmm of the matvec {out['library_ms']:.4f} ms; plan: {plan['grid']} blocks "
        f"in clusters of {plan['cluster']} ({plan['slices']} mode slices x {plan['splits']} "
        f"channel splits), {plan['stages']} comps tiles staged, {plan['smem_bytes']} bytes of "
        f"shared memory, {plan['blocks_per_sm']} blocks an SM; registers/spill bytes "
        f"{instance_registers(regs, comps_dtype, nvecs)}")
    return out


def full_array_step(nbatch, comps_dtype):
    """One step's launches of the shared-basis kernel over every chunk of
    the full array's packing (every gradient, the real padding), timed
    together through the wrappers and, replayed from a CUDA graph, the
    device alone, beside the summed bound, plain version and cuBLAS
    matvecs."""
    import torch

    from calamity_tpu_torch.ops import shared

    spec = hera_full_build()["spec"]
    cases = []
    for c, chunk in enumerate(spec.chunks):
        nu, _, _, nv = chunk.comps.shape
        valid = spec.meta[c].valid.reshape(-1)
        args, mask = shared_inputs(nbatch, nu, NFREQS, nv, valid, comps_dtype, SEED + c,
                                   on_card=True)
        coeffs2, comps = args[0], args[6]
        rhs = (coeffs2.reshape(2, nbatch, nu, len(valid) // nu, nv).permute(2, 4, 0, 1, 3)
               .reshape(nu, nv, -1).contiguous())
        cases.append((args, mask, comps.float(), rhs))

    def step():
        for args, mask, _, _ in cases:
            shared.loss_and_grads_kernel(*args, mask)

    def bmms():
        for _, _, comps_f, rhs in cases:
            torch.bmm(comps_f, rhs)

    def plain():
        for args, mask, _, _ in cases:
            shared.loss_and_grads_plain(*args, mask)

    out = {"ms": cuda_median_ms(step, n=5, per_sample=1),
           "device_ms": cuda_graph_ms(step, n=5, per_sample=1),
           "plain_ms": cuda_median_ms(plain, n=3, per_sample=1, warmup=1),
           "library_ms": cuda_median_ms(bmms, n=5, per_sample=1),
           "bound_ms": sum(_shared_bound(a, m)[0] for a, m, _, _ in cases),
           "launches": len(cases)}
    out["roofline_share"] = out["bound_ms"] / out["device_ms"]
    log(f"  full array, one step's {len(cases)} launches, N={nbatch} "
        f"{str(comps_dtype).replace('torch.', '')} comps: {out['ms']:.4f} ms (the device alone "
        f"{out['device_ms']:.4f}) against bound {out['bound_ms']:.4f} ms (share "
        f"{out['roofline_share']:.3f}); plain {out['plain_ms']:.4f} ms; cuBLAS bmm of the "
        f"matvecs {out['library_ms']:.4f} ms; {nvidia_smi_line()}")
    del cases
    torch.cuda.empty_cache()
    return out


# past 64 modes (``shared_chunk_loss_sliced``) a block's shared memory, by
# comps type: the staged comps tile's TF32 halves (float32: hi and lo, 2 x
# 8448 bytes; bfloat16: widened, 8448), the coefficients' halves (2 x
# 16384), the exchange buffers (15360) and the pair table and cotangents
# (768); and the blocks an SM that leaves, the design's occupancy
SLICED_SMEM = {"float32": 65792, "bfloat16": 57344}
SLICED_BLOCKS = {"float32": 3, "bfloat16": 4}


def check_shared_plans():
    """The kernel's launch plan (``shared_plan`` in its source) on this card
    at the full array's six chunks (N = 1 and 8), every ragged shape (N = 1
    and 3) and every width from 65 modes to 600 (float32) or 720 (bfloat16)
    at U = 1, gmax = 7, F = 1536, N = 1, both comps types each: within a
    block's 227 KB of shared memory and a cluster of 16, ceil(V / 64) mode
    slices times the channel splits on each tile of 32 pairs; up to 64 modes
    a ring of two comps tiles; past 64 modes one staged tile, the shared
    memory of :data:`SLICED_SMEM` whatever the width, and the blocks an SM
    of :data:`SLICED_BLOCKS` (the runtime's occupancy calculator). Returns
    the number of shapes."""
    import torch

    from calamity_tpu_torch.ops import _build, fused

    lib = _build.load_kernels()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [(n, nu * gmax, NFREQS, nv, nu, cdt) for nu, gmax, nv in FULL_SHAPES
             for cdt in (f32, bf16) for n in (1, 8)]
    cases += [(n, nu * gmax, nf, nv, nu, cdt) for cdt in (f32, bf16)
              for nu, gmax, nf, nv in ragged_cases(cdt) for n in (1, 3)]
    cases += [(1, 7, NFREQS, nv, 1, cdt) for cdt, top in ((f32, 600), (bf16, 720))
              for nv in range(65, top + 1)]
    blocks = set()
    for n, g, f, v, u, cdt in cases:
        c = lib.shared_plan(n, g, f, v, u, int(cdt != f32), fused.LOSS_ALL)
        pair_tiles = -(-(g // u * n) // 32) * u
        slices = -(-v // 64)
        dt = str(cdt)[6:]
        check(c["smem_bytes"] <= 227 * 1024 and c["cluster"] <= 16
              and c["slices"] == slices and c["cluster"] == slices * c["splits"]
              and c["grid"] == pair_tiles * c["cluster"]
              and (c["stages"] == 2 if v <= 64 else
                   c["stages"] == 1 and c["smem_bytes"] == SLICED_SMEM[dt]
                   and c["blocks_per_sm"] == SLICED_BLOCKS[dt]),
              f"the launch plan of N={n} G={g} F={f} V={v} U={u} {cdt}: {c}")
        blocks.add((v > 64, str(cdt)[6:], c["blocks_per_sm"]))
    log(f"  the launch plan at {len(cases)} shapes ({sms} SMs): each within 227 KB of shared "
        "memory and a cluster of 16, ceil(V / 64) slices a tile of pairs, past 64 modes "
        f"{SLICED_SMEM} bytes; blocks an SM (sliced, comps, blocks): {sorted(blocks)}")
    return len(cases)


def check_shared_nan():
    """A coefficient made NaN on the card (0/0) gives a NaN loss, and a data
    value made NaN gives NaN gradients, as the plain version does: at V =
    64 (one block a tile) and V = 128 (a cluster of two mode slices), both
    comps types, the loss-only and every-gradient instances. The TF32 split
    must not round a NaN operand to zero. Returns the number of cases."""
    import torch

    from calamity_tpu_torch.ops import fused, shared

    ncase = 0
    for nv in (64, 128):
        for cdt in (torch.float32, torch.bfloat16):
            valid = np.ones(4, bool)
            args, mask = shared_inputs(1, 1, 100, nv, valid, cdt, SEED + nv)
            zero = torch.zeros((), device=args[0].device)
            coeffs = args[0].clone()
            coeffs[0, 0, 1, nv - 1] = zero / zero
            nan_coef = [coeffs] + list(args[1:])
            got = shared.loss_and_grads_kernel(*nan_coef, mask, fused.LOSS_ONLY)[0]
            check(bool(torch.isnan(got).all()),
                  f"V={nv} {cdt}: a NaN coefficient gives the loss {got.tolist()}")
            dr = args[3].clone()
            dr[0, 2, 7] = zero / zero
            nan_data = list(args[:3]) + [dr] + list(args[4:])
            got = shared.loss_and_grads_kernel(*nan_data, mask, fused.LOSS_ALL)
            check(bool(torch.isnan(got[0]).all()) and bool(torch.isnan(got[1][:, 0, 2]).all())
                  and bool(torch.isnan(got[2][0, 2, 7])),
                  f"V={nv} {cdt}: a NaN data value gives a finite loss or gradient")
            ncase += 2
    torch.cuda.synchronize()
    log(f"  NaN operands: {ncase} cases (V = 64 and 128, float32 and bfloat16 comps), a NaN "
        "coefficient gives a NaN loss and a NaN data value NaN gradients")
    return ncase


def phase_shared_full_array():
    """Phase 3s at the full array's widths: the six chunks of
    :data:`FULL_SHAPES` with their padding (N = 1 and 8, float32 and
    bfloat16 comps) by :func:`compare_shared_full`, and a whole step's
    launches by :func:`full_array_step`; with the registers and spills of
    the instance every-gradient step runs (from the build's ptxas report)."""
    import torch

    from calamity_tpu_torch.ops import _build

    log("== phase 3s (full array): the shared-basis kernel at the full HERA array's chunks, "
        "F = 1536 (loss rel 1e-5, gradients rel 1e-4, two launches bit-equal)")
    regs = registers(_build.load_kernels().build_log, "shared_chunk_loss")
    log(f"  registers/spill bytes of the shared-basis instances: {' '.join(regs)}")
    out = {"registers": regs, "plans_checked": check_shared_plans(),
           "nan_cases": check_shared_nan()}
    for shape in FULL_SHAPES:
        c, valid = full_array_chunk(shape)
        nu, _, nv = shape
        for cdt in (torch.float32, torch.bfloat16):
            for n in (1, 8):
                out[(shape, n, cdt)] = compare_shared_full(n, nu, nv, valid, cdt,
                                                           SEED + 7 * c + n, regs)
                torch.cuda.empty_cache()
    for cdt in (torch.float32, torch.bfloat16):
        for n in (1, 8):
            out[("step", n, cdt)] = full_array_step(n, cdt)
    return out


# ---------------------------------------------------------------------- #
# phase 3a: the Adamax update and the descent's carry
# ---------------------------------------------------------------------- #
ADAMAX_SOURCE = "calamity_tpu_torch/csrc/adamax_step.cu"
# no TPU kernel: the reference leaves its Adamax (optax) and its loop body's
# bookkeeping to XLA, which fuses them into the while loop's body
ADAMAX_REPLACES = "calamity_tpu/solver/optimizers.py:152"
CARRY_REPLACES = "calamity_tpu/solver/fit.py:179"
ADAMAX_STEPS = 50  # consecutive steps, each side advancing its own state
ADAMAX_NBATCH = 8
ADAMAX_FROZEN = (2, 5)  # rows frozen from the start at N = 8
ADAMAX_NAN_ROW, ADAMAX_NAN_ROW_STEP = 6, 20  # a row whose loss turns NaN (it freezes)
ADAMAX_NAN_LOSS_STEP = 45  # the serial loss turns NaN: the steps after it are not live
ADAMAX_NAN_GRAD_STEP = 7  # NaN gradients in a coefficient leaf, an inf one in the gains after
ADAMAX_PATIENCE = 5
ADAMAX_KERNELS = ("adamax_step", "descent_carry")  # ops.adamax's KERNEL_NAME, CARRY_KERNEL_NAME


def adamax_launches():
    """The Adamax update's and the carry's launches since the counters were
    reset, by name."""
    from calamity_tpu_torch import LAUNCHES

    return {k: LAUNCHES.get(k) for k in ADAMAX_KERNELS}


def full_array_leaves():
    """The full array's parameter leaves as its descent holds them (phase
    13's packing): g_r and g_i (nants, F), then each chunk's fg_r and fg_i
    (U x gmax, V)."""
    built = hera_full_build()
    chunks = [(int(c.a0.shape[0]), int(c.comps.shape[-1])) for c in built["spec"].chunks]
    gains = (int(built["facts"]["nants"]), NFREQS)
    return [gains, gains] + chunks + chunks


def _adamax_tree(shapes, lead, make):
    nc = (len(shapes) - 2) // 2
    leaves = [make(lead + tuple(x)) for x in shapes]
    return {"g_r": leaves[0], "g_i": leaves[1], "fg_r": leaves[2:2 + nc],
            "fg_i": leaves[2 + nc:]}


def _adamax_side(shapes, nbatch, dtype, seed, warmup=1):
    """A descent's state at the leaves ``shapes`` on the card: seeded
    parameters, moments and best parameters, the step count, and the carry:
    serial (``nbatch`` None; patience) or batched over ``nbatch`` slices
    (:data:`ADAMAX_FROZEN` frozen, patience and use_min, ``warmup``
    unrecorded steps)."""
    import torch

    from calamity_tpu_torch.ops import adamax as A
    from calamity_tpu_torch.solver.optimizers import AdamaxState

    gen = torch.Generator(device="cuda").manual_seed(seed)
    lead = () if nbatch is None else (nbatch,)

    def randn(shape):
        return torch.randn(shape, generator=gen, device="cuda", dtype=dtype)

    side = {"params": _adamax_tree(shapes, lead, randn),
            "best": _adamax_tree(shapes, lead, randn)}
    side["state"] = AdamaxState(
        count=torch.tensor(3, dtype=torch.int64, device="cuda"),
        mu=_adamax_tree(shapes, lead, lambda x: 1e-2 * randn(x)),
        nu=_adamax_tree(shapes, lead, lambda x: 1e-2 * randn(x).abs_()))
    big = 9e99 if dtype == torch.float64 else float(np.float32(3e38))

    def full(shape, value, dt):
        return torch.full(shape, value, dtype=dt, device="cuda")

    i64, cap = torch.int64, ADAMAX_STEPS + 1
    if nbatch is None:
        side["carry"] = A.SerialCarry(full((), 0, i64), full((), 10 ** 9, i64),
                                      full((), big, dtype), full((), big, dtype),
                                      full((), big, dtype), full((), 0, i64),
                                      full((cap,), float("nan"), dtype), TOL, ADAMAX_PATIENCE,
                                      big)
    else:
        frozen = full((nbatch,), False, torch.bool)
        frozen[list(ADAMAX_FROZEN)] = True
        side["carry"] = A.BatchedCarry(
            full((), 0, i64), full((), 10 ** 9, i64), full((), warmup, i64), full((), 0, i64),
            frozen, full((nbatch,), big, dtype), full((nbatch,), big, dtype),
            full((nbatch,), 0, i64), full((nbatch,), 10 ** 9, i64),
            full((cap, nbatch), float("nan"), torch.float32), TOL, ADAMAX_PATIENCE)
    return side


def _side_tensors(side):
    from calamity_tpu_torch.solver.optimizers import tree_leaves

    return (tree_leaves(side["params"]) + tree_leaves(side["state"])
            + tree_leaves(side["best"]) + [x for x in side["carry"] if hasattr(x, "dtype")])


def _same_bits(a, b):
    """Two tensors of one dtype and shape with the same bytes (NaNs too)."""
    import torch

    def raw(t):
        return t.reshape(-1).view(torch.uint8)

    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(raw(a), raw(b))


def _max_abs_err(a, b):
    """max |a - b| where both are finite (0 for equal tensors)."""
    import torch

    if not a.is_floating_point():
        return 0.0 if torch.equal(a, b) else float("inf")
    both = torch.isfinite(a) & torch.isfinite(b)
    return float((a - b).abs()[both].max()) if bool(both.any()) else 0.0


def _adamax_calls(A, opt, side, grads, loss):
    A.adamax_step(opt, side["params"], grads, side["state"], side["best"], side["carry"], loss)
    A.descent_carry(side["carry"], loss, side["state"].count)


def adamax_against_plain(shapes, nbatch, dtype, seed):
    """:data:`ADAMAX_STEPS` steps of both kernels and of their plain
    versions (``ops.adamax.plain_versions``), each side advancing its own
    state from one seeded start on the same gradients and losses, with a
    NaN and an inf gradient, a NaN loss (serial: the steps after it are
    not live; batched: its row freezes), patience and the best parameters;
    equal to the bit at every tenth step and at the end; batched, the
    frozen rows' parameters and moments untouched byte for byte. Returns
    the largest abs error (finite values)."""
    import torch

    from calamity_tpu_torch.ops import adamax as A
    from calamity_tpu_torch.solver.optimizers import get_optimizer, tree_leaves, tree_map

    opt = get_optimizer("Adamax", learning_rate=1e-2)
    kern = _adamax_side(shapes, nbatch, dtype, seed)
    plain = tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor) else x, kern)
    rows = list(ADAMAX_FROZEN)
    frozen0 = ([x[rows].clone() for x in tree_leaves((kern["params"], kern["state"].mu,
                                                       kern["state"].nu))]
               if nbatch is not None else [])
    rng = np.random.default_rng(seed)
    decay = 1e3 * 0.98 ** np.arange(ADAMAX_STEPS)
    if nbatch is None:
        losses = decay * (1 + 0.05 * rng.random(ADAMAX_STEPS))
        losses[ADAMAX_NAN_LOSS_STEP] = np.nan
    else:
        losses = decay[:, None] * (1 + 0.05 * rng.random((ADAMAX_STEPS, nbatch)))
        losses[ADAMAX_NAN_ROW_STEP, ADAMAX_NAN_ROW] = np.nan
    lead = () if nbatch is None else (nbatch,)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    err = 0.0
    for k in range(ADAMAX_STEPS):
        grads = _adamax_tree(shapes, lead, lambda x: torch.randn(x, generator=gen, device="cuda",
                                                                 dtype=dtype))
        if k == ADAMAX_NAN_GRAD_STEP:
            grads["fg_r"][0].view(-1)[:3] = float("nan")
        if k == ADAMAX_NAN_GRAD_STEP + 1:
            grads["g_i"].view(-1)[5] = -float("inf")
        loss = torch.tensor(losses[k], dtype=dtype, device="cuda")
        _adamax_calls(A, opt, kern, grads, loss)
        with A.plain_versions():
            _adamax_calls(A, opt, plain, grads, loss)
        if k % 10 == 9 or k == ADAMAX_NAN_GRAD_STEP:
            for a, b in zip(_side_tensors(kern), _side_tensors(plain)):
                check(_same_bits(a, b), f"adamax N={nbatch} {dtype} step {k}: kernel and plain "
                                        f"differ ({tuple(a.shape)}, max abs "
                                        f"{_max_abs_err(a, b)})")
                err = max(err, _max_abs_err(a, b))
    nan_leaf = kern["params"]["fg_r"][0].view(-1)[:3]
    check(bool(torch.isnan(nan_leaf).all()), "a NaN gradient did not give NaN parameters")
    c = kern["carry"]
    moved = int(c.step if nbatch is None else c.it)
    if nbatch is None:
        check(moved == ADAMAX_NAN_LOSS_STEP + 1, f"serial: {moved} live steps")
    else:
        check(bool(c.frozen[ADAMAX_NAN_ROW]), "the NaN row did not freeze")
        after = tree_leaves((kern["params"], kern["state"].mu, kern["state"].nu))
        check(all(_same_bits(x[rows], y) for x, y in zip(after, frozen0)),
              "frozen rows moved")
    return err


def _adamax_bound_ms(side, nbatch):
    """The least time of one ``adamax_step`` at ``side``'s inputs: the bytes
    its elements need (an updated element reads p, g, mu and nu and writes
    p, mu and nu; an improved one also writes the best parameter, a frozen
    row's improved one reads p and writes it), over the card's memory
    rate."""
    from calamity_tpu_torch.solver.optimizers import tree_leaves

    leaves = tree_leaves(side["params"])
    itemsize = leaves[0].element_size()
    c = side["carry"]
    if nbatch is None:
        elems = sum(x.numel() for x in leaves)
        best = bool(c.best_loss > side["loss"])
        return elems * itemsize * (7 + best) / HBM_BYTES_PER_S * 1e3
    per_row = sum(x[0].numel() for x in leaves)
    rec = int(c.it) - int(c.warmup) >= 0
    loss, best_loss = side["loss"].cpu().numpy(), c.best_loss.cpu().numpy()
    frozen = c.frozen.cpu().numpy()
    nbytes = 0
    for r in range(nbatch):
        best = rec and loss[r] < best_loss[r]
        nbytes += per_row * itemsize * ((7 + best) if not frozen[r] else 2 * best)
    return nbytes / HBM_BYTES_PER_S * 1e3


def _carry_bound_ms(side, nbatch):
    """The least time of one ``descent_carry``: the carry's bytes it reads
    and writes on a live step that records (int64 counters, the fit
    dtype's losses), over the card's memory rate."""
    f = side["carry"].prev.element_size()
    if nbatch is None:  # reads 4 counters and 4 losses, writes 3 and 4
        return (7 * 8 + 8 * f) / HBM_BYTES_PER_S * 1e3
    # reads 5 counters, a row's mask, loss, last and best loss and count
    # since; writes a row's history (float32), best loss, last loss and
    # count since, and 2 counters
    return (7 * 8 + nbatch * (1 + 3 * f + 8 + 4 + 2 * f + 8)) / HBM_BYTES_PER_S * 1e3


def _foreach_adamax(opt, side, grads):
    """The update written with ``torch._foreach_*`` ops over the leaves
    (ungated; the bias correction of the next count as a host float): the
    yardstick of one PyTorch call per operation, used nowhere in the port."""
    import torch

    from calamity_tpu_torch.solver.optimizers import tree_leaves

    h = opt.hyper
    p, g = tree_leaves(side["params"]), tree_leaves(grads)
    mu, nu = tree_leaves(side["state"].mu), tree_leaves(side["state"].nu)
    bc = 1 - h.beta_1 ** (int(side["state"].count) + 1)

    def call():
        torch._foreach_mul_(mu, h.beta_1)
        torch._foreach_add_(mu, g, alpha=1 - h.beta_1)
        torch._foreach_mul_(nu, h.beta_2)
        a = torch._foreach_abs(g)
        torch._foreach_add_(a, h.epsilon)
        torch._foreach_maximum_(nu, a)
        torch._foreach_add_(p, torch._foreach_div(mu, nu), alpha=-h.learning_rate / bc)

    return call


def time_adamax(shapes, nbatch, seed):
    """Both kernels at the leaves ``shapes``, float32, N = 1 (the serial
    carry) or ``nbatch`` (batched, :data:`ADAMAX_FROZEN` frozen): ms
    through the wrapper and the device alone (replayed from a CUDA graph)
    beside the bound, the plain version and, for the update, the
    ``torch._foreach_*`` yardstick. The step stays live and improving (no
    carry moves between the update's calls; the carry's own calls record
    without stopping)."""
    import torch

    from calamity_tpu_torch.ops import adamax as A
    from calamity_tpu_torch.solver.optimizers import get_optimizer, tree_map

    opt = get_optimizer("Adamax", learning_rate=1e-2)
    side = _adamax_side(shapes, nbatch, torch.float32, seed, warmup=0)
    side["carry"] = side["carry"]._replace(tol=0.0, patience=0)
    if nbatch is not None:
        side["carry"] = side["carry"]._replace(since=None)
    lead = () if nbatch is None else (nbatch,)
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    grads = _adamax_tree(shapes, lead, lambda x: torch.randn(x, generator=gen, device="cuda"))
    side["loss"] = torch.full(lead, 1.0, device="cuda")
    p, s, b, c, loss = (side[k] for k in ("params", "state", "best", "carry", "loss"))

    def kernel():
        A.adamax_step(opt, p, grads, s, b, c, loss)

    def plain():
        A.adamax_step_plain(opt, p, grads, s, b, c, loss)

    def carry():
        A.descent_carry(c, loss, s.count)

    def carry_plain():
        A.descent_carry_plain(c, loss, s.count)

    library = _foreach_adamax(opt, tree_map(lambda x: x.clone() if hasattr(x, "clone") else x,
                                            side), grads)
    step = {"ms": cuda_median_ms(kernel, n=10, per_sample=3),
            "device_ms": cuda_graph_ms(kernel, n=10, per_sample=3),
            "plain_ms": cuda_median_ms(plain, n=5, per_sample=1, warmup=1),
            "plain_device_ms": cuda_graph_ms(plain, n=5, per_sample=1),
            "library_ms": cuda_median_ms(library, n=10, per_sample=3),
            "library_device_ms": cuda_graph_ms(library, n=10, per_sample=3),
            "bound_ms": float(_adamax_bound_ms(side, nbatch)), "bound_by": "bytes"}
    book = {"ms": cuda_median_ms(carry, n=10, per_sample=5),
            "device_ms": cuda_graph_ms(carry, n=10, per_sample=5),
            "plain_ms": cuda_median_ms(carry_plain, n=10, per_sample=5),
            "plain_device_ms": cuda_graph_ms(carry_plain, n=10, per_sample=5),
            "library_ms": None, "bound_ms": _carry_bound_ms(side, nbatch), "bound_by": "bytes"}
    del side, grads, library
    torch.cuda.empty_cache()
    return step, book


def phase_adamax():
    """Phase 3a: the descents' Adamax update and carry kernels
    (``csrc/adamax_step.cu``) at the full HERA array's 38 leaves (phase
    13's packing), N = 1 (the serial carry) and N = 8 (batched, rows
    frozen), float32 and float64, against their plain versions to the bit
    over :data:`ADAMAX_STEPS` steps (:func:`adamax_against_plain`); each
    timed in float32 beside its bound, its plain version and the update's
    ``torch._foreach_*`` yardstick (:func:`time_adamax`)."""
    import torch

    from calamity_tpu_torch.ops import adamax as A
    from calamity_tpu_torch.ops import _build

    shapes = full_array_leaves()
    nelem = sum(a * b for a, b in shapes)
    log(f"== phase 3a: the Adamax update and the descent's carry, the full array's "
        f"{len(shapes)} leaves ({nelem} elements a slice; {A.LEAVES_PER_LAUNCH} leaves a "
        f"launch), {ADAMAX_STEPS} steps kernel against plain, equal to the bit")
    build_log = _build.load_kernels().build_log
    regs = registers(build_log, "adamax_step") + registers(build_log, "descent_carry")
    log(f"  registers/spill bytes: {' '.join(regs)}")
    out = {"leaves": len(shapes), "elements": nelem, "max_abs_err": 0.0}
    for dtype in (torch.float32, torch.float64):
        for nbatch in (None, ADAMAX_NBATCH):
            t0 = time.time()
            err = adamax_against_plain(shapes, nbatch, dtype, SEED + (nbatch or 1))
            out["max_abs_err"] = max(out["max_abs_err"], err)
            log(f"  N={nbatch or 1} {str(dtype).replace('torch.', '')}: {ADAMAX_STEPS} steps "
                f"equal to the bit (a NaN and an inf gradient, a NaN loss"
                + (f", rows {ADAMAX_FROZEN} frozen and untouched, row {ADAMAX_NAN_ROW} frozen "
                   "by its NaN loss" if nbatch else ", the steps after it not live")
                + f"); {time.time() - t0:.1f} s")
            torch.cuda.empty_cache()
    for nbatch in (None, ADAMAX_NBATCH):
        step, book = time_adamax(shapes, nbatch, SEED + 11)
        n = nbatch or 1
        out[("step", n)], out[("carry", n)] = step, book
        for name, r in ((A.KERNEL_NAME, step), (A.CARRY_KERNEL_NAME, book)):
            lib = "" if r["library_ms"] is None else (
                f", torch._foreach_* ops {r['library_ms']:.4f} ms "
                f"[{r['library_device_ms']:.4f}]")
            log(f"  {name} N={n} float32: {r['ms']:.4f} ms [the device alone "
                f"{r['device_ms']:.4f}] against bound {r['bound_ms']:.6f} ms (share "
                f"{r['bound_ms'] / r['device_ms']:.3f}); plain {r['plain_ms']:.4f} ms "
                f"[{r['plain_device_ms']:.4f}]{lib}; {nvidia_smi_line()}")
    return out


# ---------------------------------------------------------------------- #
# phase 4: the main path at full size
# ---------------------------------------------------------------------- #
def random_disc_array(rng):
    pos = []
    while len(pos) < NANTS:
        r = DISC_RADIUS_M * np.sqrt(rng.uniform())
        th = rng.uniform(0, 2 * np.pi)
        cand = np.array([r * np.cos(th), r * np.sin(th), 0.0])
        if all(np.linalg.norm(cand - p) >= MIN_SEPARATION_M for p in pos):
            pos.append(cand)
    return np.asarray(pos)


def project_onto_dpss(uvd, comps):
    """Project each baseline's spectra onto its DPSS subspace in place, for
    every polarization."""
    for key, mat in comps.items():
        ap = key[0][0]
        rows, conj = uvd._bl_time_rows(ap[0], ap[1])
        for pol in range(uvd.Npols):
            d = uvd.data_array[rows, 0, :, pol]
            d = np.conj(d) if conj else d
            proj = (d @ mat) @ mat.T
            uvd.data_array[rows, 0, :, pol] = np.conj(proj) if conj else proj


def main_chunk_shapes(comps):
    from calamity_tpu_torch.solver.tensorize import chunk_fitting_groups

    return [(len(g), nbl, NFREQS, nv) for (nbl, nv), g in chunk_fitting_groups(comps).items()]


def make_corrupted_file(path, ntimes=NTIMES, npols=1, nfreqs=NFREQS, comps=None):
    """The seeded disc array's sky, projected onto its DPSS basis (``comps``
    where given: the basis depends on the baselines and channels only) and
    corrupted by gain errors, written to ``path``: (VisData, basis)."""
    from calamity_tpu_torch import cal_utils, models, simulate

    rng = np.random.default_rng(SEED)
    antpos = random_disc_array(rng)
    freqs = F0_HZ + DF_HZ * np.arange(nfreqs)
    uvd = simulate.make_visdata(antpos, freqs, ntimes=ntimes, npols=npols, nsrc=NSRC, seed=SEED)
    if comps is None:
        comps = models.yield_pbl_dpss_model_comps(uvd, min_dly=MIN_DLY_NS, offset=MIN_DLY_NS)
    project_onto_dpss(uvd, comps)
    truth = cal_utils.blank_uvcal_from_uvdata(uvd)
    truth.gain_array = truth.gain_array * (
        1 + GAIN_ERR * rng.standard_normal(truth.gain_array.shape)
        + 1j * GAIN_ERR * rng.standard_normal(truth.gain_array.shape)
    )
    corrupted = cal_utils.apply_gains(uvd, truth, inverse=True)
    corrupted.write_uvh5(path, clobber=True)
    return corrupted, comps


def phase_main_path(tmp, path, uvd, comps):
    import torch

    from calamity_tpu_torch.io import CalData, VisData
    from calamity_tpu_torch import LAUNCHES
    from calamity_tpu_torch.calibration import read_calibrate_and_model_dpss
    from calamity_tpu_torch.ops.fused import KERNEL_NAME
    from calamity_tpu_torch.ops.gains import KERNEL_NAME as GAIN_KERNEL
    from calamity_tpu_torch.ops.gains import PRODUCTS_KERNEL_NAME as PROD_KERNEL

    log(f"== phase 4: main path, {NANTS} antennas, {NFREQS} channels, {uvd.Ntimes} times")
    log(f"  dense chunk shapes (ngrps, nbls, nfreqs, nvecs): {main_chunk_shapes(comps)}")
    outs = {k: os.path.join(tmp, f"main_{k}") for k in ("resid.uvh5", "model.uvh5",
                                                        "gains.calfits")}
    timings = {}
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.reset()
    t0 = time.time()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        model, resid, gains, info = read_calibrate_and_model_dpss(
            input_data_files=path,
            resid_outfilename=outs["resid.uvh5"],
            model_outfilename=outs["model.uvh5"],
            gain_outfilename=outs["gains.calfits"],
            clobber=True,
            min_dly=MIN_DLY_NS,
            offset=MIN_DLY_NS,
            shared_basis=False,
            model_regularization="post_hoc",
            learning_rate=1e-2,
            maxsteps=MAXSTEPS,
            tol=TOL,
            device="cuda",
            timings=timings,
        )
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = LAUNCHES.get(KERNEL_NAME)
    gain_launches = LAUNCHES.get(GAIN_KERNEL)
    prod_launches = LAUNCHES.get(PROD_KERNEL)
    adamax = adamax_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    fallbacks = [str(w.message) for w in caught if "plain torch loss" in str(w.message)]
    check(not fallbacks, f"chunks left out by the kernel gate: {fallbacks}")
    hists = info[0]  # fit histories by polarization index, then time index
    recorded = 0
    for t, h in sorted(hists.items()):
        steps = h["phase_steps"]
        recorded += len(h["loss"])
        rates = [1e3 * s / max(n, 1) for s, n in zip(h["phase_seconds"], steps)]
        log(f"  time {t}: phase steps (bf16, f32) {steps}, ms/step "
            f"{', '.join(f'{r:.3f}' for r in rates)} (host clock, captures and polls included); "
            f"loss {h['loss'][0]:.6e} -> {h['loss'][-1]:.6e}")
    log(f"  host seconds: " + ", ".join(f"{k} {v:.2f}" for k, v in sorted(timings.items()))
        + f"; read_calibrate_and_model_dpss in all {wall:.1f}")
    log(f"  peak device memory {peak_gb:.3f} GB; {KERNEL_NAME} launches {launches}, "
        f"{GAIN_KERNEL} launches {gain_launches}, {PROD_KERNEL} launches {prod_launches}, "
        f"{adamax}, recorded steps {recorded}")
    check(min(launches, gain_launches, prod_launches, *adamax.values()) >= recorded,
          f"{launches}, {gain_launches}, {prod_launches}, {adamax} kernel launches < {recorded} "
          "recorded steps")
    check(np.isfinite(gains.gain_array).all(), "non-finite gains")
    good = ~uvd.flag_array
    rms = lambda x: float(np.sqrt(np.mean(np.abs(x) ** 2)))  # noqa: E731
    ratio = rms(resid.data_array[good]) / rms(uvd.data_array[good])
    log(f"  resid rms / data rms over unflagged samples: {ratio:.4e} (limit 1e-2)")
    check(ratio <= 1e-2, f"resid/data {ratio} > 1e-2")
    back_r = VisData.from_uvh5(outs["resid.uvh5"])
    back_m = VisData.from_uvh5(outs["model.uvh5"])
    back_g = CalData.from_calfits(outs["gains.calfits"])
    check(np.allclose(back_r.data_array, resid.data_array), "resid file does not read back")
    check(np.allclose(back_m.data_array, model.data_array), "model file does not read back")
    check(np.allclose(back_g.gain_array, gains.gain_array), "gains file does not read back")
    log("  output files read back through calamity_tpu_torch.io and match")
    return {"launches": launches, "gain_launches": gain_launches,
            "prod_launches": prod_launches, "adamax_launches": adamax, "recorded": recorded,
            "uvd": uvd, "comps": comps, "path": path}


# ---------------------------------------------------------------------- #
# phase 5: kernel against plain inside the loop, and the per-step host check
# ---------------------------------------------------------------------- #
def packed_slice(main):
    """Phase 4's file packed once on the card as the serial loop packs it:
    the FitSpec, the first time's data and weights, unit gains and the
    warm-started coefficients."""
    from calamity_tpu_torch import cal_utils
    from calamity_tpu_torch.solver.tensorize import FitSpec

    uvd = main["uvd"]
    gains = cal_utils.blank_uvcal_from_uvdata(uvd)
    ants_map = {int(a): i for i, a in enumerate(gains.ant_array)}
    spec = FitSpec(uvd, main["comps"], ants_map, device="cuda", shared_basis=False)
    time0 = spec.times[0]
    rows = np.isclose(uvd.time_array, time0, rtol=0.0, atol=1e-7)
    blk = uvd.data_array[rows, 0, :, 0]
    rmsdata = np.sqrt(np.mean(np.abs(blk[~uvd.flag_array[rows, 0, :, 0]]) ** 2))
    data_r, data_i, wgts = spec.pack_data(uvd, "xx", time0, data_scale_factor=rmsdata)
    g_r, g_i = spec.pack_gains(gains, "xx", time0)
    return {"g_r": g_r, "g_i": g_i, "fg_r": tuple(spec.init_coeffs(data_r, wgts)),
            "fg_i": tuple(spec.init_coeffs(data_i, wgts)), "data_r": data_r, "data_i": data_i,
            "wgts": wgts, "chunks": spec.device_chunks()}


def fit_twice(packed):
    """Phase 4's packed slice fitted twice on the card with the main path's
    settings (the mixed schedule, tol, maxsteps, post_hoc): the step counts
    and loss histories must be equal to the bit (every sum of the step is
    taken in a fixed order: the kernels have no atomics); and a third time
    with the Adamax update and the carry's plain versions
    (``ops.adamax.plain_versions``): steps, histories and parameters equal
    to the bit to the kernels' fit."""
    import contextlib

    import torch

    from calamity_tpu_torch import LAUNCHES
    from calamity_tpu_torch.ops import adamax as A
    from calamity_tpu_torch.ops.gains import KERNEL_NAME as GAIN_KERNEL
    from calamity_tpu_torch.ops.gains import PRODUCTS_KERNEL_NAME as PROD_KERNEL
    from calamity_tpu_torch.solver import fit as fitmod

    runs = []
    for plain in (False, False, True):
        args = [packed[k] for k in ("g_r", "g_i")] + [tuple(packed[k]) for k in ("fg_r", "fg_i")]
        args = [tuple(x.clone() for x in a) if isinstance(a, tuple) else a.clone() for a in args]
        LAUNCHES.reset()
        t0 = time.time()
        with A.plain_versions() if plain else contextlib.nullcontext():
            out = fitmod.fit_gains_and_foregrounds(
                *args, packed["data_r"], packed["data_i"], packed["wgts"], packed["chunks"],
                maxsteps=MAXSTEPS, tol=TOL, learning_rate=1e-2, model_regularization="post_hoc",
                comps_precision="mixed")
        torch.cuda.synchronize()
        runs.append((out, LAUNCHES.counts(), time.time() - t0))
    (o1, c1, s1), (o2, c2, s2), (o3, c3, s3) = runs
    h1, h2 = o1[4], o2[4]
    n1, n2, p1 = c1.get(GAIN_KERNEL, 0), c2.get(GAIN_KERNEL, 0), c1.get(PROD_KERNEL, 0)
    log(f"  the packed slice fitted twice: phase steps {h1['phase_steps']} and "
        f"{h2['phase_steps']}, {GAIN_KERNEL} launches {n1} and {n2}, {s1:.1f} and {s2:.1f} s; "
        f"loss histories equal to the bit: {h1['loss'] == h2['loss']}")
    check(h1["phase_steps"] == h2["phase_steps"] and h1["loss"] == h2["loss"],
          "two fits of one packed slice differ")
    check(min(n1, p1) >= len(h1["loss"]),
          f"{n1} {GAIN_KERNEL}, {p1} {PROD_KERNEL} launches for {len(h1['loss'])} steps")
    kernels = {k: c1.get(k, 0) for k in (A.KERNEL_NAME, A.CARRY_KERNEL_NAME)}
    log(f"  and with the Adamax update's and the carry's plain versions: phase steps "
        f"{o3[4]['phase_steps']}, {s3:.1f} s; steps, histories and parameters equal to the bit to "
        f"the kernels' fit: {_same_fit(o1, o3)}; launches with the kernels {kernels}, with the "
        f"plain versions {c3}")
    check(_same_fit(o1, o3), "phase 4's slice: the kernels' fit and the plain versions' differ")
    check(min(kernels.values()) >= len(h1["loss"]), f"{kernels} for {len(h1['loss'])} steps")
    check(not any(c3.get(k) for k in kernels), f"the plain versions' fit launched {c3}")
    return {"steps": h1["phase_steps"], "launches": n1, "prod_launches": p1,
            "adamax_launches": kernels}


def phase_in_loop(packed):
    import torch

    from calamity_tpu_torch.solver import fit as fitmod
    from calamity_tpu_torch.solver.optimizers import get_optimizer

    log(f"== phase 5: {N_LOOP_STEPS} recorded float32 steps, chunks on the card vs a CPU copy "
        "(histories rel 1e-4)")
    g_r, g_i, fg_r, fg_i = (packed[k] for k in ("g_r", "g_i", "fg_r", "fg_i"))
    data_r, data_i, wgts, chunks = (packed[k] for k in ("data_r", "data_i", "wgts", "chunks"))
    kw = dict(maxsteps=N_LOOP_STEPS, tol=0.0, comps_precision="float32", learning_rate=1e-2,
              model_regularization="post_hoc")

    # cost of the per-step host check: the same steps with and without a
    # device-to-host read of the loss after every step (before the CPU run
    # below, whose threads would otherwise compete for the host)
    cfg = fitmod.FitConfig(tol=0.0)
    loss_fn = fitmod.make_loss_fn(cfg, chunks, data_r, data_i, wgts, fg_r, fg_i, None, None)
    opt = get_optimizer("Adamax", learning_rate=1e-2)
    params0 = fitmod.init_params(cfg, g_r, g_i, fg_r, fg_i)

    def run(nsteps, sync_each):
        params, state = params0, opt.init(params0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(nsteps):
            loss, grads = fitmod.value_and_grad(loss_fn, params)
            params, state = opt.update(grads, state, params)
            if sync_each:
                loss.item()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / nsteps

    run(10, True)
    ms = {}
    for sync_each in (True, False, False, True):
        ms.setdefault(sync_each, []).append(run(100, sync_each))
    log(f"  float32 step, host clock over 100 steps: with a per-step loss read "
        f"{ms[True]} ms/step, without {ms[False]} ms/step (runs in order sync, no-sync, "
        "no-sync, sync)")

    def cpu(xs):
        return tuple(x.cpu() for x in xs)

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out_gpu = fitmod.fit_gains_and_foregrounds(g_r, g_i, fg_r, fg_i, data_r, data_i, wgts,
                                                   chunks, **kw)
        out_cpu = fitmod.fit_gains_and_foregrounds(
            g_r.cpu(), g_i.cpu(), cpu(fg_r), cpu(fg_i), cpu(data_r), cpu(data_i), cpu(wgts),
            tuple(cpu(c) for c in chunks), **kw)
    check(not [w for w in caught if "plain torch loss" in str(w.message)], "gate fallbacks")
    h_gpu = np.asarray(out_gpu[4]["loss"])
    h_cpu = np.asarray(out_cpu[4]["loss"])
    check(len(h_gpu) == len(h_cpu) == N_LOOP_STEPS, f"step counts {len(h_gpu)} {len(h_cpu)}")
    rel = float(np.max(np.abs(h_gpu - h_cpu) / np.abs(h_cpu)))
    log(f"  loss histories: card {h_gpu[0]:.9e} -> {h_gpu[-1]:.9e}, cpu {h_cpu[0]:.9e} -> "
        f"{h_cpu[-1]:.9e}; max rel diff {rel:.3e}")
    check(rel <= 1e-4, f"in-loop histories disagree: rel {rel}")


# ---------------------------------------------------------------------- #
# phase 6: the CLI with its defaults
# ---------------------------------------------------------------------- #
def phase_cli(tmp, repo):
    from calamity_tpu_torch import models, simulate
    from calamity_tpu_torch.io import CalData, VisData
    from calamity_tpu_torch import LAUNCHES
    from calamity_tpu_torch.ops.fused import KERNEL_NAME, explain_fused_loss_inapplicable
    from calamity_tpu_torch.ops.shared import explain_shared_loss_inapplicable
    from calamity_tpu_torch.solver.tensorize import FitSpec

    log("== phase 6: the port's CLI script with default flags on a 6-antenna Golomb file")
    uvd = simulate.make_golomb_array(nants=6, nfreqs=200, seed=0)
    comps = models.yield_pbl_dpss_model_comps(uvd, offset=MIN_DLY_NS, min_dly=MIN_DLY_NS)
    project_onto_dpss(uvd, comps)
    path = os.path.join(tmp, "golomb.uvh5")
    uvd.write_uvh5(path, clobber=True)
    outs = [os.path.join(tmp, f) for f in ("cli_resid.uvh5", "cli_model.uvh5",
                                           "cli_gains.calfits")]
    argv = ["--input_data_files", path, "--resid_outfilename", outs[0], "--model_outfilename",
            outs[1], "--gain_outfilename", outs[2], "--min_dly", str(MIN_DLY_NS),
            "--offset", str(MIN_DLY_NS), "--maxsteps", "1500", "--tol", "1e-10", "--clobber"]
    LAUNCHES.reset()
    t0 = time.time()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        run_cli(repo, argv)
    wall = time.time() - t0
    log(f"  CLI run {wall:.1f} s; {KERNEL_NAME} launches {LAUNCHES.get(KERNEL_NAME)}")
    # the layout the CLI's defaults (shared_basis=True) packed
    uvd_x = uvd.select(inplace=False, bls=[ap for ap in uvd.get_antpairs() if ap[0] != ap[1]])
    ants = sorted(set(uvd_x.ant_1_array.tolist()) | set(uvd_x.ant_2_array.tolist()))
    spec = FitSpec(uvd_x, comps, {a: i for i, a in enumerate(ants)}, device="cuda",
                   shared_basis=True)
    data_r, _, wgts = spec.pack_data(uvd_x, "xx", spec.times[0])
    for cnum, (c, a0, _) in enumerate(spec.device_chunks()):
        gates = (c, c.new_zeros((a0.shape[0], c.shape[-1])), data_r[cnum], wgts[cnum])
        dense = explain_fused_loss_inapplicable(*gates)
        shared = explain_shared_loss_inapplicable(*gates)
        route = ("the fused kernel" if dense is None else "the shared-basis kernel"
                 if shared is None else f"plain ({dense}; {shared})")
        log(f"  chunk {cnum}: comps {tuple(c.shape)}, groups {a0.shape[0]}: {route}")
    for w in caught:
        log(f"  warning: {w.message}")
    back = VisData.from_uvh5(outs[0])
    data = VisData.from_uvh5(path)
    rms = lambda x: float(np.sqrt(np.mean(np.abs(x) ** 2)))  # noqa: E731
    ratio = rms(back.data_array) / rms(data.data_array)
    log(f"  CLI resid rms / data rms {ratio:.4e} (limit 1e-2)")
    check(ratio <= 1e-2, f"CLI resid/data {ratio}")
    check(np.isfinite(CalData.from_calfits(outs[2]).gain_array).all(), "CLI gains not finite")
    check(np.isfinite(VisData.from_uvh5(outs[1]).data_array).all(), "CLI model not finite")
    check(LAUNCHES.get(KERNEL_NAME) > 0, "CLI run launched no kernel")
    cli_checkpoint_resume(tmp, repo, path)
    cli_scan_resume(tmp, repo, uvd)
    drivers_dft_and_mixed(uvd)
    return cli_on_foreign_files(tmp, repo)


def cli_on_foreign_files(tmp, repo):
    """The CLI with its default flags on HDF5 files the port did not write:
    the repo's h5py-written fixtures (a uvh5 file, starting gains in calh5
    and UVFlag weights: superblock 0, symbol-table groups), the same three
    with their Header strings variable-length (as h5py stores a Python
    ``str``), the pyuvdata-layout fixture (chunked visdata, LZF flags and
    nsamples) and its twin with HERA's integer visibilities (a compound of
    int32 ``r`` and ``i``, read with ``--host_data_dtype complex64``), each
    on the card and on the CPU in this process, both taking the same steps
    (tol 0: 400 steps in each phase of the mixed schedule, as phase 5 fixes
    its steps, so neither stops where the other's rounding moved its tol
    test): gains, model and resid of the two within phase 5's tolerance
    (rel 1e-4 of the largest gain, of the largest model value). Also the
    read seconds of each input file and of the HERA core's flags and
    nsamples cubes, under LZF, under szip and under n-bit then deflate
    (which must read as their LZF twin), through
    ``calamity_tpu_torch._h5lite`` (h5py where it is installed)."""
    import h5py

    from calamity_tpu_torch import LAUNCHES
    from calamity_tpu_torch.io import CalData, VisData
    from calamity_tpu_torch.ops.gains import KERNEL_NAME as GAIN_KERNEL
    from calamity_tpu_torch.ops.gains import PRODUCTS_KERNEL_NAME as PROD_KERNEL
    from calamity_tpu_torch.ops.shared import KERNEL_NAME as SHARED_KERNEL

    log(f"  the CLI on files the port did not write (reader: {h5py.__name__}), on the card and "
        "on the CPU (gains, model, resid rel 1e-4)")
    data = os.path.join(repo, "tests", "data")
    data_torch = os.path.join(repo, "tests", "data_torch")
    cases = {
        "h5py-written": ["--input_data_files", os.path.join(data, "golden_golomb_projected.uvh5"),
                         "--input_gain_files", os.path.join(data, "golden_gains.calh5"),
                         "--weights_file", os.path.join(data, "golden_weights.uvflag.h5")],
        "pyuvdata-layout": ["--input_data_files",
                            os.path.join(data_torch, "pyuvdata_layout.uvh5")],
        "vlen-strings": ["--input_data_files", os.path.join(data_torch, "vlen_strings.uvh5"),
                         "--input_gain_files", os.path.join(data_torch, "vlen_strings.calh5"),
                         "--weights_file", os.path.join(data_torch, "vlen_strings.uvflag.h5")],
        "hera-int-visdata": ["--input_data_files",
                             os.path.join(data_torch, "hera_int_visdata.uvh5"),
                             "--host_data_dtype", "complex64"],
    }
    out = {"launches": 0, "prod_launches": 0, "shared_launches": 0}
    rms = lambda x: float(np.sqrt(np.mean(np.abs(x) ** 2)))  # noqa: E731
    for tag, files in cases.items():
        res = {}
        for device in ("cuda", "cpu"):
            names = [os.path.join(tmp, f"{tag}_{device}_{k}") for k in ("resid.uvh5",
                                                                       "model.uvh5",
                                                                       "gains.calfits")]
            LAUNCHES.reset()
            t0 = time.time()
            run_cli(repo, files + ["--resid_outfilename", names[0], "--model_outfilename",
                                   names[1], "--gain_outfilename", names[2], "--min_dly",
                                   str(MIN_DLY_NS), "--offset", str(MIN_DLY_NS), "--maxsteps",
                                   "400", "--tol", "0", "--clobber", "--device", device])
            res[device] = (VisData.from_uvh5(names[0]).data_array,
                           VisData.from_uvh5(names[1]).data_array,
                           CalData.from_calfits(names[2]).gain_array, time.time() - t0,
                           LAUNCHES.get(GAIN_KERNEL), LAUNCHES.get(PROD_KERNEL),
                           LAUNCHES.get(SHARED_KERNEL))
        (r_c, m_c, g_c, s_c, n_c, p_c, sh_c), (r_h, m_h, g_h, s_h, *_) = res["cuda"], res["cpu"]
        host_dtype = files[files.index("--host_data_dtype") + 1] if "--host_data_dtype" in files \
            else None
        src = VisData.from_uvh5(files[1], data_dtype=host_dtype)
        good = ~src.flag_array
        ratio = rms(r_c[good]) / rms(src.data_array[good])
        dg = float(np.max(np.abs(g_c - g_h)) / np.max(np.abs(g_h)))
        dm = float(np.max(np.abs(m_c - m_h)) / np.max(np.abs(m_h)))
        dr = float(np.max(np.abs(r_c - r_h)) / np.max(np.abs(m_h)))
        log(f"    {tag}: card {s_c:.1f} s ({GAIN_KERNEL} launches {n_c}, {PROD_KERNEL} {p_c}, "
            f"{SHARED_KERNEL} {sh_c}), "
            f"CPU {s_h:.1f} s; card "
            f"against CPU: gains rel {dg:.2e}, model rel {dm:.2e}, resid {dr:.2e} of the model's "
            f"peak; card resid/data {ratio:.3e} (limit 1e-2)")
        check(max(dg, dm, dr) <= 1e-4, f"{tag}: the card's CLI run differs from the CPU's")
        check(ratio <= 1e-2 and min(n_c, p_c) > 0,
              f"{tag}: resid/data {ratio}, {n_c} and {p_c} launches")
        out["launches"] += n_c
        out["prod_launches"] += p_c
        out["shared_launches"] += sh_c
    # read seconds through the port's HDF5 reader
    from calamity_tpu_torch.io import FlagWeights

    reads = {
        "pyuvdata_layout.uvh5": lambda p: VisData.from_uvh5(p),
        "hera_int_visdata.uvh5": lambda p: VisData.from_uvh5(p, data_dtype=np.complex64),
        "vlen_strings.uvh5": lambda p: VisData.from_uvh5(p),
        "vlen_strings.calh5": lambda p: CalData.from_calh5(p),
        "vlen_strings.uvflag.h5": lambda p: FlagWeights.from_uvflag_h5(p),
    }
    out["read_s"], objs = {}, {}
    for name, read in reads.items():
        t0 = time.time()
        objs[name] = read(os.path.join(data_torch, name))
        out["read_s"][name] = time.time() - t0
    uvd_s, cal_s, flags_s = (objs[f"vlen_strings.{k}"] for k in ("uvh5", "calh5", "uvflag.h5"))
    check(uvd_s.telescope_name == cal_s.telescope_name == "SYNTH"
          and uvd_s.antenna_names[:2] == cal_s.antenna_names[:2] == ["ANT0", "ANT1"]
          and cal_s.cal_type == "gain" and flags_s.mode == "flag",
          "the variable-length strings read wrong")
    t0 = time.time()
    with h5py.File(os.path.join(data_torch, "lzf_cube_4388x1536.h5"), "r") as f:
        flags = f["Data/flags"][()]
        nsamples = f["Data/nsamples"][()]
    out["lzf_cube_read_s"] = time.time() - t0
    check(flags.shape == nsamples.shape == (4388, 1536, 1) and np.all(nsamples == 1.0),
          "the LZF cube reads wrong")
    t0 = time.time()
    with h5py.File(os.path.join(data_torch, "szip_cube_4388x1536.h5"), "r") as f:
        check(np.array_equal(f["Data/flags"][()], flags)
              and np.array_equal(f["Data/nsamples"][()], nsamples),
              "the szip cube does not read as its LZF twin")
    out["szip_cube_read_s"] = time.time() - t0
    t0 = time.time()
    with h5py.File(os.path.join(data_torch, "nbit_cube_4388x1536.h5"), "r") as f:
        nbit_flags, nbit_nsamples = f["Data/flags"][()], f["Data/nsamples"][()]
    out["nbit_cube_read_s"] = time.time() - t0
    check(nbit_flags.dtype == np.uint8 and np.array_equal(nbit_flags.astype(bool), flags)
          and nbit_nsamples.dtype == np.float32 and np.array_equal(nbit_nsamples, nsamples),
          "the n-bit cube does not read as its LZF twin")
    log(f"    read seconds ({h5py.__name__}, host): "
        + ", ".join(f"{k} {v:.3f} s" for k, v in out["read_s"].items())
        + f"; the 4388 x 1536 flags and nsamples: LZF {out['lzf_cube_read_s']:.3f} s, szip (NN) "
        f"{out['szip_cube_read_s']:.3f} s, n-bit then deflate {out['nbit_cube_read_s']:.3f} s")
    storage_fixtures(data_torch)
    return out


def _dtype_name(dt):
    """A dtype's name in a digest, as ``tests/torch_make_h5_fixture.py``
    writes it: its ``str``; a structured dtype's members spelled out."""
    if dt.names is not None:
        members = ", ".join(f"{n}: {_dtype_name(dt.fields[n][0])} @ {dt.fields[n][1]}"
                            for n in dt.names)
        return f"{{{members}}} x {dt.itemsize}"
    return dt.str if dt.subdtype is None else f"{dt.base.str}{dt.shape}"


def _value_bytes(values):
    """What a digest hashes: the values in C order, a structured array
    member after member, each string of an object array as its length (8
    bytes) and its bytes (never a pointer)."""
    if values.dtype.names is not None:
        return b"".join(_value_bytes(values[n]) for n in values.dtype.names)
    if values.dtype.kind == "O":
        return b"".join(len(v).to_bytes(8, "little") + v for v in values.reshape(-1))
    return np.ascontiguousarray(values).tobytes()


def storage_fixtures(data_torch):
    """The fixtures in the storage of the latest file format, of HDF5's
    built-in filters (extensible-array chunk indices with paged data
    blocks, v2 B-tree chunk indices, szip, scale-offset, n-bit) and in the
    types h5py and pyuvdata write (variable-length strings, integer
    compounds; ``tests/torch_make_h5_fixture.py``), read through
    ``calamity_tpu_torch._h5lite`` (h5py where it is installed): every
    dataset's shape, dtype and SHA-256 against the digests of h5py's
    reading committed beside them; the uvh5 files through the port's
    ``VisData``."""
    import hashlib

    import h5py

    from calamity_tpu_torch.io import VisData

    with open(os.path.join(data_torch, "storage_digests.json")) as fh:
        want = json.load(fh)
    for name, digests in sorted(want.items()):
        path = os.path.join(data_torch, name)
        got = {}
        t0 = time.time()
        with h5py.File(path, "r") as f:
            def walk(grp, prefix):
                for key in grp.keys():
                    node = grp[key]
                    if hasattr(node, "keys"):
                        walk(node, f"{prefix}/{key}")
                        continue
                    values = np.ascontiguousarray(  # at least 1-d
                        node[()], dtype=object if node.dtype.kind == "O" else None)
                    got[f"{prefix}/{key}"] = {
                        "shape": list(values.shape), "dtype": _dtype_name(values.dtype),
                        "sha256": hashlib.sha256(_value_bytes(values)).hexdigest()}
            walk(f, "")
        seconds = time.time() - t0
        bad = sorted(k for k in digests if got.get(k) != digests[k])
        check(not bad and got.keys() == digests.keys(),
              f"{name}: datasets read other than h5py reads them: {bad}")
        line = f"    {name}: {len(got)} datasets equal to h5py's digests, read in {seconds:.3f} s"
        if name.endswith(".uvh5"):
            uvd = VisData.from_uvh5(path, data_dtype=np.complex64)
            # the files made from the pyuvdata-layout fixture's data flag channel 10
            flagged = name == "vlen_strings.uvh5" or uvd.flag_array[:, :, 10].all()
            check(flagged and np.isfinite(uvd.data_array).all(), f"{name}: VisData reads wrong")
            line += f"; VisData {uvd.data_array.shape}"
        log(line + f" ({h5py.__name__}, host)")


def corrupted_copy(uvd, seed, err=0.05):
    """``uvd`` with random per-antenna gain errors applied: a fit with real
    gradients."""
    from calamity_tpu_torch import cal_utils

    truth = cal_utils.blank_uvcal_from_uvdata(uvd)
    rng = np.random.default_rng(seed)
    truth.gain_array = truth.gain_array * (1 + err * rng.standard_normal(truth.gain_array.shape)
                                           + 1j * err * rng.standard_normal(truth.gain_array.shape))
    return cal_utils.apply_gains(uvd, truth, inverse=True)


def cli_scan_resume(tmp, repo, uvd):
    """The scan's CLI with the mixed schedule and a checkpoint directory on a
    3-time Golomb file: a run stopped by a failure injected into the first
    checkpoint save of time 1's float32 polish (the time in progress
    persists under ``pol0_scan/time_1``), resumed into the same directory,
    against an uninterrupted run: histories, files and gains equal."""
    from calamity_tpu_torch.io import CalData, VisData
    from calamity_tpu_torch.solver import checkpoint as ckpt

    log(f"  scan CLI (--time_parallel --init_guesses_from_previous_time_step --comps_precision "
        f"mixed --checkpoint_dir) on {SCAN_NTIMES} times: stopped inside time 1, resumed, "
        "against an uninterrupted run")
    later = []
    for t in range(SCAN_NTIMES):
        u = uvd.copy()
        u.time_array = u.time_array + 2.0 * t
        later.append(u)
    multi = later[0]
    for u in later[1:]:
        multi = multi + u
    path = os.path.join(tmp, "golomb_scan.uvh5")
    corrupted_copy(multi, SEED + 1).write_uvh5(path, clobber=True)

    def argv(tag, ckdir):
        return ["--input_data_files", path, "--resid_outfilename",
                os.path.join(tmp, f"{tag}_resid.uvh5"), "--model_outfilename",
                os.path.join(tmp, f"{tag}_model.uvh5"), "--gain_outfilename",
                os.path.join(tmp, f"{tag}_gains.calfits"), "--fitted_info_outfilename",
                os.path.join(tmp, f"{tag}_info.npy"), "--min_dly", str(MIN_DLY_NS),
                "--offset", str(MIN_DLY_NS), "--maxsteps", "1500", "--tol", "1e-10",
                "--time_parallel", "--init_guesses_from_previous_time_step",
                "--comps_precision", "mixed", "--checkpoint_dir", ckdir,
                "--checkpoint_every", str(SCAN_CK_EVERY), "--clobber"]

    real_save = ckpt.save_state
    cut = []

    def failing_save(where, tree_state, scalar_state):
        if os.path.join("time_1", "phase_f32") in where and not cut:
            cut.append(where)
            raise RuntimeError("injected stop")
        return real_save(where, tree_state, scalar_state)

    cut_dir = os.path.join(tmp, "scan_ck_cut")
    ckpt.save_state = failing_save
    try:
        run_cli(repo, argv("scan_cut", cut_dir))
    except RuntimeError as exc:
        check("injected stop" in str(exc), f"scan CLI run failed: {exc}")
    finally:
        ckpt.save_state = real_save
    check(cut, "the scan CLI run never reached time 1's float32 checkpoint")
    scan_dir = os.path.join(cut_dir, "pol0_scan")
    check(os.path.isdir(os.path.join(scan_dir, "step_1"))
          and not os.path.isdir(os.path.join(scan_dir, "step_2")), "markers after the stop")
    last = ckpt.latest_checkpoint(os.path.join(scan_dir, "time_1", "phase_bf16"))
    log(f"    stopped at {os.path.relpath(cut[0], cut_dir)}; time 1's bf16 phase left "
        f"{None if last is None else os.path.basename(last)}")
    run_cli(repo, argv("scan_resumed", cut_dir))
    run_cli(repo, argv("scan_straight", os.path.join(tmp, "scan_ck_straight")))
    check(not os.path.isdir(os.path.join(scan_dir, "time_1")), "time_1 left after its marker")
    info = {t: np.load(os.path.join(tmp, f"scan_{t}_info.npy"), allow_pickle=True).item()
            for t in ("resumed", "straight")}
    for t in range(SCAN_NTIMES):
        h_res, h_str = info["resumed"][0][t], info["straight"][0][t]
        log(f"    time {t}: phase steps resumed {h_res['phase_steps']}, uninterrupted "
            f"{h_str['phase_steps']}")
        check(h_res["loss"] == h_str["loss"], f"time {t}: resumed loss history differs")
    for suffix in ("resid.uvh5", "model.uvh5"):
        a = VisData.from_uvh5(os.path.join(tmp, f"scan_resumed_{suffix}")).data_array
        b = VisData.from_uvh5(os.path.join(tmp, f"scan_straight_{suffix}")).data_array
        check(np.array_equal(a, b), f"resumed scan {suffix} differs from the uninterrupted run")
    a = CalData.from_calfits(os.path.join(tmp, "scan_resumed_gains.calfits")).gain_array
    b = CalData.from_calfits(os.path.join(tmp, "scan_straight_gains.calfits")).gain_array
    check(np.array_equal(a, b), "resumed scan gains differ from the uninterrupted run")
    log("    resumed scan files equal the uninterrupted run's")


def drivers_dft_and_mixed(uvd_dpss):
    """``calibrate_and_model_dft`` on data projected onto the DFT delay
    modes, and ``calibrate_and_model_mixed`` (multi-baseline covariance
    groups through the plain loss, single-baseline groups through the
    kernel) on the DPSS-projected file with 1% starting gain errors, both
    on the card: each fit converges (model rms >= 100 x resid rms)."""
    import torch

    from calamity_tpu_torch import LAUNCHES, cal_utils, models, simulate
    from calamity_tpu_torch.calibration import calibrate_and_model_dft, calibrate_and_model_mixed
    from calamity_tpu_torch.ops.fused import KERNEL_NAME

    rms = lambda x: float(np.sqrt(np.mean(np.abs(x) ** 2)))  # noqa: E731
    uvd = simulate.make_golomb_array(nants=6, nfreqs=200, seed=0)
    dft = models.yield_pbl_model_comps(uvd, offset=MIN_DLY_NS, min_dly=MIN_DLY_NS, basis="dft")
    for key, mat in dft.items():
        ap = key[0][0]
        d = uvd.get_data(ap + ("xx",))
        proj = (mat @ np.linalg.lstsq(mat, d.T, rcond=None)[0]).T
        rows, conj = uvd._bl_time_rows(*ap)
        uvd.data_array[rows, 0, :, 0] = np.conj(proj) if conj else proj
    LAUNCHES.reset()
    t0 = time.time()
    model, resid, _, hist = calibrate_and_model_dft(
        uvdata=uvd, min_dly=MIN_DLY_NS, offset=MIN_DLY_NS, maxsteps=3000, tol=1e-10,
        correct_resid=True, correct_model=True, model_regularization="post_hoc",
        shared_basis=False, device="cuda")
    torch.cuda.synchronize()
    ratio = rms(resid.data_array) / rms(model.data_array)
    log(f"  calibrate_and_model_dft: {time.time() - t0:.1f} s, {len(hist[0][0]['loss'])} "
        f"recorded steps, {KERNEL_NAME} launches {LAUNCHES.get(KERNEL_NAME)}, resid rms / model "
        f"rms {ratio:.3e} (limit 1e-2)")
    check(ratio <= 1e-2 and LAUNCHES.get(KERNEL_NAME) > 0, "the DFT driver did not converge "
          "through the kernel")

    gains = cal_utils.blank_uvcal_from_uvdata(uvd_dpss)
    rng = np.random.default_rng(11)
    gains.gain_array = gains.gain_array + 1e-2 * rng.standard_normal(gains.gain_array.shape) \
        + 1e-2j * rng.standard_normal(gains.gain_array.shape)
    LAUNCHES.reset()
    t0 = time.time()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        model, resid, fitted, hist = calibrate_and_model_mixed(
            uvdata=uvd_dpss, gains=gains, min_dly=0.0, offset=0.0, ant_dly=2.0 / 3.0,
            red_tol_freq=0.5, freeze_model=True, maxsteps=3000, tol=1e-10, correct_resid=False,
            correct_model=False, grp_size_threshold=1, model_regularization="post_hoc",
            shared_basis=False, device="cuda")
    torch.cuda.synchronize()
    plain = [str(w.message) for w in caught if "plain torch loss" in str(w.message)]
    resid = cal_utils.apply_gains(resid, fitted)
    model = cal_utils.apply_gains(model, fitted)
    ratio = rms(resid.data_array) / rms(model.data_array)
    log(f"  calibrate_and_model_mixed: {time.time() - t0:.1f} s, {len(hist[0][0]['loss'])} "
        f"recorded steps, {KERNEL_NAME} launches {LAUNCHES.get(KERNEL_NAME)}, resid rms / model "
        f"rms {ratio:.3e} (limit 1e-2); plain-loss chunks: {plain}")
    check(ratio <= 1e-2 and np.isfinite(fitted.gain_array).all(), "the mixed driver did not "
          "converge")
    check(LAUNCHES.get(KERNEL_NAME) > 0 and plain, "the mixed driver did not take both routes")


def run_cli(repo, argv):
    saved = sys.argv
    sys.argv = ["calibrate_and_model_dpss_torch.py"] + argv
    try:
        runpy.run_path(os.path.join(repo, "scripts", "calibrate_and_model_dpss_torch.py"),
                       run_name="__main__")
    finally:
        sys.argv = saved


def cli_checkpoint_resume(tmp, repo, path):
    """--time_parallel --checkpoint_dir: a run cut by a small maxsteps,
    then resumed with the full maxsteps into the same directory, against an
    uninterrupted run. The float32 schedule, so that the cut run stops in
    the phase the resumed run continues."""
    from calamity_tpu_torch.io import CalData, VisData
    from calamity_tpu_torch.solver.checkpoint import latest_checkpoint

    log(f"  --time_parallel --checkpoint_dir: cut at {CUT_STEPS} steps, resumed, against an "
        "uninterrupted run")

    def argv(tag, maxsteps, ckdir):
        return ["--input_data_files", path, "--resid_outfilename",
                os.path.join(tmp, f"{tag}_resid.uvh5"), "--model_outfilename",
                os.path.join(tmp, f"{tag}_model.uvh5"), "--gain_outfilename",
                os.path.join(tmp, f"{tag}_gains.calfits"), "--fitted_info_outfilename",
                os.path.join(tmp, f"{tag}_info.npy"), "--min_dly", str(MIN_DLY_NS),
                "--offset", str(MIN_DLY_NS), "--maxsteps", str(maxsteps), "--tol", "1e-10",
                "--time_parallel", "--comps_precision", "float32", "--checkpoint_dir", ckdir,
                "--checkpoint_every", str(CUT_STEPS // 2), "--clobber"]

    cut_dir = os.path.join(tmp, "ck_cut")
    t0 = time.time()
    run_cli(repo, argv("cut", CUT_STEPS, cut_dir))
    last = latest_checkpoint(os.path.join(cut_dir, "batched"))
    log(f"    cut run ({time.time() - t0:.1f} s) left {os.path.basename(last)}")
    check(last is not None and last.endswith(f"step_{CUT_STEPS}"), f"cut run left {last}")
    run_cli(repo, argv("resumed", 1500, cut_dir))
    run_cli(repo, argv("straight", 1500, os.path.join(tmp, "ck_straight")))
    info = {t: np.load(os.path.join(tmp, f"{t}_info.npy"), allow_pickle=True).item()
            for t in ("resumed", "straight")}
    h_res, h_str = info["resumed"][0][0]["loss"], info["straight"][0][0]["loss"]
    log(f"    recorded steps: resumed {len(h_res)}, uninterrupted {len(h_str)}")
    check(len(h_str) > CUT_STEPS and h_res == h_str, "resumed loss history differs")
    for suffix in ("resid.uvh5", "model.uvh5"):
        a = VisData.from_uvh5(os.path.join(tmp, f"resumed_{suffix}")).data_array
        b = VisData.from_uvh5(os.path.join(tmp, f"straight_{suffix}")).data_array
        check(np.array_equal(a, b), f"resumed {suffix} differs from the uninterrupted run")
    a = CalData.from_calfits(os.path.join(tmp, "resumed_gains.calfits")).gain_array
    b = CalData.from_calfits(os.path.join(tmp, "straight_gains.calfits")).gain_array
    check(np.array_equal(a, b), "resumed gains differ from the uninterrupted run")
    log("    resumed files equal the uninterrupted run's")


# ---------------------------------------------------------------------- #
# phase 7: the time-parallel path at full width
# ---------------------------------------------------------------------- #
def phase_time_parallel(tmp, comps=None):
    import torch

    from calamity_tpu_torch.io import CalData, VisData
    from calamity_tpu_torch import LAUNCHES
    from calamity_tpu_torch.calibration import (
        POLL_EVERY,
        calibrate_and_model_dpss,
        read_calibrate_and_model_dpss,
    )
    from calamity_tpu_torch.ops.fused import KERNEL_NAME
    from calamity_tpu_torch.ops.gains import KERNEL_NAME as GAIN_KERNEL
    from calamity_tpu_torch.ops.gains import PRODUCTS_KERNEL_NAME as PROD_KERNEL

    nslices = TP_NTIMES * TP_NPOLS
    log(f"== phase 7: time-parallel path, {NANTS} antennas, {NFREQS} channels, {TP_NTIMES} "
        f"times x {TP_NPOLS} polarizations = {nslices} slices in one batched descent")
    path = os.path.join(tmp, "tp.uvh5")
    t0 = time.time()
    uvd, comps = make_corrupted_file(path, TP_NTIMES, TP_NPOLS, comps=comps)
    log(f"  simulated and wrote {uvd.Nblts} baseline-times x {uvd.Nfreqs} channels x "
        f"{uvd.Npols} polarizations in {time.time() - t0:.1f} s (host)")
    outs = {k: os.path.join(tmp, f"tp_{k}") for k in ("resid.uvh5", "model.uvh5",
                                                      "gains.calfits")}
    timings = {}
    kw = dict(shared_basis=False, model_regularization="post_hoc", learning_rate=1e-2,
              maxsteps=MAXSTEPS, tol=TOL, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.reset()
    t0 = time.time()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        model, resid, gains, info = read_calibrate_and_model_dpss(
            input_data_files=path, resid_outfilename=outs["resid.uvh5"],
            model_outfilename=outs["model.uvh5"], gain_outfilename=outs["gains.calfits"],
            clobber=True, min_dly=MIN_DLY_NS, offset=MIN_DLY_NS, time_parallel=True,
            timings=timings, **kw)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = LAUNCHES.get(KERNEL_NAME)
    instances = instance_launches(KERNEL_NAME)
    gain_launches = LAUNCHES.get(GAIN_KERNEL)
    prod_launches = LAUNCHES.get(PROD_KERNEL)
    adamax = adamax_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    fallbacks = [str(w.message) for w in caught if "plain torch loss" in str(w.message)]
    check(not fallbacks, f"chunks left out by the kernel gate: {fallbacks}")
    steps, seconds = timings["phase_steps"], timings["phase_seconds"]
    recorded, warmups = sum(steps), len(steps)
    for name, n, sec in zip(("bf16", "f32"), steps, seconds):
        log(f"  {name} phase: {n} batch steps, {1e3 * sec / max(n, 1):.3f} ms/step (host clock, "
            f"{nslices} slices per step, incl. the host polls)")
    per_slice = {(p, t): h["phase_steps"] for p, by_t in info.items() if isinstance(p, int)
                 for t, h in by_t.items()}
    log(f"  steps per slice (bf16, f32) by (pol, time): {per_slice}")
    log("  host seconds: " + ", ".join(f"{k} {v:.2f}" for k, v in sorted(timings.items())
                                       if isinstance(v, float))
        + f"; read_calibrate_and_model_dpss in all {wall:.1f}")
    log(f"  peak device memory {peak_gb:.3f} GB; {KERNEL_NAME} launches {launches}, "
        f"{GAIN_KERNEL} launches {gain_launches}, {PROD_KERNEL} launches {prod_launches}, "
        f"{adamax}, recorded batch steps {recorded} + {warmups} warm-up steps")
    # every step of both phases launched each kernel once (a block of host
    # polls may run up to POLL_EVERY - 1 steps past the last freeze, which
    # are undone); the step-0 guard launches the loss-only instance
    for name, n in ((KERNEL_NAME, launches), (GAIN_KERNEL, gain_launches),
                    (PROD_KERNEL, prod_launches), *adamax.items()):
        check(recorded + warmups <= n <= recorded + warmups * POLL_EVERY,
              f"{n} {name} launches for {recorded} recorded + {warmups} warm-up steps")
    check(len(per_slice) == nslices, f"{len(per_slice)} slices fitted, expected {nslices}")
    check(np.isfinite(gains.gain_array).all(), "non-finite gains")
    rms = lambda x: float(np.sqrt(np.mean(np.abs(x) ** 2)))  # noqa: E731
    ratios = {}
    for pol in range(uvd.Npols):
        for t in np.unique(uvd.time_array):
            rows = np.isclose(uvd.time_array, t, rtol=0.0, atol=1e-7)
            good = ~uvd.flag_array[rows, 0, :, pol]
            ratios[(pol, float(t))] = (rms(resid.data_array[rows, 0, :, pol][good])
                                       / rms(uvd.data_array[rows, 0, :, pol][good]))
    worst = max(ratios.values())
    log(f"  resid rms / data rms per slice: {', '.join(f'{r:.3e}' for r in ratios.values())} "
        "(limit 1e-2 each)")
    check(worst <= 1e-2, f"a slice's resid/data {worst} > 1e-2")
    check(np.allclose(VisData.from_uvh5(outs["resid.uvh5"]).data_array, resid.data_array),
          "resid file does not read back")
    check(np.allclose(VisData.from_uvh5(outs["model.uvh5"]).data_array, model.data_array),
          "model file does not read back")
    check(np.allclose(CalData.from_calfits(outs["gains.calfits"]).gain_array, gains.gain_array),
          "gains file does not read back")
    log("  output files read back through calamity_tpu_torch.io and match")

    # two of the slices (the first time, both polarizations) on the serial path
    t_first = np.unique(uvd.time_array)[0]
    sub = uvd.select(times=[t_first], inplace=False)
    t0 = time.time()
    _, resid_s, _, info_s = calibrate_and_model_dpss(uvdata=sub, fg_model_comps_dict=comps,
                                                     **kw)
    torch.cuda.synchronize()
    log(f"  serial path on 2 of the slices (the basis of the file's simulation): "
        f"{time.time() - t0:.1f} s")
    for pol in range(uvd.Npols):
        h_b = np.asarray(info[pol][0]["loss"])
        h_s = np.asarray(info_s[pol][0]["loss"])
        n = min(200, len(h_b), len(h_s))
        rel = float(np.max(np.abs(h_b[:n] - h_s[:n]) / np.abs(h_s[:n])))
        rows = np.isclose(sub.time_array, t_first, rtol=0.0, atol=1e-7)
        good = ~sub.flag_array[rows, 0, :, pol]
        r_s = rms(resid_s.data_array[rows, 0, :, pol][good]) / rms(
            sub.data_array[rows, 0, :, pol][good])
        r_b = ratios[(pol, float(t_first))]
        log(f"  pol {pol}: steps batched {info[pol][0]['phase_steps']} serial "
            f"{info_s[pol][0]['phase_steps']}; first {n} losses max rel diff {rel:.2e}; "
            f"resid/data batched {r_b:.3e} serial {r_s:.3e}")
        check(rel <= 1e-2, f"pol {pol}: batched and serial histories differ: rel {rel}")
        check(max(r_b, r_s) <= 2 * min(r_b, r_s), f"pol {pol}: resid/data {r_b} vs {r_s}")
    return {"launches": launches, "gain_launches": gain_launches, "prod_launches": prod_launches,
            "adamax_launches": adamax, "instances": instances, "path": path, "uvd": uvd,
            "comps": comps, "info": info, "ratios": ratios, "timings": timings}


def batched_kernel_and_plain(tp):
    """Phase 7's 8 slices packed once and fitted by the batched descent
    (float32 comps, tol, maxsteps, lr 1e-2; slices freeze as they
    converge) with the Adamax update and the carry on their kernels, then
    with their plain versions (``ops.adamax.plain_versions``): steps,
    steps per slice, loss histories, parameters, optimizer state and final
    losses equal to the bit."""
    import contextlib

    import torch

    import profile_step_torch as prof
    from calamity_tpu_torch import LAUNCHES, cal_utils
    from calamity_tpu_torch.calibration import POLL_EVERY
    from calamity_tpu_torch.ops import adamax as A
    from calamity_tpu_torch.parallel import batched
    from calamity_tpu_torch.solver import fit as fitmod
    from calamity_tpu_torch.solver.optimizers import tree_leaves
    from calamity_tpu_torch.solver.tensorize import FitSpec

    uvd = tp["uvd"]
    gains = cal_utils.blank_uvcal_from_uvdata(uvd)
    spec = FitSpec(uvd, tp["comps"], {int(a): i for i, a in enumerate(gains.ant_array)},
                   device="cuda", shared_basis=False)
    chunks = spec.device_chunks()
    dr, di, w, g_r, g_i, fr, fi = prof.batched_problem(spec, uvd, gains)
    cfg = fitmod.FitConfig(tol=TOL, maxsteps=MAXSTEPS, opt_kwargs=(("learning_rate", 1e-2),))
    runs = {}
    for kind in ("kernels", "plain"):
        LAUNCHES.reset()
        t0 = time.time()
        with A.plain_versions() if kind == "plain" else contextlib.nullcontext():
            res = batched.batched_fit_core(cfg, chunks, dr, di, w, g_r.clone(), g_i.clone(),
                                           [x.clone() for x in fr], [x.clone() for x in fi],
                                           poll_every=POLL_EVERY)
        torch.cuda.synchronize()
        runs[kind] = (res, adamax_launches(), time.time() - t0)
    (rk, nk, sk), (rp, np_, sp) = runs["kernels"], runs["plain"]
    same = (rk.nsteps == rp.nsteps and np.array_equal(rk.nsteps_slice, rp.nsteps_slice)
            and np.array_equal(rk.loss_history, rp.loss_history, equal_nan=True)
            and all(_same_bits(x, y) for x, y in zip(
                tree_leaves(rk.opt_state) + [rk.g_r, rk.g_i, *rk.fg_r, *rk.fg_i, rk.final_loss],
                tree_leaves(rp.opt_state) + [rp.g_r, rp.g_i, *rp.fg_r, *rp.fg_i,
                                             rp.final_loss])))
    log(f"  phase 7's {g_r.shape[0]} slices packed once, float32 comps: {int(rk.nsteps)} batch "
        f"steps (per slice {rk.nsteps_slice.tolist()}), {sk:.1f} s with the kernels ({nk}), "
        f"{sp:.1f} s with the plain versions ({np_}); steps, histories, parameters and "
        f"optimizer state equal to the bit: {same}")
    check(same, "phase 7's slices: the kernels' descent and the plain versions' differ")
    check(min(nk.values()) >= int(rk.nsteps) and not any(np_.values()),
          f"launches with the kernels {nk}, with the plain versions {np_}")
    return {"steps": int(rk.nsteps), "launches": nk}

# ---------------------------------------------------------------------- #
# phase 8: the warm-started time scan at full width
# ---------------------------------------------------------------------- #
def phase_scan(tmp, tp):
    import torch

    from calamity_tpu_torch.io import CalData, VisData
    from calamity_tpu_torch import LAUNCHES
    from calamity_tpu_torch.calibration import (
        POLL_EVERY,
        calibrate_and_model_dpss,
        read_calibrate_and_model_dpss,
    )
    from calamity_tpu_torch.ops.fused import KERNEL_NAME
    from calamity_tpu_torch.ops.gains import KERNEL_NAME as GAIN_KERNEL
    from calamity_tpu_torch.ops.gains import PRODUCTS_KERNEL_NAME as PROD_KERNEL

    uvd, path, comps = tp["uvd"], tp["path"], tp["comps"]
    log(f"== phase 8: warm-started time scan, {NANTS} antennas, {NFREQS} channels, "
        f"{TP_NTIMES} times x {TP_NPOLS} polarizations, each polarization's times in order "
        "(phase 7's file and basis; default precision)")
    outs = {k: os.path.join(tmp, f"scan_{k}") for k in ("resid.uvh5", "model.uvh5",
                                                        "gains.calfits")}
    timings = {}
    kw = dict(shared_basis=False, model_regularization="post_hoc", learning_rate=1e-2,
              maxsteps=MAXSTEPS, tol=TOL, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.reset()
    t0 = time.time()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        model, resid, gains, info = read_calibrate_and_model_dpss(
            input_data_files=path, resid_outfilename=outs["resid.uvh5"],
            model_outfilename=outs["model.uvh5"], gain_outfilename=outs["gains.calfits"],
            clobber=True, fg_model_comps_dict=comps, time_parallel=True,
            init_guesses_from_previous_time_step=True, timings=timings, **kw)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = LAUNCHES.get(KERNEL_NAME)
    gain_launches = LAUNCHES.get(GAIN_KERNEL)
    prod_launches = LAUNCHES.get(PROD_KERNEL)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    fallbacks = [str(w.message) for w in caught if "plain torch loss" in str(w.message)]
    check(not fallbacks, f"chunks left out by the kernel gate: {fallbacks}")
    recorded = fits = 0
    for pol in range(uvd.Npols):
        for t, h in sorted(info[pol].items()):
            steps, secs = h["phase_steps"], h["phase_seconds"]
            recorded += len(h["loss"])
            fits += len(steps)
            rates = [1e3 * s / max(n, 1) for s, n in zip(secs, steps)]
            log(f"  pol {pol} time {t}: {steps} steps, {', '.join(f'{r:.3f}' for r in rates)} "
                f"ms/step (host clock, descent only); loss {h['loss'][0]:.6e} -> "
                f"{h['loss'][-1]:.6e}")
    log("  host seconds: " + ", ".join(f"{k} {v:.2f}" for k, v in sorted(timings.items())
                                       if isinstance(v, float))
        + f"; read_calibrate_and_model_dpss in all {wall:.1f}; step-0 guard "
        f"{timings['scan_guard_s'] / fits:.3f} s per time")
    log(f"  peak device memory {peak_gb:.3f} GB; {KERNEL_NAME} launches {launches}, "
        f"{GAIN_KERNEL} launches {gain_launches}, {PROD_KERNEL} launches {prod_launches}, for "
        f"{recorded} recorded + {fits} warm-up "
        f"steps ({launches / recorded:.4f} per recorded step)")
    # one launch per step; a block of host polls may run up to POLL_EVERY - 1
    # steps past a time's stop, which are undone
    for name, n in ((KERNEL_NAME, launches), (GAIN_KERNEL, gain_launches),
                    (PROD_KERNEL, prod_launches)):
        check(recorded + fits <= n <= recorded + fits * POLL_EVERY,
              f"{n} {name} launches for {recorded} recorded + {fits} warm-up steps")
    check(fits == TP_NTIMES * TP_NPOLS, f"{fits} times fitted")
    check(np.isfinite(gains.gain_array).all(), "non-finite gains")
    rms = lambda x: float(np.sqrt(np.mean(np.abs(x) ** 2)))  # noqa: E731
    ratios = {}
    for pol in range(uvd.Npols):
        for t in np.unique(uvd.time_array):
            rows = np.isclose(uvd.time_array, t, rtol=0.0, atol=1e-7)
            good = ~uvd.flag_array[rows, 0, :, pol]
            ratios[(pol, float(t))] = (rms(resid.data_array[rows, 0, :, pol][good])
                                       / rms(uvd.data_array[rows, 0, :, pol][good]))
    log(f"  resid rms / data rms per slice: {', '.join(f'{r:.3e}' for r in ratios.values())} "
        "(limit 1e-2 each)")
    check(max(ratios.values()) <= 1e-2, f"a slice's resid/data {max(ratios.values())} > 1e-2")
    check(np.allclose(VisData.from_uvh5(outs["resid.uvh5"]).data_array, resid.data_array),
          "resid file does not read back")
    check(np.allclose(VisData.from_uvh5(outs["model.uvh5"]).data_array, model.data_array),
          "model file does not read back")
    check(np.allclose(CalData.from_calfits(outs["gains.calfits"]).gain_array, gains.gain_array),
          "gains file does not read back")
    log("  output files read back through calamity_tpu_torch.io and match")

    # each polarization's first time, which the scan starts cold, on the
    # serial path at the same precision
    t_first = np.unique(uvd.time_array)[0]
    sub = uvd.select(times=[t_first], inplace=False)
    t0 = time.time()
    _, resid_s, _, info_s = calibrate_and_model_dpss(uvdata=sub, fg_model_comps_dict=comps,
                                                     comps_precision="float32", **kw)
    torch.cuda.synchronize()
    log(f"  serial path on each polarization's first time: {time.time() - t0:.1f} s")
    for pol in range(uvd.Npols):
        h_c = np.asarray(info[pol][0]["loss"])
        h_s = np.asarray(info_s[pol][0]["loss"])
        n = min(200, len(h_c), len(h_s))
        rel = float(np.max(np.abs(h_c[:n] - h_s[:n]) / np.abs(h_s[:n])))
        rows = np.isclose(sub.time_array, t_first, rtol=0.0, atol=1e-7)
        good = ~sub.flag_array[rows, 0, :, pol]
        r_s = rms(resid_s.data_array[rows, 0, :, pol][good]) / rms(
            sub.data_array[rows, 0, :, pol][good])
        r_c = ratios[(pol, float(t_first))]
        log(f"  pol {pol}: steps scan {len(h_c)} serial {len(h_s)}; first {n} losses max rel "
            f"diff {rel:.2e}; resid/data scan {r_c:.3e} serial {r_s:.3e}")
        check(rel <= 1e-2, f"pol {pol}: scan and serial histories differ: rel {rel}")
        check(max(r_c, r_s) <= 2 * min(r_c, r_s), f"pol {pol}: resid/data {r_c} vs {r_s}")
    return {"launches": launches, "gain_launches": gain_launches, "prod_launches": prod_launches}


# ---------------------------------------------------------------------- #
# phase 9: the device mesh, in child processes
# ---------------------------------------------------------------------- #
def _world_child(target, rank, nprocs, backend, init_file, args, results):
    import torch
    import torch.distributed as dist

    try:
        if backend == "nccl":
            torch.cuda.set_device(rank)  # NCCL: one card per rank
        dist.init_process_group(backend, init_method=f"file://{init_file}", rank=rank,
                                world_size=nprocs)
        results.put((rank, "ok", target(rank, nprocs, *args)))
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_world(target, nprocs, backend, tmp, *args, timeout=WORLD_TIMEOUT_S):
    """``target(rank, nprocs, *args)`` in ``nprocs`` spawned processes joined
    by a ``backend`` process group (under NCCL, rank r on card r); their
    results in rank order. Past ``timeout``, or when a rank fails, every process still
    alive is killed and the phase fails."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    init_file = os.path.join(tmp, f"rdzv_{target.__name__}_{time.time_ns()}")
    procs = [ctx.Process(target=_world_child, args=(target, r, nprocs, backend, init_file,
                                                    args, results)) for r in range(nprocs)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    out = {}
    try:
        while len(out) < nprocs:
            remaining = deadline - time.monotonic()
            check(remaining > 0, f"{target.__name__}: world of {nprocs} still running after "
                  f"{timeout:.0f} s")
            try:
                rank, status, value = results.get(timeout=min(remaining, 5.0))
            except queue.Empty:
                dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                check(not dead, f"{target.__name__}: a rank exited with {dead}")
                continue
            check(status == "ok", f"{target.__name__} rank {rank} failed:\n{value}")
            out[rank] = value
    finally:
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10.0)
    return [out[r] for r in range(nprocs)]


def _slice_ratios(uvd, resid):
    rms = lambda x: float(np.sqrt(np.mean(np.abs(x) ** 2)))  # noqa: E731
    ratios = {}
    for pol in range(uvd.Npols):
        for t in np.unique(uvd.time_array):
            rows = np.isclose(uvd.time_array, t, rtol=0.0, atol=1e-7)
            good = ~uvd.flag_array[rows, 0, :, pol]
            ratios[(pol, float(t))] = (rms(resid.data_array[rows, 0, :, pol][good])
                                       / rms(uvd.data_array[rows, 0, :, pol][good]))
    return ratios


def _mesh_fit(rank, path, outdir, mesh_shape, fit_kw, **kw):
    """``read_calibrate_and_model_dpss`` on this rank, through a mesh (or,
    with ``mesh_shape=None``, unsharded), with ``fit_kw`` (the device, the
    step budget and, where given, the tol); what phase 9 reads of it. Counts
    each rank's file writes and its kernel launches."""
    import torch

    from calamity_tpu_torch import LAUNCHES
    from calamity_tpu_torch.calibration import read_calibrate_and_model_dpss
    from calamity_tpu_torch.io import CalData, VisData
    from calamity_tpu_torch.ops.fused import KERNEL_NAME
    from calamity_tpu_torch.ops.gains import KERNEL_NAME as GAIN_KERNEL
    from calamity_tpu_torch.ops.gains import PRODUCTS_KERNEL_NAME as PROD_KERNEL
    from calamity_tpu_torch.parallel.mesh import make_mesh

    writes = []
    real = {(cls, name): getattr(cls, name) for cls, name in
            ((VisData, "write_uvh5"), (CalData, "write_calfits"))}

    def counted(key):
        def write(obj, filename, *a, **k):
            writes.append(os.path.basename(filename))
            return real[key](obj, filename, *a, **k)
        return write

    for (cls, name) in real:
        setattr(cls, name, counted((cls, name)))
    outs = {}
    if outdir is not None:
        outs = {f"{k}_outfilename": os.path.join(outdir, f"{k}.{ext}")
                for k, ext in (("resid", "uvh5"), ("model", "uvh5"), ("gain", "calfits"))}
    timings = {}
    cuda = fit_kw["device"].startswith("cuda")
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    LAUNCHES.reset()
    t0 = time.time()
    try:
        model, resid, gains, info = read_calibrate_and_model_dpss(
            input_data_files=path, clobber=True, min_dly=MIN_DLY_NS, offset=MIN_DLY_NS,
            shared_basis=False, model_regularization="post_hoc", learning_rate=1e-2,
            time_parallel=True, mesh=False if mesh_shape is None else make_mesh(*mesh_shape),
            timings=timings, **dict(dict(tol=TOL), **fit_kw), **outs, **kw)
        if cuda:
            torch.cuda.synchronize()
    finally:
        for (cls, name), fn in real.items():
            setattr(cls, name, fn)
    wall = time.time() - t0
    launches = LAUNCHES.get(KERNEL_NAME)
    uvd = VisData.from_uvh5(path)
    return {"hist": {(p, t): h["loss"] for p, by_t in info.items() if isinstance(p, int)
                     for t, h in by_t.items()},
            "steps": {(p, t): h.get("phase_steps", [len(h["loss"])])
                      for p, by_t in info.items() if isinstance(p, int) for t, h in by_t.items()},
            "ratios": _slice_ratios(uvd, resid), "gains": gains.gain_array,
            "model": model.data_array, "data_rms": float(np.sqrt(np.mean(
                np.abs(uvd.data_array[~uvd.flag_array]) ** 2))),
            "timings": {k: v for k, v in timings.items()
                        if isinstance(v, (int, float, list))},
            "launches": launches, "gain_launches": LAUNCHES.get(GAIN_KERNEL),
            "prod_launches": LAUNCHES.get(PROD_KERNEL), "writes": writes,
            "wall": wall, "rank": rank,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9 if cuda else None}


def world_1x1(rank, nprocs, path, fit_kw):
    """(a): a world of 1 (NCCL on the card), mesh (1, 1)."""
    return _mesh_fit(rank, path, None, (1, 1), fit_kw)


def world_1x2(rank, nprocs, path, outdir, fit_kw):
    """(b): gloo, both ranks on the one card; first, gloo's all-reduce of a
    tensor on that device itself."""
    import torch
    import torch.distributed as dist

    x = torch.full((4,), float(rank + 1), device=fit_kw["device"])
    dist.all_reduce(x)
    check(torch.equal(x.cpu(), torch.full((4,), 3.0)), f"gloo all_reduce gave {x}")
    return _mesh_fit(rank, path, outdir, (1, 2), fit_kw)


def world_small(rank, nprocs, path, fit_kw):
    """(c), in one world: the time-parallel path on mesh (2, 1), the scan on
    (1, 2), then each rank one of them unsharded, both at once (rank 0 the
    time-parallel path, rank 1 the scan)."""
    scan = dict(init_guesses_from_previous_time_step=True)
    out = {"tp": _mesh_fit(rank, path, None, (2, 1), fit_kw),
           "scan": _mesh_fit(rank, path, None, (1, 2), fit_kw, **scan)}
    out["unsharded"] = _mesh_fit(rank, path, None, None, fit_kw, **(scan if rank else {}))
    return out


def compare_runs(tag, got, want, rel_limit=1e-2, steps_limit=0.1, exact=False):
    """A sharded run against an unsharded one (or phase 7): the first 200
    losses of every slice within ``rel_limit``, resid/data <= 1e-2 on every
    slice and within 2x, steps per slice within ``steps_limit``; with
    ``exact``, every loss history and step count equal to the bit."""
    worst_rel, worst_steps = 0.0, 0.0
    for key, h_want in want["hist"].items():
        h_got = np.asarray(got["hist"][key])
        h_want = np.asarray(h_want)
        if exact:
            check(list(got["steps"][key]) == list(want["steps"][key])
                  and np.array_equal(h_got, h_want),
                  f"{tag} {key}: steps {got['steps'][key]} against {want['steps'][key]}, "
                  "histories not equal to the bit")
        n = min(200, len(h_got), len(h_want))
        rel = float(np.max(np.abs(h_got[:n] - h_want[:n]) / np.abs(h_want[:n])))
        worst_rel = max(worst_rel, rel)
        s_got, s_want = sum(got["steps"][key]), sum(want["steps"][key])
        worst_steps = max(worst_steps, abs(s_got - s_want) / s_want)
        check(rel <= rel_limit, f"{tag} {key}: first {n} losses rel {rel}")
    for key, r_want in want["ratios"].items():
        r_got = got["ratios"][key]
        check(r_got <= 1e-2, f"{tag} {key}: resid/data {r_got}")
        check(max(r_got, r_want) <= 2 * min(r_got, r_want), f"{tag} {key}: resid/data "
              f"{r_got} against {r_want}")
    check(worst_steps <= steps_limit, f"{tag}: steps differ by {worst_steps:.1%}")
    return worst_rel, worst_steps


def phase_mesh(tmp, repo, tp, fit_kw=None, nfreqs=MESH_NFREQS):
    """Phase 9 (see the module docstring); ``fit_kw``: the device and the
    step budget of every fit (default the card, phase 7's budget)."""
    fit_kw = dict(device="cuda:0", maxsteps=MAXSTEPS) if fit_kw is None else fit_kw
    cuda = fit_kw["device"].startswith("cuda")
    from calamity_tpu_torch.calibration import POLL_EVERY
    from calamity_tpu_torch.ops.fused import KERNEL_NAME
    from calamity_tpu_torch.ops.gains import KERNEL_NAME as GAIN_KERNEL
    from calamity_tpu_torch.ops.gains import PRODUCTS_KERNEL_NAME as PROD_KERNEL

    log("== phase 9: the ('data', 'bl') device mesh, in child processes "
        f"(each world limited to {WORLD_TIMEOUT_S:.0f} s)")
    card = nvidia_smi_line()
    phase7 = {"hist": {(p, t): h["loss"] for p, by_t in tp["info"].items() if isinstance(p, int)
                       for t, h in by_t.items()},
              "steps": {(p, t): h["phase_steps"] for p, by_t in tp["info"].items()
                        if isinstance(p, int) for t, h in by_t.items()}}
    phase7["ratios"] = tp["ratios"]
    out = {}

    # (a) a world of 1 over NCCL
    t0 = time.time()
    (a,) = run_world(world_1x1, 1, "nccl" if cuda else "gloo", tmp, tp["path"], fit_kw)
    # every sum of the step is taken in a fixed order (no atomics in either
    # kernel), and with no peer the mesh runs phase 7's arithmetic
    rel, dsteps = compare_runs("(a)", a, phase7, exact=True)
    recorded, warmups = sum(a["timings"]["phase_steps"]), len(a["timings"]["phase_steps"])
    # one launch per step (the polls may run up to POLL_EVERY - 1 steps past
    # the last freeze, which are undone); none where there is no card
    for name, n in ((KERNEL_NAME, a["launches"]), (GAIN_KERNEL, a["gain_launches"]),
                    (PROD_KERNEL, a["prod_launches"])):
        check(not cuda or recorded + warmups <= n <= recorded + warmups * POLL_EVERY,
              f"(a) {n} {name} launches for {recorded} recorded + {warmups} warm-up steps")
    log(f"  (a) NCCL world of 1, mesh (1, 1), against phase 7: steps per slice "
        f"{list(a['steps'].values())}, equal to phase 7's, loss histories equal to the bit; "
        f"{KERNEL_NAME} launches {a['launches']}, {GAIN_KERNEL} {a['gain_launches']}, "
        f"{PROD_KERNEL} {a['prod_launches']}, for {recorded} "
        f"recorded batch steps + {warmups} warm-up; {time.time() - t0:.1f} s with start-up")
    out["a"] = a

    # (b) a world of 2 over gloo, both ranks on the card, on the smaller
    # file of (c) (phase 7's file took 100 s of the time limit); compared
    # with (c)'s unsharded time-parallel run of it below
    small = os.path.join(tmp, "mesh_small.uvh5")
    make_corrupted_file(small, MESH_NTIMES, MESH_NPOLS, nfreqs=nfreqs)
    small_kw = dict(fit_kw, tol=MESH_TOL)
    t0 = time.time()
    outdir = os.path.join(tmp, "mesh_1x2")
    os.makedirs(outdir)
    b = run_world(world_1x2, 2, "gloo", tmp, small, outdir, small_kw)
    wall = time.time() - t0
    for other in b[1:]:
        check(np.array_equal(other["gains"], b[0]["gains"]), "(b) ranks returned other gains")
        check(other["hist"] == b[0]["hist"], "(b) ranks returned other histories")
    check(not cuda or all(min(r["launches"], r["gain_launches"], r["prod_launches"]) > 0
                          for r in b),
          f"(b) launches {[(r['launches'], r['gain_launches'], r['prod_launches']) for r in b]}")
    files = sorted(os.listdir(outdir))
    check(b[0]["writes"] == ["resid.uvh5", "gain.calfits", "model.uvh5"] and not b[1]["writes"]
          and files == ["gain.calfits", "model.uvh5", "resid.uvh5"],
          f"(b) writes rank 0 {b[0]['writes']}, rank 1 {b[1]['writes']}, files {files}")
    for r in b:
        tm = r["timings"]
        steps, secs = tm["phase_steps"], tm["phase_seconds"]
        log(f"  (b) rank {r['rank']}: ms per batch step (bf16, f32) "
            f"{', '.join(f'{1e3 * s / max(n, 1):.3f}' for s, n in zip(secs, steps))} over "
            f"{steps} steps; descent_s {tm['descent_s']:.2f}; collectives "
            f"{tm['collective_s']:.2f} s in {tm['collective_calls']} calls "
            f"({1e3 * tm['collective_s'] / max(sum(steps), 1):.3f} ms per recorded step); "
            f"peak device memory {r['peak_gb']} GB; {KERNEL_NAME} launches "
            f"{r['launches']}, {GAIN_KERNEL} {r['gain_launches']}, {PROD_KERNEL} "
            f"{r['prod_launches']}; writes {r['writes']}; {card}")
    out["b"] = b

    # (c) mesh (2, 1) and the scan on (1, 2), on the smaller file, in one world
    t0 = time.time()
    res = run_world(world_small, 2, "gloo", tmp, small, small_kw)
    for tag, key, alone in (("(c) time-parallel, mesh (2, 1)", "tp", 0),
                            ("(c) scan, mesh (1, 2)", "scan", 1)):
        got, want = res[0][key], res[alone]["unsharded"]
        rel, dsteps = compare_runs(tag, got, want)
        dmodel = float(np.max(np.abs(got["model"] - want["model"]))) / want["data_rms"]
        check(dmodel <= 1e-2, f"{tag}: model differs by {dmodel} of the data rms")
        check(not cuda or min(res[1][key][k] for k in ("launches", "gain_launches",
                                                         "prod_launches")) > 0,
              f"{tag}: rank 1 launched no kernel")
        log(f"  {tag}: {nfreqs} channels x {MESH_NTIMES} times x {MESH_NPOLS} pol, tol "
            f"{MESH_TOL:g}; steps "
            f"per slice sharded {list(got['steps'].values())}, unsharded "
            f"{list(want['steps'].values())} (within {dsteps:.2%}); first 200 losses max rel "
            f"{rel:.2e}; max |model difference| {dmodel:.2e} of the data rms; launches rank 0 "
            f"{got['launches']}, rank 1 {res[1][key]['launches']}")
    log(f"  (c) both in one world of 2: {time.time() - t0:.1f} s with start-up")
    out["c"] = res
    rel, dsteps = compare_runs("(b)", b[0], res[0]["unsharded"])
    log(f"  (b) gloo world of 2, mesh (1, 2), {nfreqs} channels x {MESH_NTIMES} times x "
        f"{MESH_NPOLS} pol, tol {MESH_TOL:g}: first 200 losses max rel {rel:.2e} against (c)'s "
        f"unsharded run, steps within {dsteps:.2%}; resid/data per slice "
        f"{', '.join(f'{x:.3e}' for x in b[0]['ratios'].values())}; rank 0 alone wrote "
        f"{files}; {wall:.1f} s with start-up")

    # (d) the supervisor
    from calamity_tpu_torch import supervisor

    t0 = time.time()
    check(supervisor.probe_device(timeout_s=120.0) == cuda, "(d) the CUDA probe's answer")
    probe_s = time.time() - t0
    golomb = os.path.join(tmp, "golomb.uvh5")
    argv = [sys.executable, os.path.join(repo, "scripts", "calibrate_and_model_dpss_torch.py"),
            "--input_data_files", golomb, "--resid_outfilename",
            os.path.join(tmp, "sup_resid.uvh5"), "--min_dly", str(MIN_DLY_NS), "--offset",
            str(MIN_DLY_NS), "--maxsteps", "500", "--tol", "1e-10", "--device",
            fit_kw["device"], "--clobber"]
    t0 = time.time()
    saved = os.environ.get("PYTHONPATH")
    # the child imports the port from this checkout
    os.environ["PYTHONPATH"] = os.pathsep.join(x for x in (repo, saved) if x)
    try:
        code = supervisor.run_supervised(argv, max_restarts=0, hang_timeout_s=240.0,
                                         echo=lambda *_: None)
    finally:
        if saved is None:
            del os.environ["PYTHONPATH"]
        else:
            os.environ["PYTHONPATH"] = saved
    check(code == 0 and os.path.exists(os.path.join(tmp, "sup_resid.uvh5")),
          f"(d) the supervised CLI run exited {code}")
    log(f"  (d) supervisor: probe_device() True in {probe_s:.1f} s; supervised CLI run on the "
        f"Golomb file exited 0 in {time.time() - t0:.1f} s")

    # (e) the mixed driver's eigh on the card
    out["e"] = mixed_eigh_on_card(tmp, fit_kw["device"])
    return out


def mixed_eigh_on_card(tmp, device):
    """(e): ``calibrate_and_model_mixed`` with the covariance eigh on the
    card against the host numpy eigh: as many eigenvectors in every
    multi-baseline group, and the same subspace as far as the covariance
    can tell, ||(P_card - P_host) C|| <= 1e-8 ||C||, and plain,
    max |P_card - P_host| <= 1e-6: eigenvectors near the cutoff are defined
    only to eps / (their relative eigenvalue gap), ~1e-7."""
    from calamity_tpu_torch import cal_utils, models, simulate
    from calamity_tpu_torch.calibration import calibrate_and_model_mixed
    from calamity_tpu_torch.models.simple_cov import simple_cov_matrix

    uvd = simulate.make_golomb_array(nants=6, nfreqs=200, seed=0)
    project_onto_dpss(uvd, models.yield_pbl_dpss_model_comps(uvd, offset=MIN_DLY_NS,
                                                             min_dly=MIN_DLY_NS))
    gains = cal_utils.blank_uvcal_from_uvdata(uvd)
    kw = dict(uvdata=uvd, gains=gains, min_dly=0.0, offset=0.0, ant_dly=2.0 / 3.0,
              red_tol_freq=0.5, freeze_model=True, maxsteps=20, tol=1e-10,
              grp_size_threshold=1, model_regularization="post_hoc", shared_basis=False,
              device=device)
    dicts, secs = {}, {}
    for on_card in (False, True):
        path = os.path.join(tmp, f"mixed_comps_{on_card}.npy")
        t0 = time.time()
        calibrate_and_model_mixed(use_tensorflow_to_derive_modeling_comps=on_card,
                                  save_dict_to=path, **kw)
        secs[on_card] = time.time() - t0
        dicts[on_card] = np.load(path, allow_pickle=True).item()
    check(list(dicts[True]) == list(dicts[False]), "(e) the component groups differ")
    grps, blvecs, _, _ = models.get_uv_overlapping_grps_conjugated(uvd, red_tol_freq=0.5)
    freqs = np.asarray(uvd.freq_array[0])
    worst_w = worst_p = 0.0
    ncov = 0
    for grp, vecs in zip(grps, blvecs):
        if len(grp) <= 1:
            continue
        key = tuple(tuple(rg) for rg in grp)
        host, card = dicts[False][key], dicts[True][key]
        check(host.shape == card.shape, f"(e) group {key}: {card.shape} against {host.shape}")
        cmat = simple_cov_matrix(np.atleast_2d(np.asarray(vecs)), freqs, ant_dly=2.0 / 3.0)
        dproj = card @ card.T - host @ host.T
        worst_w = max(worst_w, np.linalg.norm(dproj @ cmat, 2) / np.linalg.norm(cmat, 2))
        worst_p = max(worst_p, float(np.max(np.abs(dproj))))
        ncov += 1
    check(ncov > 0, "(e) no multi-baseline covariance group")
    check(worst_w <= 1e-8, f"(e) ||(P_card - P_host) C|| / ||C|| = {worst_w}")
    check(worst_p <= 1e-6, f"(e) max |P_card - P_host| = {worst_p}")
    log(f"  (e) mixed driver, covariance eigh on the card: {ncov} multi-baseline groups, as many "
        f"eigenvectors as the host eigh in each; ||(P_card - P_host) C|| / ||C|| at most "
        f"{worst_w:.2e} (limit 1e-8), max |P_card - P_host| {worst_p:.2e} (limit 1e-6); driver seconds "
        f"host {secs[False]:.1f}, card {secs[True]:.1f}")
    return {"groups": ncov, "weighted": worst_w, "projector": worst_p}


# ---------------------------------------------------------------------- #
# phase 10: the HERA core's default shared-basis packing
# ---------------------------------------------------------------------- #
HERA_CUT = dict(nside=7, nfreqs=256)  # the cut-width cross-check against the dense packing
# its step budget: tol 0 and no patience, so both packings take these steps
# in each phase of the mixed schedule (with the tol stop they stopped 5.7%
# apart: the step where |delta loss| first falls below tol moves with the
# packings' float32 summation order)
HERA_CUT_STEPS = 600


def _layout_line(c):
    return (f"{c['kind']} U={c['U']} gmax={c['gmax']} B={c['B']} F={c['F']} V={c['V']} "
            f"({c['groups']} groups)")


def _core_resid_ratio(corrupted, resid):
    good = ~corrupted.flag_array
    rms = lambda x: float(np.sqrt(np.mean(np.abs(x) ** 2)))  # noqa: E731
    return rms(resid.data_array[good]) / rms(corrupted.data_array[good])


def hera_idle_share(corrupted, comps, regularization=None):
    """The serial step of the HERA core's packing, replayed from its CUDA
    graph as the descent runs it, under ``torch.profiler``, for both phases
    of the mixed schedule (``scripts/profile_step_torch.py``;
    ``regularization="sum"``: the "sum" prior's step)."""
    import torch

    import profile_step_torch as prof
    from calamity_tpu_torch import cal_utils
    from calamity_tpu_torch.solver import fit as fitmod
    from calamity_tpu_torch.solver.tensorize import FitSpec

    gains = cal_utils.blank_uvcal_from_uvdata(corrupted)
    spec = FitSpec(corrupted, comps, {int(a): i for i, a in enumerate(gains.ant_array)},
                   device="cuda", nvec_bucketing=True, shared_basis=True)
    chunks = spec.device_chunks()
    out = {}
    for name, chs in (("bf16", fitmod.convert_chunks_dtype(chunks, torch.bfloat16)),
                      ("f32", chunks)):
        step, per_call, d = prof.serial_stepper(chs, spec, corrupted, gains, regularization)
        out[name] = prof.profile(step, per_call)
        d.close()
        r = out[name]
        log(f"  {name} step (replayed) under the profiler: device {r['device_ms']:.3f} ms in "
            f"{r['kernels']:.0f} kernels; host clock {r['plain_ms']:.3f} ms/step without the "
            f"profiler, {r['event_ms']:.3f} between CUDA events; idle share "
            f"{r['idle_share']:.3f}; per step {prof.kernels_line(r)}; "
            "costliest: "
            + "; ".join(f"{ms:.4f} ms x{n:.0f} {key[:48]}" for ms, n, key in r["top"][:4]))
    return out


def phase_hera_core():
    """Phase 10: ``scripts/hera_core_demo_torch.py``'s configuration at full
    width (361 antennas, 4388 baselines, 1536 channels) with the default
    shared-basis packing, on the card: chunk layouts, steps and ms/step per
    precision phase, launches of the three kernels, peak memory, the idle share,
    resid/data <= 1e-2. Then at cut width, with the default packing and
    with ``shared_basis=False``, on one step budget (``HERA_CUT_STEPS``):
    first 200 losses within rel 1e-4 (the two packings sum float32 in
    another order), resid/data within 2x."""
    import torch

    import hera_core_demo_torch as demo
    from calamity_tpu_torch import LAUNCHES
    from calamity_tpu_torch.ops.fused import KERNEL_NAME
    from calamity_tpu_torch.ops.gains import KERNEL_NAME as GAIN_KERNEL
    from calamity_tpu_torch.ops.gains import PRODUCTS_KERNEL_NAME as PROD_KERNEL
    from calamity_tpu_torch.ops.shared import KERNEL_NAME as SHARED_KERNEL

    log("== phase 10: the HERA core (scripts/hera_core_demo_torch.py) with the default "
        "shared-basis packing")
    corrupted, comps, facts = hera_core_build()
    log(f"  {facts['nants']} antennas, {facts['nbls']} baselines <= 45 m, {facts['nuniq']} unique "
        f"spacings, {corrupted.Nfreqs} channels; host seconds: simulate "
        f"{facts['simulate_s']:.2f}, basis {facts['basis_s']:.2f}, project "
        f"{facts['project_s']:.2f}")
    check((facts["nants"], facts["nbls"], facts["nuniq"]) == (361, 4388, 14),
          f"HERA core: {facts}")
    layouts = demo.chunk_layouts(corrupted, comps)
    for c in layouts:
        log(f"  chunk: {_layout_line(c)}")
    nshared = sum(c["kind"] != "dense" for c in layouts)
    check(nshared > 0, "the default packing packed no shared chunk")
    timings = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.reset()
    t0 = time.time()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        model, resid, gains, info = demo.fit(corrupted, comps, device="cuda", timings=timings)
    torch.cuda.synchronize()
    wall = time.time() - t0
    kernel_names = (KERNEL_NAME, GAIN_KERNEL, PROD_KERNEL, SHARED_KERNEL, *ADAMAX_KERNELS)
    launches = {name: LAUNCHES.get(name) for name in kernel_names}
    shared_instances = instance_launches(SHARED_KERNEL)
    fallbacks = [str(w.message) for w in caught if "plain torch loss" in str(w.message)]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    h = info[0][0]
    steps = h["phase_steps"]
    rates = [1e3 * s / max(n, 1) for s, n in zip(h["phase_seconds"], steps)]
    ratio = _core_resid_ratio(corrupted, resid)
    log(f"  phase steps (bf16, f32) {steps}, ms/step {', '.join(f'{r:.3f}' for r in rates)} (host "
        f"clock, captures and polls included); loss {h['loss'][0]:.6e} -> {h['loss'][-1]:.6e}")
    log("  host seconds: " + ", ".join(f"{k} {v:.2f}" for k, v in sorted(timings.items()))
        + f"; calibrate_and_model_dpss in all {wall:.1f}")
    log("  launches: " + ", ".join(f"{k} {v}" for k, v in launches.items())
        + f" for {len(h['loss'])} recorded steps ({nshared} shared chunks); peak device memory "
        f"{peak_gb:.3f} GB; resid rms / data rms {ratio:.4e} (limit 1e-2); {nvidia_smi_line()}")
    check(ratio <= 1e-2, f"HERA core resid/data {ratio}")
    check(np.isfinite(gains.gain_array).all(), "HERA core: non-finite gains")
    check(min(launches[k] for k in (GAIN_KERNEL, PROD_KERNEL, *ADAMAX_KERNELS))
          >= len(h["loss"]), f"{launches} launches for {len(h['loss'])} steps")
    check(launches[SHARED_KERNEL] >= nshared * len(h["loss"]),
          f"{launches[SHARED_KERNEL]} {SHARED_KERNEL} launches for {nshared} shared chunks and "
          f"{len(h['loss'])} steps")
    check(not fallbacks, f"HERA core: chunks named as fallbacks: {fallbacks}")
    idle = hera_idle_share(corrupted, comps)
    del model, resid, gains, corrupted, comps
    torch.cuda.empty_cache()

    # cut width: the default packing twice (equal to the bit) and the dense
    # one, on the card: the shared-basis kernel against the fused kernel
    small, small_comps, sfacts = demo.build(**HERA_CUT)
    runs = {}
    for key, shared in (("shared", True), ("again", True), ("dense", False)):
        t0 = time.time()
        LAUNCHES.reset()
        _, r, _, inf = demo.fit(small, small_comps, device="cuda", shared_basis=shared,
                                maxsteps=HERA_CUT_STEPS, tol=0.0, patience=0)
        torch.cuda.synchronize()
        runs[key] = (np.asarray(inf[0][0]["loss"]), _core_resid_ratio(small, r),
                     inf[0][0]["phase_steps"], time.time() - t0,
                     [_layout_line(c) for c in demo.chunk_layouts(small, small_comps, shared)],
                     {name: LAUNCHES.get(name) for name in (KERNEL_NAME, SHARED_KERNEL)})
    (h_s, r_s, st_s, t_s, lay_s, n_s), (h_d, r_d, st_d, t_d, lay_d, n_d) = (runs["shared"],
                                                                            runs["dense"])
    h_again = runs["again"][0]
    n = min(200, len(h_s), len(h_d))
    rel200 = float(np.max(np.abs(h_s[:n] - h_d[:n]) / np.abs(h_d[:n])))
    n_all = min(len(h_s), len(h_d))
    rel_all = float(np.max(np.abs(h_s[:n_all] - h_d[:n_all]) / np.abs(h_d[:n_all])))
    log(f"  cut width ({sfacts['nants']} antennas, {sfacts['nbls']} baselines, "
        f"{HERA_CUT['nfreqs']} channels; tol 0, {HERA_CUT_STEPS} steps a phase): shared packing "
        f"{lay_s}, steps {st_s}, resid/data {r_s:.3e}, {t_s:.1f} s, launches {n_s}; fitted "
        f"again: histories equal to the bit {bool(np.array_equal(h_s, h_again))}; dense packing "
        f"{lay_d}, steps {st_d}, resid/data {r_d:.3e}, {t_d:.1f} s, launches {n_d}; first {n} "
        f"losses max rel {rel200:.2e} (limit 1e-4), all {n_all} max rel {rel_all:.2e}")
    check(st_s == st_d == [HERA_CUT_STEPS] * 2, f"cut width: steps {st_s} and {st_d}")
    check(np.array_equal(h_s, h_again), "cut width: the shared packing's two fits differ")
    check(n_s[SHARED_KERNEL] > 0 and n_d[KERNEL_NAME] > 0 and n_d[SHARED_KERNEL] == 0,
          f"cut width: launches shared {n_s}, dense {n_d}")
    check(rel200 <= 1e-4, f"cut width: shared and dense histories differ: rel {rel200}")
    check(max(r_s, r_d) <= 2 * min(r_s, r_d), f"cut width: resid/data {r_s} against {r_d}")
    return {"launches": launches, "instances": shared_instances, "steps": steps,
            "ms_per_step": rates, "peak_gb": peak_gb,
            "resid_ratio": ratio, "idle": {k: v["idle_share"] for k, v in idle.items()},
            "profile": {k: {"device_ms": v["device_ms"], "kernels": v["kernels"],
                            "plain_ms": v["plain_ms"], "named": v["named"]}
                        for k, v in idle.items()},
            "layouts": layouts}


# ---------------------------------------------------------------------- #
# phase 11: the default "sum" prior at full width
# ---------------------------------------------------------------------- #
SUM_LOOP_STEPS = 50  # phase 11 (b): recorded batched steps, card against a CPU copy
# phase 11 (a)'s step budget a phase of the mixed schedule, for the
# script's time limit: unbudgeted, the fit takes [2836, 424] steps
# (PERF.md section 5)
HERA_SUM_MAXSTEPS = 500


class PlainTerms:
    """Counts, while it is entered, the calls of the plain torch terms a
    "sum" fit falls back to for a chunk no kernel takes, serial or batched:
    ``ops.loss._sum_terms``."""

    def __enter__(self):
        from calamity_tpu_torch.ops import loss

        self.calls = 0
        self._saved = [(loss, "_sum_terms", loss._sum_terms)]
        for mod, name, fn in self._saved:
            setattr(mod, name, self._counted(fn))
        return self

    def _counted(self, fn):
        def counted(*args, **kw):
            self.calls += 1
            return fn(*args, **kw)

        return counted

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)


def instance_launches(name):
    """Launches of each instance of a chunk-loss kernel since the counters
    were last reset, by instance name."""
    from calamity_tpu_torch import LAUNCHES
    from calamity_tpu_torch.ops.fused import MODE_NAMES

    return {m: LAUNCHES.get(f"{name}:{m}") for m in MODE_NAMES if LAUNCHES.get(f"{name}:{m}")}


def phase_sum_hera():
    """Phase 11 (a): the HERA core at full width (361 antennas, 4388
    baselines, 1536 channels, the default shared-basis packing) through
    ``calibrate_and_model_dpss`` with the entry point's default "sum"
    prior, fitted twice on a step budget (:data:`HERA_SUM_MAXSTEPS`):
    steps, ms/step, launches of each kernel and instance a step (every
    shared chunk's "sum" forward and backward instances each step, no
    chunk on the plain terms, none named as a fallback), resid/data <=
    1e-2, the two fits equal to the bit, and the step's device time and
    idle share under the profiler."""
    import torch

    import hera_core_demo_torch as demo
    from calamity_tpu_torch import LAUNCHES
    from calamity_tpu_torch.ops.fused import KERNEL_NAME
    from calamity_tpu_torch.ops.gains import KERNEL_NAME as GAIN_KERNEL
    from calamity_tpu_torch.ops.gains import PRODUCTS_KERNEL_NAME as PROD_KERNEL
    from calamity_tpu_torch.ops.shared import KERNEL_NAME as SHARED_KERNEL

    log('== phase 11 (a): the HERA core with the defaults\' "sum" prior, fitted twice, '
        f"{HERA_SUM_MAXSTEPS} steps a phase at most")
    corrupted, comps, _ = hera_core_build()
    nshared = sum(c["kind"] != "dense" for c in demo.chunk_layouts(corrupted, comps))
    runs = []
    for _ in range(2):
        timings = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        LAUNCHES.reset()
        t0 = time.time()
        with PlainTerms() as plain, warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            _, resid, gains, info = demo.fit(corrupted, comps, device="cuda", timings=timings,
                                             maxsteps=HERA_SUM_MAXSTEPS,
                                             model_regularization="sum")
            torch.cuda.synchronize()
        h = info[0][0]
        runs.append({
            "wall": time.time() - t0, "hist": np.asarray(h["loss"]), "steps": h["phase_steps"],
            "ms_per_step": [1e3 * s / max(n, 1) for s, n in zip(h["phase_seconds"],
                                                               h["phase_steps"])],
            "launches": {k: LAUNCHES.get(k) for k in (KERNEL_NAME, SHARED_KERNEL, GAIN_KERNEL,
                                                      PROD_KERNEL)},
            "instances": instance_launches(SHARED_KERNEL), "plain_calls": plain.calls,
            "fallbacks": [str(w.message) for w in caught if "plain torch loss" in str(w.message)],
            "ratio": _core_resid_ratio(corrupted, resid), "timings": timings,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "finite": bool(np.isfinite(gains.gain_array).all())})
    first, again = runs
    recorded = len(first["hist"])
    per_step = {k: v / recorded for k, v in first["instances"].items()}
    log(f"  phase steps (bf16, f32) {first['steps']}, ms/step "
        f"{', '.join(f'{r:.3f}' for r in first['ms_per_step'])} (host clock, captures and "
        f"polls included); loss {first['hist'][0]:.6e} -> {first['hist'][-1]:.6e}; fit_s "
        f"{first['timings'].get('fit_s', float('nan')):.2f}, calibrate_and_model_dpss in all "
        f"{first['wall']:.1f} s; peak device memory {first['peak_gb']:.3f} GB")
    log(f"  launches {first['launches']} for {recorded} recorded steps and {nshared} shared "
        f"chunks; {SHARED_KERNEL} by instance {first['instances']} ("
        + ", ".join(f"{k} {v / nshared:.3f} a chunk and step" for k, v in per_step.items())
        + f"); plain-term calls {first['plain_calls']}; resid rms / data rms "
        f"{first['ratio']:.4e} (limit 1e-2); {nvidia_smi_line()}")
    log(f"  fitted again: steps {again['steps']}, histories equal to the bit "
        f"{bool(np.array_equal(first['hist'], again['hist']))}, resid/data {again['ratio']:.4e}")
    for r in runs:
        check(r["plain_calls"] == 0, f"a B=1 chunk took the plain terms {r['plain_calls']} times")
        check(not r["fallbacks"], f"chunks named as fallbacks: {r['fallbacks']}")
        check(r["finite"], "HERA core sum fit: non-finite gains")
        check(r["ratio"] <= 1e-2, f"HERA core sum fit: resid/data {r['ratio']}")
        check(r["launches"][KERNEL_NAME] == 0, f"dense launches in the HERA core: {r['launches']}")
        for inst in ("sum_fwd", "sum_all"):
            check(r["instances"].get(inst, 0) >= nshared * len(r["hist"]),
                  f"{r['instances']} for {nshared} shared chunks and {len(r['hist'])} steps")
        check(min(r["launches"][GAIN_KERNEL], r["launches"][PROD_KERNEL]) >= len(r["hist"]),
              f"gain kernels {r['launches']} for {len(r['hist'])} steps")
    check(first["steps"] == again["steps"] and np.array_equal(first["hist"], again["hist"]),
          "the HERA core's two sum fits differ")
    idle = hera_idle_share(corrupted, comps, regularization="sum")
    return {"steps": first["steps"], "ms_per_step": first["ms_per_step"],
            "launches": first["launches"], "instances": first["instances"],
            "per_step": per_step, "resid_ratio": first["ratio"], "peak_gb": first["peak_gb"],
            "idle": {k: v["idle_share"] for k, v in idle.items()},
            "profile": {k: {"device_ms": v["device_ms"], "kernels": v["kernels"],
                            "plain_ms": v["plain_ms"], "named": v["named"]}
                        for k, v in idle.items()}}


def batched_sum_in_loop(tp):
    """Phase 7's file packed as the time-parallel driver packs it (8
    slices, float32 comps), :data:`SUM_LOOP_STEPS` recorded batched "sum"
    steps on the card (the fused kernel's "sum" instances at N = 8) and,
    with a CPU copy of the first slice (the kernels' plain versions; every
    slice of the batched descent is its own descent, so one slice takes
    the steps it takes among eight, and the CPU's steps at N = 8 would
    take two minutes), its history within rel 1e-4."""
    import profile_step_torch as prof
    from calamity_tpu_torch import cal_utils
    from calamity_tpu_torch.calibration import POLL_EVERY
    from calamity_tpu_torch.parallel import batched
    from calamity_tpu_torch.solver import fit as fitmod
    from calamity_tpu_torch.solver.tensorize import FitSpec

    uvd = tp["uvd"]
    gains = cal_utils.blank_uvcal_from_uvdata(uvd)
    spec = FitSpec(uvd, tp["comps"], {int(a): i for i, a in enumerate(gains.ant_array)},
                   device="cuda", shared_basis=False)
    chunks = spec.device_chunks()
    packed = prof.batched_problem(spec, uvd, gains)
    cfg = fitmod.FitConfig(tol=0.0, maxsteps=SUM_LOOP_STEPS, regularization="sum",
                           opt_kwargs=(("learning_rate", 1e-2),))
    nbatch = packed[3].shape[0]
    firsts = [0]
    hists = {}
    for where, rows in (("cuda", slice(None)), ("cpu", firsts)):
        def on(x):
            return [on(y) for y in x] if isinstance(x, (list, tuple)) else x[rows].to(where)

        dr, di, w, g_r, g_i, fr, fi = (on(x) for x in packed)
        chs = [tuple(x.to(where) for x in c) for c in chunks]
        priors = prof.sum_priors(dr, di, w, dims=(1, 2, 3))
        opt, one_step = batched._batched_step_fn(cfg, chs, dr, di, w, fr, fi, *priors)
        params = fitmod.init_params(cfg, g_r, g_i, fr, fi)
        carry = batched._fresh_carry(cfg, g_r.shape[0], np.float32, g_r.device, None)
        t0 = time.time()
        out = batched._batched_segment(cfg, one_step, params, opt.init(params), carry, 0,
                                       SUM_LOOP_STEPS, poll_every=POLL_EVERY)
        hists[where] = out[3]
        log(f"  {SUM_LOOP_STEPS} batched sum steps of {g_r.shape[0]} slices on {where}: "
            f"{time.time() - t0:.1f} s")
    h_gpu, h_cpu = hists["cuda"][:, firsts], hists["cpu"]
    check(hists["cuda"].shape == (SUM_LOOP_STEPS, nbatch) and h_cpu.shape == h_gpu.shape,
          f"histories {hists['cuda'].shape} {h_cpu.shape}")
    rel = float(np.max(np.abs(h_gpu - h_cpu) / np.abs(h_cpu)))
    log(f"  history of slice {firsts[0]}, card (N = {nbatch}) against CPU: max rel {rel:.3e} "
        "(limit 1e-4)")
    check(rel <= 1e-4, f"batched sum histories disagree: rel {rel}")
    return rel


def phase_sum_time_parallel(tmp, tp):
    """Phase 11 (b): phase 7's file (8 slices) through
    ``read_calibrate_and_model_dpss`` with ``time_parallel=True,
    shared_basis=False`` and the default "sum" prior: every step through
    the fused kernel's one-pass "sum" instance at N = 8 and one combine
    (one read of comps a chunk and step), no chunk on the plain terms,
    resid/data <= 1e-2 on every slice; ms a batch step and peak memory;
    then :func:`batched_sum_in_loop`."""
    import torch

    from calamity_tpu_torch import LAUNCHES
    from calamity_tpu_torch.calibration import read_calibrate_and_model_dpss
    from calamity_tpu_torch.ops.fused import COMBINE_NAME, KERNEL_NAME
    from calamity_tpu_torch.ops.gains import KERNEL_NAME as GAIN_KERNEL
    from calamity_tpu_torch.ops.gains import PRODUCTS_KERNEL_NAME as PROD_KERNEL

    log('== phase 11 (b): phase 7\'s file, time-parallel, dense chunks, the defaults\' "sum" '
        "prior")
    uvd = tp["uvd"]
    timings = {}
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.reset()
    t0 = time.time()
    with PlainTerms() as plain, warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        _, resid, gains, info = read_calibrate_and_model_dpss(
            input_data_files=tp["path"], resid_outfilename=os.path.join(tmp, "sum_resid.uvh5"),
            clobber=True, min_dly=MIN_DLY_NS, offset=MIN_DLY_NS, time_parallel=True,
            shared_basis=False, fg_model_comps_dict=tp["comps"], learning_rate=1e-2,
            maxsteps=MAXSTEPS, tol=TOL, device="cuda", timings=timings)
        torch.cuda.synchronize()
    wall = time.time() - t0
    instances = instance_launches(KERNEL_NAME)
    launches = {k: LAUNCHES.get(k) for k in (KERNEL_NAME, COMBINE_NAME, GAIN_KERNEL, PROD_KERNEL)}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steps, seconds = timings["phase_steps"], timings["phase_seconds"]
    recorded = sum(steps) + len(steps)  # recorded and warm-up batch steps
    one_pass = instances.get("sum_fwd_all", 0) + instances.get("sum_fwd_dp", 0)
    # launches that read comps for the "sum" terms, a batch step (the parent's two)
    reads = (one_pass + instances.get("sum_fwd", 0)) / recorded
    rms = lambda x: float(np.sqrt(np.mean(np.abs(x) ** 2)))  # noqa: E731
    ratios = []
    for pol in range(uvd.Npols):
        for t in np.unique(uvd.time_array):
            rows = np.isclose(uvd.time_array, t, rtol=0.0, atol=1e-7)
            good = ~uvd.flag_array[rows, 0, :, pol]
            ratios.append(rms(resid.data_array[rows, 0, :, pol][good])
                          / rms(uvd.data_array[rows, 0, :, pol][good]))
    fallbacks = [str(w.message) for w in caught if "plain torch loss" in str(w.message)]
    log(f"  batch steps (bf16, f32) {steps}, ms/step "
        f"{', '.join(f'{1e3 * s / max(n, 1):.3f}' for s, n in zip(seconds, steps))} (host clock, "
        f"8 slices a step); read_calibrate_and_model_dpss in all {wall:.1f} s (basis given); "
        f"peak device memory {peak_gb:.3f} GB; {KERNEL_NAME} by instance {instances} and "
        f"{launches[COMBINE_NAME]} {COMBINE_NAME} launches for {recorded} batch steps ({reads:.4f} "
        f"comps-reading \"sum\" launches a step); plain-term calls {plain.calls}; resid/data per "
        f"slice {', '.join(f'{r:.3e}' for r in ratios)} (limit 1e-2); {nvidia_smi_line()}")
    check(plain.calls == 0, f"a B=1 chunk took the plain terms {plain.calls} times")
    check(not fallbacks, f"chunks named as fallbacks: {fallbacks}")
    check(np.isfinite(gains.gain_array).all(), "non-finite gains")
    check(len(ratios) == TP_NTIMES * TP_NPOLS and max(ratios) <= 1e-2, f"resid/data {ratios}")
    check(instances.get("sum_fwd_all", 0) >= recorded, f"{instances} for {recorded} batch steps")
    check(launches[COMBINE_NAME] == one_pass,
          f"{launches[COMBINE_NAME]} combines for {one_pass} one-pass launches")
    # one read of comps a step; the "sum" forward alone runs only where no
    # gradient is wanted (a few evaluations outside the descent)
    check(reads < 1.1, f"{reads} comps-reading launches a batch step: {instances}")
    check(min(launches.values()) >= recorded, f"{launches} for {recorded} batch steps")
    rel = batched_sum_in_loop(tp)
    return {"launches": launches, "instances": instances, "steps": steps,
            "ms_per_step": [1e3 * s / max(n, 1) for s, n in zip(seconds, steps)],
            "ratios": ratios, "in_loop_rel": rel, "peak_gb": peak_gb, "reads_per_step": reads}


# ---------------------------------------------------------------------- #
# phase 12: the descent captured in a CUDA graph against the same descent
# uncaptured
# ---------------------------------------------------------------------- #
# phase 12's step budget a phase: the runs are compared, not converged (400
# before phase 13 took its share of the script's time limit)
GRAPH_STEPS = 200
GRAPH_CK_STEPS = 150  # case (d): steps a phase, a checkpoint every GRAPH_CK_EVERY
GRAPH_CK_EVERY = 50


def graphed_and_eager(fn):
    """``fn()`` run as the entry points run it (each descent step one
    replay of its CUDA graph), then uncaptured (``solver.graph.eager_steps``,
    the private switch: every step's launches issued from the host): for
    each, its result, host seconds, launches by name, peak device memory and
    the captures it made."""
    import contextlib

    import torch

    from calamity_tpu_torch import LAUNCHES
    from calamity_tpu_torch.solver import graph

    runs = {}
    for kind in ("graphed", "eager"):
        first = len(graph.CAPTURES)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        LAUNCHES.reset()
        t0 = time.perf_counter()
        with contextlib.nullcontext() if kind == "graphed" else graph.eager_steps():
            out = fn()
        torch.cuda.synchronize()
        runs[kind] = {"out": out, "seconds": time.perf_counter() - t0,
                      "launches": LAUNCHES.counts(),
                      "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                      "captures": [dict(c) for c in graph.CAPTURES[first:]]}
    check(runs["graphed"]["captures"] and not runs["eager"]["captures"],
          f"captures graphed {runs['graphed']['captures']}, eager {runs['eager']['captures']}")
    check(runs["graphed"]["launches"] == runs["eager"]["launches"],
          f"launches graphed {runs['graphed']['launches']} and eager "
          f"{runs['eager']['launches']} differ")
    return runs


def _graph_line(tag, runs, steps):
    """One log line of a phase 12 case: host ms a step of both runs, the
    captures, launches a step, peak memory."""
    from calamity_tpu_torch.ops.gains import KERNEL_NAME as GAIN_KERNEL

    g, e = runs["graphed"], runs["eager"]
    caps = g["captures"]
    log(f"  ({tag}) {steps} recorded steps, equal to the bit; host ms/step graphed "
        f"{1e3 * g['seconds'] / steps:.3f}, eager {1e3 * e['seconds'] / steps:.3f} (whole fit, "
        f"captures included); {len(caps)} captures, "
        + ", ".join(f"{c['name']} {c['seconds']:.3f} s pool {c['pool_bytes'] / 1e6:.1f} MB "
                    f"{c['replays']} replays" for c in caps)
        + f"; {GAIN_KERNEL} launches a step {g['launches'].get(GAIN_KERNEL, 0) / steps:.3f} both, "
        + ", ".join(f"{k} {g['launches'].get(k, 0) / steps:.3f}" for k in ADAMAX_KERNELS)
        + f"; peak device memory graphed {g['peak_gb']:.3f} GB, eager {e['peak_gb']:.3f} GB")
    check(min(g["launches"].get(k, 0) for k in ADAMAX_KERNELS) >= steps,
          f"({tag}) {g['launches']} for {steps} steps")


def _graph_stats(runs, steps):
    return {k: {"ms_per_step": 1e3 * r["seconds"] / steps, "peak_gb": r["peak_gb"],
                "captures": r["captures"]} for k, r in runs.items()}


def _same_fit(a, b):
    """Two ``fit_gains_and_foregrounds`` results equal to the bit: steps,
    histories, gains and coefficients."""
    import torch

    ha, hb = a[4], b[4]
    return (ha["loss"] == hb["loss"] and ha.get("phase_steps") == hb.get("phase_steps")
            and all(torch.equal(x, y) for x, y in zip([a[0], a[1], *a[2], *a[3]],
                                                      [b[0], b[1], *b[2], *b[3]])))


def _profile_steps(tag, chs, problem, batched=False, regularization=None, eager=False):
    """The step of ``problem`` replayed (and with ``eager``, uncaptured)
    under the profiler (``scripts/profile_step_torch.py``): device ms,
    kernels, host ms and idle share of each. The device time is the
    profiler's kernel sum, or, where the profiler saw no kernel of the
    replays, the time between CUDA events around them."""
    import profile_step_torch as prof

    out = {}
    for kind, capture in (("graphed", True), ("eager", False))[:2 if eager else 1]:
        if batched:
            step, per_call, d = prof.batched_stepper(chs, None, None, None, None, regularization,
                                                     capture, problem=problem)
        else:
            step, per_call, d = prof.serial_stepper(chs, None, None, None, regularization,
                                                    capture, problem=problem)
        r = prof.profile(step, per_call)
        d.close()
        r["dev_ms"] = r["device_ms"] if r["device_ms"] > 0 else r["event_ms"]
        r["idle"] = 1 - r["dev_ms"] / r["plain_ms"]
        out[kind] = r
    g = out["graphed"]
    log(f"  ({tag}) step under the profiler: replayed device {g['device_ms']:.3f} ms in "
        f"{g['kernels']:.0f} kernels (between CUDA events {g['event_ms']:.3f}), host "
        f"{g['plain_ms']:.3f} ms/step, idle share {g['idle']:.3f}"
        + ("" if not eager else
           f"; eager device {out['eager']['device_ms']:.3f} ms in "
           f"{out['eager']['kernels']:.0f} kernels, host {out['eager']['plain_ms']:.3f} "
           f"ms/step, idle share {out['eager']['idle']:.3f}"))
    return {k: {x: v[x] for x in ("device_ms", "event_ms", "dev_ms", "plain_ms", "kernels", "idle")}
            for k, v in out.items()}


def phase_graph(tmp, main, tp):
    """Phase 12: four descents captured as the entry points run them (one
    CUDA-graph replay a step) against the same descents uncaptured, each
    pair equal to the bit (steps, histories, final parameters, launches):
    (a) phase 4's packed slice, serial, the mixed schedule; (b) the HERA
    core's slice at full width with the demo's patience and use_min and the
    "sum" prior; (c) phase 7's 8 slices, batched, with the "sum" prior (the
    fused kernel's one pass); (d) a checkpointed serial fit of (a)'s slice,
    and the graphed one cut mid-fit and resumed. Each on a step budget
    (:data:`GRAPH_STEPS` a phase); the host ms a step of both runs, the
    captures, peak memory, and (a)-(c)'s step replayed under the profiler,
    (b)'s also uncaptured. (b)'s replayed step must take at most 1.3 times
    its device time on the host clock, and at most a third of the eager
    step's."""
    import torch

    import profile_step_torch as prof
    from calamity_tpu_torch import cal_utils
    from calamity_tpu_torch.calibration import POLL_EVERY
    from calamity_tpu_torch.parallel import batched
    from calamity_tpu_torch.solver import fit as fitmod
    from calamity_tpu_torch.solver.optimizers import tree_leaves
    from calamity_tpu_torch.solver.tensorize import FitSpec

    log(f"== phase 12: the descent captured in a CUDA graph against the same descent uncaptured "
        f"({GRAPH_STEPS} steps a phase at most; host polls every {POLL_EVERY} steps)")
    out = {}

    def serial(problem, chunks, **kw):
        dr, di, w, g_r, g_i, fr, fi = problem
        return fitmod.fit_gains_and_foregrounds(
            g_r.clone(), g_i.clone(), [x.clone() for x in fr], [x.clone() for x in fi], dr, di,
            w, chunks, learning_rate=1e-2, **kw)

    def recorded(res):
        return len(res[4]["loss"])

    # (a) phase 4's packed slice
    packed = packed_slice(main)
    slice4 = tuple(packed[k] for k in ("data_r", "data_i", "wgts", "g_r", "g_i", "fg_r", "fg_i"))
    kw_a = dict(maxsteps=GRAPH_STEPS, tol=TOL, model_regularization="post_hoc",
                comps_precision="mixed")
    runs = graphed_and_eager(lambda: serial(slice4, packed["chunks"], **kw_a))
    check(_same_fit(runs["graphed"]["out"], runs["eager"]["out"]),
          "(a) the graphed and the eager serial fits differ")
    steps = recorded(runs["graphed"]["out"])
    _graph_line("a", runs, steps)
    prof_a = _profile_steps("a, float32 phase", packed["chunks"], slice4)
    out["a"] = {"steps": runs["graphed"]["out"][4]["phase_steps"],
                "runs": _graph_stats(runs, steps), "profile": prof_a}

    # (d) the same slice, checkpointed, and the graphed run cut and resumed
    ck = {k: os.path.join(tmp, f"graph_ck_{k}") for k in ("graphed", "eager", "resumed")}
    kw_d = dict(maxsteps=GRAPH_CK_STEPS, tol=0.0, model_regularization="post_hoc",
                comps_precision="mixed", checkpoint_every=GRAPH_CK_EVERY)
    which = iter(("graphed", "eager"))
    runs = graphed_and_eager(lambda: serial(slice4, packed["chunks"],
                                            checkpoint_dir=ck[next(which)], **kw_d))
    check(_same_fit(runs["graphed"]["out"], runs["eager"]["out"]),
          "(d) the graphed and the eager checkpointed fits differ")
    shutil.copytree(ck["graphed"], ck["resumed"])
    cut = os.path.join(ck["resumed"], "phase_f32")
    for name in os.listdir(cut):
        if int(name.split("_")[1]) > GRAPH_CK_EVERY:
            shutil.rmtree(os.path.join(cut, name))
    resumed = serial(slice4, packed["chunks"], checkpoint_dir=ck["resumed"], **kw_d)
    check(_same_fit(resumed, runs["graphed"]["out"]),
          "(d) the resumed graphed fit differs from the uninterrupted one")
    steps = recorded(runs["graphed"]["out"])
    _graph_line("d", runs, steps)
    log(f"  (d) cut after the float32 phase's step {GRAPH_CK_EVERY}, resumed graphed: equal to the "
        "bit to the uninterrupted fits")
    out["d"] = {"steps": runs["graphed"]["out"][4]["phase_steps"],
                "runs": _graph_stats(runs, steps)}
    del packed, slice4

    # (b) the HERA core's slice at full width, the "sum" prior
    corrupted, comps, _ = hera_core_build()
    gains = cal_utils.blank_uvcal_from_uvdata(corrupted)
    spec = FitSpec(corrupted, comps, {int(a): i for i, a in enumerate(gains.ant_array)},
                   device="cuda", nvec_bucketing=True, shared_basis=True)
    chunks = spec.device_chunks()
    hera = prof.serial_problem(spec, corrupted, gains)
    kw_b = dict(maxsteps=GRAPH_STEPS, tol=1e-11, patience=500, use_min=True,
                model_regularization="sum", sky_model_r=hera[0], sky_model_i=hera[1],
                comps_precision="mixed")
    runs = graphed_and_eager(lambda: serial(hera, chunks, **kw_b))
    check(_same_fit(runs["graphed"]["out"], runs["eager"]["out"]),
          "(b) the graphed and the eager HERA core fits differ")
    steps = recorded(runs["graphed"]["out"])
    _graph_line("b", runs, steps)
    prof_b = {}
    for name, chs in (("bf16", fitmod.convert_chunks_dtype(chunks, torch.bfloat16)),
                      ("f32", chunks)):
        prof_b[name] = _profile_steps(f"b, {name} phase", chs, hera, regularization="sum",
                                      eager=True)
    out["b"] = {"steps": runs["graphed"]["out"][4]["phase_steps"],
                "runs": _graph_stats(runs, steps), "profile": prof_b}
    for name, p in prof_b.items():
        g, e = p["graphed"], p["eager"]
        log(f"  (b) {name} phase: replayed host/device {g['plain_ms'] / g['dev_ms']:.3f} (limit "
            f"1.3), replayed/eager host {g['plain_ms'] / e['plain_ms']:.3f} (limit 1/3)")
        check(g["plain_ms"] <= 1.3 * g["dev_ms"] and 3 * g["plain_ms"] <= e["plain_ms"],
              f"(b) {name}: the replayed step {g} against the eager one {e}")
    del hera, chunks, spec
    _HERA.clear()  # phase 12 is its last user

    # (c) phase 7's 8 slices, batched, the "sum" prior
    uvd = tp["uvd"]
    gains = cal_utils.blank_uvcal_from_uvdata(uvd)
    spec = FitSpec(uvd, tp["comps"], {int(a): i for i, a in enumerate(gains.ant_array)},
                   device="cuda", shared_basis=False)
    chunks = spec.device_chunks()
    problem = prof.batched_problem(spec, uvd, gains)
    dr, di, w, g_r, g_i, fr, fi = problem
    cfg = fitmod.FitConfig(tol=TOL, maxsteps=GRAPH_STEPS, regularization="sum",
                           opt_kwargs=(("learning_rate", 1e-2),))
    priors = prof.sum_priors(dr, di, w, dims=(1, 2, 3))
    runs = graphed_and_eager(lambda: batched.batched_fit_core(
        cfg, chunks, dr, di, w, g_r, g_i, fr, fi, *priors, poll_every=POLL_EVERY))
    rg, re_ = runs["graphed"]["out"], runs["eager"]["out"]
    check(rg.nsteps == re_.nsteps and np.array_equal(rg.nsteps_slice, re_.nsteps_slice)
          and np.array_equal(rg.loss_history, re_.loss_history, equal_nan=True)
          and all(torch.equal(x, y) for x, y in zip(
              tree_leaves(rg.opt_state) + [rg.g_r, rg.g_i, *rg.fg_r, *rg.fg_i, rg.final_loss],
              tree_leaves(re_.opt_state) + [re_.g_r, re_.g_i, *re_.fg_r, *re_.fg_i,
                                            re_.final_loss])),
          "(c) the graphed and the eager batched descents differ")
    steps = int(rg.nsteps)
    _graph_line("c", runs, steps)
    log(f"  (c) steps per slice {rg.nsteps_slice.tolist()}, step count "
        f"{int(rg.opt_state.count)}")
    prof_c = _profile_steps("c", chunks, problem, batched=True, regularization="sum")
    out["c"] = {"steps": int(rg.nsteps), "runs": _graph_stats(runs, steps), "profile": prof_c}
    return out


# ---------------------------------------------------------------------- #
# phase 13: the full HERA array
# ---------------------------------------------------------------------- #
# (a)'s step budget a phase of the mixed schedule: the demo's 2000, cut for
# the script's time limit (the loss falls 34-fold in the first 250 steps:
# resid/data 2.1e-3 after 1000 + 1000 steps, about 8e-3 after 250)
FULL_MAXSTEPS = 400
FULL_TP_STEPS = 15  # (b): batch steps a phase, replayed from the step graph (time limit)
FULL_RFI_FRAC = 0.05  # (b): the campaign's RFI flags, bf16 weights and loss blocks
FULL_LOSS_BLOCK = 512


def _full_profile(tag, chs, problem):
    """The full array's serial step of ``problem`` replayed from its CUDA
    graph under the profiler (``scripts/profile_step_torch.py``): device
    ms, kernels, host ms and idle share."""
    import profile_step_torch as prof

    step, per_call, d = prof.serial_stepper(chs, None, None, None, problem=problem)
    r = prof.profile(step, per_call)
    d.close()
    log(f"  ({tag}) step replayed under the profiler: device {r['device_ms']:.3f} ms in "
        f"{r['kernels']:.0f} kernels (between CUDA events {r['event_ms']:.3f}); host "
        f"{r['plain_ms']:.3f} ms/step without the profiler; idle share {r['idle_share']:.3f}; "
        f"per step {prof.kernels_line(r)}")
    return {k: r[k] for k in ("device_ms", "event_ms", "plain_ms", "kernels", "idle_share",
                              "named")}


def phase_hera_full():
    """Phase 13: ``scripts/hera_full_demo_torch.py``'s configuration at full
    width (331 antennas, all 54,615 baselines, 1536 channels; 18 chunks of
    77,748 groups, every one shared or shared-batched). (a) One slice on the
    serial path with the demo's arguments, :data:`FULL_MAXSTEPS` steps a
    phase at most: every chunk's loss on the shared-basis kernel each step,
    resid/data <= 1e-2, finite gains; steps, host ms a step, peak memory,
    the ``timings`` stages, and the step replayed under the profiler. (b)
    :data:`FULL_NTIMES` slices on the time-parallel path as the JAX
    package's campaign ran its 8 (5% RFI flags, bfloat16 weights, loss
    blocks of 512 groups), :data:`FULL_TP_STEPS` batch steps a phase:
    losses finite and falling, every chunk on the kernel; ms a batch step,
    launches a step, peak memory, ``writeback_s`` and the host's resident
    set; then the same slices packed once and stepped by the batched
    descent with and without the loss blocks (peak memory and ms a batch
    step of each, or that the
    unblocked one does not fit)."""
    import torch

    import hera_core_demo_torch as core
    import hera_full_demo_torch as demo
    import profile_step_torch as prof
    from calamity_tpu_torch import LAUNCHES
    from calamity_tpu_torch.calibration import POLL_EVERY
    from calamity_tpu_torch.ops.fused import KERNEL_NAME
    from calamity_tpu_torch.ops.gains import KERNEL_NAME as GAIN_KERNEL
    from calamity_tpu_torch.ops.gains import PRODUCTS_KERNEL_NAME as PROD_KERNEL
    from calamity_tpu_torch.ops.shared import KERNEL_NAME as SHARED_KERNEL
    from calamity_tpu_torch.parallel import batched
    from calamity_tpu_torch.solver import fit as fitmod

    log("== phase 13: the full HERA array (scripts/hera_full_demo_torch.py) with the demo's "
        "arguments")
    full = hera_full_build()
    corrupted, comps, facts, spec = (full[k] for k in ("corrupted", "comps", "facts", "spec"))
    check((facts["nants"], facts["nbls"], facts["nuniq"]) == (331, 54615, 630),
          f"full array: {facts}")
    names = (KERNEL_NAME, SHARED_KERNEL, GAIN_KERNEL, PROD_KERNEL, *ADAMAX_KERNELS)
    out = {"facts": facts, "build_s": full["seconds"]}

    # (a) the leading slice, serial
    one = corrupted.select(times=np.unique(corrupted.time_array)[:1], inplace=False)
    layouts = core.chunk_layouts(one, comps)
    ngroups = sum(c["groups"] for c in layouts)
    log(f"  {len(layouts)} chunks, {ngroups} groups: "
        + "; ".join(f"{c['kind']} ({c['U']}, {c['gmax']}, {c['V']})" for c in layouts))
    check(len(layouts) == FULL_CHUNKS and ngroups == FULL_GROUPS
          and all(c["kind"] != "dense" for c in layouts), f"full array layouts {layouts}")
    timings = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.reset()
    t0 = time.time()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        _, resid, gains, info = demo.fit(one, comps, device="cuda", maxsteps=FULL_MAXSTEPS,
                                         timings=timings)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {k: LAUNCHES.get(k) for k in names}
    fallbacks = [str(w.message) for w in caught if "plain torch loss" in str(w.message)]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    h = info[0][0]
    recorded = len(h["loss"])
    rates = [1e3 * sec / max(n, 1) for sec, n in zip(h["phase_seconds"], h["phase_steps"])]
    ratio = _core_resid_ratio(one, resid)
    log(f"  (a) one slice: phase steps (bf16, f32) {h['phase_steps']}, ms/step "
        f"{', '.join(f'{r:.3f}' for r in rates)} (host clock, captures and polls included); "
        f"loss {h['loss'][0]:.6e} -> {h['loss'][-1]:.6e} (every 250 steps: "
        f"{', '.join(f'{x:.3e}' for x in h['loss'][::250])}); calibrate_and_model_dpss in all "
        f"{wall:.1f} s; peak device memory {peak_gb:.3f} GB; resid rms / data rms {ratio:.4e} "
        f"(limit 1e-2)")
    log("  (a) host seconds: " + ", ".join(f"{k} {v:.2f}" for k, v in sorted(timings.items())
                                          if np.isscalar(v)))
    log(f"  (a) launches {launches} for {recorded} recorded steps: {SHARED_KERNEL} "
        f"{launches[SHARED_KERNEL] / recorded:.3f} a step for {len(layouts)} chunks, by instance "
        f"{instance_launches(SHARED_KERNEL)}; {nvidia_smi_line()}")
    check(not fallbacks, f"full array: chunks named as fallbacks: {fallbacks}")
    check(launches[KERNEL_NAME] == 0, f"dense launches in the full array: {launches}")
    check(launches[SHARED_KERNEL] >= FULL_CHUNKS * recorded,
          f"{launches[SHARED_KERNEL]} {SHARED_KERNEL} launches for {FULL_CHUNKS} chunks and "
          f"{recorded} steps")
    check(min(launches[k] for k in (GAIN_KERNEL, PROD_KERNEL, *ADAMAX_KERNELS)) >= recorded,
          f"gain and Adamax kernels {launches} for {recorded} steps")
    check(np.isfinite(gains.gain_array).all(), "full array (a): non-finite gains")
    check(ratio <= 1e-2, f"full array (a): resid/data {ratio}")
    out["a"] = {"steps": h["phase_steps"], "ms_per_step": rates, "peak_gb": peak_gb,
                "launches": launches, "instances": instance_launches(SHARED_KERNEL),
                "resid_ratio": ratio, "wall_s": wall,
                "timings": {k: v for k, v in timings.items() if np.isscalar(v)}}
    del one, resid, gains, info
    torch.cuda.empty_cache()
    problem = prof.serial_problem(spec, corrupted, full["gains"])
    chunks = spec.device_chunks()
    out["a"]["profile"] = {
        name: _full_profile(f"a, {name} phase", chs, problem)
        for name, chs in (("bf16", fitmod.convert_chunks_dtype(chunks, torch.bfloat16)),
                          ("f32", chunks))}
    del problem
    torch.cuda.empty_cache()

    # (b) the slices, time-parallel, as the campaign ran them
    flagged = demo.rfi_flags(corrupted, FULL_RFI_FRAC)
    timings = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.reset()
    t0 = time.time()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        _, resid, gains, info = demo.fit(
            corrupted, comps, device="cuda", maxsteps=FULL_TP_STEPS, time_parallel=True,
            wgts_precision="bfloat16", loss_block_ngrps=FULL_LOSS_BLOCK, timings=timings)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {k: LAUNCHES.get(k) for k in names}
    fallbacks = [str(w.message) for w in caught if "plain torch loss" in str(w.message)]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steps, seconds = timings["phase_steps"], timings["phase_seconds"]
    batch_steps = sum(steps) + len(steps)  # recorded and warm-up batch steps
    rates = [1e3 * sec / max(n, 1) for sec, n in zip(seconds, steps)]
    hists = [np.asarray(info[0][t]["loss"]) for t in sorted(info[0])]
    ratios = list(_slice_ratios(corrupted, resid).values())
    log(f"  (b) {len(hists)} slices, {int(flagged.sum())} of {corrupted.Nfreqs} channels flagged "
        f"in RFI bands, bfloat16 weights, loss blocks of {FULL_LOSS_BLOCK} groups: batch steps "
        f"(bf16, f32) {steps}, ms/step {', '.join(f'{r:.3f}' for r in rates)} (host clock, "
        f"{len(hists)} slices a step); in all {wall:.1f} s; peak device memory {peak_gb:.3f} GB; "
        f"launches {launches} for {batch_steps} batch steps "
        f"({launches[SHARED_KERNEL] / batch_steps:.2f} {SHARED_KERNEL} a step); loss per slice "
        + ", ".join(f"{x[0]:.4e} -> {x[-1]:.4e}" for x in hists)
        + f"; resid/data per slice {', '.join(f'{r:.3e}' for r in ratios)}")
    log("  (b) host seconds: " + ", ".join(f"{k} {v:.2f}" for k, v in sorted(timings.items())
                                          if np.isscalar(v)) + f"; {nvidia_smi_line()}")
    check(len(hists) == FULL_NTIMES, f"full array (b): {len(hists)} slices")
    check(all(np.isfinite(x).all() and x[-1] < x[0] for x in hists),
          f"full array (b): losses not finite or not falling: {[(x[0], x[-1]) for x in hists]}")
    check(not fallbacks, f"full array (b): chunks named as fallbacks: {fallbacks}")
    check(launches[KERNEL_NAME] == 0 and launches[SHARED_KERNEL] >= FULL_CHUNKS * batch_steps
          and min(launches[k] for k in ADAMAX_KERNELS) >= batch_steps,
          f"full array (b): launches {launches} for {batch_steps} batch steps")
    out["b"] = {"steps": steps, "ms_per_step": rates, "peak_gb": peak_gb, "launches": launches,
                "launches_per_step": {k: v / batch_steps for k, v in launches.items()},
                "flagged_channels": int(flagged.sum()), "resid_ratios": ratios,
                "wall_s": wall, "timings": {k: v for k, v in timings.items() if np.isscalar(v)}}
    del resid, gains, info
    torch.cuda.empty_cache()

    # the slices packed once, stepped with and without the loss blocks
    problem = list(prof.batched_problem(spec, corrupted, full["gains"]))
    problem[2] = [w.to(torch.bfloat16) if w.shape[-1] > 1 else w for w in problem[2]]
    dr, di, w, g_r, g_i, fr, fi = problem
    out["blocks"] = {}
    for blk in (FULL_LOSS_BLOCK, None):
        cfg = fitmod.FitConfig(tol=0.0, maxsteps=FULL_TP_STEPS, remat=True, loss_block=blk,
                               opt_kwargs=(("learning_rate", 1e-2),))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        LAUNCHES.reset()
        t0 = time.perf_counter()
        try:
            res = batched.batched_fit_core(cfg, chunks, dr, di, w, g_r.clone(), g_i.clone(),
                                           [x.clone() for x in fr], [x.clone() for x in fi],
                                           poll_every=POLL_EVERY)
            torch.cuda.synchronize()
        except torch.cuda.OutOfMemoryError as exc:
            log(f"  (b) loss blocks {blk}: does not fit in the card's memory ({exc})")
            out["blocks"][str(blk)] = {"fits": False}
            torch.cuda.empty_cache()
            continue
        sec = time.perf_counter() - t0
        nst = int(res.nsteps)
        hist = np.asarray(res.loss_history[:nst])
        entry = {"fits": True, "steps": nst, "ms_per_step": 1e3 * sec / max(nst, 1),
                 "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                 "shared_per_step": LAUNCHES.get(SHARED_KERNEL) / max(nst + 1, 1)}
        out["blocks"][str(blk)] = entry
        log(f"  (b) the packed {FULL_NTIMES} slices, float32 comps, loss blocks {blk}: {nst} "
            f"batch steps, "
            f"{entry['ms_per_step']:.3f} ms/step (host clock, the capture included), peak "
            f"device memory {entry['peak_gb']:.3f} GB, {entry['shared_per_step']:.2f} "
            f"{SHARED_KERNEL} launches a step; losses finite and falling "
            f"{bool(np.isfinite(hist).all() and (hist[-1] < hist[0]).all())}")
        check(np.isfinite(hist).all() and (hist[-1] < hist[0]).all(),
              f"full array, loss blocks {blk}: losses {hist[0]} -> {hist[-1]}")
        del res
        torch.cuda.empty_cache()
    del problem, dr, di, w, fr, fi
    _FULL.clear()  # phase 13 is its last user
    torch.cuda.empty_cache()
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False; this smoke test needs a CUDA card",
              file=sys.stderr)
        sys.exit(2)
    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, repo)
    os.environ.setdefault("TQDM_DISABLE", "1")  # no progress bars in the log
    import calamity_tpu_torch  # noqa: F401  (raises outside a checkout)

    t_start = time.time()
    phase_environment()
    phase_build()
    run = (set(sys.argv[sys.argv.index("--phases") + 1].split(","))
           if "--phases" in sys.argv else None)  # a subset, for a short run
    if run is not None:
        log(f"running phases {sorted(run)} only")
    want = lambda name: run is None or name in run  # noqa: E731
    sys.path.insert(0, os.path.join(repo, "scripts"))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    out = {}

    def mark(phase):
        log(f"  [{phase} done: {time.time() - t_start:.1f} s since the start]")

    try:
        if want("3g"):
            out["gain"] = phase_gain_grad()
            mark("phase 3g")
        if want("3s"):
            out["shared"] = phase_shared_kernel()
            out["shared_full"] = phase_shared_full_array()
            mark("phase 3s")
        if want("3a"):
            out["adamax"] = phase_adamax()
            mark("phase 3a")
        if any(want(p) for p in ("3", "4", "5", "12")):
            t0 = time.time()
            path = os.path.join(tmp, "main.uvh5")
            uvd, comps = make_corrupted_file(path)
            log(f"== set-up: simulated {uvd.Nbls} baselines x {uvd.Ntimes} times x "
                f"{uvd.Nfreqs} channels and wrote the uvh5 file in {time.time() - t0:.1f} s "
                "(host)")
            check(uvd.Nbls == NANTS * (NANTS - 1) // 2,
                  f"expected 2016 baselines, got {uvd.Nbls}")
            shapes = main_chunk_shapes(comps)
            check(len(shapes) == 1 and shapes[0][1] == 1,
                  f"expected one dense B=1 chunk: {shapes}")
            ngrps, _, nfreqs, nvecs = shapes[0]
        if want("3"):
            out["fused"] = phase_kernel_vs_plain((ngrps, nfreqs, nvecs))
            mark("phase 3")
        if any(want(p) for p in ("4", "5", "12")):
            out["main"] = phase_main_path(tmp, path, uvd, comps)
            packed = packed_slice(out["main"])
            out["twice"] = fit_twice(packed)
            phase_in_loop(packed)
            del packed
            mark("phase 4 and 5")
        if want("6"):
            out["cli"] = phase_cli(tmp, repo)
            mark("phase 6")
        if any(want(p) for p in ("7", "8", "9", "11", "12")):
            # phase 4's basis: the same baselines and channels
            out["tp"] = phase_time_parallel(tmp, out["main"]["comps"] if "main" in out else None)
            if want("7"):
                out["tp_twice"] = batched_kernel_and_plain(out["tp"])
            mark("phase 7")
        if want("8"):
            out["scan"] = phase_scan(tmp, out["tp"])
            mark("phase 8")
        if want("9"):
            out["mesh"] = phase_mesh(tmp, repo, out["tp"])
            mark("phase 9")
        if want("10"):
            out["hera"] = phase_hera_core()
            mark("phase 10")
        if want("11"):
            out["sum_hera"] = phase_sum_hera()
            mark("phase 11 (a)")
            out["sum_tp"] = phase_sum_time_parallel(tmp, out["tp"])
            mark("phase 11 (b)")
        if want("12"):
            out["graph"] = phase_graph(tmp, out["main"], out["tp"])
            mark("phase 12")
        if want("13"):
            out["full"] = phase_hera_full()
            mark("phase 13")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    jax_loaded = sorted(m for m in sys.modules if m in ("jax", "calamity_tpu")
                        or m.startswith(("jax.", "calamity_tpu.")))
    check(not jax_loaded, f"the JAX package or jax was imported: {jax_loaded}")
    log(f"total {time.time() - t_start:.1f} s")
    if run is not None:
        log("a partial run: no kernels line and no result line")
        return
    print(json.dumps({"kernels": kernels_line(out)}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


def kernels_line(out):
    """The kernels of the main paths, with what this run measured of them."""
    import torch

    from calamity_tpu_torch.ops.fused import COMBINE_NAME, KERNEL_NAME
    from calamity_tpu_torch.ops.gains import KERNEL_NAME as GAIN_KERNEL
    from calamity_tpu_torch.ops.gains import PRODUCTS_KERNEL_NAME as PROD_KERNEL
    from calamity_tpu_torch.ops.shared import KERNEL_NAME as SHARED_KERNEL

    fused, gain, prods = out["fused"], out["gain"]["grad"], out["gain"]["products"]
    shared = out["shared"]
    packed = out["gain"]["hera_packed"]
    main, tp, scan, mesh, cli, hera = (out[k] for k in ("main", "tp", "scan", "mesh", "cli",
                                                        "hera"))
    sum_hera, sum_tp, full = out["sum_hera"], out["sum_tp"], out["full"]
    # the largest abs error of a loss or a gradient, kernel against plain, over phase 3
    n8 = fused[(8, torch.float32)]
    timed = {f"N={n} {str(cdt).replace('torch.', '')} comps": {
        k: fused[(n, cdt)][k] for k in ("grad_ms", "loss_only_ms", "plain_grad_ms",
                                        "plain_ms", "matvec_library_ms", "fwdbwd_ms",
                                        "plain_fwdbwd_ms", "bound_ms", "loss_only_bound_ms",
                                        "roofline_share", "transient_gb")}
        for n in (8, 1) for cdt in (torch.float32, torch.bfloat16)}
    fused_by_path = {"serial": main["launches"], "time_parallel": tp["launches"],
                     "time_scan": scan["launches"],
                     # phase 9 (b): per rank of the mesh (1, 2)
                     "mesh_1x2": [r["launches"] for r in mesh["b"]],
                     "mesh_1x1": mesh["a"]["launches"],
                     "hera_core": hera["launches"][KERNEL_NAME],
                     "hera_core_sum": sum_hera["launches"][KERNEL_NAME],
                     "time_parallel_sum": sum_tp["launches"][KERNEL_NAME]}
    gain_by_path = {"serial": main["gain_launches"], "serial_twice": out["twice"]["launches"],
                    "time_parallel": tp["gain_launches"], "time_scan": scan["gain_launches"],
                    "mesh_1x2": [r["gain_launches"] for r in mesh["b"]],
                    "mesh_1x1": mesh["a"]["gain_launches"], "cli_foreign_files": cli["launches"],
                    "hera_core": hera["launches"][GAIN_KERNEL],
                    "hera_core_sum": sum_hera["launches"][GAIN_KERNEL],
                    "time_parallel_sum": sum_tp["launches"][GAIN_KERNEL],
                    "hera_full": full["a"]["launches"][GAIN_KERNEL],
                    "hera_full_time_parallel": full["b"]["launches"][GAIN_KERNEL]}
    prod_by_path = {"serial": main["prod_launches"], "serial_twice": out["twice"]["prod_launches"],
                    "time_parallel": tp["prod_launches"], "time_scan": scan["prod_launches"],
                    "mesh_1x2": [r["prod_launches"] for r in mesh["b"]],
                    "mesh_1x1": mesh["a"]["prod_launches"],
                    "cli_foreign_files": cli["prod_launches"],
                    "hera_core": hera["launches"][PROD_KERNEL],
                    "hera_core_sum": sum_hera["launches"][PROD_KERNEL],
                    "time_parallel_sum": sum_tp["launches"][PROD_KERNEL],
                    "hera_full": full["a"]["launches"][PROD_KERNEL],
                    "hera_full_time_parallel": full["b"]["launches"][PROD_KERNEL]}
    g8, p8 = gain[("phase7", 8)], prods[("phase7", 8)]
    return [{
        "name": KERNEL_NAME,
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": (main["launches"] + tp["launches"] + scan["launches"]
                     + sum(fused_by_path["mesh_1x2"]) + fused_by_path["hera_core"]
                     + fused_by_path["time_parallel_sum"]),
        "launches_by_path": fused_by_path,
        # each instance: its launches on the main path that runs it (the
        # "sum" instances: phase 11 (b)) and its times at N=8, float32 comps
        "instances": fused_instances(n8, tp, sum_tp),
        "max_abs_err": max(r["max_abs_err"] for r in fused.values()),
        # the instance the descent launches (loss and every gradient), at the
        # time-parallel path's chunk: N=8, float32 comps
        "ms": n8["grad_ms"],
        "plain_ms": n8["plain_grad_ms"],
        "bound_ms": n8["bound_ms"],
        "bound_by": n8["bound_by"],
        # no single PyTorch call computes the loss with its gradients
        "library_ms": None,
        "matvec_library_ms": n8["matvec_library_ms"],
        "roofline_share": n8["roofline_share"],
        "grad_ms": n8["grad_ms"],
        "plain_grad_ms": n8["plain_grad_ms"],
        "loss_only_ms": n8["loss_only_ms"],
        "timed": timed,
        "card": nvidia_smi_line(),
    }, {
        "name": GAIN_KERNEL,
        "route": "cuda",
        "source": GAIN_KERNEL_SOURCE,
        "replaces": GAIN_KERNEL_REPLACES,
        "launches": sum(sum(v) if isinstance(v, list) else v for k, v in gain_by_path.items()),
        "launches_by_path": gain_by_path,
        "max_abs_err": max(r["max_abs_err"] for r in gain.values()),
        # phase 7's shapes: N=8 slices, 2016 rows, 64 antennas, 1536 channels
        "ms": g8["ms"],
        "plain_ms": g8["plain_ms"],
        "bound_ms": g8["bound_ms"],
        "bound_by": g8["bound_by"],
        # one index_add_ scattering the (row, side) contributions
        "library_ms": g8["library_ms"],
        "timed": dict({f"{shape} N={n}": {k: gain[(shape, n)][k] for k in
                                          ("ms", "device_ms", "plain_ms", "bound_ms",
                                           "library_ms")}
                       for shape in ("phase7", "hera") for n in (8, 1)},
                      **{f"hera_packed_step N={n}": {
                          k: packed[n][k] for k in ("ms", "device_ms", "listed_one_segment_ms",
                                                    "listed_segmented_ms", "plain_ms",
                                                    "bound_ms", "library_ms")}
                         for n in (8, 1)}),
        "card": nvidia_smi_line(),
    }, {
        "name": PROD_KERNEL,
        "route": "cuda",
        "source": PROD_KERNEL_SOURCE,
        "replaces": GAIN_KERNEL_REPLACES,
        "launches": sum(sum(v) if isinstance(v, list) else v for k, v in prod_by_path.items()),
        "launches_by_path": prod_by_path,
        "max_abs_err": max(r["max_abs_err"] for r in prods.values()),
        # phase 7's shapes: N=8 slices, 2016 rows, 64 antennas, 1536 channels
        "ms": p8["ms"],
        "plain_ms": p8["plain_ms"],
        "bound_ms": p8["bound_ms"],
        "bound_by": p8["bound_by"],
        # no single PyTorch call gathers and multiplies; the four gathers alone
        "library_ms": None,
        "gathers_ms": p8["gathers_ms"],
        "timed": dict({f"{shape} N={n}": {k: prods[(shape, n)][k] for k in
                                          ("ms", "device_ms", "plain_ms", "bound_ms",
                                           "gathers_ms")}
                       for shape in ("phase7", "hera") for n in (8, 1)},
                      **{f"hera_packed_step N={n}": {
                          "ms": packed[n]["products_ms"],
                          "device_ms": packed[n]["products_device_ms"],
                          "plain_ms": packed[n]["products_plain_ms"],
                          "bound_ms": packed[n]["products_bound_ms"]} for n in (8, 1)}),
        "card": nvidia_smi_line(),
    }, combine_entry(COMBINE_NAME, fused, sum_tp),
        shared_kernel_entry(SHARED_KERNEL, shared, hera, cli, sum_hera, full, out["shared_full"]),
        *adamax_entries(out)]


def adamax_entries(out):
    """The kernels line's entries of the Adamax update and the carry: their
    launches on the main paths that count them (phases 4, 7, 10 and 13,
    with phase 4's and phase 7's kernel fits beside their plain twins) and
    their times at the full array's 38 leaves, N = 1 float32, the serial
    step of phase 13 (a) (phase 3a; N = 8 under "timed")."""
    by_path = {"serial": out["main"]["adamax_launches"],
               "serial_twice": out["twice"]["adamax_launches"],
               "time_parallel": out["tp"]["adamax_launches"],
               "time_parallel_twice": out["tp_twice"]["launches"],
               "hera_core": out["hera"]["launches"],
               "hera_full": out["full"]["a"]["launches"],
               "hera_full_time_parallel": out["full"]["b"]["launches"]}
    a = out["adamax"]
    entries = []
    for name, key, replaces in ((ADAMAX_KERNELS[0], "step", ADAMAX_REPLACES),
                                (ADAMAX_KERNELS[1], "carry", CARRY_REPLACES)):
        paths = {k: v[name] for k, v in by_path.items()}
        r = a[(key, 1)]
        entries.append({
            "name": name,
            "route": "cuda",
            "source": ADAMAX_SOURCE,
            "replaces": replaces,
            "launches": sum(paths.values()),
            "launches_by_path": paths,
            "max_abs_err": a["max_abs_err"],
            "ms": r["ms"],
            "device_ms": r["device_ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            # the update: torch._foreach_* ops, one call an operation
            # (ungated); the carry: none computes it
            "library_ms": r["library_ms"],
            "timed": {f"N={n} float32": a[(key, n)] for n in (1, ADAMAX_NBATCH)},
            "leaves": a["leaves"],
            "card": nvidia_smi_line(),
        })
    return entries


def fused_instances(n8, tp, sum_tp):
    """The fused kernel's instances for the kernels line: launches on the
    time-parallel path that runs each (phase 7 for the chi-square's, phase
    11 (b) for the "sum" prior's) and ms at the main chunk, N=8, float32
    comps."""
    out = {"loss_all": {"ms": n8["grad_ms"], "bound_ms": n8["bound_ms"],
                        "launches": tp["instances"].get("loss_all", 0)},
           "loss_only": {"ms": n8["loss_only_ms"], "bound_ms": n8["loss_only_bound_ms"],
                         "launches": tp["instances"].get("loss_only", 0)}}
    for name in ("sum_fwd", "sum_fwd_dp", "sum_fwd_all"):
        out[name] = dict(n8["sum"][name], launches=sum_tp["instances"].get(name, 0))
    return out


def combine_entry(name, fused, sum_tp):
    """The kernels line's entry of the combine, the second kernel of the
    fused source: its launches on the "sum" time-parallel path (phase 11
    (b)), its times after the one pass with every gradient at the main
    chunk, N=8, float32 comps (phase 3)."""
    import torch

    c8 = fused[(8, torch.float32)]["sum"]["combine_all"]
    return {
        "name": name,
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": COMBINE_REPLACES,
        "launches": sum_tp["launches"][name],
        "launches_by_path": {"time_parallel_sum": sum_tp["launches"][name]},
        "max_abs_err": max(r["combine_max_abs_err"] for r in fused.values()),
        "ms": c8["ms"],
        "device_ms": c8["device_ms"],
        "plain_ms": c8["plain_ms"],
        "bound_ms": c8["bound_ms"],
        "bound_by": c8["bound_by"],
        # no single PyTorch call forms the three linear combinations
        "library_ms": None,
        "timed": {f"N={n} {str(cdt).replace('torch.', '')} comps {k}": fused[(n, cdt)]["sum"][k]
                  for n in (8, 1) for cdt in (torch.float32, torch.bfloat16)
                  for k in ("combine_all", "combine_dp")},
        "card": nvidia_smi_line(),
    }


def shared_kernel_entry(name, shared, hera, cli, sum_hera, full, shared_full):
    """The kernels line's entry of the shared-basis kernel: launches on the
    paths that run shared chunks (the HERA core, the CLI on the foreign
    files, the full array), its times at the HERA core's chunks and at the
    full array's (phase 3s); the headline is one step of the HERA core's
    four chunks at N = 1, float32 comps, as the HERA core's float32 phase
    runs it."""
    import torch

    f32 = torch.float32
    chunks = sorted({k[0] for k in shared if isinstance(k[0], int) and len(k) == 3})
    step = [shared[(c, 1, f32)] for c in chunks]
    by_path = {"hera_core": hera["launches"][name], "cli_foreign_files": cli["shared_launches"],
               "hera_core_sum": sum_hera["launches"][name],
               "hera_full": full["a"]["launches"][name],
               "hera_full_time_parallel": full["b"]["launches"][name]}
    # each instance over the HERA step's four chunks, N = 1, float32 comps;
    # the "sum" instances' launches from phase 11 (a)
    instances = {"loss_all": {k: sum(r[k] for r in step) for k in ("ms", "device_ms",
                                                                   "bound_ms")}}
    instances["loss_all"]["launches"] = hera["instances"].get("loss_all", 0)
    for inst in step[0]["sum"]:
        instances[inst] = {k: sum(r["sum"][inst][k] for r in step)
                           for k in ("ms", "device_ms", "bound_ms")}
        instances[inst]["launches"] = sum_hera["instances"].get(inst, 0)
    return {
        "name": name,
        "route": "cuda",
        "source": SHARED_KERNEL_SOURCE,
        "replaces": SHARED_KERNEL_REPLACES,
        "launches": sum(by_path.values()),
        "launches_by_path": by_path,
        "instances": instances,
        "max_abs_err": max(r["max_abs_err"] for r in shared.values()),
        # the HERA core's step of four chunks, N = 1, float32 comps
        "ms": sum(r["ms"] for r in step),
        "device_ms": sum(r["device_ms"] for r in step),
        "plain_ms": sum(r["plain_ms"] for r in step),
        "bound_ms": sum(r["bound_ms"] for r in step),
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in step) else "operations",
        # cuBLAS' batched matvec of the same operators alone (no single
        # PyTorch call computes the loss with its gradients)
        "library_ms": sum(r["library_ms"] for r in step),
        "torch_ops_fwdbwd_ms": sum(r["torch_ops_fwdbwd_ms"] for r in step),
        "timed": {f"chunk {c} N={n} {str(cdt).replace('torch.', '')} comps": {
            k: shared[(c, n, cdt)][k] for k in ("ms", "device_ms", "plain_ms", "loss_only_ms",
                                                "library_ms", "fwdbwd_ms", "torch_ops_fwdbwd_ms",
                                                "bound_ms", "roofline_share")}
            for c in chunks for n in (1, 8) for cdt in (f32, torch.bfloat16)},
        # the full array's six chunks and its whole step of 18 launches
        "timed_full_array": {
            f"{'step' if k[0] == 'step' else 'chunk (U, gmax, V) = ' + str(k[0])} N={k[1]} "
            f"{str(k[2]).replace('torch.', '')} comps": {
                x: v[x] for x in ("ms", "device_ms", "plain_ms", "library_ms", "bound_ms",
                                  "roofline_share", "plan") if x in v}
            for k, v in shared_full.items() if isinstance(k, tuple)},
        "registers": shared_full["registers"],
        "card": nvidia_smi_line(),
    }


if __name__ == "__main__":
    main()
