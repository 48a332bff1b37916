#!/usr/bin/env python
"""Smoke test of the PyTorch/CUDA port (calamity_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card and nvcc.
It builds the port's CUDA kernel from the sources in the checkout, holds it
against its plain PyTorch version, drives the port's main path (file read,
DPSS components, FitSpec packing, Cholesky warm start, Adamax descent,
uvh5/calfits write-back) at full width, and checks what comes out. Phases:

1. environment: torch, CUDA, the card and its power limit, nvcc, triton;
2. build of the kernel library;
3. kernel against plain at the main path's chunk shape and at ragged small
   shapes, float32 and bfloat16 comps, with times; then its batched form
   (N slices sharing one comps read) against its plain version at N = 8 on
   the main chunk, N = 1 and 3 at ragged shapes and on a group-block view,
   float32 and bfloat16 comps and weights, timed against the plain version
   and against N single-slice launches;
4. the main path at full size: 64 antennas (2016 baselines), 1536 channels,
   2 times, through ``read_calibrate_and_model_dpss`` with every chunk dense
   (``shared_basis=False``), the CLI's ``post_hoc`` regularization and the
   default ``mixed`` schedule;
5. 50 recorded descent steps on that data with the chunks on the card and
   with a CPU copy (the plain version), histories compared; and the cost of
   the per-step host check of the stop conditions;
6. the port's CLI script with its default flags on a small Golomb file, and
   with ``--time_parallel --checkpoint_dir``: cut mid-fit, resumed, and
   held against an uninterrupted run;
7. the time-parallel path at full width: one ``read_calibrate_and_model_dpss``
   with ``time_parallel=True`` on 64 antennas, 1536 channels, 4 times and 2
   polarizations (8 slices in one batched descent), every step through the
   batched kernel; two of its slices against the serial path.

Any failure raises and exits non-zero; there is no fallback to the CPU. The
last line is one JSON object naming the device.
"""

import json
import os
import runpy
import shutil
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np

SEED = 20261016
NANTS = 64
DISC_RADIUS_M = 50.0
MIN_SEPARATION_M = 4.0
NFREQS = 1536
F0_HZ = 100e6
DF_HZ = 100e3
NTIMES = 2
TP_NTIMES = 4  # the time-parallel phase: 4 times x 2 polarizations = 8 slices
TP_NPOLS = 2
NSRC = 50
GAIN_ERR = 0.03
MIN_DLY_NS = 2.0 / 0.3  # = offset: the repo's tests' DPSS delay settings
MAXSTEPS = 3000  # per phase of the mixed schedule
TOL = 1e-11
N_LOOP_STEPS = 50
CUT_STEPS = 40  # where phase 6's checkpointed CLI run is cut
KERNEL_REPLACES = "calamity_tpu/ops/fused.py:152"
KERNEL_SOURCE = "calamity_tpu_torch/csrc/fused_chunk_loss.cu"


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


def phase_build():
    from calamity_tpu_torch.ops import _build

    log("== phase 2: build")
    # build from the checkout's sources, never from an earlier build
    shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)
    lib = _build.load_kernels()
    check(lib.build_seconds > 0.0, "kernel library was not built from source")
    log(f"built {os.path.relpath(lib.path)} from {[os.path.relpath(s) for s in _build.sources()]}"
        f" in {lib.build_seconds:.2f} s")
    for line in lib.build_log.splitlines():
        if "registers" in line or "spill" in line or "error" in line.lower():
            log(f"  nvcc: {line.strip()}")
    return lib


# ---------------------------------------------------------------------- #
# phase 3: kernel against plain
# ---------------------------------------------------------------------- #
def kernel_inputs(ngrps, nfreqs, nvecs, comps_dtype, seed):
    import torch

    rng = np.random.default_rng(seed)
    comps = rng.standard_normal((ngrps, nfreqs, nvecs), dtype=np.float32)
    comps /= np.linalg.norm(comps, axis=1, keepdims=True)
    coeffs2 = rng.standard_normal((2, ngrps, nvecs), dtype=np.float32)
    pr = (1 + 0.1 * rng.standard_normal((ngrps, nfreqs), dtype=np.float32))
    pi = 0.1 * rng.standard_normal((ngrps, nfreqs), dtype=np.float32)
    dr = rng.standard_normal((ngrps, nfreqs), dtype=np.float32)
    di = rng.standard_normal((ngrps, nfreqs), dtype=np.float32)
    w = np.abs(rng.standard_normal((ngrps, nfreqs), dtype=np.float32))
    w /= w.sum()
    dev = torch.device("cuda")
    t = [torch.as_tensor(x, device=dev) for x in (coeffs2, pr, pi, comps, dr, di, w)]
    t[3] = t[3].to(comps_dtype)
    return t


def compare_kernel(shape, comps_dtype, timed):
    import torch

    from calamity_tpu_torch.ops import fused

    ngrps, nfreqs, nvecs = shape
    args = kernel_inputs(ngrps, nfreqs, nvecs, comps_dtype, SEED + ngrps + nvecs)
    loss_k, v_k = fused._fwd_kernel(*args)
    loss_p, v_p = fused._fwd_plain(*args)
    torch.cuda.synchronize()
    lk, lp = float(loss_k), float(loss_p)
    loss_rel = abs(lk - lp) / abs(lp)
    loss_err = abs(lk - lp)
    v_err = float((v_k - v_p).abs().max())
    v_scale = float(v_p.abs().max())

    def grads(fn):
        leaves = [a.detach().clone().requires_grad_(i in (0, 1, 2)) for i, a in enumerate(args)]
        fn(*leaves).backward()
        return [leaves[i].grad for i in (0, 1, 2)]

    g_k = grads(fused.fused_chunk_loss)
    g_p = grads(fused.fused_chunk_loss_plain)
    g_rel = [float((a - b).abs().max() / b.abs().max()) for a, b in zip(g_k, g_p)]
    name = str(comps_dtype).replace("torch.", "")
    log(f"  {shape} {name}: loss kernel {lk:.9e} plain {lp:.9e} rel {loss_rel:.2e}; "
        f"max|dv| {v_err:.3e} (max|v| {v_scale:.3e}); grad rel (coeffs, pr, pi) "
        f"{', '.join(f'{x:.2e}' for x in g_rel)}")
    check(loss_rel <= 1e-5, f"loss disagrees at {shape} {name}: rel {loss_rel}")
    check(v_err <= 1e-5 * v_scale, f"v disagrees at {shape} {name}: {v_err} vs {v_scale}")
    check(max(g_rel) <= 1e-4, f"gradients disagree at {shape} {name}: {g_rel}")
    out = {"max_abs_err": max(v_err, loss_err)}
    if timed:
        def fwdbwd(fn):
            leaves = [a.detach().requires_grad_(i in (0, 1, 2)) for i, a in enumerate(args)]
            return lambda: fn(*leaves).backward()

        out["fwd_ms"] = cuda_median_ms(lambda: fused._fwd_kernel(*args))
        out["plain_fwd_ms"] = cuda_median_ms(lambda: fused._fwd_plain(*args))
        out["fwdbwd_ms"] = cuda_median_ms(fwdbwd(fused.fused_chunk_loss))
        out["plain_fwdbwd_ms"] = cuda_median_ms(fwdbwd(fused.fused_chunk_loss_plain))
        comps_gb = args[3].numel() * args[3].element_size() / 1e9
        log(f"    forward: kernel {out['fwd_ms']:.4f} ms ({comps_gb / out['fwd_ms']:.2f} TB/s "
            f"of comps read), plain {out['plain_fwd_ms']:.4f} ms; forward+backward: kernel "
            f"{out['fwdbwd_ms']:.4f} ms, plain {out['plain_fwdbwd_ms']:.4f} ms "
            "(median of 20 samples of 5 back-to-back calls)")
        # device memory one kernel forward+backward allocates beyond its
        # inputs (for bf16 comps: the float32 upcast of comps in the backward)
        step = fwdbwd(fused.fused_chunk_loss)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        step()
        torch.cuda.synchronize()
        transient_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
        log(f"    forward+backward transient device memory {transient_gb:.3f} GB "
            f"(comps {comps_gb:.3f} GB)")
    return out


def batched_inputs(nbatch, ngrps, nfreqs, nvecs, comps_dtype, wgts_dtype, seed, extra=0):
    """Inputs of the batched kernel; with ``extra`` > 0 the per-slice planes
    are views of (nbatch, ngrps + extra, nfreqs) cubes at groups
    [extra // 2, extra // 2 + ngrps), as a loss block reads them."""
    import torch

    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")
    gt = ngrps + extra

    def t(*shape):
        return torch.as_tensor(rng.standard_normal(shape, dtype=np.float32), device=dev)

    comps = t(ngrps, nfreqs, nvecs)
    comps /= torch.linalg.vector_norm(comps, dim=1, keepdim=True)
    coeffs2 = t(2, nbatch, ngrps, nvecs)
    pr, pi = 1 + 0.1 * t(nbatch, ngrps, nfreqs), 0.1 * t(nbatch, ngrps, nfreqs)
    dr, di = t(nbatch, gt, nfreqs), t(nbatch, gt, nfreqs)
    w = t(nbatch, gt, nfreqs).abs()
    w /= w.sum(dim=(1, 2), keepdim=True)
    g0 = extra // 2
    sl = slice(g0, g0 + ngrps)
    return [coeffs2, pr, pi, dr[:, sl], di[:, sl], w[:, sl].to(wgts_dtype),
            comps.to(comps_dtype)]


def compare_batched(nbatch, shape, comps_dtype, wgts_dtype, timed, extra=0):
    import torch

    from calamity_tpu_torch.ops import fused

    ngrps, nfreqs, nvecs = shape
    args = batched_inputs(nbatch, ngrps, nfreqs, nvecs, comps_dtype, wgts_dtype,
                          SEED + 7 * nbatch + ngrps + nvecs, extra)
    loss_k, v_k = fused._fwd_batched_kernel(*args)
    loss_p, v_p = fused._fwd_batched_plain(*args)
    torch.cuda.synchronize()
    loss_rel = float(((loss_k - loss_p).abs() / loss_p.abs()).max())
    loss_err = float((loss_k - loss_p).abs().max())
    v_err = float((v_k - v_p).abs().max())
    v_scale = float(v_p.abs().max())
    # a different cotangent per slice, so a slice mixed into another shows
    cot = torch.arange(1, nbatch + 1, device=args[0].device, dtype=torch.float32)

    def grads(fn):
        leaves = [a.detach().clone().requires_grad_(i < 3) for i, a in enumerate(args)]
        torch.sum(fn(*leaves) * cot).backward()
        return [leaves[i].grad for i in range(3)]

    g_k = grads(fused.fused_chunk_loss_batched)
    g_p = grads(fused.fused_chunk_loss_batched_plain)
    g_rel = [float((a - b).abs().max() / b.abs().max()) for a, b in zip(g_k, g_p)]
    names = "/".join(str(d).replace("torch.", "") for d in (comps_dtype, wgts_dtype))
    view = f", group-block view of {ngrps + extra} groups" if extra else ""
    log(f"  N={nbatch} {shape} comps/weights {names}{view}: per-slice loss max rel "
        f"{loss_rel:.2e}; max|dv| {v_err:.3e} (max|v| {v_scale:.3e}); grad rel (coeffs, pr, pi) "
        f"{', '.join(f'{x:.2e}' for x in g_rel)}")
    check(loss_rel <= 1e-5, f"batched loss disagrees at N={nbatch} {shape} {names}: {loss_rel}")
    check(v_err <= 1e-5 * v_scale, f"batched v disagrees at N={nbatch} {shape} {names}")
    check(max(g_rel) <= 1e-4, f"batched gradients disagree at N={nbatch} {shape}: {g_rel}")
    out = {"max_abs_err": max(v_err, loss_err)}
    if timed:
        # the same slices as N launches of the one-slice kernel, each with
        # its own contiguous inputs (each launch reads comps again)
        singles = [[args[0][:, n:n + 1].contiguous()]
                   + [a[n:n + 1].contiguous() for a in args[1:6]] + [args[6]]
                   for n in range(nbatch)]

        def n_launches():
            for one in singles:
                fused._fwd_batched_kernel(*one)

        def fwdbwd(fn):
            leaves = [a.detach().requires_grad_(i < 3) for i, a in enumerate(args)]
            return lambda: torch.sum(fn(*leaves)).backward()

        out["fwd_ms"] = cuda_median_ms(lambda: fused._fwd_batched_kernel(*args))
        out["plain_fwd_ms"] = cuda_median_ms(lambda: fused._fwd_batched_plain(*args))
        out["single_launches_ms"] = cuda_median_ms(n_launches)
        out["fwdbwd_ms"] = cuda_median_ms(fwdbwd(fused.fused_chunk_loss_batched))
        out["plain_fwdbwd_ms"] = cuda_median_ms(fwdbwd(fused.fused_chunk_loss_batched_plain))
        comps_gb = args[6].numel() * args[6].element_size() / 1e9
        plane_gb = sum(a.numel() * a.element_size() for a in args[1:6]) / 1e9
        log(f"    forward: batched kernel {out['fwd_ms']:.4f} ms ({comps_gb:.3f} GB comps + "
            f"{plane_gb:.3f} GB planes read, {(comps_gb + plane_gb) / out['fwd_ms']:.2f} TB/s "
            f"with v written aside), plain {out['plain_fwd_ms']:.4f} ms, {nbatch} one-slice "
            f"launches {out['single_launches_ms']:.4f} ms; forward+backward: kernel "
            f"{out['fwdbwd_ms']:.4f} ms, plain {out['plain_fwdbwd_ms']:.4f} ms "
            "(median of 20 samples of 5 back-to-back calls)")
    return out


def phase_kernel_vs_plain(main_shape):
    import torch

    log("== phase 3: kernel against plain (loss rel 1e-5, v 1e-5 x max|v|, grads rel 1e-4)")
    results = {}
    for dt in (torch.float32, torch.bfloat16):
        results[dt] = compare_kernel(main_shape, dt, timed=True)
        for shape in ((5, 37, 3), (7, 129, 130), (1, 1, 1)):
            compare_kernel(shape, dt, timed=False)
    torch.cuda.empty_cache()
    log("   batched form: N slices share one comps read (per-slice loss rel 1e-5, "
        "v 1e-5 x max|v|, grads rel 1e-4)")
    batched = {}
    f32, bf16 = torch.float32, torch.bfloat16
    for cdt in (f32, bf16):
        for wdt in (f32, bf16):
            batched[(cdt, wdt)] = compare_batched(8, main_shape, cdt, wdt,
                                                  timed=wdt == f32)
            torch.cuda.empty_cache()
            for n in (1, 3):
                for shape in ((5, 37, 3), (7, 129, 130), (1, 1, 1)):
                    batched[(n, shape, cdt, wdt)] = compare_batched(n, shape, cdt, wdt, False)
            batched[("view", cdt, wdt)] = compare_batched(3, (7, 129, 130), cdt, wdt, False,
                                                          extra=5)
    ngrps = main_shape[0]
    batched["main_view"] = compare_batched(8, (ngrps // 2,) + tuple(main_shape[1:]), f32, f32,
                                           False, extra=ngrps - ngrps // 2)
    torch.cuda.empty_cache()
    return results, batched


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


def make_corrupted_file(path, ntimes=NTIMES, npols=1):
    from calamity_tpu import cal_utils, models, simulate

    rng = np.random.default_rng(SEED)
    antpos = random_disc_array(rng)
    freqs = F0_HZ + DF_HZ * np.arange(NFREQS)
    uvd = simulate.make_visdata(antpos, freqs, ntimes=ntimes, npols=npols, nsrc=NSRC, seed=SEED)
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

    from calamity_tpu.io import CalData, VisData
    from calamity_tpu_torch import LAUNCHES
    from calamity_tpu_torch.calibration import read_calibrate_and_model_dpss
    from calamity_tpu_torch.ops.fused import KERNEL_NAME

    log(f"== phase 4: main path, {NANTS} antennas, {NFREQS} channels, {NTIMES} times")
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
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    fallbacks = [str(w.message) for w in caught if "fused kernel" in str(w.message)]
    check(not fallbacks, f"chunks left out by the kernel gate: {fallbacks}")
    hists = info[0]  # fit histories by polarization index, then time index
    recorded = 0
    for t, h in sorted(hists.items()):
        steps = h["phase_steps"]
        recorded += len(h["loss"])
        rates = [1e3 * s / max(n, 1) for s, n in zip(h["phase_seconds"], steps)]
        log(f"  time {t}: phase steps (bf16, f32) {steps}, ms/step "
            f"{', '.join(f'{r:.3f}' for r in rates)} (host clock, incl. per-step sync); "
            f"loss {h['loss'][0]:.6e} -> {h['loss'][-1]:.6e}")
    log(f"  host seconds: " + ", ".join(f"{k} {v:.2f}" for k, v in sorted(timings.items()))
        + f"; read_calibrate_and_model_dpss in all {wall:.1f}")
    log(f"  peak device memory {peak_gb:.3f} GB; {KERNEL_NAME} launches {launches}, "
        f"recorded steps {recorded}")
    check(launches >= recorded, f"{launches} kernel launches < {recorded} recorded steps")
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
    log("  output files read back through calamity_tpu.io and match")
    return {"launches": launches, "recorded": recorded, "uvd": uvd, "comps": comps,
            "path": path}


# ---------------------------------------------------------------------- #
# phase 5: kernel against plain inside the loop, and the per-step host check
# ---------------------------------------------------------------------- #
def phase_in_loop(main):
    import torch

    from calamity_tpu import cal_utils
    from calamity_tpu_torch.solver import fit as fitmod
    from calamity_tpu_torch.solver.optimizers import get_optimizer
    from calamity_tpu_torch.solver.tensorize import FitSpec

    log(f"== phase 5: {N_LOOP_STEPS} recorded float32 steps, chunks on the card vs a CPU copy "
        "(histories rel 1e-4)")
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
    fg_r = tuple(spec.init_coeffs(data_r, wgts))
    fg_i = tuple(spec.init_coeffs(data_i, wgts))
    chunks = spec.device_chunks()
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
    check(not [w for w in caught if "fused kernel" in str(w.message)], "gate fallbacks")
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
    from calamity_tpu import models, simulate
    from calamity_tpu.io import CalData, VisData
    from calamity_tpu_torch import LAUNCHES
    from calamity_tpu_torch.ops.fused import KERNEL_NAME, explain_fused_loss_inapplicable
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
        coeffs = c.new_zeros((a0.shape[0], c.shape[-1]))
        reason = explain_fused_loss_inapplicable(c, coeffs, data_r[cnum], wgts[cnum])
        log(f"  chunk {cnum}: comps {tuple(c.shape)}, groups {a0.shape[0]}: "
            f"{'kernel' if reason is None else 'plain (' + reason + ')'}")
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
    from calamity_tpu.io import CalData, VisData
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
def phase_time_parallel(tmp):
    import torch

    from calamity_tpu.io import CalData, VisData
    from calamity_tpu_torch import LAUNCHES
    from calamity_tpu_torch.calibration import (
        POLL_EVERY,
        calibrate_and_model_dpss,
        read_calibrate_and_model_dpss,
    )
    from calamity_tpu_torch.ops.fused import KERNEL_NAME

    nslices = TP_NTIMES * TP_NPOLS
    log(f"== phase 7: time-parallel path, {NANTS} antennas, {NFREQS} channels, {TP_NTIMES} "
        f"times x {TP_NPOLS} polarizations = {nslices} slices in one batched descent")
    path = os.path.join(tmp, "tp.uvh5")
    t0 = time.time()
    uvd, comps = make_corrupted_file(path, TP_NTIMES, TP_NPOLS)
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
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    fallbacks = [str(w.message) for w in caught if "fused kernel" in str(w.message)]
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
    log(f"  peak device memory {peak_gb:.3f} GB; {KERNEL_NAME} launches {launches}, recorded "
        f"batch steps {recorded} + {warmups} warm-up steps")
    # every step of both phases launched the batched kernel once (a block
    # of host polls may run up to POLL_EVERY - 1 steps past the last freeze,
    # which are undone)
    check(recorded + warmups <= launches <= recorded + warmups * POLL_EVERY,
          f"{launches} launches for {recorded} recorded + {warmups} warm-up steps")
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
    log("  output files read back through calamity_tpu.io and match")

    # two of the slices (the first time, both polarizations) on the serial path
    t_first = np.unique(uvd.time_array)[0]
    sub = uvd.select(times=[t_first], inplace=False)
    t0 = time.time()
    _, resid_s, _, info_s = calibrate_and_model_dpss(uvdata=sub, min_dly=MIN_DLY_NS,
                                                     offset=MIN_DLY_NS, **kw)
    torch.cuda.synchronize()
    log(f"  serial path on 2 of the slices: {time.time() - t0:.1f} s")
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
    return {"launches": launches}


def main():
    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False; this smoke test needs a CUDA card",
              file=sys.stderr)
        sys.exit(2)
    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, repo)
    import calamity_tpu_torch  # noqa: F401  (raises outside a checkout)
    from calamity_tpu_torch.ops.fused import KERNEL_NAME

    os.environ.setdefault("TQDM_DISABLE", "1")  # no progress bars in the log
    t_start = time.time()
    phase_environment()
    phase_build()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        t0 = time.time()
        path = os.path.join(tmp, "main.uvh5")
        uvd, comps = make_corrupted_file(path)
        log(f"== set-up: simulated {uvd.Nbls} baselines x {uvd.Ntimes} times x {uvd.Nfreqs} "
            f"channels and wrote the uvh5 file in {time.time() - t0:.1f} s (host)")
        check(uvd.Nbls == NANTS * (NANTS - 1) // 2, f"expected 2016 baselines, got {uvd.Nbls}")
        shapes = main_chunk_shapes(comps)
        check(len(shapes) == 1 and shapes[0][1] == 1, f"expected one dense B=1 chunk: {shapes}")
        ngrps, _, nfreqs, nvecs = shapes[0]
        results, batched = phase_kernel_vs_plain((ngrps, nfreqs, nvecs))
        main_out = phase_main_path(tmp, path, uvd, comps)
        phase_in_loop(main_out)
        phase_cli(tmp, repo)
        tp_out = phase_time_parallel(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check("jax" not in sys.modules, "jax was imported")
    n8 = batched[(torch.float32, torch.float32)]
    # the largest abs error of v or a loss, kernel against plain, over phase 3
    errs = [r["max_abs_err"] for r in list(results.values()) + list(batched.values())]
    kernels = [{
        "name": KERNEL_NAME,
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": main_out["launches"] + tp_out["launches"],
        "launches_by_path": {"serial": main_out["launches"],
                             "time_parallel": tp_out["launches"]},
        "max_abs_err": max(errs),
        "ms": n8["fwd_ms"],
        "plain_ms": n8["plain_fwd_ms"],
        "n_single_slice_launches_ms": n8["single_launches_ms"],
        "one_slice_ms": results[torch.float32]["fwd_ms"],
        "one_slice_plain_ms": results[torch.float32]["plain_fwd_ms"],
    }]
    log(f"total {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
