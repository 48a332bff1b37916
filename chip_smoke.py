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
   shapes, float32 and bfloat16 comps, with times;
4. the main path at full size: 64 antennas (2016 baselines), 1536 channels,
   2 times, through ``read_calibrate_and_model_dpss`` with every chunk dense
   (``shared_basis=False``), the CLI's ``post_hoc`` regularization and the
   default ``mixed`` schedule;
5. 50 recorded descent steps on that data with the chunks on the card and
   with a CPU copy (the plain version), histories compared; and the cost of
   the per-step host check of the stop conditions;
6. the port's CLI script with its default flags on a small Golomb file.

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
NSRC = 50
GAIN_ERR = 0.03
MIN_DLY_NS = 2.0 / 0.3  # = offset: the repo's tests' DPSS delay settings
MAXSTEPS = 3000  # per phase of the mixed schedule
TOL = 1e-11
N_LOOP_STEPS = 50
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
    out = {"v_max_abs_err": v_err}
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


def phase_kernel_vs_plain(main_shape):
    import torch

    log("== phase 3: kernel against plain (loss rel 1e-5, v 1e-5 x max|v|, grads rel 1e-4)")
    results = {}
    for dt in (torch.float32, torch.bfloat16):
        results[dt] = compare_kernel(main_shape, dt, timed=True)
        for shape in ((5, 37, 3), (7, 129, 130), (1, 1, 1)):
            compare_kernel(shape, dt, timed=False)
    torch.cuda.empty_cache()
    return results


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
    """Project each baseline's spectra onto its DPSS subspace in place."""
    for key, mat in comps.items():
        ap = key[0][0]
        rows, conj = uvd._bl_time_rows(ap[0], ap[1])
        d = uvd.data_array[rows, 0, :, 0]
        d = np.conj(d) if conj else d
        proj = (d @ mat) @ mat.T
        uvd.data_array[rows, 0, :, 0] = np.conj(proj) if conj else proj


def main_chunk_shapes(comps):
    from calamity_tpu_torch.solver.tensorize import chunk_fitting_groups

    return [(len(g), nbl, NFREQS, nv) for (nbl, nv), g in chunk_fitting_groups(comps).items()]


def make_corrupted_file(path):
    from calamity_tpu import cal_utils, models, simulate

    rng = np.random.default_rng(SEED)
    antpos = random_disc_array(rng)
    freqs = F0_HZ + DF_HZ * np.arange(NFREQS)
    uvd = simulate.make_visdata(antpos, freqs, ntimes=NTIMES, npols=1, nsrc=NSRC, seed=SEED)
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
    argv = ["calibrate_and_model_dpss_torch.py", "--input_data_files", path,
            "--resid_outfilename", outs[0], "--model_outfilename", outs[1],
            "--gain_outfilename", outs[2], "--min_dly", str(MIN_DLY_NS),
            "--offset", str(MIN_DLY_NS), "--maxsteps", "1500", "--tol", "1e-10", "--clobber"]
    LAUNCHES.reset()
    saved = sys.argv
    sys.argv = argv
    t0 = time.time()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        runpy.run_path(os.path.join(repo, "scripts", "calibrate_and_model_dpss_torch.py"),
                       run_name="__main__")
    sys.argv = saved
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


def main():
    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False; this smoke test needs a CUDA card",
              file=sys.stderr)
        sys.exit(2)
    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, repo)
    import calamity_tpu_torch  # noqa: F401  (raises outside a checkout)
    from calamity_tpu_torch import LAUNCHES
    from calamity_tpu_torch.ops.fused import KERNEL_NAME

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
        results = phase_kernel_vs_plain((ngrps, nfreqs, nvecs))
        main_out = phase_main_path(tmp, path, uvd, comps)
        phase_in_loop(main_out)
        phase_cli(tmp, repo)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check("jax" not in sys.modules, "jax was imported")
    f32 = results[torch.float32]
    kernels = [{
        "name": KERNEL_NAME,
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": main_out["launches"],
        "max_abs_err": max(r["v_max_abs_err"] for r in results.values()),
        "ms": f32["fwd_ms"],
        "plain_ms": f32["plain_fwd_ms"],
    }]
    check(LAUNCHES.get(KERNEL_NAME) > 0, "CLI run launched no kernel")
    log(f"total {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
