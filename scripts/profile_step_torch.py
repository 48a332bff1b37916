#!/usr/bin/env python
"""Where a descent step of calamity_tpu_torch spends its time, on one GPU.

    python3 scripts/profile_step_torch.py

Run from the root of a checkout on a machine with a CUDA card. It builds
the main-path problem of ``chip_smoke.py`` (64 antennas, 2016 dense B=1
groups, 1536 channels), packs the first time slice on the card, and for the
bf16-comps and float32 phases of the mixed schedule times 50 descent steps
(after 20 warm-up steps) under ``torch.profiler``: device time per step by
kernel, kernels per step, and the device's idle share against the host
clock. It then times the same 50 steps without the profiler.
"""

import os
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import calamity_tpu_torch  # noqa: E402,F401  (first: registers the HDF5 fallback)
import chip_smoke  # noqa: E402
from calamity_tpu import cal_utils  # noqa: E402
from calamity_tpu_torch.solver import fit as fitmod  # noqa: E402
from calamity_tpu_torch.solver.optimizers import get_optimizer  # noqa: E402
from calamity_tpu_torch.solver.tensorize import FitSpec  # noqa: E402

NSTEPS = 50
NWARMUP = 20


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    with tempfile.TemporaryDirectory() as tmp:
        uvd, comps = chip_smoke.make_corrupted_file(os.path.join(tmp, "main.uvh5"))
    gains = cal_utils.blank_uvcal_from_uvdata(uvd)
    spec = FitSpec(uvd, comps, {int(a): i for i, a in enumerate(gains.ant_array)},
                   device="cuda")
    t0 = spec.times[0]
    rows = np.isclose(uvd.time_array, t0, rtol=0.0, atol=1e-7)
    rms = np.sqrt(np.mean(np.abs(uvd.data_array[rows, 0, :, 0]) ** 2))
    dr, di, w = spec.pack_data(uvd, "xx", t0, data_scale_factor=rms)
    g_r, g_i = spec.pack_gains(gains, "xx", t0)
    fr, fi = tuple(spec.init_coeffs(dr, w)), tuple(spec.init_coeffs(di, w))
    chunks = spec.device_chunks()
    print(f"chunks {[tuple(c.shape) for c, _, _ in chunks]}")
    phases = (("bf16", fitmod.convert_chunks_dtype(chunks, torch.bfloat16)), ("f32", chunks))
    for name, chs in phases:
        cfg = fitmod.FitConfig(tol=0.0)
        loss_fn = fitmod.make_loss_fn(cfg, chs, dr, di, w, fr, fi, None, None)
        opt = get_optimizer("Adamax", learning_rate=1e-2)
        state = {"params": fitmod.init_params(cfg, g_r, g_i, fr, fi)}
        state["opt"] = opt.init(state["params"])

        def step():
            loss, grads = fitmod.value_and_grad(loss_fn, state["params"])
            state["params"], state["opt"] = opt.update(grads, state["opt"], state["params"])
            loss.item()  # the descent's per-step host read

        for _ in range(NWARMUP):
            step()
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            start = time.perf_counter()
            for _ in range(NSTEPS):
                step()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - start) / NSTEPS
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / NSTEPS
        print(f"== {name} step: host clock {wall_ms:.3f} ms/step under the profiler; "
              f"device {dev_ms:.3f} ms/step in {sum(e.count for e in kernels) / NSTEPS:.0f} "
              f"kernels; idle share {1 - dev_ms / wall_ms:.3f}")
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
            print(f"  {e.self_device_time_total / 1e3 / NSTEPS:8.4f} ms/step "
                  f"x{e.count / NSTEPS:<5.1f} {e.key[:90]}")
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(NSTEPS):
            step()
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - start) / NSTEPS
        print(f"  host clock without the profiler {plain_ms:.3f} ms/step; idle share "
              f"{1 - dev_ms / plain_ms:.3f}")
    print(chip_smoke.nvidia_smi_line())


if __name__ == "__main__":
    main()
