#!/usr/bin/env python
"""The HERA-core configuration on the PyTorch/CUDA port, on one card.

The port's counterpart of ``examples/hera_core_demo.py``, with the same
flags and defaults plus ``--device``: a 19 x 19 grid core of 361 antennas
at 14.6 m (HERA's dish pitch), the baselines up to ``--bllen_max`` 45 m
(4388 baselines, 14 unique spacings), 1536 channels of 100 kHz from 100
MHz, a 50-source point sky per unique spacing projected onto its DPSS
basis (min_dly = offset = 10 ns), 3% complex gain errors from
``default_rng(11)``, then ``calibrate_and_model_dpss`` with the default
shared-basis packing (``shared_basis=True``: every baseline of one length
shares one operator, in shared and shared-batched chunks),
``nvec_bucketing``, ``post_hoc`` regularization, lr 1e-2, tol 1e-11,
maxsteps 3000, patience 500 with ``use_min``, ``correct_resid`` and
``correct_model``, and the default mixed schedule. The array is built
with the port's own host layer; nothing of the JAX package is imported.

    python scripts/hera_core_demo_torch.py                        # on the card
    python scripts/hera_core_demo_torch.py --device cpu --nside 5 --nfreqs 64

``--backend cpu`` is taken as ``--device cpu``. ``chip_smoke.py`` phase 10
runs :func:`build` and :func:`fit` at full width on the card.
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

MIN_DLY_NS = 10.0  # = offset
SEED_GAINS = 11
SEED_SKY = 1


def build(nside=19, spacing=14.6, bllen_max=45.0, nfreqs=1536, nsrc=50):
    """The corrupted grid-core data and its DPSS components:
    ``(corrupted VisData, comps dict, facts)``, ``facts`` holding the
    antenna, baseline and unique-spacing counts and the host seconds of the
    simulation, the basis and the projection."""
    from calamity_tpu_torch import cal_utils, models, simulate
    from calamity_tpu_torch.io.visdata import VisData

    rng = np.random.default_rng(SEED_GAINS)
    xs, ys = np.meshgrid(np.arange(nside), np.arange(nside))
    antpos = np.zeros((nside * nside, 3))
    antpos[:, 0] = xs.ravel() * spacing
    antpos[:, 1] = ys.ravel() * spacing
    nants = nside * nside
    pairs, vecs = [], []
    for i in range(nants):
        for j in range(i + 1, nants):
            v = antpos[j] - antpos[i]
            if np.linalg.norm(v) <= bllen_max:
                pairs.append((i, j))
                vecs.append(v)
    vecs = np.asarray(vecs)
    nbls = len(pairs)
    uniq, inverse = np.unique(np.round(vecs, 6), axis=0, return_inverse=True)
    inverse = inverse.reshape(-1)

    t0 = time.time()
    freqs = 100e6 + 100e3 * np.arange(nfreqs)
    vis_uniq = simulate.point_source_visibilities(uniq, freqs, nsrc=nsrc, seed=SEED_SKY)
    t_sim = time.time() - t0
    data = vis_uniq[inverse]
    uvd = VisData(
        telescope_name="HERA-CORE-SIM",
        instrument="HERA-CORE-SIM",
        latitude=simulate.HERA_LAT,
        longitude=simulate.HERA_LON,
        altitude=simulate.HERA_ALT,
        channel_width=100e3,
        ant_1_array=np.asarray([p[0] for p in pairs], dtype=np.int64),
        ant_2_array=np.asarray([p[1] for p in pairs], dtype=np.int64),
        antenna_numbers=np.arange(nants, dtype=np.int64),
        antenna_names=[f"ANT{i}" for i in range(nants)],
        antenna_positions=simulate._enu_to_ecef_rel(antpos, simulate.HERA_LAT,
                                                    simulate.HERA_LON),
        freq_array=freqs[None, :],
        integration_time=np.full(nbls, 10.7),
        lst_array=np.zeros(nbls),
        polarization_array=np.asarray([-5], dtype=np.int64),
        time_array=np.full(nbls, 2459122.25),
        uvw_array=vecs,
        data_array=data[:, None, :, None].astype(np.complex128),
        flag_array=np.zeros((nbls, 1, nfreqs, 1), dtype=bool),
        nsample_array=np.ones((nbls, 1, nfreqs, 1), dtype=np.float32),
    )

    t0 = time.time()
    comps = models.yield_pbl_dpss_model_comps(uvd, min_dly=MIN_DLY_NS, offset=MIN_DLY_NS)
    t_basis = time.time() - t0
    t0 = time.time()
    cache = {}
    lengths = np.linalg.norm(uniq, axis=1)
    for u in range(len(uniq)):
        mat = models.yield_dpss_model_comps_bl_grp(lengths[u], freqs, min_dly=MIN_DLY_NS,
                                                   offset=MIN_DLY_NS, operator_cache=cache)
        vis_uniq[u] = mat @ (mat.T @ vis_uniq[u])
    uvd.data_array = vis_uniq[inverse][:, None, :, None].astype(np.complex128)
    t_proj = time.time() - t0

    truth = cal_utils.blank_uvcal_from_uvdata(uvd)
    truth.gain_array = truth.gain_array * (
        1 + 0.03 * rng.standard_normal(truth.gain_array.shape)
        + 0.03j * rng.standard_normal(truth.gain_array.shape)
    )
    corrupted = cal_utils.apply_gains(uvd, truth, inverse=True)
    facts = dict(nants=nants, nbls=nbls, nuniq=len(uniq), simulate_s=t_sim, basis_s=t_basis,
                 project_s=t_proj)
    return corrupted, comps, facts


def chunk_layouts(uvd, comps, shared_basis=True, nvec_bucketing=True):
    """The chunks ``calibrate_and_model_dpss`` packs for these arguments,
    as dicts: ``kind`` (dense, shared or shared-batched), ``U`` operators,
    ``gmax`` groups an operator, ``B`` baselines a group, ``F`` channels,
    ``V`` modes and ``groups``. Packed on the host (the same ``FitSpec``
    the fit builds)."""
    from calamity_tpu_torch import cal_utils
    from calamity_tpu_torch.solver.tensorize import FitSpec

    gains = cal_utils.blank_uvcal_from_uvdata(uvd)
    spec = FitSpec(uvd, comps, {int(a): i for i, a in enumerate(gains.ant_array)}, device="cpu",
                   nvec_bucketing=nvec_bucketing, shared_basis=shared_basis)
    out = []
    for comps_c, a0, _ in spec.device_chunks():
        nu, nbl, nf, nv = comps_c.shape
        ngrps = a0.shape[0]
        kind = ("dense" if nu == ngrps else "shared" if nu == 1 else "shared-batched")
        out.append(dict(kind=kind, U=nu, gmax=ngrps // nu, B=nbl, F=nf, V=nv, groups=ngrps))
    return out


def fit(corrupted, comps, device="cuda", maxsteps=3000, tol=1e-11, patience=500,
        comps_precision=None, shared_basis=True, dtype=np.float32, timings=None,
        model_regularization="post_hoc"):
    """``calibrate_and_model_dpss`` on the corrupted core with the demo's
    settings (``model_regularization="sum"``: the entry point's default
    flux prior instead of the demo's post_hoc): (model, resid, gains, fit
    history)."""
    from calamity_tpu_torch import calibration

    return calibration.calibrate_and_model_dpss(
        uvdata=corrupted,
        gains=None,
        fg_model_comps_dict=comps,
        maxsteps=maxsteps,
        comps_precision=comps_precision,
        tol=tol,
        patience=patience,
        use_min=patience > 0,
        learning_rate=1e-2,
        correct_resid=True,
        correct_model=True,
        model_regularization=model_regularization,
        nvec_bucketing=True,
        shared_basis=shared_basis,
        dtype=dtype,
        device=device,
        timings=timings,
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nside", type=int, default=19, help="grid side (nants = nside^2)")
    ap.add_argument("--spacing", type=float, default=14.6)
    ap.add_argument("--bllen_max", type=float, default=45.0)
    ap.add_argument("--nfreqs", type=int, default=1536)
    ap.add_argument("--nsrc", type=int, default=50)
    ap.add_argument("--maxsteps", type=int, default=3000)
    ap.add_argument("--tol", type=float, default=1e-11)
    ap.add_argument("--patience", type=int, default=500,
                    help="stop when the loss has not improved for this many steps and return "
                         "the tracked argmin (use_min); 0 restores reference semantics")
    ap.add_argument("--backend", default="default", choices=["cpu", "default"],
                    help="cpu: the same as --device cpu")
    ap.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    ap.add_argument("--comps_precision", default=None,
                    choices=["float32", "bfloat16", "mixed"],
                    help="basis storage precision for the descent")
    args = ap.parse_args()
    device = "cpu" if args.backend == "cpu" else args.device

    def stage(label):
        print(f"[{time.strftime('%H:%M:%S')}] {label}", file=sys.stderr, flush=True)

    stage("building the grid core")
    corrupted, comps, facts = build(args.nside, args.spacing, args.bllen_max, args.nfreqs,
                                    args.nsrc)
    stage(f"{facts['nants']} antennas, {facts['nbls']} baselines <= {args.bllen_max} m, "
          f"{facts['nuniq']} unique spacings")
    for c in chunk_layouts(corrupted, comps):
        stage(f"chunk: {c}")
    stage(f"fitting on {device}")
    timings = {}
    t0 = time.time()
    model, resid, gains, info = fit(corrupted, comps, device, args.maxsteps, args.tol,
                                    args.patience, args.comps_precision, timings=timings)
    t_fit = time.time() - t0

    def rms(x):
        return np.sqrt(np.mean(np.abs(x) ** 2))

    hist = info[0][0]
    nsteps = len(hist["loss"])
    print(f"\n=== HERA-core demo (port): {facts['nants']} ants / {facts['nbls']} baselines / "
          f"{args.nfreqs} channels / {facts['nuniq']} unique spacings on {device} ===")
    print(f"simulate  : {facts['simulate_s']:7.1f}s")
    print(f"basis     : {facts['basis_s']:7.1f}s")
    print(f"project   : {facts['project_s']:7.1f}s")
    print(f"fit       : {t_fit:7.1f}s ({nsteps} steps; phase steps {hist['phase_steps']}, "
          f"ms/step " + ", ".join(f"{1e3 * s / max(n, 1):.3f}" for s, n in
                                  zip(hist["phase_seconds"], hist["phase_steps"])) + ")")
    print(f"loss      : {hist['loss'][0]:.3e} -> {hist['loss'][-1]:.3e}")
    print(f"model/resid: {rms(model.data_array) / rms(resid.data_array):.1f}x")
    print(f"data/resid : {rms(corrupted.data_array) / rms(resid.data_array):.1f}x")


if __name__ == "__main__":
    main()
