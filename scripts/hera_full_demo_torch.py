#!/usr/bin/env python
"""The full HERA array on the PyTorch/CUDA port, on one card.

The port's counterpart of ``examples/hera_full_demo.py``, with the same
flags, defaults and seeds; ``--backend`` becomes ``--device``: a complete
hexagonal lattice (``--rings`` 10: 331 antennas at HERA's 14.6 m pitch),
EVERY cross baseline (54,615), 1536 channels of 100 kHz from 100 MHz, a
50-source point sky per unique spacing (630 of them, ``seed=1``) projected
onto its DPSS basis (min_dly = offset = 10 ns; the projection's operator
cache shared with the component dict), tiled over ``--ntimes`` times, 3%
complex gain errors from ``default_rng(13)``, then
``calibrate_and_model_dpss`` with the demo's arguments: the default
shared-basis packing with ``nvec_bucketing``, ``remat=True``, post_hoc
regularization, lr 1e-2, tol 1e-11, maxsteps 2000, patience 500 with
``use_min``, ``correct_resid`` and ``correct_model``, the mixed schedule;
optionally time-parallel (``--time_parallel``, with ``--warm_start_times``
the warm-started scan), RFI-like channel bands flagged from
``default_rng(99)`` (``--rfi_flag_frac``), bfloat16 weights, group blocks
of the loss (``--loss_block_ngrps``), checkpoints, and the ('data', 'bl')
mesh (``--mesh`` under ``torchrun``: NCCL on ``cuda:LOCAL_RANK``, gloo
with ``--device cpu``). The array is built with the port's own host
layer; nothing of the JAX package is imported.

    python scripts/hera_full_demo_torch.py                        # on the card
    python scripts/hera_full_demo_torch.py --device cpu --rings 3 --nfreqs 64

``--prep_cache DIR`` keeps the prepared inputs (the corrupted data as
uvh5, the component dict, ``meta.npz`` written last); a later run with the
same configuration reloads them, a cache of more times serves a run of
fewer (their leading subset), and any other difference exits naming it.
``--prep_only`` fills the cache and exits without touching the device.
``chip_smoke.py`` phase 13 runs :func:`build`, :func:`rfi_flags` and
:func:`fit` at full width on the card.
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

MIN_DLY_NS = 10.0  # = offset
SEED_GAINS = 13
SEED_SKY = 1
SEED_RFI = 99


def hex_lattice(rings, pitch):
    """(nants, 3) east-north-up positions of a complete hexagonal lattice of
    ``rings`` rings (3 r (r + 1) + 1 antennas) at ``pitch`` metres."""
    pts = []
    for i in range(-rings, rings + 1):
        for j in range(-rings, rings + 1):
            if abs(i + j) <= rings:
                pts.append((pitch * (i + j / 2.0), pitch * j * np.sqrt(3) / 2.0, 0.0))
    return np.asarray(pts)


def build(rings=10, pitch=14.6, nfreqs=1536, nsrc=50, ntimes=1, data_dtype="complex64"):
    """The corrupted lattice data and its DPSS components, built as the
    demo builds them: ``(corrupted VisData, comps dict, facts)``, ``facts``
    holding the antenna, baseline, unique-spacing and operator counts and
    the host seconds of the simulation with its projection (``simulate_s``),
    the component dict (``basis_s``) and the gain corruption
    (``corrupt_s``)."""
    from calamity_tpu_torch import cal_utils, models, simulate
    from calamity_tpu_torch.io.visdata import VisData

    rng = np.random.default_rng(SEED_GAINS)
    antpos = hex_lattice(rings, pitch)
    nants = len(antpos)
    iu, ju = np.triu_indices(nants, k=1)
    vecs = antpos[ju] - antpos[iu]
    nbls = len(vecs)
    uniq, inverse = np.unique(np.round(vecs, 6), axis=0, return_inverse=True)
    inverse = inverse.reshape(-1)

    t0 = time.time()
    freqs = 100e6 + 100e3 * np.arange(nfreqs)
    vis_uniq = simulate.point_source_visibilities(uniq, freqs, nsrc=nsrc, seed=SEED_SKY)
    cache = {}
    lengths = np.linalg.norm(uniq, axis=1)
    for u in range(len(uniq)):
        mat = models.yield_dpss_model_comps_bl_grp(lengths[u], freqs, min_dly=MIN_DLY_NS,
                                                   offset=MIN_DLY_NS, operator_cache=cache)
        vis_uniq[u] = mat @ (mat.T @ vis_uniq[u])
    data = vis_uniq[inverse]
    t_sim = time.time() - t0
    noperators = len(cache)

    uvd = VisData(
        telescope_name="HERA-FULL-SIM",
        instrument="HERA-FULL-SIM",
        latitude=simulate.HERA_LAT,
        longitude=simulate.HERA_LON,
        altitude=simulate.HERA_ALT,
        channel_width=100e3,
        ant_1_array=np.tile(iu, ntimes).astype(np.int64),
        ant_2_array=np.tile(ju, ntimes).astype(np.int64),
        antenna_numbers=np.arange(nants, dtype=np.int64),
        antenna_names=[f"ANT{i}" for i in range(nants)],
        antenna_positions=simulate._enu_to_ecef_rel(antpos, simulate.HERA_LAT,
                                                    simulate.HERA_LON),
        freq_array=freqs[None, :],
        integration_time=np.full(nbls * ntimes, 10.7),
        lst_array=np.zeros(nbls * ntimes),
        polarization_array=np.asarray([-5], dtype=np.int64),
        time_array=np.repeat(2459122.25 + 2.0 * np.arange(ntimes), nbls),
        uvw_array=np.tile(vecs, (ntimes, 1)),
        data_array=np.tile(data[:, None, :, None], (ntimes, 1, 1, 1)).astype(
            np.dtype(data_dtype)),
        flag_array=np.zeros((nbls * ntimes, 1, nfreqs, 1), dtype=bool),
        nsample_array=np.ones((nbls * ntimes, 1, nfreqs, 1), dtype=np.float32),
    )
    del data, vis_uniq

    t0 = time.time()
    # the projection's operator cache: each distinct delay width costs one
    # tridiagonal eigendecomposition at the full band
    comps = models.yield_pbl_dpss_model_comps(uvd, min_dly=MIN_DLY_NS, offset=MIN_DLY_NS,
                                              operator_cache=cache)
    t_basis = time.time() - t0

    t0 = time.time()
    truth = cal_utils.blank_uvcal_from_uvdata(uvd)
    truth.gain_array = truth.gain_array * (
        1 + 0.03 * rng.standard_normal(truth.gain_array.shape)
        + 0.03j * rng.standard_normal(truth.gain_array.shape)
    )
    corrupted = cal_utils.apply_gains(uvd, truth, inverse=True)
    facts = dict(nants=nants, nbls=nbls, nuniq=len(uniq), noperators=noperators,
                 simulate_s=t_sim, basis_s=t_basis, corrupt_s=time.time() - t0)
    return corrupted, comps, facts


def rfi_flags(corrupted, frac):
    """Flag ``frac`` of the channels in RFI-like contiguous bands, the same
    channels at every time (a persistent transmitter), in place, as the
    demo does: bands of 2-23 channels at random centres from
    ``default_rng(99)`` until the target count is reached. Returns the
    (nfreqs,) mask of flagged channels."""
    frng = np.random.default_rng(SEED_RFI)
    nf = corrupted.Nfreqs
    target = int(frac * nf)
    flagged = np.zeros(nf, dtype=bool)
    while flagged.sum() < target:
        c = int(frng.integers(0, nf))
        w = int(frng.integers(2, 24))
        flagged[max(0, c - w // 2): c + w // 2 + 1] = True
    corrupted.flag_array[:, :, flagged, :] = True
    return flagged


def fit(corrupted, comps, device="cuda", maxsteps=2000, tol=1e-11, patience=500,
        comps_precision=None, wgts_precision="float32", time_parallel=False,
        warm_start_times=False, mesh=None, checkpoint_dir=None, checkpoint_every=1000,
        steps_per_execution=None, loss_block_ngrps=None, dtype=np.float32, timings=None,
        verbose=False):
    """``calibrate_and_model_dpss`` on the corrupted lattice with the demo's
    arguments: (model, resid, gains, fit history)."""
    from calamity_tpu_torch import calibration

    return calibration.calibrate_and_model_dpss(
        uvdata=corrupted,
        gains=None,
        fg_model_comps_dict=comps,
        maxsteps=maxsteps,
        comps_precision=comps_precision,
        wgts_precision=wgts_precision,
        tol=tol,
        learning_rate=1e-2,
        correct_resid=True,
        correct_model=True,
        model_regularization="post_hoc",
        nvec_bucketing=True,
        remat=True,
        time_parallel=time_parallel,
        init_guesses_from_previous_time_step=warm_start_times,
        mesh=mesh,
        timings=timings,
        checkpoint_dir=checkpoint_dir,
        checkpoint_every=checkpoint_every,
        steps_per_execution=steps_per_execution,
        loss_block_ngrps=loss_block_ngrps,
        patience=patience,
        use_min=patience > 0,
        dtype=dtype,
        device=device,
        verbose=verbose,
    )


def _stage(label):
    print(f"[{time.strftime('%H:%M:%S')}] {label}", file=sys.stderr, flush=True)


def prepare(rings=10, pitch=14.6, nfreqs=1536, nsrc=50, ntimes=1, data_dtype="complex64",
            prep_cache=None, prep_only=False, stage=_stage):
    """The fit's inputs ``(corrupted, comps, facts)``: from ``prep_cache``
    where it holds this configuration (a cache of more times gives its
    leading ``ntimes``; any other difference raises ``SystemExit`` naming
    it), else built by :func:`build` and, with ``prep_cache``, written there
    (``corrupted.uvh5``, ``comps.npy``, then ``meta.npz``, which marks the
    cache valid). With ``prep_only`` nothing is returned (None) once the
    cache holds the inputs."""
    from calamity_tpu_torch.io.visdata import VisData

    if prep_only and prep_cache is None:
        raise SystemExit("--prep_only requires --prep_cache")
    key = dict(rings=rings, pitch=pitch, nfreqs=nfreqs, nsrc=nsrc, ntimes=ntimes)
    meta_p = None if prep_cache is None else os.path.join(prep_cache, "meta.npz")
    if meta_p is not None and os.path.isfile(meta_p):
        meta = np.load(meta_p)
        cached_nt = int(meta["ntimes"])
        mismatch = {k: (v, meta[k].item()) for k, v in key.items()
                    if k != "ntimes" and meta[k].item() != v}
        if ntimes > cached_nt:
            mismatch["ntimes"] = (ntimes, cached_nt)
        if mismatch:
            raise SystemExit(f"--prep_cache {prep_cache} was built for a different "
                             f"configuration: {mismatch}")
        if prep_only:
            stage("prep_only: cache already present")
            return None
        stage(f"loading prepared inputs from {prep_cache}")
        t0 = time.time()
        # cast while reading: no full-precision cube beside its cast copy
        corrupted = VisData.from_uvh5(os.path.join(prep_cache, "corrupted.uvh5"),
                                      data_dtype=np.dtype(data_dtype))
        if ntimes < cached_nt:
            keep = np.unique(corrupted.time_array)[:ntimes]
            corrupted.select(times=keep, inplace=True)
            stage(f"  selected {ntimes} of {cached_nt} cached times")
        # a file this program wrote (the comps dict's matrices are shared
        # objects: pickle stores each distinct operator once)
        comps = np.load(os.path.join(prep_cache, "comps.npy"), allow_pickle=True).item()
        facts = {k: meta[k].item() for k in ("nants", "nbls", "nuniq", "noperators",
                                             "simulate_s", "basis_s", "corrupt_s")}
        stage(f"  loaded in {time.time() - t0:.0f}s")
        return corrupted, comps, facts

    stage("simulating + projecting per unique spacing, building the component dict")
    corrupted, comps, facts = build(rings, pitch, nfreqs, nsrc, ntimes, data_dtype)
    stage(f"{facts['nants']} antennas, {facts['nbls']} baselines, {facts['nuniq']} unique "
          f"spacings, {facts['noperators']} distinct operators")
    if prep_cache is not None:
        stage(f"caching prepared inputs to {prep_cache}")
        t0 = time.time()
        os.makedirs(prep_cache, exist_ok=True)
        corrupted.write_uvh5(os.path.join(prep_cache, "corrupted.uvh5"), clobber=True)
        np.save(os.path.join(prep_cache, "comps.npy"), np.asarray(comps, dtype=object),
                allow_pickle=True)
        # meta marks the cache valid: written last and atomically, so an
        # interrupted prep leaves none and the next run rebuilds
        tmp = os.path.join(prep_cache, "meta.tmp.npz")
        np.savez(tmp, **facts, **key)
        os.replace(tmp, meta_p)
        stage(f"  cached in {time.time() - t0:.0f}s")
    if prep_only:
        stage("prep_only: done")
        return None
    return corrupted, comps, facts


def argparser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rings", type=int, default=10, help="hex rings (10 -> 331 ants)")
    ap.add_argument("--pitch", type=float, default=14.6)
    ap.add_argument("--nfreqs", type=int, default=1536)
    ap.add_argument("--nsrc", type=int, default=50)
    ap.add_argument("--maxsteps", type=int, default=2000)
    ap.add_argument("--tol", type=float, default=1e-11)
    ap.add_argument("--backend", default="default", choices=["cpu", "default"],
                    help="cpu: the same as --device cpu")
    ap.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    ap.add_argument("--comps_precision", default=None,
                    choices=["float32", "bfloat16", "mixed"],
                    help="basis storage precision for the descent")
    ap.add_argument("--time_parallel", action="store_true",
                    help="fit every time in one batched descent (sharded over --mesh)")
    ap.add_argument("--warm_start_times", action="store_true",
                    help="with --time_parallel: fit the times in order, each seeded by the "
                         "one before (init_guesses_from_previous_time_step)")
    ap.add_argument("--mesh", default=None,
                    help="'auto' or 'N_DATA,N_BL': shard the fit over a ('data', 'bl') mesh "
                         "of the torchrun group")
    ap.add_argument("--ntimes", type=int, default=1)
    ap.add_argument("--checkpoint_dir", default=None,
                    help="mid-fit checkpoint/resume directory")
    ap.add_argument("--checkpoint_every", type=int, default=1000)
    ap.add_argument("--steps_per_execution", type=int, default=None,
                    help="bound the steps of one descent call (time-parallel paths)")
    ap.add_argument("--prep_cache", default=None,
                    help="directory caching the prepared inputs (corrupted data uvh5 + "
                         "component dict), reloaded by a later run of the same configuration")
    ap.add_argument("--prep_only", action="store_true",
                    help="build and cache the prepared inputs and exit without touching "
                         "the device")
    ap.add_argument("--patience", type=int, default=500,
                    help="freeze a slice when its loss has not improved for this many steps "
                         "(with use_min; 0 off: reference semantics)")
    ap.add_argument("--loss_block_ngrps", type=int, default=None,
                    help="group-block size of the batched loss (bounds activation memory)")
    ap.add_argument("--wgts_precision", default="float32", choices=["float32", "bfloat16"],
                    help="weight-cube storage precision (bfloat16 halves it; matters with "
                         "--rfi_flag_frac, whose weights depend on frequency)")
    ap.add_argument("--rfi_flag_frac", type=float, default=0.0,
                    help="flag this fraction of channels in RFI-like bands (every time)")
    ap.add_argument("--data_dtype", default="complex64", choices=["complex64", "complex128"],
                    help="host storage dtype of the visibility cubes (the fit computes in "
                         "float32 either way)")
    return ap


def main(argv=None):
    args = argparser().parse_args(argv)
    device = "cpu" if args.backend == "cpu" else args.device
    prepared = prepare(args.rings, args.pitch, args.nfreqs, args.nsrc, args.ntimes,
                       args.data_dtype, args.prep_cache, args.prep_only)
    if prepared is None:
        return
    corrupted, comps, facts = prepared
    if args.rfi_flag_frac > 0:
        flagged = rfi_flags(corrupted, args.rfi_flag_frac)
        _stage(f"RFI flags: {int(flagged.sum())}/{corrupted.Nfreqs} channels in bands")

    import torch

    from calamity_tpu_torch.calibration import resolve_device
    from calamity_tpu_torch.parallel.mesh import init_distributed_from_env, make_mesh, mesh_shape
    from calamity_tpu_torch.utils import rss_gib

    device = resolve_device(device)
    mesh, own_group = None, False
    if args.mesh is not None:
        device, own_group = init_distributed_from_env(device)
        if args.mesh == "auto":
            mesh = make_mesh()
        else:
            n_data, n_bl = (int(x) for x in args.mesh.split(","))
            mesh = make_mesh(n_data=n_data, n_bl=n_bl)
        _stage(f"mesh: {mesh_shape(mesh)} over {torch.distributed.get_world_size()} ranks")
    try:
        on_card = torch.device(device).type == "cuda"
        if on_card:
            torch.cuda.reset_peak_memory_stats(device)
        _stage(f"fitting on {device} (time_parallel={args.time_parallel})")
        timings = {}
        t0 = time.time()
        model, resid, gains, info = fit(
            corrupted, comps, device=device, maxsteps=args.maxsteps, tol=args.tol,
            patience=args.patience, comps_precision=args.comps_precision,
            wgts_precision=args.wgts_precision, time_parallel=args.time_parallel,
            warm_start_times=args.warm_start_times, mesh=mesh,
            checkpoint_dir=args.checkpoint_dir, checkpoint_every=args.checkpoint_every,
            steps_per_execution=args.steps_per_execution,
            loss_block_ngrps=args.loss_block_ngrps, timings=timings, verbose=True)
        t_fit = time.time() - t0
        peak = torch.cuda.max_memory_allocated(device) / 2**30 if on_card else None
    finally:
        if own_group:
            torch.distributed.destroy_process_group()

    def rms(x):
        return np.sqrt(np.mean(np.abs(x) ** 2))

    hist = info[0][0]
    nsteps = len(hist["loss"])
    print(f"\n=== full-HERA demo (port): {facts['nants']} ants / {facts['nbls']} baselines / "
          f"{args.nfreqs} channels / {facts['nuniq']} unique spacings on {device} ===")
    print(f"sim+proj  : {facts['simulate_s']:7.1f}s")
    print(f"basis     : {facts['basis_s']:7.1f}s")
    print(f"packing   : {timings.get('packing_s', float('nan')):7.2f}s "
          "(FitSpec: chunk tensors + row/conj tables)")
    print(f"fit       : {t_fit:7.1f}s ({nsteps} steps, {1e3 * t_fit / max(nsteps, 1):.2f} "
          "ms/step incl. build+packing)")
    if "writeback_s" in timings:
        print(f"write-back: {timings['writeback_s']:7.1f}s (host RSS at end "
              f"{timings.get('writeback_rss_gib', float('nan')):.1f} GiB)")
    stages = {k: v for k, v in timings.items() if k.endswith("_s") and k != "writeback_s"}
    if stages:
        print("--- per-stage wall-clock ---")
        for k, v in stages.items():
            print(f"  {k:36s}: {v:8.1f}s")
    if "phase_steps" in timings:
        print(f"  {'phase steps, ms/step':36s}: {timings['phase_steps']}, "
              + ", ".join(f"{1e3 * s / max(n, 1):.3f}"
                          for s, n in zip(timings["phase_seconds"], timings["phase_steps"])))
    print(f"loss      : {hist['loss'][0]:.3e} -> {hist['loss'][-1]:.3e}")
    print(f"model/resid: {rms(model.data_array) / rms(resid.data_array):.1f}x")
    print(f"data/resid : {rms(corrupted.data_array) / rms(resid.data_array):.1f}x")
    if peak is not None:
        print(f"device mem : {peak:6.2f} GiB peak allocated ({torch.cuda.get_device_name(device)})")
    print(f"host RSS  : {rss_gib():6.1f} GiB (data dtype {args.data_dtype})")


if __name__ == "__main__":
    main()
