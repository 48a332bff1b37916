"""Calibration drivers and CLI argument parsers.

Port of calamity_tpu/calibration.py: the serial per-(pol, time) loop of
``calibrate_and_model_tensor``, its batched time-parallel path
(``time_parallel=True``: every slice in one descent on one device) and its
warm-started time scan (``time_parallel=True`` with
``init_guesses_from_previous_time_step``: the times of each polarization in
order, each fit seeded by the one before), the DPSS, DFT and mixed
drivers, the file driver ``read_calibrate_and_model_dpss`` and the layered
argparsers, on the torch solver, with checkpointed fits and profiler traces
(``n_profile_steps``) on every path. Every driver takes a ``device``
(default "cuda"); the CPU is used only when asked for. The numpy helpers
(``renormalize``, ``_finalize_model_resid``, ``flag_poltime``,
``get_auto_weights``, ``resolve_comps_precision``) are the reference's,
copied unchanged.

The time-parallel paths run sharded over a ('data', 'bl') device mesh
(``mesh=``, ``parallel.mesh``): one process per device, each packing the
whole file and fitting its block, every rank returning the whole result;
with ``mesh=None`` a default process group of more than one rank gets the
auto mesh, as the reference does for more than one device. The serial path
ignores ``mesh``. Under ``torchrun`` the file driver joins the group itself
and rank 0 alone writes the files.
"""

from __future__ import annotations

import argparse
import contextlib
import datetime
import os
from functools import partial

import numpy as np
import torch

from . import cal_utils, models
from ._device import SPANS, resolve_device
from .io.caldata import CalData
from .io.flags import FlagWeights
from .io.polarizations import polstr2num
from .io.visdata import VisData
from .ops.gains import carry_valid
from .ops.loss import fg_model_all_chunks, fg_model_all_chunks_host
from .parallel.mesh import is_writer
from .solver.fit import fit_gains_and_foregrounds
from .solver.graph import POLL_EVERY
from .solver.tensorize import FitSpec, to_numpy
from .utils import echo, host_map, rss_gib, select_baselines

__all__ = [
    "renormalize",
    "flag_poltime",
    "get_auto_weights",
    "resolve_comps_precision",
    "calibrate_and_model_tensor",
    "calibrate_and_model_dpss",
    "calibrate_and_model_dft",
    "calibrate_and_model_mixed",
    "read_calibrate_and_model_dpss",
    "input_output_parser",
    "fitting_argparser",
    "dpss_fit_argparser",
]


def renormalize(uvdata_reference_model, uvdata_deconv, gains, polarization, time,
                additional_flags=None):
    """Fix the overall amplitude degeneracy of a fitted (model, gains) pair.

    Reference parity (calibration.py:313-366): the model is scaled by the
    rms ratio to the reference model over jointly-unflagged samples and the
    gains absorb scale^-1/2. Guards against empty/non-finite selections so
    heavily-flagged poltimes never inject NaNs."""
    polnum = int(
        np.nonzero(
            uvdata_deconv.polarization_array
            == polstr2num(polarization, x_orientation=uvdata_deconv.x_orientation)
        )[0][0]
    )
    bltsel = np.isclose(uvdata_deconv.time_array, time, rtol=0.0, atol=1e-7)
    selection = (
        ~uvdata_deconv.flag_array[bltsel, :, :, polnum]
        & ~uvdata_reference_model.flag_array[bltsel, :, :, polnum]
    )
    if additional_flags is not None:
        selection = selection & ~additional_flags[bltsel, :, :, polnum]
    if not np.any(selection):
        return
    with np.errstate(divide="ignore", invalid="ignore"):
        data_ratio = (
            uvdata_reference_model.data_array[bltsel, :, :, polnum][selection]
            / uvdata_deconv.data_array[bltsel, :, :, polnum][selection]
        )
    data_ratio = np.where(np.isfinite(data_ratio), data_ratio, np.nan)
    if np.all(np.isnan(np.abs(data_ratio))):
        return
    scale_factor = np.sqrt(np.nanmean(np.abs(data_ratio) ** 2.0))
    if not np.isfinite(scale_factor) or scale_factor == 0.0:
        return
    uvdata_deconv.data_array[bltsel, :, :, polnum] *= scale_factor
    polnum_gains = int(
        np.nonzero(
            gains.jones_array
            == polstr2num(polarization, x_orientation=uvdata_deconv.x_orientation)
        )[0][0]
    )
    gindt = int(np.nonzero(np.isclose(gains.time_array, time, rtol=0.0, atol=1e-7))[0][0])
    gains.gain_array[:, :, :, gindt, polnum_gains] *= scale_factor ** -0.5


def _finalize_model_resid(uvdata, model, resid, gains, correct_model, correct_resid):
    """Form resid = data − g·model; optionally calibrate model/resid outputs.

    Reference parity: calibration.py:1322-1331. The gain-corrupted model is
    never materialized as a separate full VisData: the subtraction streams
    per (time, pol) block and the in-place apply_gains variants mutate the
    driver-owned copies."""
    if correct_model:
        cal_utils.subtract_model_with_gains(resid, model, gains)
    else:
        model = cal_utils.apply_gains(model, gains, inverse=True, inplace=True)
        resid.data_array -= model.data_array
        resid.data_array[model.flag_array] = 0.0
    resid.data_array[uvdata.flag_array] = 0.0
    if correct_resid:
        resid = cal_utils.apply_gains(resid, gains, inplace=True)
    return model, resid


def flag_poltime(data_object, time, polarization):
    """Flag one (time, polarization) of a VisData or CalData
    (reference calibration.py:1334-1350)."""
    if isinstance(data_object, VisData):
        bltsel = np.isclose(data_object.time_array, time, rtol=0.0, atol=1e-7)
        polnum = int(
            np.nonzero(
                data_object.polarization_array
                == polstr2num(polarization, x_orientation=data_object.x_orientation)
            )[0][0]
        )
        data_object.flag_array[bltsel, :, :, polnum] = True
        data_object.data_array[bltsel, :, :, polnum] = 0.0
    elif isinstance(data_object, CalData):
        polnum = int(
            np.nonzero(
                data_object.jones_array
                == polstr2num(polarization, x_orientation=data_object.x_orientation)
            )[0][0]
        )
        gindt = int(
            np.nonzero(np.isclose(data_object.time_array, time, rtol=0.0, atol=1e-7))[0][0]
        )
        data_object.gain_array[:, 0, :, gindt, polnum] = 1.0
        data_object.flag_array[:, 0, :, gindt, polnum] = True
    else:
        raise ValueError("only supports data_object that is CalData or VisData.")


def get_auto_weights(uvdata, delay_extent=25.0):
    """Inverse-variance weights from DPSS-smoothed autocorrelations
    (reference calibration.py:916-960).

    Each autocorrelation waterfall is fit to wide DPSS modes (half-width
    ``delay_extent`` ns); cross-baseline weights are 1 / (auto_i * auto_j),
    zeroed at flags. All masked fits are solved as one batched
    normal-equations solve."""
    freqs = np.asarray(uvdata.freq_array[0], dtype=np.float64)
    comps = models.yield_dpss_model_comps_bl_grp(0.0, freqs, offset=delay_extent)
    data_weights = FlagWeights(uvdata, mode="flag")
    pols = uvdata.get_pols()
    auto_ants = [ap[0] for ap in uvdata.get_antpairs() if ap[0] == ap[1]]
    if not auto_ants:
        raise ValueError("no autocorrelations present; cannot build auto weights")

    # (nauto, npol, ntimes, nfreqs) stacked waterfalls + unflagged masks
    D = np.stack(
        [[uvdata.get_data((a, a, pol)).real for pol in pols] for a in auto_ants]
    ).astype(np.float64)
    M = np.stack(
        [[~uvdata.get_flags((a, a, pol)) for pol in pols] for a in auto_ants]
    ).astype(np.float64)

    G = np.einsum("aptf,fv,fw->aptvw", M, comps, comps)
    b = np.einsum("aptf,fv->aptv", M * D, comps)
    nvec = comps.shape[1]
    any_unflagged = M.any(axis=-1)
    ridge = 1e-10 * np.maximum(
        np.einsum("aptvv->apt", G)[..., None, None] / nvec, 1.0
    )
    G = G + (ridge + (~any_unflagged)[..., None, None]) * np.eye(nvec)
    coeffs = np.linalg.solve(G, b[..., None])[..., 0]
    smooth = np.einsum("fv,aptv->aptf", comps, coeffs)
    smooth = np.where(any_unflagged[..., None], smooth, 1.0)

    ant_slot = {int(a): i for i, a in enumerate(auto_ants)}
    pair_rows: dict = {}
    for row, (a1, a2) in enumerate(
        zip(uvdata.ant_1_array.tolist(), uvdata.ant_2_array.tolist())
    ):
        pair_rows.setdefault((a1, a2), []).append(row)
    missing = sorted(
        {a for ap in pair_rows for a in ap if a not in ant_slot}
    )
    if missing:
        raise ValueError(
            f"antennas {missing} appear in cross baselines but have no "
            "autocorrelation; exclude them (ex_ants) or disable "
            "use_autocorrs_in_weights"
        )
    for (a1, a2), rows in pair_rows.items():
        rows = np.asarray(rows)
        rows = rows[np.argsort(uvdata.time_array[rows], kind="stable")]
        w = 1.0 / (smooth[ant_slot[a1]] * smooth[ant_slot[a2]])  # (npol, nt, nf)
        w = np.transpose(w, (1, 2, 0))  # (ntimes, nfreqs, npols)
        data_weights.weights_array[rows, 0] = w * (~uvdata.flag_array[rows, 0])
    return data_weights


def resolve_comps_precision(dtype, warm_started):
    """Default ``comps_precision`` for a fit configuration: "mixed" for
    float32 fits; "float32" for float64 fits and warm-started fits."""
    if np.dtype(dtype) == np.float64 or warm_started:
        return "float32"
    return "mixed"


@contextlib.contextmanager
def _stage(timings, key, device=None):
    """A stage of a calibration, as the span ``calibration.<key>``. Where a
    ``timings`` dict is given, the stage ends with ``device`` (if any)
    drained and its seconds are added to ``timings[key]``: they are the
    device's too."""
    with SPANS.span(f"calibration.{key}") as span:
        yield span
        if timings is not None and device is not None:
            SPANS.sync(device)
    if timings is not None:
        timings[key] = timings.get(key, 0.0) + span.seconds


# threads of the time-parallel path's host stages: each holds a slice's
# temporaries, several GB at the full HERA array's size
_HOST_THREADS = 4


def _mark_rss(timings):
    """Record the host's resident set after the write-back
    (``writeback_rss_gib``, as the reference records it), where a
    ``timings`` dict is given."""
    if timings is not None:
        timings["writeback_rss_gib"] = rss_gib()


def _slice_rms(uvdata, polnum, time, skip_threshold):
    """The rms of a (time, pol) slice's unflagged data, or None where less
    than ``skip_threshold`` of it is unflagged (the slice is skipped)."""
    bltsel = np.isclose(uvdata.time_array, time, rtol=0.0, atol=1e-7)
    unflagged = ~uvdata.flag_array[bltsel, 0, :, polnum]
    if np.count_nonzero(unflagged) / (uvdata.Nbls * uvdata.Nfreqs) < skip_threshold:
        return None
    return np.sqrt(np.mean(np.abs(uvdata.data_array[bltsel, 0, :, polnum][unflagged]) ** 2.0))


def calibrate_and_model_tensor(
    uvdata,
    fg_model_comps_dict,
    gains=None,
    freeze_model=False,
    optimizer="Adamax",
    tol=1e-14,
    maxsteps=10000,
    include_autos=False,
    verbose=False,
    sky_model=None,
    dtype=np.float32,
    use_min=False,
    use_redundancy=False,
    notebook_progressbar=False,
    correct_resid=False,
    correct_model=True,
    weights=None,
    nsamples_in_weights=True,
    graph_mode=False,
    grp_size_threshold=5,
    n_profile_steps=0,
    profile_log_dir="./logdir",
    model_regularization="sum",
    init_guesses_from_previous_time_step=False,
    skip_threshold=0.5,
    use_model_snr_weights=False,
    time_parallel=False,
    mesh=None,
    checkpoint_dir=None,
    checkpoint_every=1000,
    resume=True,
    steps_per_execution=None,
    use_pallas=False,
    remat=False,
    comps_precision=None,
    wgts_precision="float32",
    patience=0,
    nvec_bucketing=False,
    shared_basis=True,
    loss_block_ngrps=None,
    timings=None,
    device="cuda",
    **opt_kwargs,
):
    """Simultaneous gain calibration and foreground fitting.

    Reference parity: calamity_tpu.calibration.calibrate_and_model_tensor:
    skip/flag thresholds, per-time rms scaling, Cholesky warm starts,
    optional warm-starting from the previous time, post-hoc or "sum"
    regularization, checkpointed fits (``checkpoint_dir``), profiler traces
    of a short descent (``n_profile_steps``, under ``profile_log_dir``).
    ``time_parallel=True`` fits every unskipped (time, pol) slice in one
    batched descent (``_calibrate_time_parallel``); with
    ``init_guesses_from_previous_time_step`` it runs the warm-started time
    scan instead (``_calibrate_time_scan``). ``graph_mode`` and
    ``use_pallas`` are accepted for signature parity and ignored: on CUDA
    the fused chunk-loss kernel runs wherever its gate accepts a chunk.

    ``device``: where the fit runs ("cuda", "cuda:N" or "cpu"). Asking for
    CUDA where there is none raises.

    ``mesh``: read on the time-parallel paths only, as the reference does.
    A ('data', 'bl') mesh from ``parallel.mesh.make_mesh`` shards the fit:
    this process fits its block on ``device`` and returns the whole
    result. ``None``: the auto mesh (every rank on 'bl') where a default
    process group of more than one rank is initialized, else one device.
    ``False``: one device. In a process group an unsharded fit (the serial
    path, ``mesh=False``) runs whole on every rank, and rank 0 alone
    writes and resumes its ``checkpoint_dir``.

    ``timings``: optional dict that receives the seconds of each stage
    (``packing_s``, ``pack_data_s``, ``warm_start_s``, ``fit_s``,
    ``writeback_s``, ``finalize_s``; repeated stages accumulate), each
    ending with the device drained, and ``writeback_rss_gib``, the host's
    resident set after the write-back. Every stage is a span
    ``calibration.<key>`` of ``SPANS`` (``_device``), with or without it.

    Returns (model, resid, gains, fit_history).
    """
    del graph_mode, use_pallas, notebook_progressbar
    device = resolve_device(device)
    mesh = _resolve_mesh(mesh, device) if time_parallel else None
    if mesh is None and not is_writer():
        # an unsharded fit in a process group runs whole and on its own on
        # every rank: rank 0 alone checkpoints and resumes it, so no two
        # processes write one directory, and nothing waits on a peer whose
        # step count the card's atomics may have moved
        checkpoint_dir = None
    if steps_per_execution is not None and not time_parallel:
        raise ValueError(
            "steps_per_execution bounds the steps of one descent call on the "
            "time_parallel paths only; the serial path does not support it"
        )
    if loss_block_ngrps is not None and not time_parallel:
        raise ValueError(
            "loss_block_ngrps blocks the loss over groups on the "
            "time_parallel paths only; the serial path does not support it"
        )
    if comps_precision is None:
        comps_precision = resolve_comps_precision(
            dtype, init_guesses_from_previous_time_step
        )
    if wgts_precision not in ("float32", "bfloat16"):
        raise ValueError(
            f"wgts_precision must be 'float32' or 'bfloat16', got {wgts_precision!r}"
        )
    stage = partial(_stage, timings, device=device)

    antpairs_data = uvdata.get_antpairs()
    if not include_autos:
        antpairs_data = [ap for ap in antpairs_data if ap[0] != ap[1]]
    uvdata = uvdata.select(inplace=False, bls=list(antpairs_data))

    resid = uvdata.copy()
    model = uvdata.copy()
    model.data_array[:] = 0.0
    model.flag_array[:] = False

    if gains is None:
        echo(
            f"{datetime.datetime.now()} Gains are None. Initializing gains starting with unity...\n",
            verbose=verbose,
        )
        gains = cal_utils.blank_uvcal_from_uvdata(uvdata)
    else:
        gains = gains.copy()

    if sky_model is None and model_regularization is not None:
        echo(
            f"{datetime.datetime.now()} Sky model is None. Initializing from data...\n",
            verbose=verbose,
        )
        if not np.any(gains.flag_array) and np.all(gains.gain_array == 1.0):
            # identity gains: the initialized sky model IS the data
            sky_model = uvdata
        else:
            sky_model = cal_utils.apply_gains(uvdata, gains)
    elif sky_model is not None:
        sky_model = sky_model.select(inplace=False, bls=list(antpairs_data))

    ants_map = {int(ant): i for i, ant in enumerate(gains.ant_array)}
    echo(f"{datetime.datetime.now()} Packing foreground modeling tensors...\n", verbose=verbose)
    with stage("packing_s"):
        # under a mesh the spec stays on the host: each rank uploads its block
        spec = FitSpec(
            uvdata,
            fg_model_comps_dict,
            ants_map,
            device=device if mesh is None else "cpu",
            dtype=dtype,
            use_redundancy=use_redundancy,
            grp_size_threshold=grp_size_threshold,
            nvec_bucketing=nvec_bucketing,
            shared_basis=shared_basis,
        )
        chunks = spec.device_chunks()
    echo(f"{datetime.datetime.now()} Packed {len(chunks)} chunks\n", verbose=verbose)
    del fg_model_comps_dict

    if time_parallel and init_guesses_from_previous_time_step:
        return _calibrate_time_scan(
            uvdata=uvdata, spec=spec, chunks=chunks, gains=gains, sky_model=sky_model,
            model=model, resid=resid, weights=weights,
            nsamples_in_weights=nsamples_in_weights, skip_threshold=skip_threshold,
            use_model_snr_weights=use_model_snr_weights, freeze_model=freeze_model,
            optimizer=optimizer, tol=tol, maxsteps=maxsteps, use_min=use_min,
            model_regularization=model_regularization, correct_model=correct_model,
            correct_resid=correct_resid, remat=remat, comps_precision=comps_precision,
            wgts_precision=wgts_precision, patience=patience, verbose=verbose,
            opt_kwargs=opt_kwargs, checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every, resume=resume,
            steps_per_execution=steps_per_execution, loss_block_ngrps=loss_block_ngrps,
            n_profile_steps=n_profile_steps, profile_log_dir=profile_log_dir,
            timings=timings, device=device, mesh=mesh,
        )
    if time_parallel:
        return _calibrate_time_parallel(
            uvdata=uvdata, spec=spec, chunks=chunks, gains=gains, sky_model=sky_model,
            model=model, resid=resid, weights=weights,
            nsamples_in_weights=nsamples_in_weights, skip_threshold=skip_threshold,
            use_model_snr_weights=use_model_snr_weights, freeze_model=freeze_model,
            optimizer=optimizer, tol=tol, maxsteps=maxsteps, use_min=use_min,
            model_regularization=model_regularization, correct_model=correct_model,
            correct_resid=correct_resid, remat=remat, comps_precision=comps_precision,
            wgts_precision=wgts_precision, patience=patience, verbose=verbose,
            opt_kwargs=opt_kwargs, checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every, resume=resume,
            steps_per_execution=steps_per_execution, loss_block_ngrps=loss_block_ngrps,
            n_profile_steps=n_profile_steps, profile_log_dir=profile_log_dir,
            timings=timings, device=device, mesh=mesh,
        )

    fit_history = {}
    g_r = g_i = fg_r = fg_i = None
    for polnum, pol in enumerate(uvdata.get_pols()):
        echo(
            f"{datetime.datetime.now()} Working on pol {pol}, {polnum + 1} of {uvdata.Npols}...\n",
            verbose=verbose,
        )
        fit_history_p = {}
        first_time = True
        for time_index, time in enumerate(spec.times):
            echo(
                f"{datetime.datetime.now()} Working on time {time_index + 1} of {spec.ntimes}...\n",
                verbose=verbose,
            )
            bltsel = np.isclose(uvdata.time_array, time, rtol=0.0, atol=1e-7)
            frac_unflagged = np.count_nonzero(
                ~uvdata.flag_array[bltsel, 0, :, polnum]
            ) / (uvdata.Nbls * uvdata.Nfreqs)
            if frac_unflagged < skip_threshold:
                echo(
                    f"{datetime.datetime.now()}: Only {frac_unflagged * 100}-percent of "
                    "data unflagged. Skipping...\n",
                    verbose=verbose,
                )
                flag_poltime(resid, time=time, polarization=pol)
                flag_poltime(gains, time=time, polarization=pol)
                flag_poltime(model, time=time, polarization=pol)
                continue

            with stage("pack_data_s"):
                rmsdata = np.sqrt(
                    np.mean(
                        np.abs(
                            uvdata.data_array[bltsel, 0, :, polnum][
                                ~uvdata.flag_array[bltsel, 0, :, polnum]
                            ]
                        )
                        ** 2.0
                    )
                )
                data_r, data_i, wgts = spec.pack_data(
                    uvdata,
                    pol,
                    time,
                    data_scale_factor=rmsdata,
                    weights=weights,
                    nsamples_in_weights=nsamples_in_weights,
                )
                if sky_model is uvdata:
                    # identity-gains alias: the sky tensors ARE the data tensors
                    sky_r, sky_i = data_r, data_i
                elif sky_model is not None:
                    sky_r, sky_i, _ = spec.pack_data(
                        sky_model, pol, time, data_scale_factor=rmsdata, weights=weights
                    )
                else:
                    sky_r, sky_i = None, None

            if first_time or not init_guesses_from_previous_time_step:
                first_time = False
                with stage("warm_start_s"):
                    g_r, g_i = spec.pack_gains(gains, pol, time)
                    init_r = sky_r if sky_r is not None else data_r
                    init_i = sky_i if sky_i is not None else data_i
                    fg_r = tuple(spec.init_coeffs(init_r, wgts))
                    fg_i = tuple(spec.init_coeffs(init_i, wgts))
                    if use_model_snr_weights:
                        wmodel = fg_model_all_chunks(fg_r, fg_i, chunks)
                        wgts = [
                            (torch.square(vr) + torch.square(vi)) * w
                            for (vr, vi), w in zip(wmodel, wgts)
                        ]
                        wsum = sum(float(torch.sum(w)) for w in wgts)
                        wgts = [w / wsum for w in wgts]
            with stage("fit_s"):
                if wgts_precision == "bfloat16":
                    # half the weights' device memory and read traffic; the
                    # loss widens them at the point of use
                    wgts = [w.to(torch.bfloat16) for w in wgts]

                (g_r, g_i, fg_r, fg_i, fit_history_p[time_index]) = fit_gains_and_foregrounds(
                    g_r=g_r,
                    g_i=g_i,
                    fg_r=fg_r,
                    fg_i=fg_i,
                    data_r=data_r,
                    data_i=data_i,
                    wgts=wgts,
                    chunks=chunks,
                    optimizer=optimizer,
                    use_min=use_min,
                    freeze_model=freeze_model,
                    verbose=verbose,
                    tol=tol,
                    maxsteps=maxsteps,
                    sky_model_r=sky_r,
                    sky_model_i=sky_i,
                    model_regularization=model_regularization,
                    n_profile_steps=n_profile_steps,
                    profile_log_dir=profile_log_dir,
                    checkpoint_dir=(
                        None
                        if checkpoint_dir is None
                        else f"{checkpoint_dir}/pol{polnum}_t{time_index}"
                    ),
                    checkpoint_every=checkpoint_every,
                    resume=resume,
                    remat=remat,
                    comps_precision=comps_precision,
                    patience=patience,
                    **opt_kwargs,
                )
            with stage("writeback_s"):
                # write-back on the host from the host copy of each chunk's basis
                spec.insert_model(
                    model,
                    fg_model_all_chunks_host(
                        [to_numpy(x) for x in fg_r],
                        [to_numpy(x) for x in fg_i],
                        spec.host_comps,
                    ),
                    pol, time, rmsdata,
                )
                spec.insert_gains(gains, g_r, g_i, pol, time)
                if (
                    not freeze_model
                    and model_regularization == "post_hoc"
                    and np.any(~model.flag_array[bltsel])
                ):
                    renormalize(
                        uvdata_reference_model=sky_model,
                        uvdata_deconv=model,
                        gains=gains,
                        polarization=pol,
                        time=time,
                        additional_flags=uvdata.flag_array,
                    )
        fit_history[polnum] = fit_history_p

    with stage("finalize_s"):
        model, resid = _finalize_model_resid(
            uvdata, model, resid, gains, correct_model, correct_resid
        )
    _mark_rss(timings)
    return model, resid, gains, fit_history


def _resolve_mesh(mesh, device):
    """The mesh a time-parallel fit runs on, or None for one device
    (reference calibration.py:415-430): ``False`` opts out; ``None`` builds
    the auto mesh where a default process group of more than one rank is
    initialized (the counterpart of more than one JAX device)."""
    import torch.distributed as dist

    from .parallel.mesh import make_mesh, mesh_shape

    if mesh is False:
        return None
    if mesh is None:
        if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() < 2:
            return None
        if device.type == "cuda":
            torch.cuda.set_device(device)
        # every rank on 'bl': also the right axis for the scan, whose times
        # run in order
        return make_mesh()
    mesh_shape(mesh)  # a ('data', 'bl') DeviceMesh, or TypeError
    return mesh


def _pad_axis(arr, axis, target):
    """Zero-pad one axis of a tensor up to ``target`` length (reference
    calibration.py:1348-1357)."""
    if arr.shape[axis] == target:
        return arr
    shape = list(arr.shape)
    shape[axis] = target - arr.shape[axis]
    return torch.cat([arr, arr.new_zeros(shape)], dim=axis)


def _pad_axis_np(arr, axis, target):
    """Zero-pad one axis of a host numpy array up to ``target`` length
    (reference calibration.py:1360-1369)."""
    if arr.shape[axis] == target:
        return arr
    pad = [(0, 0)] * arr.ndim
    pad[axis] = (0, target - arr.shape[axis])
    return np.pad(arr, pad)


def _pad_chunks_for_bl(chunks, n_bl):
    """Pad every chunk's group and operator-class axes to ``n_bl`` multiples
    so shard boundaries land on whole groups (and, for shared-batched
    chunks, on whole operator classes) (reference calibration.py:1372-1407).

    Shared-batched chunks (1 < U < ngrps) have the class-major layout
    ngrps = U * gmax; their class axis U is padded with zero operators,
    which appends gmax * (U_pad - U) zero-weight dummy groups at the end of
    the flat group axis, so each rank's classes stay whole. Plain shared
    chunks keep their one operator (group dim 1, replicated). Chunks are
    tensors or numpy arrays. Returns (padded_chunks, padded group counts)."""
    out, pads = [], []
    for comps, a0, a1 in chunks:
        pad = _pad_axis if isinstance(comps, torch.Tensor) else _pad_axis_np
        ngrps = a0.shape[0]
        if 1 < comps.shape[0] < ngrps:
            nu = comps.shape[0]
            gmax = ngrps // nu
            nu_pad = -(-nu // n_bl) * n_bl
            ngrps_pad = nu_pad * gmax
            comps_pad = pad(comps, 0, nu_pad)
        else:
            ngrps_pad = -(-ngrps // n_bl) * n_bl
            comps_pad = comps if comps.shape[0] != ngrps else pad(comps, 0, ngrps_pad)
        a0_pad = pad(a0, 0, ngrps_pad)
        carry_valid(a0, a0_pad, slice(0, ngrps_pad))  # the padded groups hold no baseline
        out.append((comps_pad, a0_pad, pad(a1, 0, ngrps_pad)))
        pads.append(ngrps_pad)
    return out, pads


def _compress_freq_invariant_wgts(w):
    """A weights stack whose every channel plane is equal, as one
    broadcastable (..., 1) plane (reference calibration.py:1410-1427).
    Frequency-dependent weights (flags, autocorrelation weights) are
    returned unchanged."""
    if w.shape[-1] == 1:
        return w
    first = w[..., :1]
    if np.array_equal(w, np.broadcast_to(first, w.shape)):
        return np.ascontiguousarray(first)
    return w




def _calibrate_time_parallel(
    uvdata, spec, chunks, gains, sky_model, model, resid, weights, nsamples_in_weights,
    skip_threshold, use_model_snr_weights, freeze_model, optimizer, tol, maxsteps, use_min,
    model_regularization, correct_model, correct_resid, remat, comps_precision,
    wgts_precision, patience, verbose, opt_kwargs, checkpoint_dir, checkpoint_every, resume,
    steps_per_execution, loss_block_ngrps, n_profile_steps, profile_log_dir, timings,
    device, mesh=None,
):
    """Every unskipped (time, pol) slice in one batched descent
    (reference calibration.py:1430-2136, without the segment plans).

    Slices are packed on the host straight into preallocated stacks,
    uploaded once, warm-started and given their priors batched on the
    device, and written back per slice on the host. ``checkpoint_dir``
    persists the batched descent under ``{dir}/batched`` (phase
    subdirectories for the mixed schedule). ``timings`` receives
    ``extract_s``, ``upload_s``, ``warmstart_s``, ``descent_s`` (the step-0
    guard's host evaluation included, ``loss_guard_s`` on its own) and
    ``writeback_s``, with ``phase_seconds`` (the guard apart) and
    ``phase_steps`` (recorded batch steps) per descent phase.

    Under a ``mesh`` the batch axis is padded to an n_data multiple (dummy
    rows repeat the last slice's gains, with zero weights) and every
    chunk's groups to an n_bl multiple (``_pad_chunks_for_bl``); each rank
    uploads its block, warm-starts it, and sums the weight and prior sums
    over 'bl'; the descent's results are gathered whole and the padding
    trimmed before the write-back. ``timings`` then also receives
    ``collective_s`` and ``collective_calls`` (this rank's host seconds in
    collective calls, and their count)."""
    from .ops.lstsq import (
        blocked_init_from_data,
        gram_cholesky_chunk,
        init_coeffs_from_cholesky_batched,
    )
    from .ops.fused import warn_fused_fallbacks
    from .ops.loss import fg_model_batched
    from .parallel.batched import (
        _loss_block_size,
        batched_fit_checkpointed,
        batched_fit_core,
        host_batched_losses,
    )
    from .parallel.mesh import MeshShard, shard_chunk
    from .solver.checkpoint import latest_checkpoint, load_phase_meta, save_phase_meta
    from .solver.fit import FitConfig, convert_chunks_dtype, profile_trace

    nchunks = len(chunks)
    slices = []  # (polnum, pol, time_index, time, rms)
    for polnum, pol in enumerate(uvdata.get_pols()):
        for time_index, time in enumerate(spec.times):
            rms = _slice_rms(uvdata, polnum, time, skip_threshold)
            if rms is None:
                flag_poltime(resid, time=time, polarization=pol)
                flag_poltime(gains, time=time, polarization=pol)
                flag_poltime(model, time=time, polarization=pol)
                continue
            slices.append((polnum, pol, time_index, time, rms))

    fit_history = {polnum: {} for polnum in range(uvdata.Npols)}
    if not slices:
        model, resid = _finalize_model_resid(
            uvdata, model, resid, gains, correct_model, correct_resid
        )
        return model, resid, gains, fit_history
    echo(f"{datetime.datetime.now()} Batched fit over {len(slices)} (time, pol) slices...\n",
         verbose=verbose)

    stage = partial(_stage, timings, device=device)

    shard = None if mesh is None else MeshShard(mesh, device, nbatch=len(slices))
    nbatch = len(slices) if shard is None else shard.nbatch
    n_bl = 1 if shard is None else shard.n_bl
    fit_chunks, ngrps_pads = _pad_chunks_for_bl(chunks, n_bl)
    # the identity-gains alias (sky_model is uvdata) packs nothing twice:
    # warm starts and priors read the data cubes
    have_sky = sky_model is not None and sky_model is not uvdata

    def alloc_stacks():
        return [np.zeros((nbatch, ngrps_pads[c], chunks[c][1].shape[1], spec.nfreqs),
                         dtype=spec.dtype) for c in range(nchunks)]

    def local(x):
        # this rank's (rows, groups) block of a host stack
        return x if shard is None else shard.block(x)

    with stage("extract_s"):
        data_r_h, data_i_h, wgts_h = alloc_stacks(), alloc_stacks(), alloc_stacks()
        sky_r_h = alloc_stacks() if have_sky else []
        sky_i_h = alloc_stacks() if have_sky else []

        def extract(b):
            # slice b's rows of the host stacks are its own
            _, pol, _, time, rms = slices[b]
            spec.pack_data_into(uvdata, pol, time, data_r_h, data_i_h, wgts_h, b,
                                data_scale_factor=rms, weights=weights,
                                nsamples_in_weights=nsamples_in_weights)
            if have_sky:
                spec.pack_data_into(sky_model, pol, time, sky_r_h, sky_i_h, None, b,
                                    data_scale_factor=rms)
            return spec.pack_gains(gains, pol, time)

        g_r_l, g_i_l = (list(x) for x in zip(*host_map(extract, range(len(slices)), _HOST_THREADS)))
        # dummy rows repeat the last slice's gains (their zero weights keep
        # them inert)
        g_r_l += g_r_l[-1:] * (nbatch - len(slices))
        g_i_l += g_i_l[-1:] * (nbatch - len(slices))
        g_r_b = torch.stack(g_r_l)
        g_i_b = torch.stack(g_i_l)
        del g_r_l, g_i_l
        wgts_h = [_compress_freq_invariant_wgts(w) for w in wgts_h]

    def upload_wgts(w):
        w = torch.as_tensor(w, device=device)
        if wgts_precision == "bfloat16" and w.shape[-1] > 1:
            # frequency-dependent weights at half width (frequency-invariant
            # ones are already one plane and stay full precision)
            w = w.to(torch.bfloat16)
        return w

    with stage("upload_s"):
        if shard is None:
            run_chunks = chunks
            data_r_b = [torch.as_tensor(x, device=device) for x in data_r_h]
            data_i_b = [torch.as_tensor(x, device=device) for x in data_i_h]
            wgts_b = [upload_wgts(w) for w in wgts_h]
        else:
            # each rank uploads its block alone
            blocks = [shard_chunk(mesh, fit_chunks[c], data_r_h[c], data_i_h[c], wgts_h[c],
                                  device) for c in range(nchunks)]
            run_chunks = tuple(b[0] for b in blocks)
            data_r_b = [b[1] for b in blocks]
            data_i_b = [b[2] for b in blocks]
            wgts_b = [upload_wgts(b[3]) for b in blocks]
            g_r_b = shard.local_rows(g_r_b).to(device)
            g_i_b = shard.local_rows(g_i_b).to(device)
            del blocks

    with stage("warmstart_s"):
        # a checkpointed resume restores the coefficients: skip the warm starts
        # when nothing else reads their by-products
        ck_base = None if checkpoint_dir is None else os.path.join(checkpoint_dir, "batched")
        skip_init = False
        if (ck_base is not None and resume and not freeze_model
                and model_regularization != "sum" and not use_model_snr_weights):
            if comps_precision == "mixed":
                skip_init = (latest_checkpoint(os.path.join(ck_base, "phase_f32")) is not None
                             or latest_checkpoint(os.path.join(ck_base, "phase_bf16")) is not None)
            else:
                skip_init = latest_checkpoint(ck_base) is not None
        # a block of loss_block_ngrps groups spans the 'bl' ranks: each rank
        # evaluates its share of it, inside its own shard
        loss_block = (None if loss_block_ngrps is None
                      else max(1, int(loss_block_ngrps) // n_bl))
        tdt = data_r_b[0].dtype
        nrows = data_r_b[0].shape[0]
        fg_r_b, fg_i_b = [], []
        prior_r_b = torch.zeros((nrows,), dtype=tdt, device=device)
        prior_i_b = torch.zeros((nrows,), dtype=tdt, device=device)
        wsum_b = torch.zeros((nrows,), dtype=tdt, device=device)
        for cnum, (comps, a0, _) in enumerate(run_chunks):
            ngrps = a0.shape[0]
            if skip_init:
                zero = torch.zeros((nrows, ngrps, comps.shape[-1]), dtype=tdt, device=device)
                fg_r_b.append(zero)
                fg_i_b.append(zero.clone())
                continue
            chol, active = gram_cholesky_chunk(comps)
            nu = comps.shape[0]
            gmax = ngrps // nu if 1 < nu < ngrps else 1
            blk = _loss_block_size(ngrps, gmax, loss_block) or ngrps
            if not have_sky and not use_model_snr_weights:
                cr, ci, wsum_c, pr_c, pi_c = blocked_init_from_data(
                    chol, active, comps, data_r_b[cnum], data_i_b[cnum], wgts_b[cnum], blk)
                wsum_b, prior_r_b, prior_i_b = wsum_b + wsum_c, prior_r_b + pr_c, prior_i_b + pi_c
                fg_r_b.append(cr)
                fg_i_b.append(ci)
                continue
            new_w, crs, cis = [], [], []
            sky_r_c = local(sky_r_h[cnum]) if have_sky else None
            sky_i_c = local(sky_i_h[cnum]) if have_sky else None
            for g0 in range(0, ngrps, blk):
                if have_sky:
                    src_r = torch.as_tensor(sky_r_c[:, g0:g0 + blk], device=device)
                    src_i = torch.as_tensor(sky_i_c[:, g0:g0 + blk], device=device)
                else:
                    src_r = data_r_b[cnum][:, g0:g0 + blk]
                    src_i = data_i_b[cnum][:, g0:g0 + blk]
                w_blk = wgts_b[cnum][:, g0:g0 + blk].to(tdt)
                if nu == 1:
                    comps_blk, chol_blk, active_blk = comps, chol, active
                elif nu < ngrps:
                    u0, u1 = g0 // gmax, (g0 + blk) // gmax
                    comps_blk, chol_blk, active_blk = comps[u0:u1], chol[u0:u1], active[u0:u1]
                else:
                    sl = slice(g0, g0 + blk)
                    comps_blk, chol_blk, active_blk = comps[sl], chol[sl], active[sl]
                cr, ci = init_coeffs_from_cholesky_batched(chol_blk, active_blk, comps_blk,
                                                           src_r, src_i, w_blk)
                if use_model_snr_weights:
                    vr, vi = fg_model_batched(cr, ci, comps_blk)
                    w_blk = (torch.square(vr) + torch.square(vi)) * w_blk
                    new_w.append(w_blk)
                wsum_b = wsum_b + torch.sum(w_blk, dim=(1, 2, 3))
                prior_r_b = prior_r_b + torch.sum(src_r * w_blk, dim=(1, 2, 3))
                prior_i_b = prior_i_b + torch.sum(src_i * w_blk, dim=(1, 2, 3))
                crs.append(cr)
                cis.append(ci)
            if use_model_snr_weights:
                wgts_b[cnum] = torch.cat(new_w, dim=1)
            fg_r_b.append(torch.cat(crs, dim=1))
            fg_i_b.append(torch.cat(cis, dim=1))
        if shard is not None:
            # each rank summed its groups: the slices' sums are the 'bl' sums
            wsum_b, prior_r_b, prior_i_b = shard.sum_bl(torch.stack([wsum_b, prior_r_b,
                                                                     prior_i_b]))
        if use_model_snr_weights:
            # renormalize the reweighted batch to unit total per slice
            denom = torch.where(wsum_b > 0, wsum_b, torch.ones_like(wsum_b))
            wgts_b = [w / denom[:, None, None, None] for w in wgts_b]
            wgts_h = [to_numpy(w) for w in wgts_b]  # the guard's host weights
            wgts_b = [w.to(torch.bfloat16) if wgts_precision == "bfloat16" else w for w in wgts_b]
            prior_r_b = prior_r_b / denom
            prior_i_b = prior_i_b / denom
        else:
            wgts_h = [local(w) for w in wgts_h]
        del sky_r_h, sky_i_h

    cfg = FitConfig(
        optimizer=optimizer,
        opt_kwargs=tuple(sorted(opt_kwargs.items())),
        maxsteps=int(maxsteps),
        tol=float(tol),
        use_min=bool(use_min),
        freeze_model=bool(freeze_model),
        regularization="sum" if model_regularization == "sum" else None,
        remat=bool(remat),
        patience=int(patience),
        loss_block=loss_block,
    )
    warn_fused_fallbacks(run_chunks, fg_r_b, data_r_b, wgts_b)
    if n_profile_steps > 0:
        # a short batched descent traced by the profiler before the fit
        # (reference calibration.py:1986-2003)
        prof_cfg = cfg._replace(maxsteps=int(n_profile_steps), tol=0.0, patience=0)
        prof_chunks = (convert_chunks_dtype(run_chunks, torch.bfloat16)
                       if comps_precision in ("bfloat16", "mixed") else run_chunks)
        profile_trace(profile_log_dir, lambda: batched_fit_core(
            prof_cfg, prof_chunks, data_r_b, data_i_b, wgts_b, g_r_b, g_i_b, fg_r_b, fg_i_b,
            prior_r_b, prior_i_b, poll_every=POLL_EVERY, shard=shard))
        prof_chunks = None

    # the step-0 guard's independent value: numpy float64 from the host
    # stacks (this rank's blocks), never the device cubes or the kernel
    host_chunks = [(hc, to_numpy(a0), to_numpy(a1))
                   for hc, (_, a0, a1) in zip(spec.host_comps, chunks)]
    if shard is not None:
        host_chunks = [shard.chunk(c) for c in _pad_chunks_for_bl(host_chunks, n_bl)[0]]
    data_r_g, data_i_g = [local(x) for x in data_r_h], [local(x) for x in data_i_h]
    prior_h = (to_numpy(prior_r_b), to_numpy(prior_i_b))

    guards = []  # the spans of the step-0 guard's evaluations in a phase

    def guard_fn(fr_const, fi_const):
        def expected(params):
            with SPANS.span("loss_guard") as span:
                guards.append(span)
                fr = fr_const if freeze_model else params["fg_r"]
                fi = fi_const if freeze_model else params["fg_i"]
                out = host_batched_losses(
                    to_numpy(params["g_r"]), to_numpy(params["g_i"]),
                    [to_numpy(x) for x in fr], [to_numpy(x) for x in fi], host_chunks,
                    data_r_g, data_i_g, wgts_h, *prior_h, regularization=cfg.regularization,
                    reduce=None if shard is None else shard.sum_bl_host)
                if shard is not None:
                    out = shard.gather_rows_host(out)
                return out
        return expected

    phase_seconds, phase_steps = [], []

    def run_batched(chs, gr, gi, fr, fi, opt_state0=None, ckdir=None):
        guards.clear()
        with SPANS.span("phase") as phase:
            res = batched_fit_checkpointed(
                cfg, chs, data_r_b, data_i_b, wgts_b, gr, gi, fr, fi, prior_r_b, prior_i_b,
                ckdir, int(checkpoint_every) if ckdir is not None else cfg.maxsteps, resume,
                verbose, opt_state0, steps_per_execution=steps_per_execution,
                expected_loss_fn=guard_fn(fr, fi), poll_every=POLL_EVERY, shard=shard)
            SPANS.sync(device)
        guard_s = sum(g.seconds for g in guards)
        # the descent's own seconds: the guard's host evaluation apart
        phase_seconds.append(phase.seconds - guard_s)
        if timings is not None:
            timings["loss_guard_s"] = timings.get("loss_guard_s", 0.0) + guard_s
        phase_steps.append(int(res.nsteps))
        hist = np.asarray(res.loss_history[: res.nsteps], dtype=np.float64)
        return res, hist, np.asarray(res.nsteps_slice)

    # one fit: both phases of the mixed schedule
    with stage("descent_s"), SPANS.fit(device):
        skip1 = (comps_precision == "mixed" and ck_base is not None and resume
                 and latest_checkpoint(os.path.join(ck_base, "phase_f32")) is not None)
        chunks_lo = None
        if comps_precision == "bfloat16" or (comps_precision == "mixed" and not skip1):
            chunks_lo = convert_chunks_dtype(run_chunks, torch.bfloat16)
        hist1 = ns1 = None
        if comps_precision == "bfloat16":
            result, hist2, ns2 = run_batched(chunks_lo, g_r_b, g_i_b, fg_r_b, fg_i_b, ckdir=ck_base)
        elif comps_precision == "mixed":
            ck1 = ck2 = None
            if ck_base is not None:
                ck1 = os.path.join(ck_base, "phase_bf16")
                ck2 = os.path.join(ck_base, "phase_f32")
            if skip1:
                # the resume lands in the float32 polish: restore the bf16
                # phase's diagnostics
                meta = load_phase_meta(ck_base)
                if meta is not None:
                    hist1 = np.asarray(meta["history"], dtype=np.float64)
                    ns1 = np.asarray(meta["nsteps_slice"])
                else:
                    hist1 = np.zeros((0, nbatch), dtype=np.float64)
                    ns1 = np.zeros((nbatch,), dtype=np.int64)
                result, hist2, ns2 = run_batched(run_chunks, g_r_b, g_i_b, fg_r_b, fg_i_b,
                                                 ckdir=ck2)
            else:
                res1, hist1, ns1 = run_batched(chunks_lo, g_r_b, g_i_b, fg_r_b, fg_i_b,
                                               ckdir=ck1)
                if ck_base is not None:
                    _save_shared(shard, save_phase_meta, ck_base, history=hist1, nsteps_slice=ns1)
                echo(f"{datetime.datetime.now()} bf16 phase done ({int(res1.nsteps)} steps); "
                     "polishing in float32...\n", verbose=verbose)
                # the optimizer state carries across the precision switch
                chunks_lo = None
                result, hist2, ns2 = run_batched(run_chunks, res1.g_r, res1.g_i, res1.fg_r,
                                                 res1.fg_i, opt_state0=res1.opt_state, ckdir=ck2)
                res1 = None
        else:
            result, hist2, ns2 = run_batched(run_chunks, g_r_b, g_i_b, fg_r_b, fg_i_b,
                                             ckdir=ck_base)
    if timings is not None:
        timings["phase_seconds"] = phase_seconds
        timings["phase_steps"] = phase_steps

    with stage("writeback_s"):
        g_r_out, g_i_out = result.g_r, result.g_i
        fr_out, fi_out = result.fg_r, result.fg_i
        if shard is not None:
            # the whole batch on every rank, the padding trimmed
            g_r_out, g_i_out = shard.gather_rows(g_r_out), shard.gather_rows(g_i_out)
            fr_out = [shard.gather_coeffs(x)[:, :a0.shape[0]]
                      for x, (_, a0, _) in zip(fr_out, chunks)]
            fi_out = [shard.gather_coeffs(x)[:, :a0.shape[0]]
                      for x, (_, a0, _) in zip(fi_out, chunks)]
            if timings is not None:
                timings["collective_s"] = shard.collective_s
                timings["collective_calls"] = shard.collective_calls
        g_r_out = to_numpy(g_r_out)
        g_i_out = to_numpy(g_i_out)
        fr_out = [to_numpy(x) for x in fr_out]
        fi_out = [to_numpy(x) for x in fi_out]
        # release the descent's device memory and the host stacks (the guard's)
        # before the host write-back, which holds one slice's model at a time
        result = data_r_b = data_i_b = wgts_b = chunks_lo = None  # noqa: F841
        data_r_h = data_i_h = wgts_h = data_r_g = data_i_g = None  # noqa: F841
        for b, (polnum, pol, time_index, time, rms) in enumerate(slices):
            loss = hist2[: int(ns2[b]), b].tolist()
            entry = {"loss": loss}
            if hist1 is not None:
                entry = {"loss": hist1[: int(ns1[b]), b].tolist() + loss,
                         "phase_steps": [int(ns1[b]), int(ns2[b])]}
            fit_history[polnum][time_index] = entry

        def write_back(bs):
            # one time's slices, its polarizations in order: the rows of the
            # model and the gains of one time are that time's own
            for b in bs:
                _, pol, _, time, rms = slices[b]
                spec.insert_model(model, fg_model_all_chunks_host([f[b] for f in fr_out],
                                                                  [f[b] for f in fi_out],
                                                                  spec.host_comps), pol, time, rms)
                spec.insert_gains(gains, g_r_out[b], g_i_out[b], pol, time)
                bltsel = np.isclose(uvdata.time_array, time, rtol=0.0, atol=1e-7)
                if (not freeze_model and model_regularization == "post_hoc"
                        and np.any(~model.flag_array[bltsel])):
                    renormalize(uvdata_reference_model=sky_model, uvdata_deconv=model,
                                gains=gains, polarization=pol, time=time,
                                additional_flags=uvdata.flag_array)

        by_time = {}
        for b, sl in enumerate(slices):
            by_time.setdefault(sl[2], []).append(b)
        host_map(write_back, list(by_time.values()), _HOST_THREADS)
        model, resid = _finalize_model_resid(
            uvdata, model, resid, gains, correct_model, correct_resid
        )
    _mark_rss(timings)
    return model, resid, gains, fit_history


def _save_shared(shard, save_fn, *args, **kwargs):
    """``save_fn(*args, **kwargs)`` by the one writing rank, then (under a
    mesh) a barrier, so that no rank reads a half-written file."""
    if is_writer():
        save_fn(*args, **kwargs)
    if shard is not None:
        shard.barrier()


def _host_f32(x):
    """A host stack as float32 numpy (bfloat16 CPU tensors widened)."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return x


def _calibrate_time_scan(
    uvdata, spec, chunks, gains, sky_model, model, resid, weights, nsamples_in_weights,
    skip_threshold, use_model_snr_weights, freeze_model, optimizer, tol, maxsteps, use_min,
    model_regularization, correct_model, correct_resid, remat, comps_precision,
    wgts_precision, patience, verbose, opt_kwargs, checkpoint_dir, checkpoint_every, resume,
    steps_per_execution, loss_block_ngrps, n_profile_steps, profile_log_dir, timings,
    device, mesh=None,
):
    """Warm-started fits over the times of each polarization, in order, each
    seeded by the previous time's solution (reference calibration.py:666-1345).

    Per polarization: times below ``skip_threshold`` are flagged; the
    usable times are packed on the host into stacks
    (``FitSpec.pack_data_into``); the first time gets the Cholesky warm
    start (and, with ``use_model_snr_weights``, model-SNR weights, written
    into its host planes); every time gets its own "sum" prior. The stacks
    stay on the host and each time uploads when its fit starts, so the
    device holds one time. Each time runs the segmented batched descent at
    nbatch=1 (``parallel.batched.scan_time_fit``; the bfloat16 then float32
    phases under "mixed"). The reference's two forms, one compiled
    ``lax.scan`` and a host loop of segments, are this one host loop here:
    with ``checkpoint_dir``, completed times persist as
    ``{dir}/pol{N}_scan/step_{slot+1}`` markers and the time in progress
    under ``{dir}/pol{N}_scan/time_{slot}`` (removed once its marker lands),
    so a resume continues mid-time.

    Under a ``mesh`` the groups are sharded over 'bl' (padded to an n_bl
    multiple) and each time's cubes follow; 'data' is unused, since the
    times run in order. Each rank warm-starts its groups and uploads its
    block of each time; the weight and prior sums are summed over 'bl'.
    Rank 0 writes the markers (the carry gathered whole), every rank waits
    for them, and a resume restores each rank's block.

    The step-0 guard is armed on the first phase of every time, against
    ``host_batched_losses`` on the host stacks. ``timings`` receives
    ``scan_upload_s``, ``scan_descent_s``, ``scan_guard_s``,
    ``scan_fetch_s``, ``scan_save_s`` (marker saves) and ``writeback_s``;
    each time's history entry holds its ``loss``, ``phase_steps`` and, for
    a time fitted in this run, ``phase_seconds`` (descent only)."""
    import shutil

    from .ops.fused import warn_fused_fallbacks
    from .ops.lstsq import gram_cholesky_chunk, init_coeffs_from_cholesky
    from .parallel.batched import (
        host_batched_losses,
        scan_carry,
        scan_time_fit,
        scanned_warmstart_fit_core,
        upload_time_slice,
    )
    from .parallel.mesh import MeshShard, contiguous
    from .solver.checkpoint import (
        _checkpoint_loadable,
        latest_checkpoint,
        load_phase_meta,
        load_state,
        save_phase_meta,
        save_state,
    )
    from .solver.fit import FitConfig, convert_chunks_dtype, profile_trace

    nchunks = len(chunks)
    fit_history = {polnum: {} for polnum in range(uvdata.Npols)}
    shard = None if mesh is None else MeshShard(mesh, device)
    n_bl = 1 if shard is None else shard.n_bl
    ngrps_real = [a0.shape[0] for _, a0, _ in chunks]
    host_chunks = [(hc, to_numpy(a0), to_numpy(a1))
                   for hc, (_, a0, a1) in zip(spec.host_comps, chunks)]
    run_chunks, ngrps_pads = _pad_chunks_for_bl(chunks, n_bl)
    if shard is not None:
        run_chunks = [shard.chunk(c, device) for c in run_chunks]
        host_chunks = [shard.chunk(c) for c in _pad_chunks_for_bl(host_chunks, n_bl)[0]]
    grams = [gram_cholesky_chunk(c) for c, _, _ in run_chunks]

    def lg(x, axis=0):
        # this rank's groups of a host array (every group when unsharded)
        return x if shard is None else shard.block(x, axis)

    # bfloat16 chunks serve the descent only; warm starts, SNR weights and
    # the write-back read the float32 basis
    fit_chunks, fit_chunks_lo = run_chunks, None
    if comps_precision == "bfloat16":
        fit_chunks = convert_chunks_dtype(run_chunks, torch.bfloat16)
    elif comps_precision == "mixed":
        fit_chunks_lo = convert_chunks_dtype(run_chunks, torch.bfloat16)
    cfg = FitConfig(
        optimizer=optimizer,
        opt_kwargs=tuple(sorted(opt_kwargs.items())),
        maxsteps=int(maxsteps),
        tol=float(tol),
        use_min=bool(use_min),
        freeze_model=bool(freeze_model),
        regularization="sum" if model_regularization == "sum" else None,
        remat=bool(remat),
        patience=int(patience),
        # each rank evaluates its share of a block, inside its own shard
        loss_block=(None if loss_block_ngrps is None
                    else max(1, int(loss_block_ngrps) // n_bl)),
    )

    stage = partial(_stage, timings, device=device)

    def whole(carry):
        # a carry gathered whole over 'bl' (the padded groups)
        if shard is None:
            return carry
        return (carry[0], carry[1], [shard.gather_coeffs(f) for f in carry[2]],
                [shard.gather_coeffs(f) for f in carry[3]])

    def own(carry):
        if shard is None:
            return carry
        return (carry[0], carry[1], [shard.local_coeffs(f) for f in carry[2]],
                [shard.local_coeffs(f) for f in carry[3]])

    warned = profiled = False
    for polnum, pol in enumerate(uvdata.get_pols()):
        usable = []  # (time_index, time, rms)
        for time_index, time in enumerate(spec.times):
            rms = _slice_rms(uvdata, polnum, time, skip_threshold)
            if rms is None:
                flag_poltime(resid, time=time, polarization=pol)
                flag_poltime(gains, time=time, polarization=pol)
                flag_poltime(model, time=time, polarization=pol)
                continue
            usable.append((time_index, time, rms))
        if not usable:
            continue
        nt_u = len(usable)

        def alloc():
            return [np.zeros((nt_u, ngrps_pads[c], chunks[c][1].shape[1], spec.nfreqs),
                             dtype=spec.dtype) for c in range(nchunks)]

        def up(xs):
            return [torch.as_tensor(x, device=device) for x in xs]

        data_r_s, data_i_s, wgts_s = alloc(), alloc(), alloc()
        priors_r, priors_i = [], []
        fg_init = None
        for slot, (time_index, time, rms) in enumerate(usable):
            spec.pack_data_into(uvdata, pol, time, data_r_s, data_i_s, wgts_s, slot,
                                data_scale_factor=rms, weights=weights,
                                nsamples_in_weights=nsamples_in_weights)
            w_v = [lg(w[slot]) for w in wgts_s]
            if sky_model is not None and sky_model is not uvdata:
                sky_r, sky_i, _ = spec.pack_data(sky_model, pol, time, data_scale_factor=rms,
                                                 weights=weights, as_numpy=True)
                sky_r = [lg(_pad_axis_np(x, 0, n)) for x, n in zip(sky_r, ngrps_pads)]
                sky_i = [lg(_pad_axis_np(x, 0, n)) for x, n in zip(sky_i, ngrps_pads)]
            else:
                # no sky model, or the identity-gains alias (sky == data)
                sky_r = [lg(x[slot]) for x in data_r_s]
                sky_i = [lg(x[slot]) for x in data_i_s]
            if slot == 0:
                w_d = up(w_v)
                fg_init = tuple(
                    tuple(init_coeffs_from_cholesky(chol, active, c, d, w)
                          for (chol, active), (c, _, _), d, w
                          in zip(grams, run_chunks, up(src), w_d))
                    for src in (sky_r, sky_i))
                if use_model_snr_weights:
                    # the first time only: later times keep their own
                    # weights (reference calibration.py:872-891), rewritten
                    # in place in the slot-0 planes
                    wmodel = fg_model_all_chunks(fg_init[0], fg_init[1], run_chunks)
                    for cnum, (vr, vi) in enumerate(wmodel):
                        w_v[cnum] *= np.square(to_numpy(vr)) + np.square(to_numpy(vi))
                    wsum = sum(float(np.sum(w)) for w in w_v)
                    if shard is not None:
                        wsum = float(shard.sum_bl_host(wsum))
                    for w in w_v:
                        np.divide(w, np.dtype(spec.dtype).type(wsum), out=w)
            priors_r.append(sum(float(np.sum(sr * w)) for sr, w in zip(sky_r, w_v)))
            priors_i.append(sum(float(np.sum(si * w)) for si, w in zip(sky_i, w_v)))
        if shard is not None:
            # each rank summed its groups
            priors_r, priors_i = shard.sum_bl_host([priors_r, priors_i])
        g_r0, g_i0 = (x.to(device) for x in spec.pack_gains(gains, pol, usable[0][1]))
        # frequency-invariant weights as one broadcast plane; frequency-
        # dependent ones at half width under bfloat16 weights (a CPU
        # bfloat16 stack, widened by the loss at the point of use)
        wgts_s = [_compress_freq_invariant_wgts(w) for w in wgts_s]
        if wgts_precision == "bfloat16":
            wgts_s = [torch.from_numpy(w).to(torch.bfloat16) if w.shape[-1] > 1 else w
                      for w in wgts_s]
        if shard is not None:
            # this rank's groups of every stack
            data_r_s, data_i_s, wgts_s = ([contiguous(lg(x, axis=1)) for x in xs]
                                          for xs in (data_r_s, data_i_s, wgts_s))
        wgts_h = [_host_f32(w) for w in wgts_s]  # the guard's weights
        prior_r_s = np.asarray(priors_r, dtype=spec.dtype)
        prior_i_s = np.asarray(priors_i, dtype=spec.dtype)

        def expected(slot, g_r, g_i, fr, fi):
            # numpy float64 from the host stacks: never the device cubes
            sl = slice(slot, slot + 1)
            return host_batched_losses(
                to_numpy(g_r), to_numpy(g_i), [to_numpy(x) for x in fr],
                [to_numpy(x) for x in fi], host_chunks, [x[sl] for x in data_r_s],
                [x[sl] for x in data_i_s], [w[sl] for w in wgts_h], prior_r_s[sl],
                prior_i_s[sl], regularization=cfg.regularization,
                reduce=None if shard is None else shard.sum_bl_host)

        if not warned:
            warned = True
            probes = [torch.empty((0,), dtype=fg_init[0][0].dtype, device=device)] * nchunks
            warn_fused_fallbacks(fit_chunks, fg_init[0], probes, probes)
        if n_profile_steps > 0 and not profiled:
            # a short one-time scan traced by the profiler before the fit
            # (reference calibration.py:932-948)
            profiled = True
            prof_cfg = cfg._replace(maxsteps=int(n_profile_steps), tol=0.0, patience=0)
            one = slice(0, 1)
            profile_trace(profile_log_dir, lambda: scanned_warmstart_fit_core(
                prof_cfg, fit_chunks, [x[one] for x in data_r_s], [x[one] for x in data_i_s],
                [w[one] for w in wgts_s], g_r0, g_i0, fg_init[0], fg_init[1],
                prior_r_s[one], prior_i_s[one], poll_every=POLL_EVERY, shard=shard))

        # per time: (params, recorded losses, steps, phase steps, phase seconds)
        outputs = []
        ck = None if checkpoint_dir is None else os.path.join(checkpoint_dir, f"pol{polnum}_scan")
        ck_every = int(checkpoint_every) if ck is not None else None
        carry = (g_r0[None], g_i0[None], [f[None] for f in fg_init[0]],
                 [f[None] for f in fg_init[1]])
        start_slot = 0
        if ck is not None and resume:
            like = whole(carry)
            while _checkpoint_loadable(os.path.join(ck, f"step_{start_slot + 1}")):
                tree, scal = load_state(os.path.join(ck, f"step_{start_slot + 1}"),
                                        {"out": like}, ("history", "nsteps", "phase_steps"))
                carry = own(tree["out"])
                outputs.append((carry, np.asarray(scal["history"], dtype=np.float32),
                                int(scal["nsteps"]), scal["phase_steps"].tolist(), None))
                start_slot += 1
            if shard is not None:
                shard.barrier()  # every rank has read the markers
            for slot in range(start_slot):
                # a mid-time directory left by a stop after its marker landed
                if is_writer():
                    shutil.rmtree(os.path.join(ck, f"time_{slot}"), ignore_errors=True)
            if start_slot:
                echo(f"{datetime.datetime.now()} Resuming warm-started scan at time "
                     f"{start_slot + 1}/{nt_u}", verbose=verbose)

        def run_time(slot, carry, ck_t):
            with stage("scan_upload_s"):
                dev_in = [[upload_time_slice(x, slot, device) for x in stack]
                          for stack in (data_r_s, data_i_s, wgts_s)]
                pr = upload_time_slice(prior_r_s, slot, device)
                pi = upload_time_slice(prior_i_s, slot, device)

            def fit(chs, carry, ckdir, opt_state0=None, guard=True):
                with SPANS.span("phase") as phase:
                    res, row, nst, guard_s = scan_time_fit(
                        cfg, chs, *dev_in, carry, pr, pi, ckdir, ck_every, resume, verbose,
                        opt_state0, steps_per_execution,
                        partial(expected, slot) if guard else None, POLL_EVERY, shard)
                    SPANS.sync(device)
                desc = phase.seconds - guard_s
                if timings is not None:
                    timings["scan_descent_s"] = timings.get("scan_descent_s", 0.0) + desc
                    timings["scan_guard_s"] = timings.get("scan_guard_s", 0.0) + guard_s
                return res, row, nst, desc

            with SPANS.fit(device):  # one time: its phases
                if comps_precision != "mixed":
                    res, row, nst, sec = fit(fit_chunks, carry, ck_t)
                    return scan_carry(res), row, nst, [nst], [sec]
                ck1 = None if ck_t is None else os.path.join(ck_t, "phase_bf16")
                ck2 = None if ck_t is None else os.path.join(ck_t, "phase_f32")
                if ck2 is not None and resume and latest_checkpoint(ck2) is not None:
                    # the resume lands in the float32 polish: the bf16
                    # phase's diagnostics come from its metadata, and the
                    # guard is armed on the phase that runs first
                    meta = load_phase_meta(ck_t)
                    hist1 = (np.zeros((0,), np.float32) if meta is None
                             else np.asarray(meta["history"], dtype=np.float32))
                    ns1, sec1 = (0 if meta is None else int(meta["nsteps"])), 0.0
                    res, row2, ns2, sec2 = fit(fit_chunks, carry, ck2)
                else:
                    res1, hist1, ns1, sec1 = fit(fit_chunks_lo, carry, ck1)
                    if ck_t is not None:
                        _save_shared(shard, save_phase_meta, ck_t, history=hist1, nsteps=ns1)
                    # the optimizer state carries across the precision switch
                    res, row2, ns2, sec2 = fit(fit_chunks, scan_carry(res1), ck2,
                                               opt_state0=res1.opt_state, guard=False)
                return (scan_carry(res), np.concatenate([hist1, row2]), ns1 + ns2, [ns1, ns2],
                        [sec1, sec2])

        for slot in range(start_slot, nt_u):
            ck_t = None if ck is None else os.path.join(ck, f"time_{slot}")
            carry, row, nst, psteps, psecs = run_time(slot, carry, ck_t)
            outputs.append((carry, row, nst, psteps, psecs))
            if ck is not None:
                with stage("scan_fetch_s"):
                    out_host = tuple(
                        x.detach().cpu() if isinstance(x, torch.Tensor)
                        else [f.detach().cpu() for f in x] for x in whole(carry))

                def save_marker():
                    save_state(os.path.join(ck, f"step_{slot + 1}"), {"out": out_host},
                               {"history": row, "nsteps": nst, "phase_steps": psteps})
                    shutil.rmtree(ck_t, ignore_errors=True)

                with stage("scan_save_s"):
                    _save_shared(shard, save_marker)
                echo(f"{datetime.datetime.now()} checkpointed scan time {slot + 1}/{nt_u}",
                     verbose=verbose)
        with stage("scan_fetch_s"):
            outputs = [(tuple(to_numpy(x) if isinstance(x, torch.Tensor)
                              else [to_numpy(f)[:, :n] for f, n in zip(x, ngrps_real)]
                              for x in whole(o[0])),) + o[1:]
                       for o in outputs]
        with stage("writeback_s"):
            for slot, (time_index, time, rms) in enumerate(usable):
                (g_r, g_i, fr, fi), row, nst, psteps, psecs = outputs[slot]
                entry = {"loss": np.asarray(row[:nst], dtype=np.float64).tolist(),
                         "phase_steps": [int(n) for n in psteps]}
                if psecs is not None:
                    entry["phase_seconds"] = psecs
                fit_history[polnum][time_index] = entry
                spec.insert_model(model, fg_model_all_chunks_host([f[0] for f in fr],
                                                                  [f[0] for f in fi],
                                                                  spec.host_comps),
                                  pol, time, rms)
                spec.insert_gains(gains, g_r[0], g_i[0], pol, time)
                bltsel = np.isclose(uvdata.time_array, time, rtol=0.0, atol=1e-7)
                if (not freeze_model and model_regularization == "post_hoc"
                        and np.any(~model.flag_array[bltsel])):
                    renormalize(uvdata_reference_model=sky_model, uvdata_deconv=model, gains=gains,
                                polarization=pol, time=time, additional_flags=uvdata.flag_array)

    if shard is not None and timings is not None:
        timings["collective_s"] = shard.collective_s
        timings["collective_calls"] = shard.collective_calls
    with stage("writeback_s"):
        model, resid = _finalize_model_resid(
            uvdata, model, resid, gains, correct_model, correct_resid
        )
    _mark_rss(timings)
    return model, resid, gains, fit_history


def calibrate_and_model_dpss(
    uvdata,
    horizon=1.0,
    min_dly=0.0,
    offset=0.0,
    include_autos=False,
    verbose=False,
    red_tol=1.0,
    notebook_progressbar=False,
    fg_model_comps_dict=None,
    **fitting_kwargs,
):
    """Gain + foreground fit with per-baseline DPSS components
    (reference calibration.py:1503-1584)."""
    if fg_model_comps_dict is None:
        # the basis is the host's work: no device to drain
        with _stage(fitting_kwargs.get("timings"), "basis_s"):
            fg_model_comps_dict = models.yield_pbl_dpss_model_comps(
                uvdata,
                horizon=horizon,
                min_dly=min_dly,
                offset=offset,
                include_autos=include_autos,
                red_tol=red_tol,
                use_redundancy=fitting_kwargs.get("use_redundancy", False),
                notebook_progressbar=notebook_progressbar,
                verbose=verbose,
            )
    return calibrate_and_model_tensor(
        uvdata=uvdata,
        fg_model_comps_dict=fg_model_comps_dict,
        include_autos=include_autos,
        verbose=verbose,
        notebook_progressbar=notebook_progressbar,
        **fitting_kwargs,
    )


def calibrate_and_model_dft(
    uvdata,
    horizon=1.0,
    min_dly=0.0,
    offset=0.0,
    include_autos=False,
    verbose=False,
    red_tol=1.0,
    notebook_progressbar=False,
    **fitting_kwargs,
):
    """Gain + foreground fit with per-baseline DFT delay modes (reference
    calibration.py:2175-2207). Every chunk is dense with one baseline per
    group, so the fused kernel computes the loss."""
    fg_model_comps_dict = models.yield_pbl_model_comps(
        uvdata,
        horizon=horizon,
        min_dly=min_dly,
        offset=offset,
        include_autos=include_autos,
        red_tol=red_tol,
        use_redundancy=fitting_kwargs.get("use_redundancy", False),
        notebook_progressbar=notebook_progressbar,
        verbose=verbose,
        basis="dft",
    )
    return calibrate_and_model_tensor(
        uvdata=uvdata,
        fg_model_comps_dict=fg_model_comps_dict,
        include_autos=include_autos,
        verbose=verbose,
        notebook_progressbar=notebook_progressbar,
        **fitting_kwargs,
    )


def calibrate_and_model_mixed(
    uvdata,
    horizon=1.0,
    min_dly=0.0,
    offset=0.0,
    ant_dly=0.0,
    include_autos=False,
    verbose=False,
    red_tol=1.0,
    red_tol_freq=0.5,
    n_angle_bins=200,
    notebook_progressbar=False,
    use_redundancy=False,
    use_tensorflow_to_derive_modeling_comps=False,
    eigenval_cutoff=1e-10,
    dtype_matinv=np.float64,
    require_exact_angle_match=True,
    angle_match_tol=1e-3,
    grp_size_threshold=5,
    model_comps_dict=None,
    save_dict_to=None,
    **fitting_kwargs,
):
    """Mixed DPSS + multi-baseline-covariance foreground fit (reference
    calibration.py:2210-2274). Single-baseline DPSS groups take the fused
    kernel; fitting groups of several baselines take the plain torch loss.
    The covariance and its eigendecomposition are host numpy, or with
    ``use_tensorflow_to_derive_modeling_comps=True`` (the reference's device
    eigh) torch float64 on the fit's ``device``. ``save_dict_to`` saves the
    component dict, which ``model_comps_dict=`` takes back."""
    fitting_grps, blvecs, _, _ = models.get_uv_overlapping_grps_conjugated(
        uvdata,
        red_tol=red_tol,
        include_autos=include_autos,
        red_tol_freq=red_tol_freq,
        n_angle_bins=n_angle_bins,
        notebook_progressbar=notebook_progressbar,
        require_exact_angle_match=require_exact_angle_match,
        angle_match_tol=angle_match_tol,
    )
    if model_comps_dict is None:
        model_comps_dict = models.yield_mixed_comps(
            fitting_grps,
            blvecs,
            np.asarray(uvdata.freq_array[0]),
            eigenval_cutoff=eigenval_cutoff,
            ant_dly=ant_dly,
            horizon=horizon,
            offset=offset,
            min_dly=min_dly,
            verbose=verbose,
            dtype=dtype_matinv,
            notebook_progressbar=notebook_progressbar,
            grp_size_threshold=grp_size_threshold,
            use_torch=use_tensorflow_to_derive_modeling_comps,
            device=fitting_kwargs.get("device", "cuda"),
        )
    if save_dict_to is not None:
        np.save(save_dict_to, np.asarray(model_comps_dict, dtype=object), allow_pickle=True)
    return calibrate_and_model_tensor(
        uvdata=uvdata,
        fg_model_comps_dict=model_comps_dict,
        include_autos=include_autos,
        verbose=verbose,
        notebook_progressbar=notebook_progressbar,
        use_redundancy=use_redundancy,
        grp_size_threshold=grp_size_threshold,
        **fitting_kwargs,
    )


def read_calibrate_and_model_dpss(
    input_data_files,
    input_model_files=None,
    input_gain_files=None,
    resid_outfilename=None,
    gain_outfilename=None,
    model_outfilename=None,
    fitted_info_outfilename=None,
    x_orientation="east",
    clobber=False,
    bllen_min=0.0,
    bllen_max=np.inf,
    bl_ew_min=0.0,
    ex_ants=None,
    select_ants=None,
    gpu_index=None,
    gpu_memory_limit=None,
    precision=32,
    use_autocorrs_in_weights=False,
    weights_file=None,
    host_data_dtype=None,
    device="cuda",
    **calibration_kwargs,
):
    """File-level driver (reference calibration.py:2277-2469).

    Reads uvh5 inputs, runs the DPSS fit on ``device``, writes resid/model
    uvh5 and gains (calfits or calh5 by extension). ``gpu_index`` and
    ``gpu_memory_limit`` are accepted for CLI parity and ignored: pick the
    card with ``device="cuda:N"``.

    ``weights_file``: path to a UVFlag HDF5 weights object; mutually
    exclusive with ``use_autocorrs_in_weights``. ``host_data_dtype``: host
    storage dtype for the visibility cubes ("complex64"/"complex128";
    default keeps the file dtype).

    Under ``torchrun`` (``WORLD_SIZE`` > 1) every rank reads and packs the
    whole file, joins the default process group (NCCL on
    ``cuda:LOCAL_RANK``, gloo for ``device="cpu"``) unless one is
    initialized already, and fits through the auto mesh (with
    ``time_parallel``); rank 0 alone writes the outputs, and a group this
    call created is destroyed when it returns."""
    del gpu_index, gpu_memory_limit
    from .parallel.mesh import init_distributed_from_env

    device, own_group = init_distributed_from_env(resolve_device(device))
    try:
        return _read_calibrate_and_model_dpss(
            input_data_files, input_model_files, input_gain_files, resid_outfilename,
            gain_outfilename, model_outfilename, fitted_info_outfilename, x_orientation,
            clobber, bllen_min, bllen_max, bl_ew_min, ex_ants, select_ants, precision,
            use_autocorrs_in_weights, weights_file, host_data_dtype, device,
            calibration_kwargs)
    finally:
        if own_group:
            import torch.distributed as dist

            dist.destroy_process_group()


def _read_calibrate_and_model_dpss(
    input_data_files, input_model_files, input_gain_files, resid_outfilename,
    gain_outfilename, model_outfilename, fitted_info_outfilename, x_orientation, clobber,
    bllen_min, bllen_max, bl_ew_min, ex_ants, select_ants, precision,
    use_autocorrs_in_weights, weights_file, host_data_dtype, device, calibration_kwargs,
):
    if host_data_dtype is not None:
        try:
            _hdt = np.dtype(host_data_dtype)
        except TypeError as exc:
            raise ValueError(
                "host_data_dtype must be complex64 or complex128, "
                f"got {host_data_dtype!r}"
            ) from exc
        if _hdt not in (np.dtype(np.complex64), np.dtype(np.complex128)):
            raise ValueError(
                "host_data_dtype must be complex64 or complex128, "
                f"got {host_data_dtype!r}"
            )

    def _cast_host_dtype(obj):
        """Cast an in-memory VisData's data cube to host_data_dtype without
        deep-copying the full-precision cube first."""
        if host_data_dtype is None or obj.data_array.dtype == _hdt:
            return obj
        import copy as _copy

        out = _copy.copy(obj)
        out.data_array = obj.data_array.astype(_hdt)
        out.flag_array = obj.flag_array.copy()
        out.nsample_array = obj.nsample_array.copy()
        return out

    # fail fast on taken output paths before any compute happens
    if not clobber:
        for out in (resid_outfilename, gain_outfilename, model_outfilename,
                    fitted_info_outfilename):
            if out is not None and os.path.exists(out):
                raise IOError(f"{out} exists and clobber=False")

    if isinstance(input_data_files, str):
        input_data_files = [input_data_files]
    if isinstance(input_data_files, list):
        uvd = VisData.from_uvh5(input_data_files[0], data_dtype=host_data_dtype)
        for extra in input_data_files[1:]:
            uvd = uvd + VisData.from_uvh5(extra, data_dtype=host_data_dtype)
    else:
        uvd = _cast_host_dtype(input_data_files)

    if use_autocorrs_in_weights and weights_file is not None:
        raise ValueError(
            "use_autocorrs_in_weights and weights_file are mutually exclusive"
        )
    if use_autocorrs_in_weights:
        weights = get_auto_weights(uvd)
    elif weights_file is not None:
        weights = FlagWeights.from_uvflag_h5(weights_file)
    else:
        weights = None
    select_baselines(
        uvd,
        bllen_min=bllen_min,
        bllen_max=bllen_max,
        bl_ew_min=bl_ew_min,
        ex_ants=ex_ants,
        select_ants=select_ants,
    )

    if isinstance(input_model_files, str):
        input_model_files = [input_model_files]
    if input_model_files is not None:
        if isinstance(input_model_files, list):
            uvd_model = VisData.from_uvh5(
                input_model_files[0], data_dtype=host_data_dtype
            )
            for extra in input_model_files[1:]:
                uvd_model = uvd_model + VisData.from_uvh5(
                    extra, data_dtype=host_data_dtype
                )
        else:
            uvd_model = _cast_host_dtype(input_model_files)
        select_baselines(
            uvd_model, bllen_min=bllen_min, bllen_max=bllen_max, bl_ew_min=bl_ew_min
        )
    else:
        uvd_model = None

    if isinstance(input_gain_files, str):
        input_gain_files = [input_gain_files]
    if input_gain_files is not None:
        if isinstance(input_gain_files, list):
            def _read_gain(path):
                if path.endswith(".calh5"):
                    return CalData.from_calh5(path)
                return CalData.from_calfits(path)

            uvc = _read_gain(input_gain_files[0])
            for extra in input_gain_files[1:]:
                uvc = uvc + _read_gain(extra)
        else:
            uvc = input_gain_files
    else:
        uvc = None

    dtype = {32: np.float32, 64: np.float64}[precision]

    model_fit, resid_fit, gains_fit, fit_info = calibrate_and_model_dpss(
        uvdata=uvd, sky_model=uvd_model, gains=uvc, dtype=dtype, weights=weights,
        device=device, **calibration_kwargs,
    )

    from .version import history_string

    # every rank returns the same objects; rank 0 alone writes them
    writer = is_writer()
    provenance = history_string()
    if resid_outfilename is not None:
        resid_fit.history = (resid_fit.history or "") + provenance
        if writer:
            resid_fit.write_uvh5(resid_outfilename, clobber=clobber)
    if gain_outfilename is not None:
        gains_fit.x_orientation = x_orientation
        gains_fit.history = (gains_fit.history or "") + provenance
        if writer and gain_outfilename.endswith(".calh5"):
            gains_fit.write_calh5(gain_outfilename, clobber=clobber)
        elif writer:
            gains_fit.write_calfits(gain_outfilename, clobber=clobber)
    if model_outfilename is not None:
        model_fit.history = (model_fit.history or "") + provenance
        if writer:
            model_fit.write_uvh5(model_outfilename, clobber=clobber)

    fit_info = {"fit_history": fit_info} if not isinstance(fit_info, dict) else fit_info
    fit_info["calibration_kwargs"] = dict(calibration_kwargs)
    fit_info["calibration_kwargs"]["dtype"] = dtype
    fit_info["calibration_kwargs"]["device"] = str(device)
    if writer and fitted_info_outfilename is not None:
        np.save(fitted_info_outfilename, fit_info, allow_pickle=True)
    return model_fit, resid_fit, gains_fit, fit_info


# --------------------------------------------------------------------- #
# CLI argument parsers (reference calibration.py:2475-2632)
# --------------------------------------------------------------------- #
def input_output_parser():
    ap = argparse.ArgumentParser()
    sp = ap.add_argument_group("Input and Output Arguments.")
    sp.add_argument("--input_data_files", type=str, nargs="+", required=True,
                    help="paths to data files to calibrate.")
    sp.add_argument("--input_model_files", type=str, nargs="+",
                    help="paths to model files to set overall amplitude and phase.")
    sp.add_argument("--input_gain_files", type=str, nargs="+",
                    help="paths to gains to use as a starting point.")
    sp.add_argument("--resid_outfilename", type=str, default=None,
                    help="path for residual output file.")
    sp.add_argument("--model_outfilename", type=str, default=None,
                    help="path for foreground model output file.")
    sp.add_argument("--gain_outfilename", type=str, default=None,
                    help="path for writing fitted gains (.calfits or .calh5).")
    sp.add_argument("--fitted_info_outfilename", type=str, default=None,
                    help="path for writing fit diagnostics (loss histories "
                         "and calibration kwargs) as an .npy pickle.")
    sp.add_argument("--clobber", action="store_true", default=False,
                    help="Overwrite existing outputs.")
    sp.add_argument("--x_orientation", default="east", type=str,
                    help="x_orientation of feeds to set in output gains.")
    sp.add_argument("--bllen_min", default=0.0, type=float,
                    help="minimum baseline length to include.")
    sp.add_argument("--bllen_max", default=np.inf, type=float,
                    help="maximum baseline length to include.")
    sp.add_argument("--bl_ew_min", default=0.0, type=float,
                    help="minimum EW baseline component to include.")
    sp.add_argument("--ex_ants", default=None, type=int, nargs="+",
                    help="Antennas to exclude.")
    sp.add_argument("--select_ants", default=None, type=int, nargs="+",
                    help="Antennas to select exclusively.")
    sp.add_argument("--gpu_index", default=None, type=int,
                    help="Accepted for parity; pick the card with --device cuda:N.")
    sp.add_argument("--gpu_memory_limit", default=None, type=int,
                    help="Accepted for parity; ignored.")
    sp.add_argument("--device", default="cuda", type=str,
                    help="Device of the fit: cuda (default), cuda:N or cpu. "
                         "CUDA that is not present is an error.")
    sp.add_argument("--precision", default=32, type=int,
                    help="Bits of floating-point precision (32 or 64).")
    sp.add_argument("--weights_file", default=None, type=str,
                    help="Path to a UVFlag HDF5 weights object (baseline "
                         "type, flag mode) to use as fitting weights; "
                         "mutually exclusive with --use_autocorrs_in_weights.")
    sp.add_argument("--host_data_dtype", default=None, type=str,
                    choices=["complex64", "complex128"],
                    help="Host storage dtype for visibility arrays (default "
                         "keeps the file dtype). complex64 halves every "
                         "host-side data copy; a precision-32 fit computes "
                         "in float32 either way.")
    return ap


def fitting_argparser():
    ap = input_output_parser()
    sp = ap.add_argument_group("General Fitting Arguments.")
    sp.add_argument("--tol", type=float, default=1e-14,
                    help="Stop once the loss changes by less than this value.")
    sp.add_argument("--optimizer", type=str, default="Adamax",
                    help="First-order optimizer: Adadelta, Adam, Adamax, Ftrl, "
                         "Nadam, SGD, RMSprop, Adagrad or LAMB.")
    sp.add_argument("--maxsteps", type=int, default=10000,
                    help="Max optimization steps.")
    sp.add_argument("--verbose", default=False, action="store_true")
    sp.add_argument("--use_min", default=False, action="store_true",
                    help="Return the argmin-loss parameters (guards momentum overshoot).")
    sp.add_argument("--patience", type=int, default=0,
                    help="Stop when the loss has not reached a new minimum "
                         "for this many steps; 0 disables. Combine with "
                         "--use_min so the returned state is the tracked argmin.")
    sp.add_argument("--use_redundancy", default=False, action="store_true",
                    help="Share foreground coefficients within redundant groups.")
    sp.add_argument("--correct_model", default=True, action=argparse.BooleanOptionalAction,
                    help="Remove gain effects from the foreground model.")
    sp.add_argument("--correct_resid", default=False, action=argparse.BooleanOptionalAction,
                    help="Apply fitted gains to the residuals.")
    sp.add_argument("--graph_mode", default=False, action="store_true",
                    help="Accepted for parity; ignored.")
    sp.add_argument("--init_guesses_from_previous_time_step", default=False,
                    action="store_true",
                    help="Warm-start each time from the previous time's solution "
                         "(with --time_parallel: the warm-started time scan).")
    sp.add_argument("--learning_rate", type=float, default=1e-2,
                    help="gradient descent learning rate.")
    sp.add_argument("--red_tol", type=float, default=1.0,
                    help="Redundancy tolerance between baselines [meters].")
    sp.add_argument("--skip_threshold", type=float, default=0.5,
                    help="Skip and flag a (time, pol) if more than this fraction is flagged.")
    sp.add_argument("--model_regularization", type=str, default="post_hoc")
    sp.add_argument("--nsamples_in_weights", default=False, action=argparse.BooleanOptionalAction,
                    help="Weight the loss by nsamples.")
    sp.add_argument("--use_model_snr_weights", default=False, action="store_true",
                    help="Weight the loss proportional to model SNR.")
    sp.add_argument("--use_autocorrs_in_weights", default=False, action="store_true",
                    help="Use smooth autocorrelation fits as inverse-variance weights.")
    tp = ap.add_argument_group("Scaling arguments.")
    tp.add_argument("--time_parallel", default=False, action="store_true",
                    help="Fit every (time, pol) slice in one batched descent on "
                         "the device; with --init_guesses_from_previous_time_step, "
                         "fit each polarization's times in order instead, each "
                         "seeded by the one before (the warm-started time scan).")
    tp.add_argument("--use_pallas", default=False, action="store_true",
                    help="Accepted for parity; ignored (on CUDA the fused "
                         "chunk-loss kernel runs wherever its gate accepts "
                         "a chunk).")
    tp.add_argument("--comps_precision", default=None, type=str,
                    choices=["float32", "bfloat16", "mixed"],
                    help="Basis-tensor storage precision during the descent: "
                         "bfloat16 halves the bytes of comps read per step "
                         "(bf16 convergence floor); mixed descends in bf16 "
                         "then polishes in float32. Default: mixed for "
                         "32-bit fits, float32 under --precision 64.")
    tp.add_argument("--wgts_precision", default="float32", type=str,
                    choices=["float32", "bfloat16"],
                    help="Weight-cube storage precision: bfloat16 halves the "
                         "weights' device memory and reads (the fused kernel "
                         "widens them on load).")
    tp.add_argument("--checkpoint_dir", default=None, type=str,
                    help="Persist the descent state here every "
                         "--checkpoint_every steps and resume from the "
                         "latest checkpoint found.")
    tp.add_argument("--checkpoint_every", default=1000, type=int,
                    help="Steps between mid-fit checkpoints.")
    tp.add_argument("--steps_per_execution", default=None, type=int,
                    help="time_parallel only: recorded steps per descent call "
                         "(per time on the scan), "
                         "independent of the checkpoint cadence (the "
                         "trajectory does not depend on it).")
    tp.add_argument("--loss_block_ngrps", default=None, type=int,
                    help="time_parallel only: evaluate each chunk's loss over "
                         "blocks of this many groups, recomputed on the "
                         "backward pass (bounds the activation memory).")
    return ap


def dpss_fit_argparser():
    ap = fitting_argparser()
    sp = ap.add_argument_group("DPSS Specific Fitting Arguments.")
    sp.add_argument("--horizon", default=1.0, type=float,
                    help="Fraction of horizon delay to model with DPSS modes.")
    sp.add_argument("--min_dly", default=0.0, type=float,
                    help="Minimum delay [ns] to model with DPSS modes.")
    sp.add_argument("--offset", default=0.0, type=float,
                    help="Offset from horizon delay [ns] to model with DPSS modes.")
    return ap
