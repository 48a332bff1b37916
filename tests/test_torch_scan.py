"""The port's warm-started time scan against calamity_tpu's, on the CPU.

``calibrate_and_model_tensor(time_parallel=True,
init_guesses_from_previous_time_step=True)`` without a checkpoint directory,
bounded execution, loss blocking or mixed schedule (where the reference
compiles one ``lax.scan``) on the multi-time Golomb fixture with gain
errors: a skipped time, ``use_min`` with patience, ``freeze_model``, the
"sum" prior, a sky model, model-SNR weights, bfloat16 weights and another
optimizer; ``scanned_warmstart_fit_core`` against its JAX counterpart
directly (float64, and the zero-plateau patience case of
tests/test_parallel.py); the step-0 guard armed on every time and catching
a cube corrupted after upload; the CLI's ``--time_parallel
--init_guesses_from_previous_time_step`` against the JAX CLI; profiler
traces (``n_profile_steps``). Checkpoints, bounded execution, loss
blocking and the mixed schedule are in tests/test_torch_scan_checkpoint.py.

Tolerances (those of tests/test_torch_time_parallel.py): float32 descents of
a few hundred steps in two frameworks agree to 1e-3 of the data rms in the
outputs and 1e-3 in the gains, with equal recorded steps per time and the
first 25 losses of every time within rel 1e-4; float64 core runs to rel
1e-9 (only summation order differs).
"""

import numpy as np
import pytest
import torch
from torch_parity import (
    DPSS_DLY,
    as_port,
    batched_problem,
    flagged_for_skip,
    gain_corrupted,
    multitime_visdata,
    rel_err,
    to_np,
)

from calamity_tpu import calibration as jcal
from calamity_tpu import cli as jcli
from calamity_tpu.io import CalData, VisData
from calamity_tpu_torch import calibration as tcal
from calamity_tpu_torch import cli as tcli
from calamity_tpu_torch import io as tio
from calamity_tpu_torch.parallel import batched as tb

RMS = lambda x: float(np.sqrt(np.mean(np.abs(x) ** 2)))  # noqa: E731


@pytest.fixture(scope="module")
def corrupted_multitime(golomb_visdata):
    return gain_corrupted(multitime_visdata(golomb_visdata))


@pytest.fixture(scope="module")
def flagged_multitime(corrupted_multitime):
    return flagged_for_skip(corrupted_multitime)


SCAN = dict(min_dly=DPSS_DLY, offset=DPSS_DLY, tol=1e-10, learning_rate=1e-2,
            model_regularization="post_hoc", shared_basis=False, time_parallel=True,
            init_guesses_from_previous_time_step=True, correct_resid=True)


def _both(uvd, **kw):
    kw = dict(SCAN, **kw)
    jout = jcal.calibrate_and_model_dpss(uvdata=uvd, **kw)
    timings = {}
    tkw = {k: as_port(v) if k == "sky_model" else v for k, v in kw.items()}
    tout = tcal.calibrate_and_model_dpss(uvdata=as_port(uvd), device="cpu", timings=timings,
                                         **tkw)
    return jout, tout, timings


def _assert_agree(jout, tout, uvd):
    (mj, rj, gj, hj), (mt, rt, gt, ht) = jout, tout
    data_rms = RMS(uvd.data_array[~uvd.flag_array])
    for pol, by_time in hj.items():
        assert sorted(ht[pol]) == sorted(by_time)
        for t, h in by_time.items():
            got, want = np.asarray(ht[pol][t]["loss"]), np.asarray(h["loss"])
            assert len(got) == len(want)
            n = min(25, len(want))
            assert rel_err(got[:n], want[:n]) <= 1e-4
    np.testing.assert_array_equal(gt.flag_array, gj.flag_array)
    np.testing.assert_array_equal(rt.flag_array, rj.flag_array)
    assert np.max(np.abs(gt.gain_array - gj.gain_array)) <= 1e-3
    assert np.max(np.abs(rt.data_array - rj.data_array)) <= 1e-3 * data_rms
    assert np.max(np.abs(mt.data_array - mj.data_array)) <= 1e-3 * data_rms


def test_scan_matches_jax_with_a_skipped_time(flagged_multitime):
    jout, tout, timings = _both(flagged_multitime, maxsteps=250)
    _assert_agree(jout, tout, flagged_multitime)
    hist = tout[3][0]
    assert sorted(hist) == [0, 2]  # time 1 skipped and flagged
    assert np.all(tout[2].flag_array[:, 0, :, 1, 0])
    assert all(h["phase_steps"] == [len(h["loss"])] for h in hist.values())
    assert {"scan_upload_s", "scan_descent_s", "scan_guard_s", "scan_fetch_s",
            "writeback_s"} <= set(timings)
    assert "scan_save_s" not in timings  # nothing persists without a checkpoint dir
    data = flagged_multitime.data_array[~flagged_multitime.flag_array]
    assert RMS(tout[1].data_array[~flagged_multitime.flag_array]) <= 1e-2 * RMS(data)


@pytest.mark.parametrize("case", ["use_min_patience", "freeze_model", "sum_prior", "sky_model",
                                  "snr_weights", "bfloat16_weights", "optimizer"])
def test_scan_options_match_jax(corrupted_multitime, flagged_multitime, case):
    uvd = corrupted_multitime
    kw = dict(maxsteps=150)
    if case == "use_min_patience":
        # argmin tracking and the patience counter on every time (patience
        # firing is held to the JAX package in float64 below, where larger
        # steps do not amplify float32 rounding)
        kw.update(use_min=True, patience=8, learning_rate=0.1, tol=0.0)
    elif case == "freeze_model":
        kw.update(freeze_model=True)
    elif case == "sum_prior":
        kw.update(model_regularization="sum")
    elif case == "sky_model":
        kw.update(sky_model=corrupted_multitime.copy())
    elif case == "snr_weights":
        kw.update(use_model_snr_weights=True)
    elif case == "bfloat16_weights":
        uvd = flagged_multitime  # frequency-dependent weights, stored as bfloat16
        kw.update(wgts_precision="bfloat16")
    elif case == "optimizer":
        kw.update(optimizer="Adam")
    jout, tout, _ = _both(uvd, **kw)
    _assert_agree(jout, tout, uvd)


@pytest.fixture(scope="module")
def problem64(corrupted_multitime):
    """Host stacks of the 3 times (1 polarization) in float64, with the
    time-0 warm start (the core's inputs)."""
    return batched_problem(corrupted_multitime, dtype=np.float64, gain_err=0.1)[1]


@pytest.mark.parametrize("case", ["tol", "use_min_patience", "freeze_model", "sum_prior"])
def test_scanned_warmstart_fit_core_matches_jax(problem64, case):
    from calamity_tpu.parallel.batched import scanned_warmstart_fit_core as jax_scan
    from calamity_tpu.solver.fit import FitConfig as JaxFitConfig
    from calamity_tpu_torch.convert import chunks_from_jax
    from calamity_tpu_torch.solver.fit import FitConfig

    p = problem64
    kw = dict(opt_kwargs=(("learning_rate", 1e-2),), maxsteps=120, tol=1e-9)
    prior = (np.zeros(3), np.zeros(3))
    if case == "use_min_patience":
        kw.update(use_min=True, patience=4, tol=0.0, opt_kwargs=(("learning_rate", 0.3),))
    elif case == "freeze_model":
        kw.update(freeze_model=True)
    elif case == "sum_prior":
        kw.update(regularization="sum")
        rng = np.random.default_rng(2)
        prior = (rng.uniform(0.5, 1.0, 3), rng.uniform(-0.1, 0.1, 3))
    args = (p["data_r"], p["data_i"], p["wgts"], p["g_r"][0], p["g_i"][0],
            [f[0] for f in p["fg_r"]], [f[0] for f in p["fg_i"]], *prior)
    jparams, jhist, jsteps, jfinal = jax_scan(JaxFitConfig(**kw), p["chunks"],
                                              *[tuple(a) if isinstance(a, list) else a
                                                for a in args])

    def t(x):
        return torch.as_tensor(np.array(x))

    tparams, thist, tsteps, tfinal = tb.scanned_warmstart_fit_core(
        FitConfig(**kw), chunks_from_jax(p["chunks"], "cpu"), *args[:3], t(args[3]), t(args[4]),
        [t(f) for f in args[5]], [t(f) for f in args[6]], *prior)
    assert thist.shape == (3, kw["maxsteps"])
    np.testing.assert_array_equal(tsteps, np.asarray(jsteps))
    np.testing.assert_array_equal(np.isnan(thist), np.isnan(np.asarray(jhist)))
    done = ~np.isnan(thist)
    assert rel_err(thist[done], np.asarray(jhist)[done]) <= 1e-6  # the history is float32
    assert rel_err(tfinal, jfinal) <= 1e-9
    for got, want in zip([tparams[0], tparams[1], *tparams[2], *tparams[3]],
                         [jparams[0], jparams[1], *jparams[2], *jparams[3]]):
        assert rel_err(got, want) <= 1e-9
    if case == "use_min_patience":
        assert (tsteps < kw["maxsteps"]).all()


def test_patience_stops_every_time_of_the_scan():
    """tests/test_parallel.py::test_patience_stops_warmstart_scan on the
    port: on the zero plateau every time stops after patience + 1 recorded
    steps with its (zero) argmin loss."""
    from conftest import zero_plateau_fit_args

    from calamity_tpu_torch.convert import chunks_from_jax
    from calamity_tpu_torch.solver.fit import FitConfig

    chunks, data_r, data_i, wgts, g_r, g_i, fg = zero_plateau_fit_args()

    def two_times(x):
        return np.stack([np.asarray(x), np.asarray(x)])

    cfg = FitConfig(opt_kwargs=(("learning_rate", 1e-2),), maxsteps=200, tol=0.0, use_min=True,
                    patience=40)
    _, history, nsteps, finals = tb.scanned_warmstart_fit_core(
        cfg, chunks_from_jax(chunks, "cpu"), [two_times(data_r[0])], [two_times(data_i[0])],
        [two_times(wgts[0])], torch.as_tensor(np.asarray(g_r)), torch.as_tensor(np.asarray(g_i)),
        [torch.as_tensor(np.asarray(fg[0]))], [torch.zeros(np.asarray(fg[0]).shape,
                                                           dtype=torch.float64)],
        np.zeros(2), np.zeros(2))
    assert nsteps.tolist() == [41, 41]
    assert to_np(finals).tolist() == [0.0, 0.0]
    assert history.shape == (2, 200)
    assert np.all(history[:, :41] == 0.0) and np.all(np.isnan(history[:, 41:]))


@pytest.mark.parametrize("comps_precision", ["float32", "mixed"])
def test_guard_is_armed_on_every_time(corrupted_multitime, monkeypatch, comps_precision):
    """The step-0 guard's independent loss is taken on every time of both
    forms (the first phase of each time under the mixed schedule), and a
    cube corrupted after its upload stops the scan."""
    calls = []
    real_losses = tb.host_batched_losses

    def counting(*a, **k):
        calls.append(1)
        return real_losses(*a, **k)

    monkeypatch.setattr(tb, "host_batched_losses", counting)
    kw = dict(SCAN, uvdata=as_port(corrupted_multitime), maxsteps=30, tol=0.0,
              comps_precision=comps_precision, device="cpu")
    tcal.calibrate_and_model_dpss(**kw)
    assert len(calls) == 3

    real_upload = tb.upload_time_slice

    def scrambling(stack, t, device):
        out = real_upload(stack, t, device)
        if t == 1 and out.dim() == 4:  # time 1's data and weight cubes
            out = out.flip(-1) * 3.0
        return out

    monkeypatch.setattr(tb, "upload_time_slice", scrambling)
    with pytest.raises(RuntimeError, match="step-0 loss cross-check failed"):
        tcal.calibrate_and_model_dpss(**kw)


def test_cli_scan_matches_jax_cli(corrupted_multitime, tmp_path):
    uvd = corrupted_multitime
    path = str(tmp_path / "in.uvh5")
    uvd.write_uvh5(path)

    def run(main, tag, extra):
        outs = {k: str(tmp_path / f"{tag}_{k}") for k in ("resid.uvh5", "model.uvh5",
                                                          "gains.calfits")}
        main(["--input_data_files", path, "--resid_outfilename", outs["resid.uvh5"],
              "--model_outfilename", outs["model.uvh5"], "--gain_outfilename",
              outs["gains.calfits"], "--min_dly", str(DPSS_DLY), "--offset", str(DPSS_DLY),
              "--maxsteps", "100", "--tol", "1e-10", "--time_parallel",
              "--init_guesses_from_previous_time_step", "--clobber"] + extra)
        return outs

    oj = run(jcli.main, "j", [])
    ot = run(tcli.main, "t", ["--device", "cpu"])
    for key in ("resid.uvh5", "model.uvh5"):
        a, b = tio.VisData.from_uvh5(ot[key]), VisData.from_uvh5(oj[key])
        np.testing.assert_array_equal(a.flag_array, b.flag_array)
        assert np.max(np.abs(a.data_array - b.data_array)) <= 1e-3 * RMS(uvd.data_array)
    ga = tio.CalData.from_calfits(ot["gains.calfits"])
    gb = CalData.from_calfits(oj["gains.calfits"])
    assert np.max(np.abs(ga.gain_array - gb.gain_array)) <= 1e-3


@pytest.mark.parametrize("comps_precision", ["float32", "mixed"])
def test_scan_profile_steps_write_a_trace(corrupted_multitime, tmp_path, comps_precision):
    """n_profile_steps: one short one-time scan traced before the fit; the
    fit itself unchanged."""
    kw = dict(SCAN, uvdata=as_port(corrupted_multitime), maxsteps=20, tol=0.0,
              comps_precision=comps_precision, device="cpu")
    _, r_plain, g_plain, h_plain = tcal.calibrate_and_model_dpss(**kw)
    logdir = tmp_path / "prof"
    _, r_prof, g_prof, h_prof = tcal.calibrate_and_model_dpss(
        n_profile_steps=4, profile_log_dir=str(logdir), **kw)
    assert len(list(logdir.glob("trace_*.json"))) == 1
    for t, h in h_plain[0].items():
        assert h_prof[0][t]["loss"] == h["loss"]
    np.testing.assert_array_equal(g_prof.gain_array, g_plain.gain_array)
    np.testing.assert_array_equal(r_prof.data_array, r_plain.data_array)
