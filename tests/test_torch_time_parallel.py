"""The port's time-parallel driver end to end against calamity_tpu's, on
the CPU: ``calibrate_and_model_tensor(time_parallel=True)`` on the
multi-time Golomb fixture (model, resid, gains and per-slice histories,
with a slice skipped by ``skip_threshold``, the float32 and mixed
schedules and bfloat16 weights), the port's batched driver against its
serial driver, the CLI's ``--time_parallel`` against the JAX CLI, the
serial path with bfloat16 weights against the JAX package, and profiler
traces of the batched descent (``n_profile_steps``).

Tolerances: float32 descents of up to a few hundred steps in two
frameworks; outputs agree to 1e-3 of the data rms and gains to 1e-3 of
their amplitude (summation-order differences compound over the steps);
loss histories of a 25-step fit to rel 1e-4.
"""

import numpy as np
import pytest
from torch_parity import (
    DPSS_DLY,
    as_port,
    flagged_for_skip,
    gain_corrupted,
    multitime_visdata,
    rel_err,
)

from calamity_tpu import calibration as jcal
from calamity_tpu import cli as jcli
from calamity_tpu.io import CalData, VisData
from calamity_tpu_torch import calibration as tcal
from calamity_tpu_torch import cli as tcli
from calamity_tpu_torch import io as tio

RMS = lambda x: float(np.sqrt(np.mean(np.abs(x) ** 2)))  # noqa: E731


@pytest.fixture(scope="module")
def corrupted_multitime(golomb_visdata):
    """The multi-time fixture with 5% gain errors applied."""
    return gain_corrupted(multitime_visdata(golomb_visdata))


@pytest.fixture(scope="module")
def flagged_multitime(corrupted_multitime):
    """Three times; time 1 skipped at skip_threshold 0.5; frequency-dependent
    weights at time 0."""
    return flagged_for_skip(corrupted_multitime)


def _both(uvd, **kw):
    kw = dict(dict(min_dly=DPSS_DLY, offset=DPSS_DLY, tol=1e-10, learning_rate=1e-2,
                   model_regularization="post_hoc", shared_basis=False, time_parallel=True,
                   correct_resid=True), **kw)
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
            assert len(ht[pol][t]["loss"]) == len(h["loss"])
    np.testing.assert_array_equal(gt.flag_array, gj.flag_array)
    np.testing.assert_array_equal(rt.flag_array, rj.flag_array)
    assert np.max(np.abs(gt.gain_array - gj.gain_array)) <= 1e-3
    assert np.max(np.abs(rt.data_array - rj.data_array)) <= 1e-3 * data_rms
    assert np.max(np.abs(mt.data_array - mj.data_array)) <= 1e-3 * data_rms


@pytest.mark.parametrize("comps_precision", ["float32", "mixed"])
def test_driver_matches_jax_with_a_skipped_slice(flagged_multitime, comps_precision):
    jout, tout, timings = _both(flagged_multitime, maxsteps=300, comps_precision=comps_precision)
    _assert_agree(jout, tout, flagged_multitime)
    hist = tout[3][0]
    assert sorted(hist) == [0, 2]  # time 1 skipped and flagged
    assert np.all(tout[2].flag_array[:, 0, :, 1, 0])
    assert {"extract_s", "upload_s", "warmstart_s", "descent_s", "writeback_s"} <= set(timings)
    nphases = 2 if comps_precision == "mixed" else 1
    assert len(timings["phase_steps"]) == nphases
    if comps_precision == "mixed":
        assert all(len(h["phase_steps"]) == 2 for h in hist.values())
    data = flagged_multitime.data_array[~flagged_multitime.flag_array]
    assert RMS(tout[1].data_array[~flagged_multitime.flag_array]) <= 1e-2 * RMS(data)


def test_driver_bfloat16_weights_match_jax(flagged_multitime):
    jout, tout, _ = _both(flagged_multitime, maxsteps=200, comps_precision="float32",
                          wgts_precision="bfloat16")
    _assert_agree(jout, tout, flagged_multitime)


@pytest.mark.parametrize("case", ["sky_model", "snr_weights", "loss_block", "sum_prior"])
def test_driver_options_match_jax(corrupted_multitime, case):
    """The warm-start and prior variants of the driver: a sky model other
    than the data (packed and uploaded block by block), model-SNR weights,
    a blocked loss, and the "sum" prior."""
    kw = dict(maxsteps=150, comps_precision="float32")
    if case == "sky_model":
        kw["sky_model"] = corrupted_multitime.copy()
    elif case == "snr_weights":
        kw["use_model_snr_weights"] = True
    elif case == "loss_block":
        kw["loss_block_ngrps"] = 4
    elif case == "sum_prior":
        kw["model_regularization"] = "sum"
    jout, tout, _ = _both(corrupted_multitime, **kw)
    _assert_agree(jout, tout, corrupted_multitime)


def test_batched_driver_matches_serial_driver(corrupted_multitime):
    uvd = as_port(corrupted_multitime)
    kw = dict(min_dly=DPSS_DLY, offset=DPSS_DLY, maxsteps=150, tol=1e-10, learning_rate=1e-2,
              model_regularization="post_hoc", shared_basis=False, comps_precision="float32",
              device="cpu")
    _, rs, gs, hs = tcal.calibrate_and_model_dpss(uvdata=uvd, **kw)
    _, rp, gp, hp = tcal.calibrate_and_model_dpss(uvdata=uvd, time_parallel=True, **kw)
    for t in range(3):
        assert len(hp[0][t]["loss"]) == len(hs[0][t]["loss"])
        assert rel_err(np.asarray(hp[0][t]["loss"]), np.asarray(hs[0][t]["loss"])) <= 1e-4
    assert np.max(np.abs(gp.gain_array - gs.gain_array)) <= 1e-4
    assert np.max(np.abs(rp.data_array - rs.data_array)) <= 1e-4 * RMS(uvd.data_array)


def test_cli_time_parallel_matches_jax_cli(corrupted_multitime, tmp_path):
    uvd = corrupted_multitime
    path = str(tmp_path / "in.uvh5")
    uvd.write_uvh5(path)

    def run(main, tag, extra):
        outs = {k: str(tmp_path / f"{tag}_{k}") for k in ("resid.uvh5", "model.uvh5",
                                                          "gains.calfits")}
        main(["--input_data_files", path, "--resid_outfilename", outs["resid.uvh5"],
              "--model_outfilename", outs["model.uvh5"], "--gain_outfilename",
              outs["gains.calfits"], "--min_dly", str(DPSS_DLY), "--offset", str(DPSS_DLY),
              "--maxsteps", "100", "--tol", "1e-10", "--time_parallel", "--clobber"] + extra)
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


def test_serial_driver_bfloat16_weights_match_jax(flagged_multitime):
    kw = dict(min_dly=DPSS_DLY, offset=DPSS_DLY, maxsteps=200, tol=1e-10, learning_rate=1e-2,
              model_regularization="post_hoc", shared_basis=False, comps_precision="float32",
              wgts_precision="bfloat16")
    jout = jcal.calibrate_and_model_dpss(uvdata=flagged_multitime, **kw)
    tout = tcal.calibrate_and_model_dpss(uvdata=as_port(flagged_multitime), device="cpu", **kw)
    _assert_agree(jout, tout, flagged_multitime)


@pytest.mark.parametrize("kwargs", [dict(), dict(init_guesses_from_previous_time_step=True)])
def test_time_parallel_options_not_ported_raise(golomb_visdata, kwargs):
    # a mesh on the time-parallel paths is a ('data', 'bl') DeviceMesh from
    # parallel.mesh.make_mesh (tests/test_torch_mesh.py); anything else raises
    with pytest.raises(TypeError, match="DeviceMesh from make_mesh"):
        tcal.calibrate_and_model_dpss(uvdata=as_port(golomb_visdata), min_dly=DPSS_DLY,
                                      offset=DPSS_DLY, maxsteps=2, time_parallel=True,
                                      device="cpu", mesh=object(), **kwargs)


@pytest.mark.parametrize("comps_precision", ["float32", "mixed"])
def test_time_parallel_profile_steps_write_a_trace(corrupted_multitime, tmp_path,
                                                   comps_precision):
    """n_profile_steps: a short batched descent traced before the fit, its
    Chrome trace under profile_log_dir; the fit itself unchanged."""
    kw = dict(uvdata=as_port(corrupted_multitime), min_dly=DPSS_DLY, offset=DPSS_DLY,
              maxsteps=20, tol=0.0, model_regularization="post_hoc", shared_basis=False,
              time_parallel=True, comps_precision=comps_precision, device="cpu")
    _, r_plain, g_plain, h_plain = tcal.calibrate_and_model_dpss(**kw)
    logdir = tmp_path / "prof"
    _, r_prof, g_prof, h_prof = tcal.calibrate_and_model_dpss(
        n_profile_steps=4, profile_log_dir=str(logdir), **kw)
    assert len(list(logdir.glob("trace_*.json"))) == 1
    assert h_prof == h_plain
    np.testing.assert_array_equal(g_prof.gain_array, g_plain.gain_array)
    np.testing.assert_array_equal(r_prof.data_array, r_plain.data_array)
