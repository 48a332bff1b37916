"""The port's drivers end to end against calamity_tpu's, on the CPU.

- ``read_calibrate_and_model_dpss`` and the CLI on the tests/test_cli.py
  scenario (redundant array, model and gain input files, default
  ``shared_basis=True`` so shared and dense chunks are both packed): gains
  and the written files agree with the JAX run.
- The slice's configuration (post_hoc, ``shared_basis=False``: every chunk
  dense, through the fused loss) on the golden Golomb file: gains agree and
  resid rms <= 1e-2 x data rms.
- The DFT and mixed drivers (``calibrate_and_model_dft``,
  ``calibrate_and_model_mixed``) on the scenarios of tests/test_calibration.py,
  at fewer steps: gains and outputs agree with the JAX run; the mixed
  driver's saved component dict round-trips.
- Importing the port never loads jax nor the JAX package; device meshes
  (not ported yet) and wrong option values raise.

Tolerance: float32 descents of a few hundred steps in two frameworks;
gains agree to 1e-3 of their amplitude and outputs to 1e-3 of the data
rms (summation-order differences compound over the steps).
"""

import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch
from torch_parity import DPSS_DLY, GOLDEN_GOLOMB, as_port, project_onto_dpss, rel_err

from calamity_tpu import calibration as jcal
from calamity_tpu import cli as jcli
from calamity_tpu.io import CalData, VisData
from calamity_tpu_torch import calibration as tcal
from calamity_tpu_torch import cli as tcli
from calamity_tpu_torch import io as tio

RMS = lambda x: float(np.sqrt(np.mean(np.abs(x) ** 2)))  # noqa: E731
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def cli_scenario(tmp_path, redundant_visdata):
    path = str(tmp_path / "input.uvh5")
    redundant_visdata.write_uvh5(path)
    gains = CalData.blank_from_visdata(redundant_visdata)
    gains.x_orientation = "east"
    gname = str(tmp_path / "gains_input.calfits")
    gains.write_calfits(gname)
    return tmp_path, path, gname


def _outputs(tmp_path, tag):
    return {k: str(tmp_path / f"{tag}_{k}") for k in ("resid.uvh5", "model.uvh5",
                                                      "gains.calfits")}


def _assert_files_agree(a, b, data_rms):
    """``a``: the port's files, read by the port; ``b``: the JAX package's."""
    for key in ("resid.uvh5", "model.uvh5"):
        va, vb = tio.VisData.from_uvh5(a[key]), VisData.from_uvh5(b[key])
        np.testing.assert_array_equal(va.flag_array, vb.flag_array)
        assert np.max(np.abs(va.data_array - vb.data_array)) <= 1e-3 * data_rms
    ga = tio.CalData.from_calfits(a["gains.calfits"])
    gb = CalData.from_calfits(b["gains.calfits"])
    assert np.max(np.abs(ga.gain_array - gb.gain_array)) <= 1e-3 * np.max(np.abs(gb.gain_array))
    assert ga.x_orientation == gb.x_orientation == "east"


def test_read_calibrate_and_model_dpss_matches_jax(cli_scenario, redundant_visdata):
    tmp_path, path, gname = cli_scenario
    kw = dict(input_data_files=path, input_model_files=path, input_gain_files=gname,
              maxsteps=150, tol=1e-10, min_dly=DPSS_DLY, offset=DPSS_DLY)
    out_j, out_t = _outputs(tmp_path, "jax"), _outputs(tmp_path, "torch")
    _, _, gj, info_j = jcal.read_calibrate_and_model_dpss(
        resid_outfilename=out_j["resid.uvh5"], model_outfilename=out_j["model.uvh5"],
        gain_outfilename=out_j["gains.calfits"], **kw)
    # the in-memory default regularization, "sum": every B=1 chunk takes a
    # chunk-loss kernel's "sum" instances (on the CPU, their plain versions)
    model, resid, gt, info_t = tcal.read_calibrate_and_model_dpss(
        resid_outfilename=out_t["resid.uvh5"], model_outfilename=out_t["model.uvh5"],
        gain_outfilename=out_t["gains.calfits"], device="cpu", **kw)
    assert info_t["calibration_kwargs"]["device"] == "cpu"
    assert info_t["calibration_kwargs"]["dtype"] == np.float32
    for t, h in info_j[0].items():
        assert len(info_t[0][t]["loss"]) == len(h["loss"])
        assert info_t[0][t]["phase_steps"] == h["phase_steps"]
    assert np.max(np.abs(gt.gain_array - gj.gain_array)) <= 1e-3
    _assert_files_agree(out_t, out_j, RMS(redundant_visdata.data_array))
    back = tio.VisData.from_uvh5(out_t["model.uvh5"])
    assert "[calamity_tpu provenance]" in back.history
    np.testing.assert_array_equal(back.data_array, model.data_array)


def test_cli_matches_jax_cli(cli_scenario, redundant_visdata):
    tmp_path, path, gname = cli_scenario
    out_j, out_t = _outputs(tmp_path, "jcli"), _outputs(tmp_path, "tcli")

    def argv(out):
        return ["--input_data_files", path, "--resid_outfilename", out["resid.uvh5"],
                "--model_outfilename", out["model.uvh5"], "--gain_outfilename",
                out["gains.calfits"], "--min_dly", str(DPSS_DLY), "--offset", str(DPSS_DLY),
                "--maxsteps", "100", "--tol", "1e-10", "--clobber"]

    jcli.main(argv(out_j))
    # post_hoc: every chunk, shared ones included, is one a kernel takes
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        tcli.main(argv(out_t) + ["--device", "cpu"])
    assert not [w for w in caught if "plain torch loss" in str(w.message)]
    _assert_files_agree(out_t, out_j, RMS(redundant_visdata.data_array))
    args = tcal.dpss_fit_argparser().parse_args(["--input_data_files", "x.uvh5"])
    assert args.device == "cuda" and args.model_regularization == "post_hoc"


def test_slice_configuration_on_golden_golomb():
    """post_hoc regularization with every chunk dense: the configuration
    whose loss the fused kernel computes on the card."""
    uvd = VisData.from_uvh5(GOLDEN_GOLOMB)
    kw = dict(min_dly=DPSS_DLY, offset=DPSS_DLY, maxsteps=300, tol=1e-10, learning_rate=1e-2,
              model_regularization="post_hoc", shared_basis=False)
    _, rj, gj, _ = jcal.calibrate_and_model_dpss(uvdata=uvd, **kw)
    timings = {}
    _, rt, gt, ht = tcal.calibrate_and_model_dpss(uvdata=tio.VisData.from_uvh5(GOLDEN_GOLOMB),
                                                  device="cpu", timings=timings, **kw)
    assert {"basis_s", "packing_s", "fit_s", "writeback_s"} <= set(timings)
    assert ht[0][0]["phase_steps"][0] > 0
    assert np.max(np.abs(gt.gain_array - gj.gain_array)) <= 1e-3
    data_rms = RMS(uvd.data_array[~uvd.flag_array])
    assert RMS(rt.data_array[~uvd.flag_array]) <= 1e-2 * data_rms
    assert np.max(np.abs(rt.data_array - rj.data_array)) <= 1e-3 * data_rms


def test_import_never_loads_jax():
    code = (
        "import sys; import calamity_tpu_torch, calamity_tpu_torch.calibration, "
        "calamity_tpu_torch.cli, calamity_tpu_torch.convert, calamity_tpu_torch.ops._build, "
        "calamity_tpu_torch.parallel, calamity_tpu_torch.solver.checkpoint, "
        "calamity_tpu_torch.simulate, calamity_tpu_torch.models, calamity_tpu_torch.version; "
        "bad = sorted(m for m in sys.modules if m in ('jax', 'jaxlib', 'optax', 'calamity_tpu') "
        "or m.startswith(('jax.', 'calamity_tpu.'))); "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("kwargs", [
    dict(mesh=object()),
    dict(mesh=False),
    dict(time_parallel=True, mesh=False),
])
def test_mesh_is_read_on_the_time_parallel_paths_only(golomb_visdata, kwargs):
    """As in the JAX package: the serial path ignores ``mesh`` (anything at
    all), and ``mesh=False`` opts the time-parallel path out of the auto
    mesh; either way the fit is the one without the keyword."""
    kw = dict(min_dly=DPSS_DLY, offset=DPSS_DLY, maxsteps=20, device="cpu",
              time_parallel=kwargs.get("time_parallel", False))
    want = tcal.calibrate_and_model_dpss(uvdata=as_port(golomb_visdata), **kw)
    got = tcal.calibrate_and_model_dpss(uvdata=as_port(golomb_visdata), **dict(kw, **kwargs))
    for t, h in want[3][0].items():
        assert got[3][0][t]["loss"] == h["loss"]
    np.testing.assert_array_equal(got[2].gain_array, want[2].gain_array)
    np.testing.assert_array_equal(got[1].data_array, want[1].data_array)


@pytest.mark.parametrize("kwargs, exc, match", [
    (dict(steps_per_execution=10), ValueError, "time_parallel paths only"),
    (dict(optimizer="Adamw"), KeyError, "unknown optimizer"),
    (dict(wgts_precision="float16"), ValueError, "wgts_precision"),
    (dict(loss_block_ngrps=8), ValueError, "time_parallel"),
])
def test_not_ported_options_raise(golomb_visdata, kwargs, exc, match):
    with pytest.raises(exc, match=match):
        tcal.calibrate_and_model_dpss(uvdata=as_port(golomb_visdata), min_dly=DPSS_DLY,
                                      offset=DPSS_DLY, maxsteps=2, device="cpu", **kwargs)


def test_cuda_device_without_cuda_raises(golomb_visdata):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcal.calibrate_and_model_dpss(uvdata=as_port(golomb_visdata), maxsteps=2)


def _assert_fits_agree(jout, tout, data):
    (mj, rj, gj, hj), (mt, rt, gt, ht) = jout, tout
    for pol, by_time in hj.items():
        for t, h in by_time.items():
            assert len(ht[pol][t]["loss"]) == len(h["loss"])
    assert np.max(np.abs(gt.gain_array - gj.gain_array)) <= 1e-3
    data_rms = RMS(data)
    assert np.max(np.abs(rt.data_array - rj.data_array)) <= 1e-3 * data_rms
    assert np.max(np.abs(mt.data_array - mj.data_array)) <= 1e-3 * data_rms


@pytest.mark.parametrize("shared_basis", [True, False])
def test_dft_driver_matches_jax(golomb_visdata, shared_basis):
    """tests/test_calibration.py::test_calibrate_and_model_dft at 300 steps:
    data projected onto the DFT delay modes; with ``shared_basis=False``
    every chunk is dense with one baseline per group (the kernel's layout
    on the card)."""
    from calamity_tpu import models

    uvd = golomb_visdata.copy()
    comps = models.yield_pbl_model_comps(uvd, offset=DPSS_DLY, min_dly=DPSS_DLY, basis="dft")
    for key, mat in comps.items():
        ap = key[0][0]
        d = uvd.get_data(ap + ("xx",))
        proj = (mat @ np.linalg.lstsq(mat, d.T, rcond=None)[0]).T
        rows, conj = uvd._bl_time_rows(*ap)
        uvd.data_array[rows, 0, :, 0] = np.conj(proj) if conj else proj
    kw = dict(min_dly=DPSS_DLY, offset=DPSS_DLY, maxsteps=300, tol=1e-10, correct_resid=True,
              correct_model=True, model_regularization="post_hoc", shared_basis=shared_basis)
    jout = jcal.calibrate_and_model_dft(uvdata=uvd, **kw)
    tout = tcal.calibrate_and_model_dft(uvdata=as_port(uvd), device="cpu", **kw)
    _assert_fits_agree(jout, tout, uvd.data_array)
    assert RMS(tout[0].data_array) >= 1e2 * RMS(tout[1].data_array)


@pytest.fixture(scope="module")
def mixed_scenario(golomb_visdata):
    """The mixed-driver scenario of tests/test_calibration.py: the DPSS-
    projected sky with noise 100 dB down in power, 1% random starting
    gains, unit weights."""
    from calamity_tpu import cal_utils, models
    from calamity_tpu.io import FlagWeights

    uvd = golomb_visdata.copy()
    project_onto_dpss(uvd, models.yield_pbl_dpss_model_comps(uvd, offset=DPSS_DLY,
                                                             min_dly=DPSS_DLY))
    rng = np.random.default_rng(3)
    amp = 1e-5 * RMS(uvd.data_array)
    uvd.data_array = uvd.data_array + amp * (rng.standard_normal(uvd.data_array.shape)
                                             + 1j * rng.standard_normal(uvd.data_array.shape))
    gains = cal_utils.blank_uvcal_from_uvdata(uvd)
    rng = np.random.default_rng(11)
    gains.gain_array = gains.gain_array + 1e-2 * rng.standard_normal(gains.gain_array.shape) \
        + 1e-2j * rng.standard_normal(gains.gain_array.shape)
    weights = FlagWeights(golomb_visdata, mode="flag")
    weights.weights_array = np.ones_like(weights.flag_array, dtype=np.float64)
    return uvd, gains, weights


def _mixed_kw(scenario, **kw):
    uvd, gains, weights = scenario
    return dict(dict(min_dly=0.0, offset=0.0, ant_dly=2.0 / 3.0, red_tol_freq=0.5, uvdata=uvd,
                     gains=gains, freeze_model=True, maxsteps=150, tol=0.0,
                     correct_resid=False, correct_model=False, weights=weights,
                     grp_size_threshold=1), **kw)


@pytest.mark.parametrize("model_regularization, shared_basis", [("post_hoc", False),
                                                                ("sum", True)])
def test_mixed_driver_matches_jax(mixed_scenario, model_regularization, shared_basis):
    """tests/test_calibration.py::test_calibrate_and_model_mixed at 150
    steps a phase (tol 0: a float32 tol stop may land a step apart in two
    frameworks), covariance components from host numpy in both packages: the
    multi-baseline groups take the plain loss, the single-baseline DPSS
    groups (with ``shared_basis=False``) the fused loss."""
    kw = _mixed_kw(mixed_scenario, model_regularization=model_regularization,
                   shared_basis=shared_basis)
    jout = jcal.calibrate_and_model_mixed(**kw)
    tkw = {k: as_port(v) if k in ("uvdata", "gains", "weights") else v for k, v in kw.items()}
    with pytest.warns(UserWarning, match="nbls=") if model_regularization == "post_hoc" \
            else _no_warning():
        tout = tcal.calibrate_and_model_mixed(device="cpu", **tkw)
    _assert_fits_agree(jout, tout, mixed_scenario[0].data_array)


class _no_warning:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_mixed_save_dict_round_trips(mixed_scenario, tmp_path):
    """save_dict_to persists the component dict (the JAX package's own
    dict, to rounding); fed back through model_comps_dict it gives the same
    fit; the device eigh option (a torch eigh on the fit's device) gives
    components spanning the same subspaces as the host numpy eigh."""
    kw = _mixed_kw(mixed_scenario, maxsteps=40, model_regularization="post_hoc")
    tkw = {k: as_port(v) if k in ("uvdata", "gains", "weights") else v for k, v in kw.items()}
    path_t, path_j = str(tmp_path / "comps_t.npy"), str(tmp_path / "comps_j.npy")
    first = tcal.calibrate_and_model_mixed(device="cpu", save_dict_to=path_t, **tkw)
    jcal.calibrate_and_model_mixed(save_dict_to=path_j, **dict(kw, maxsteps=1))
    saved = np.load(path_t, allow_pickle=True).item()
    ref = np.load(path_j, allow_pickle=True).item()
    assert list(saved) == list(ref)
    for key in ref:
        assert rel_err(np.abs(saved[key]), np.abs(ref[key])) <= 1e-8
    again = tcal.calibrate_and_model_mixed(device="cpu", model_comps_dict=saved, **tkw)
    assert again[3][0][0]["loss"] == first[3][0][0]["loss"]
    np.testing.assert_array_equal(again[2].gain_array, first[2].gain_array)
    path_d = str(tmp_path / "comps_d.npy")
    tcal.calibrate_and_model_mixed(device="cpu", use_tensorflow_to_derive_modeling_comps=True,
                                   save_dict_to=path_d, **dict(tkw, maxsteps=1))
    on_device = np.load(path_d, allow_pickle=True).item()
    assert list(on_device) == list(saved)
    # the branch it ports: the JAX package's device eigh (use_jax)
    path_jd = str(tmp_path / "comps_jd.npy")
    jcal.calibrate_and_model_mixed(use_tensorflow_to_derive_modeling_comps=True,
                                   save_dict_to=path_jd, **dict(kw, maxsteps=1))
    ref_device = np.load(path_jd, allow_pickle=True).item()
    assert list(ref_device) == list(on_device)
    for key, want in ref_device.items():
        assert on_device[key].shape == want.shape
        assert np.max(np.abs(on_device[key] @ on_device[key].T - want @ want.T)) <= 1e-6
    for key, host in saved.items():
        # the same number of eigenvectors; signs are arbitrary, so the
        # projectors are compared. Eigenvectors whose eigenvalues sit near
        # the 1e-10 cutoff, a relative gap g ~ 1e-9 apart, are defined only
        # to eps / g ~ 1e-7 by any float64 eigh (tests/test_torch_host.py
        # holds the covariance-weighted difference to 1e-8)
        assert on_device[key].shape == host.shape
        assert np.max(np.abs(on_device[key] @ on_device[key].T - host @ host.T)) <= 1e-6


# ---------------------------------------------------------------------- #
# the file driver's options against the JAX package's
# (tests/test_cli.py and tests/test_calibration.py scenarios)
# ---------------------------------------------------------------------- #
DRIVER_KW = dict(tol=1e-10, min_dly=DPSS_DLY, offset=DPSS_DLY)


def _gains_agree(gt, gj):
    assert np.max(np.abs(gt.gain_array - gj.gain_array)) <= 1e-3 * np.max(np.abs(gj.gain_array))


def test_host_data_dtype_matches_jax(tmp_path, redundant_visdata):
    path = str(tmp_path / "input.uvh5")
    redundant_visdata.write_uvh5(path)
    kw = dict(input_data_files=path, maxsteps=60, host_data_dtype="complex64", **DRIVER_KW)
    mj, _, gj, _ = jcal.read_calibrate_and_model_dpss(**kw)
    out = str(tmp_path / "model.uvh5")
    mt, _, gt, _ = tcal.read_calibrate_and_model_dpss(device="cpu", model_outfilename=out, **kw)
    assert mt.data_array.dtype == mj.data_array.dtype == np.complex64
    assert tio.VisData.from_uvh5(out).data_array.dtype == np.complex128  # files stay spec
    scale = np.max(np.abs(mj.data_array))
    assert np.max(np.abs(mt.data_array - mj.data_array)) <= 1e-3 * scale
    _gains_agree(gt, gj)
    for cal, extra in ((jcal, {}), (tcal, {"device": "cpu"})):
        with pytest.raises(ValueError, match="host_data_dtype"):
            cal.read_calibrate_and_model_dpss(input_data_files=path, host_data_dtype="float32",
                                              **extra)


@pytest.mark.parametrize("case", ["weights_file", "with_autocorr_weights"])
def test_weights_file_matches_jax(tmp_path, redundant_visdata, case):
    from calamity_tpu.io import FlagWeights

    path = str(tmp_path / "input.uvh5")
    redundant_visdata.write_uvh5(path)
    rng = np.random.default_rng(3)
    uvf = FlagWeights(redundant_visdata, mode="flag")
    uvf.weights_array[:] = np.abs(rng.standard_normal(uvf.weights_array.shape))
    wpath = str(tmp_path / "weights.h5")
    uvf.to_uvflag_h5(wpath)
    kw = dict(input_data_files=path, maxsteps=200, weights_file=wpath, **DRIVER_KW)
    if case == "with_autocorr_weights":
        for cal, extra in ((jcal, {}), (tcal, {"device": "cpu"})):
            with pytest.raises(ValueError, match="mutually exclusive"):
                cal.read_calibrate_and_model_dpss(use_autocorrs_in_weights=True, **kw, **extra)
        return
    _, _, gj, _ = jcal.read_calibrate_and_model_dpss(**kw)
    _, _, gt, _ = tcal.read_calibrate_and_model_dpss(device="cpu", **kw)
    _gains_agree(gt, gj)
    _, _, g_plain, _ = tcal.read_calibrate_and_model_dpss(
        device="cpu", **dict(kw, weights_file=None))
    assert not np.allclose(gt.gain_array, g_plain.gain_array)  # the weights moved the fit


def test_clobber_fails_fast_like_jax(tmp_path, redundant_visdata, monkeypatch):
    path = str(tmp_path / "input.uvh5")
    redundant_visdata.write_uvh5(path)
    out = str(tmp_path / "resid.uvh5")
    open(out, "w").close()

    def no_fit(*a, **k):
        raise AssertionError("the fit ran before the output paths were checked")

    monkeypatch.setattr(tcal, "calibrate_and_model_dpss", no_fit)
    for cal, extra in ((jcal, {}), (tcal, {"device": "cpu"})):
        with pytest.raises(IOError, match="clobber"):
            cal.read_calibrate_and_model_dpss(input_data_files=path, resid_outfilename=out,
                                              maxsteps=5, **extra)


def test_calh5_gain_output_matches_jax(tmp_path, redundant_visdata):
    path = str(tmp_path / "input.uvh5")
    redundant_visdata.write_uvh5(path)
    outs = {k: str(tmp_path / f"{k}.calh5") for k in ("jax", "torch")}
    kw = dict(input_data_files=path, maxsteps=50, **DRIVER_KW)
    jcal.read_calibrate_and_model_dpss(gain_outfilename=outs["jax"], **kw)
    tcal.read_calibrate_and_model_dpss(gain_outfilename=outs["torch"], device="cpu", **kw)
    gj = CalData.from_calh5(outs["jax"])
    for reader in (CalData.from_calh5, tio.CalData.from_calh5):  # each package reads both
        gt = reader(outs["torch"])
        assert np.isfinite(gt.gain_array).all()
        _gains_agree(gt, gj)
    np.testing.assert_array_equal(tio.CalData.from_calh5(outs["jax"]).gain_array, gj.gain_array)


def test_multi_file_concatenation_matches_jax(tmp_path, golomb_visdata):
    paths = []
    for k in range(2):
        u = golomb_visdata.copy()
        u.time_array = u.time_array + 2.0 * k
        paths.append(str(tmp_path / f"part{k}.uvh5"))
        u.write_uvh5(paths[-1])
    kw = dict(input_data_files=paths, maxsteps=50, **dict(DRIVER_KW, tol=1e-8))
    mj, _, gj, ij = jcal.read_calibrate_and_model_dpss(**kw)
    mt, _, gt, it = tcal.read_calibrate_and_model_dpss(device="cpu", **kw)
    assert mt.Ntimes == mj.Ntimes == 2 and len(it[0]) == len(ij[0]) == 2
    for t in range(2):
        assert len(it[0][t]["loss"]) == len(ij[0][t]["loss"])
    _gains_agree(gt, gj)


def _with_autos(uvd):
    """``noise_with_flags`` plus one positive, smooth autocorrelation per
    antenna (tests/test_calibration.py:302-319)."""
    from calamity_tpu import simulate as jsim

    auto = jsim.make_visdata(np.zeros((1, 3)), uvd.freq_array[0], ntimes=uvd.Ntimes,
                             include_autos=True)
    nblt = len(auto.time_array)
    for ant in np.unique(np.concatenate([uvd.ant_1_array, uvd.ant_2_array])):
        a = auto.copy()
        a.ant_1_array[:] = ant
        a.ant_2_array[:] = ant
        a.time_array = np.repeat(np.unique(uvd.time_array), 1)[:nblt]
        a.data_array = np.abs(a.data_array).real.astype(complex) + 10.0 + ant
        uvd = uvd + a
    return uvd


@pytest.mark.parametrize("case", ["redundant_with_autos", "flagged_noise_with_autos"])
def test_get_auto_weights_matches_jax(case, redundant_visdata, noise_with_flags):
    uvd = redundant_visdata if case == "redundant_with_autos" else _with_autos(noise_with_flags)
    wj = jcal.get_auto_weights(uvd)
    wt = tcal.get_auto_weights(as_port(uvd))
    assert type(wt).__name__ == "FlagWeights"
    assert wt.weights_array.shape == wj.weights_array.shape
    np.testing.assert_array_equal(np.isfinite(wt.weights_array), np.isfinite(wj.weights_array))
    good = np.isfinite(wj.weights_array)
    assert rel_err(wt.weights_array[good], wj.weights_array[good]) <= 1e-10


@pytest.mark.parametrize("scenario", ["gsm_perfect_data", "gsm_plus_eor_noisy_gains"])
def test_reference_fixture_scenarios_through_the_port(scenario):
    """tests/test_reference_fixtures.py's scenarios on the committed golden
    Golomb file, through the port: resid 100x below the model and the data."""
    from calamity_tpu import cal_utils, models

    uvd = VisData.from_uvh5(GOLDEN_GOLOMB)
    uvd.select(bls=[ap for ap in uvd.get_antpairs() if ap[0] != ap[1]], inplace=True)
    project_onto_dpss(uvd, models.yield_pbl_dpss_model_comps(uvd, offset=DPSS_DLY,
                                                             min_dly=DPSS_DLY))
    gains = cal_utils.blank_uvcal_from_uvdata(uvd)
    if scenario == "gsm_plus_eor_noisy_gains":
        rng_eor = np.random.default_rng(7)
        amp = 10 ** (-50 / 20) * RMS(uvd.data_array)
        uvd.data_array = uvd.data_array + amp * (rng_eor.standard_normal(uvd.data_array.shape)
                                                 + 1j * rng_eor.standard_normal(
                                                     uvd.data_array.shape))
        rng = np.random.default_rng(0)
        gains.gain_array = gains.gain_array + 1e-2 * rng.standard_normal(
            gains.gain_array.shape) + 1e-2j * rng.standard_normal(gains.gain_array.shape)
    model, resid, _, _ = tcal.calibrate_and_model_dpss(
        uvdata=as_port(uvd), gains=as_port(gains), min_dly=DPSS_DLY, offset=DPSS_DLY,
        maxsteps=3000, tol=1e-10, correct_resid=True, correct_model=True,
        model_regularization="post_hoc", device="cpu")
    assert RMS(model.data_array) >= 1e2 * RMS(resid.data_array)
    assert RMS(uvd.data_array) >= 1e2 * RMS(resid.data_array)
