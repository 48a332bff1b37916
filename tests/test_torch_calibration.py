"""The port's drivers end to end against calamity_tpu's, on the CPU.

- ``read_calibrate_and_model_dpss`` and the CLI on the tests/test_cli.py
  scenario (redundant array, model and gain input files, default
  ``shared_basis=True`` so shared and dense chunks are both packed): gains
  and the written files agree with the JAX run.
- The slice's configuration (post_hoc, ``shared_basis=False``: every chunk
  dense, through the fused loss) on the golden Golomb file: gains agree and
  resid rms <= 1e-2 x data rms.
- Importing the port never loads jax nor the JAX package; options not ported
  yet raise.

Tolerance: float32 descents of a few hundred steps in two frameworks;
gains agree to 1e-3 of their amplitude and outputs to 1e-3 of the data
rms (summation-order differences compound over the steps).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch_parity import DPSS_DLY, GOLDEN_GOLOMB, as_port

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
    # the in-memory default regularization, "sum", takes the plain loss
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
    with pytest.warns(UserWarning, match="shared-basis"):  # post_hoc: shared chunks named
        tcli.main(argv(out_t) + ["--device", "cpu"])
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


@pytest.mark.parametrize("kwargs, exc, match", [
    (dict(time_parallel=True, init_guesses_from_previous_time_step=True),
     NotImplementedError, "items 11-12"),
    (dict(mesh=object()), NotImplementedError, "item 13"),
    (dict(steps_per_execution=10), ValueError, "time_parallel paths only"),
    (dict(time_parallel=True, mesh=object()), NotImplementedError, "item 13"),
    (dict(n_profile_steps=2), NotImplementedError, "item 6"),
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
