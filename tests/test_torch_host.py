"""The port's own host layer (calamity_tpu_torch.io, .models, .cal_utils,
.simulate, .utils, .version) against the JAX package's modules it was
copied from: the same inputs give equal outputs, bit for bit; the files
each package writes are read back equal by the other; and the port's CLI
runs without importing jax or any module of the JAX package."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import calamity_tpu.io as jio
from calamity_tpu import cal_utils as jcal
from calamity_tpu import models as jmodels
from calamity_tpu import simulate as jsim
from calamity_tpu import version as jversion
from calamity_tpu_torch import cal_utils as tcal
from calamity_tpu_torch import io as tio
from calamity_tpu_torch import models as tmodels
from calamity_tpu_torch import simulate as tsim
from calamity_tpu_torch import version as tversion
from calamity_tpu_torch.models import simple_cov as tsimple_cov

from torch_parity import DPSS_DLY

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FREQS = 100e6 + 100e3 * np.arange(64)


def _equal(a, b):
    """Recursive equality of host-layer outputs: arrays bit for bit (same
    dtype and shape), containers element by element."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b, equal_nan=True)
    if isinstance(a, dict):
        return isinstance(b, dict) and list(a) == list(b) and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_equal(x, y) for x, y in zip(a, b)))
    return a == b


def _same_container(a, b):
    """Two containers (VisData, CalData, FlagWeights) of the two packages
    hold equal attributes."""
    assert type(a).__name__ == type(b).__name__
    assert sorted(vars(a)) == sorted(vars(b))
    for name in vars(a):
        assert _equal(getattr(a, name), getattr(b, name)), name


def test_make_golomb_array_equal():
    _same_container(jsim.make_golomb_array(nants=5, nfreqs=48, ntimes=2, seed=3),
                    tsim.make_golomb_array(nants=5, nfreqs=48, ntimes=2, seed=3))


def test_redundant_and_noise_arrays_equal():
    _same_container(jsim.make_redundant_array(include_autos=True, seed=5),
                    tsim.make_redundant_array(include_autos=True, seed=5))
    _same_container(jsim.make_noise_with_rfi_flags(), tsim.make_noise_with_rfi_flags())


@pytest.mark.parametrize("half_width", [50e-9, 400e-9])
def test_dpss_and_dft_operators_bit_equal(half_width):
    assert _equal(jmodels.dpss_operator(FREQS, half_width),
                  tmodels.dpss_operator(FREQS, half_width))
    assert _equal(jmodels.dpss_basis(FREQS, half_width), tmodels.dpss_basis(FREQS, half_width))
    assert _equal(jmodels.dft_operator(FREQS, half_width), tmodels.dft_operator(FREQS, half_width))


def test_pbl_dpss_model_comps_bit_equal():
    jv = jsim.make_golomb_array(nants=6, nfreqs=80, seed=0)
    tv = tsim.make_golomb_array(nants=6, nfreqs=80, seed=0)
    jc = jmodels.yield_pbl_dpss_model_comps(jv, offset=DPSS_DLY, min_dly=DPSS_DLY)
    tc = tmodels.yield_pbl_dpss_model_comps(tv, offset=DPSS_DLY, min_dly=DPSS_DLY)
    assert len(jc) == 15 and _equal(jc, tc)


def test_redundancy_and_overlap_groups_equal():
    jv = jsim.make_redundant_array(include_autos=True, seed=5)
    tv = tsim.make_redundant_array(include_autos=True, seed=5)
    for kw in ({}, {"remove_redundancy": True}, {"include_autos": True}):
        assert _equal(jmodels.get_redundant_grps_data(jv, **kw),
                      tmodels.get_redundant_grps_data(tv, **kw))
    jg = jsim.make_golomb_array(nants=6, nfreqs=80, seed=0)
    tg = tsim.make_golomb_array(nants=6, nfreqs=80, seed=0)
    j_over = jmodels.get_uv_overlapping_grps_conjugated(jg)
    t_over = tmodels.get_uv_overlapping_grps_conjugated(tg)
    assert _equal(j_over, t_over)
    # the mixed (DPSS + multi-baseline covariance) comps of those groups
    assert _equal(
        jmodels.yield_mixed_comps(j_over[0], j_over[1], jg.freq_array[0], ant_dly=DPSS_DLY,
                                  grp_size_threshold=1),
        tmodels.yield_mixed_comps(t_over[0], t_over[1], tg.freq_array[0], ant_dly=DPSS_DLY,
                                  grp_size_threshold=1))


def test_simple_cov_host_path_equal_and_jax_branch_refused():
    blvecs = np.array([[10.0, 0, 0], [12.0, 3.0, 0]])
    kw = dict(horizon=1.0, offset=5.0, min_dly=5.0, ant_dly=1e-9)
    assert _equal(jmodels.simple_cov_matrix(blvecs, FREQS[:24], **kw),
                  tmodels.simple_cov_matrix(blvecs, FREQS[:24], **kw))
    assert _equal(jmodels.yield_simple_multi_baseline_model_comps(blvecs, FREQS[:24], **kw),
                  tmodels.yield_simple_multi_baseline_model_comps(blvecs, FREQS[:24], **kw))
    for fn in (tsimple_cov.simple_cov_matrix, tsimple_cov.yield_simple_multi_baseline_model_comps):
        with pytest.raises(ValueError, match="use_torch"):
            fn(blvecs, FREQS[:24], use_jax=True)


@pytest.mark.parametrize("blvecs", [
    [[10.0, 0, 0], [12.0, 3.0, 0]],
    [[10.0, 0, 0], [12.0, 3.0, 0], [14.5, -2.0, 0.0]],
])
def test_simple_cov_torch_eigh_spans_the_host_subspace(blvecs):
    """use_torch=True on the CPU: the covariance equals the numpy one to
    rounding, and the components select as many eigenvectors as the host
    numpy eigh and model the covariance the same way:
    ||(P_torch - P_host) C|| <= 1e-8 ||C|| (projectors, because eigenvector
    signs are arbitrary; weighted by C, because eigenvectors near the
    cutoff are defined only to eps / (their eigenvalue gap) by any eigh)."""
    blvecs = np.asarray(blvecs)
    freqs = 100e6 + 100e3 * np.arange(80)
    kw = dict(horizon=1.0, offset=DPSS_DLY, min_dly=DPSS_DLY, ant_dly=2.0 / 3.0)
    cmat = tsimple_cov.simple_cov_matrix(blvecs, freqs, **kw)
    on_torch = tsimple_cov.simple_cov_matrix(blvecs, freqs, use_torch=True, device="cpu", **kw)
    assert isinstance(on_torch, torch.Tensor) and on_torch.dtype == torch.float64
    assert np.max(np.abs(on_torch.numpy() - cmat)) <= 1e-14 * np.max(np.abs(cmat))
    host = tsimple_cov.yield_simple_multi_baseline_model_comps(blvecs, freqs, **kw)
    dev = tsimple_cov.yield_simple_multi_baseline_model_comps(blvecs, freqs, use_torch=True,
                                                              device="cpu", **kw)
    assert dev.shape == host.shape and 0 < host.shape[1] < cmat.shape[0]
    gap = (dev @ dev.T - host @ host.T) @ cmat
    assert np.linalg.norm(gap, 2) <= 1e-8 * np.linalg.norm(cmat, 2)


@pytest.mark.parametrize("blvecs", [
    [[10.0, 0, 0], [12.0, 3.0, 0]],
    [[10.0, 0, 0], [12.0, 3.0, 0], [14.5, -2.0, 0.0]],
])
def test_simple_cov_torch_eigh_against_the_jax_device_eigh(blvecs):
    """The branch use_torch=True ports, the JAX package's use_jax=True (its
    covariance and eigh on the JAX device, float64): the same covariance to
    rounding, as many eigenvectors, and the same subspace, weighted by C to
    1e-8 and plain to 1e-6 (eigenvectors near the cutoff are defined only
    to eps / their eigenvalue gap, ~1e-7)."""
    freqs = 100e6 + 100e3 * np.arange(80)
    kw = dict(horizon=1.0, offset=DPSS_DLY, min_dly=DPSS_DLY, ant_dly=2.0 / 3.0)
    want_c = np.asarray(jmodels.simple_cov_matrix(blvecs, freqs, use_jax=True, **kw))
    got_c = tsimple_cov.simple_cov_matrix(blvecs, freqs, use_torch=True, device="cpu", **kw)
    assert np.max(np.abs(got_c.numpy() - want_c)) <= 1e-14 * np.max(np.abs(want_c))
    want = jmodels.yield_simple_multi_baseline_model_comps(blvecs, freqs, use_jax=True, **kw)
    got = tsimple_cov.yield_simple_multi_baseline_model_comps(blvecs, freqs, use_torch=True,
                                                              device="cpu", **kw)
    assert got.shape == want.shape and 0 < want.shape[1] < want_c.shape[0]
    dproj = got @ got.T - want @ want.T
    assert np.linalg.norm(dproj @ want_c, 2) <= 1e-8 * np.linalg.norm(want_c, 2)
    assert np.max(np.abs(dproj)) <= 1e-6


def test_cal_utils_equal():
    jv = jsim.make_golomb_array(nants=5, nfreqs=32, ntimes=2, seed=4)
    tv = tsim.make_golomb_array(nants=5, nfreqs=32, ntimes=2, seed=4)
    jg, tg = jcal.blank_uvcal_from_uvdata(jv), tcal.blank_uvcal_from_uvdata(tv)
    _same_container(jg, tg)
    rng = np.random.default_rng(9)
    scale = 1 + 0.05 * (rng.standard_normal(jg.gain_array.shape)
                        + 1j * rng.standard_normal(jg.gain_array.shape))
    jg.gain_array = jg.gain_array * scale
    tg.gain_array = tg.gain_array * scale
    for inverse in (False, True):
        _same_container(jcal.apply_gains(jv, jg, inverse=inverse),
                        tcal.apply_gains(tv, tg, inverse=inverse))
    jr, tr = jv.copy(), tv.copy()
    jcal.subtract_model_with_gains(jr, jv, jg)
    tcal.subtract_model_with_gains(tr, tv, tg)
    _same_container(jr, tr)


def _write(pkg, uvd, gains, weights, tmp):
    """Each package writes the same containers from its own objects."""
    io = jio if pkg == "jax" else tio
    v = io.VisData.__new__(io.VisData)
    v.__dict__ = {k: (x.copy() if isinstance(x, np.ndarray) else x) for k, x in vars(uvd).items()}
    g = io.CalData.__new__(io.CalData)
    g.__dict__ = dict(vars(gains))
    w = io.FlagWeights.__new__(io.FlagWeights)
    w.__dict__ = dict(vars(weights))
    paths = {k: os.path.join(tmp, f"{pkg}.{k}") for k in ("uvh5", "calh5", "calfits", "h5")}
    v.write_uvh5(paths["uvh5"])
    g.write_calh5(paths["calh5"])
    g.write_calfits(paths["calfits"])
    w.to_uvflag_h5(paths["h5"])
    return paths


@pytest.mark.parametrize("writer, reader", [("jax", "torch"), ("torch", "jax"),
                                            ("torch", "torch")])
def test_files_round_trip_across_packages(tmp_path, writer, reader):
    """uvh5, calh5, calfits and UVFlag files written by one package read back
    equal by the other (and by the port itself)."""
    uvd = tsim.make_golomb_array(nants=4, nfreqs=16, ntimes=2, seed=1)
    gains = tio.CalData.blank_from_visdata(uvd)
    gains.gain_array = gains.gain_array * (1 + 0.1j)
    weights = tio.FlagWeights(uvd, mode="flag")
    paths = _write(writer, uvd, gains, weights, str(tmp_path))
    io = jio if reader == "jax" else tio
    back = {"uvh5": io.VisData.from_uvh5(paths["uvh5"]),
            "calh5": io.CalData.from_calh5(paths["calh5"]),
            "calfits": io.CalData.from_calfits(paths["calfits"]),
            "h5": io.FlagWeights.from_uvflag_h5(paths["h5"])}
    v = back["uvh5"]
    for name in ("data_array", "flag_array", "nsample_array", "time_array", "ant_1_array",
                 "ant_2_array", "freq_array", "antenna_positions", "polarization_array"):
        assert _equal(getattr(v, name), getattr(uvd, name)), name
    assert v.antenna_names == uvd.antenna_names and v.history == uvd.history
    for key in ("calh5", "calfits"):
        assert np.array_equal(back[key].gain_array, gains.gain_array), key
        assert np.array_equal(back[key].flag_array, gains.flag_array), key
    assert _equal(back["h5"].weights_array, weights.weights_array)


def test_history_string_format_matches():
    """The port's provenance block has the JAX package's lines, in its order
    (the git state is the port's own directory's)."""
    def keys(text):
        return [line.split(":")[0] for line in text.splitlines() if line.strip()]

    assert keys(jversion.history_string("note")) == keys(tversion.history_string("note"))
    assert "note" in tversion.history_string("note")


def test_cli_imports_neither_jax_nor_the_jax_package(tmp_path):
    """The port's CLI on the CPU, in a fresh interpreter, on a tiny Golomb
    file: it writes its outputs and never loads jax or calamity_tpu."""
    uvd = tsim.make_golomb_array(nants=4, nfreqs=32, seed=0)
    path = str(tmp_path / "in.uvh5")
    uvd.write_uvh5(path)
    outs = [str(tmp_path / f) for f in ("resid.uvh5", "model.uvh5", "gains.calfits")]
    argv = ["--input_data_files", path, "--resid_outfilename", outs[0],
            "--model_outfilename", outs[1], "--gain_outfilename", outs[2],
            "--min_dly", str(DPSS_DLY), "--offset", str(DPSS_DLY), "--maxsteps", "20",
            "--device", "cpu", "--clobber"]
    script = os.path.join(REPO, "scripts", "calibrate_and_model_dpss_torch.py")
    code = (
        "import json, runpy, sys\n"
        f"sys.argv = [{script!r}] + {argv!r}\n"
        f"runpy.run_path({script!r}, run_name='__main__')\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'calamity_tpu')\n"
        "             or m.startswith(('jax.', 'calamity_tpu.')))\n"
        "print(json.dumps({'loaded': bad, 'port': 'calamity_tpu_torch' in sys.modules}))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                          cwd=str(tmp_path), timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report == {"loaded": [], "port": True}
    assert all(os.path.exists(p) for p in outs)
    resid = tio.VisData.from_uvh5(outs[0])
    assert np.isfinite(resid.data_array).all()


def test_supervisor_compat_and_mesh_import_neither_jax_nor_the_jax_package():
    """``python -m calamity_tpu_torch.supervisor --help``, and imports of the
    port's compat shims and device mesh, in a fresh interpreter: none loads
    jax or calamity_tpu."""
    code = (
        "import json, runpy, sys\n"
        "sys.argv = ['calamity_tpu_torch.supervisor', '--help']\n"
        "try:\n"
        "    runpy.run_module('calamity_tpu_torch.supervisor', run_name='__main__')\n"
        "except SystemExit as exc:\n"
        "    assert exc.code == 0, exc.code\n"
        "import calamity_tpu_torch.compat, calamity_tpu_torch.parallel.mesh\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'calamity_tpu')\n"
        "             or m.startswith(('jax.', 'calamity_tpu.')))\n"
        "print(json.dumps({'loaded': bad}))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "--hang_timeout" in proc.stdout
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == {"loaded": []}
