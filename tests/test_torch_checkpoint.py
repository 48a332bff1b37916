"""Checkpointed fits of the port: the checkpoint files, bit-exact resume of
the batched and serial descents, the segmentation invariance of
``steps_per_execution``, resume across a ``use_min`` flip, patience rebuilt
after a resume, the step-0 loss guard on resume, and the reference's two
batched faults fixed (``use_min`` starting from zeros; the guard skipped on
resume).

A crash is simulated by deleting the checkpoints written after some step
and running again into the same directory. Resumed trajectories are held
to the uninterrupted one exactly (same ops on the same CPU); the serial
checkpointed mixed schedule is held to the JAX package's at rel 1e-4.
"""

import os
import shutil

import numpy as np
import pytest
import torch
from torch_parity import (
    BATCHED_DESCENT,
    DPSS_DLY,
    GOLDEN_GOLOMB,
    as_port,
    batched_problem,
    multitime_visdata,
    rel_err,
    to_np,
    torch_batched_problem,
)

from calamity_tpu_torch import calibration as tcal
from calamity_tpu_torch.convert import chunks_from_jax, to_tensor
from calamity_tpu_torch.parallel import batched as tb
from calamity_tpu_torch.solver import checkpoint as ck
from calamity_tpu_torch.solver.fit import FitConfig
from calamity_tpu_torch.solver.optimizers import AdamaxState


@pytest.fixture(scope="module")
def multitime(golomb_visdata):
    return multitime_visdata(golomb_visdata)


@pytest.fixture(scope="module")
def problem(multitime):
    return batched_problem(multitime, dtype=np.float32, gain_err=0.1)


def _args(p):
    t = torch_batched_problem(p)
    return (t["chunks"], t["data_r"], t["data_i"], t["wgts"], t["g_r"], t["g_i"], t["fg_r"],
            t["fg_i"], None, None)


def _crash(src, dst, keep_upto):
    """A copy of checkpoint dir ``src`` as a run that died after step
    ``keep_upto`` would have left it."""
    shutil.copytree(src, dst)
    for name in os.listdir(dst):
        if name.startswith("step_") and int(name.split("_")[1]) > keep_upto:
            shutil.rmtree(os.path.join(dst, name))


def _assert_same(a, b):
    assert a.nsteps == b.nsteps
    np.testing.assert_array_equal(a.loss_history, b.loss_history)
    np.testing.assert_array_equal(a.nsteps_slice, b.nsteps_slice)
    for x, y in zip([a.g_r, a.g_i, *a.fg_r, *a.fg_i, a.final_loss],
                    [b.g_r, b.g_i, *b.fg_r, *b.fg_i, b.final_loss]):
        assert torch.equal(x, y)


def test_state_roundtrip_and_structure_checks(tmp_path):
    tree = {"params": {"g": torch.arange(6.0).reshape(2, 3), "fg": [torch.ones(2, 2).double()]},
            "opt": AdamaxState(count=7, mu={"g": torch.zeros(2, 3)}, nu={"g": torch.ones(2, 3)}),
            "lo": torch.tensor([1.5, -2.0], dtype=torch.bfloat16), "none": ()}
    path = str(tmp_path / "step_3")
    ck.save_state(path, tree, {"step": 3, "history": np.arange(4.0)})
    like = {"params": {"g": torch.empty(2, 3), "fg": [torch.empty(2, 2).double()]},
            "opt": AdamaxState(count=0, mu={"g": torch.empty(2, 3)}, nu={"g": torch.empty(2, 3)}),
            "lo": torch.empty(2, dtype=torch.bfloat16), "none": ()}
    got, scal = ck.load_state(path, like, ("step", "history"))
    assert got["opt"].count == 7 and isinstance(got["opt"], AdamaxState)
    assert torch.equal(got["params"]["g"], tree["params"]["g"])
    assert got["params"]["fg"][0].dtype == torch.float64
    assert got["lo"].dtype == torch.bfloat16 and torch.equal(got["lo"], tree["lo"])
    assert int(scal["step"]) == 3 and scal["history"].tolist() == [0.0, 1.0, 2.0, 3.0]
    with pytest.raises(ValueError, match="does not match"):
        ck.load_state(path, dict(like, none=torch.empty(1)), ("step",))
    with pytest.raises(ValueError, match="does not match"):
        ck.load_state(path, dict(like, lo=torch.empty(3)), ("step",))


def test_latest_checkpoint_skips_what_it_cannot_load(tmp_path):
    good = {"x": torch.ones(2)}
    ck.save_state(str(tmp_path / "step_5"), good, {"step": 5})
    ck.save_state(str(tmp_path / "step_9"), good, {"step": 9})
    os.remove(tmp_path / "step_9" / "treedef.pkl")  # a save cut short
    os.makedirs(tmp_path / "step_12")
    (tmp_path / "step_12" / "treedef.pkl").write_bytes(b"not a pickle")
    (tmp_path / "step_12" / "state.npz").write_bytes(b"nor an archive")
    os.makedirs(tmp_path / "step_20.tmp")
    assert ck.latest_checkpoint(str(tmp_path)) == str(tmp_path / "step_5")
    assert ck.latest_checkpoint(str(tmp_path / "missing")) is None


@pytest.mark.parametrize("case", ["tol", "patience"])
def test_batched_resume_is_bit_exact(problem, tmp_path, case):
    kw = dict(BATCHED_DESCENT, maxsteps=60, tol=1e-9)
    if case == "patience":
        # patience rebuilt from the stored history after the resume
        kw.update(tol=0.0, patience=3, opt_kwargs=(("learning_rate", 0.3),))
    cfg = FitConfig(**kw)
    args = _args(problem[1])
    core = tb.batched_fit_core(cfg, *args[:-2])
    full = tb.batched_fit_checkpointed(cfg, *args, str(tmp_path / "a"), 4, True, False)
    _assert_same(full, core)  # the segmented descent is the core's trajectory
    keep = 4 if case == "patience" else 8
    assert full.nsteps > keep
    _crash(str(tmp_path / "a"), str(tmp_path / "b"), keep)
    resumed = tb.batched_fit_checkpointed(cfg, *args, str(tmp_path / "b"), 4, True, False)
    _assert_same(resumed, full)
    assert resumed.opt_state.count == full.opt_state.count


@pytest.mark.parametrize("spe", [1, 3, 7])
def test_steps_per_execution_does_not_change_the_trajectory(problem, spe):
    cfg = FitConfig(**dict(BATCHED_DESCENT, maxsteps=20))
    args = _args(problem[1])
    core = tb.batched_fit_core(cfg, *args[:-2])
    cut = tb.batched_fit_checkpointed(cfg, *args, None, 20, True, False, steps_per_execution=spe)
    _assert_same(cut, core)


@pytest.mark.parametrize("saved_use_min", [False, True])
def test_resume_across_a_use_min_flip(problem, tmp_path, saved_use_min):
    args = _args(problem[1])
    first = FitConfig(**dict(BATCHED_DESCENT, maxsteps=20, use_min=saved_use_min))
    tb.batched_fit_checkpointed(first, *args, str(tmp_path), 10, True, False)
    later = FitConfig(**dict(BATCHED_DESCENT, maxsteps=40, use_min=not saved_use_min))
    resumed = tb.batched_fit_checkpointed(later, *args, str(tmp_path), 10, True, False)
    straight = tb.batched_fit_checkpointed(FitConfig(**dict(BATCHED_DESCENT, maxsteps=40)),
                                           *args, None, 40, True, False)
    # the trajectory does not depend on use_min
    assert resumed.nsteps == 40
    np.testing.assert_array_equal(resumed.loss_history, straight.loss_history)
    if later.use_min:
        # argmin tracking restarts at the resume point
        best = np.nanmin(resumed.loss_history[20:], axis=0)
        np.testing.assert_allclose(to_np(resumed.final_loss), best, rtol=1e-6)
    else:
        assert torch.equal(resumed.g_r, straight.g_r)


def test_use_min_keeps_the_entry_parameters(problem):
    """Reference fault (parallel/batched.py:1303-1325): best_params started
    as zeros, so maxsteps=0 or a slice that never records a finite loss
    returned zero gains. The port keeps the entry parameters."""
    p = dict(problem[1])
    w = p["wgts"][0].copy()
    w[1, 0, 0, 0] = np.nan  # slice 1 never records a finite loss
    p["wgts"] = [w] + list(p["wgts"][1:])
    args = _args(p)
    res = tb.batched_fit_checkpointed(FitConfig(**dict(BATCHED_DESCENT, maxsteps=10, use_min=True)),
                                      *args, None, 10, True, False)
    assert res.nsteps_slice[1] == 1
    assert torch.equal(res.g_r[1], args[4][1]) and torch.equal(res.fg_r[0][1], args[6][0][1])
    assert not torch.equal(res.g_r[0], args[4][0])  # the others moved
    zero = tb.batched_fit_checkpointed(FitConfig(**dict(BATCHED_DESCENT, maxsteps=0, use_min=True)),
                                       *args, None, 10, True, False)
    assert torch.equal(zero.g_r, args[4]) and torch.equal(zero.g_i, args[5])


def test_maxsteps_zero_use_min_returns_entry_gains_through_the_driver(multitime):
    _, _, gains, hist = tcal.calibrate_and_model_dpss(
        uvdata=as_port(multitime), min_dly=DPSS_DLY, offset=DPSS_DLY, maxsteps=0, use_min=True,
        model_regularization=None, shared_basis=False, time_parallel=True, device="cpu")
    assert np.all(gains.gain_array == 1.0)
    assert all(h["loss"] == [] for h in hist[0].values())


def test_guard_fires_on_resume_against_a_corrupted_cube(problem, tmp_path):
    """Reference fault (parallel/batched.py:1396-1406): the step-0 guard
    was skipped on resume. The port checks the first loss after a resume
    against the host value at the restored parameters."""
    spec, p = problem
    host = {k: p[k] for k in ("data_r", "data_i", "wgts")}
    host_chunks = [(np.asarray(c), np.asarray(a0), np.asarray(a1)) for c, a0, a1 in p["chunks"]]

    def expected(params):
        return tb.host_batched_losses(to_np(params["g_r"]), to_np(params["g_i"]),
                                      [to_np(x) for x in params["fg_r"]],
                                      [to_np(x) for x in params["fg_i"]], host_chunks,
                                      host["data_r"], host["data_i"], host["wgts"])

    cfg = FitConfig(**dict(BATCHED_DESCENT, maxsteps=20))
    args = _args(p)
    tb.batched_fit_checkpointed(cfg, *args, str(tmp_path), 10, True, False,
                                expected_loss_fn=expected)
    later = FitConfig(**dict(BATCHED_DESCENT, maxsteps=30))
    _crash(str(tmp_path), str(tmp_path / "ok"), 20)
    ok = tb.batched_fit_checkpointed(later, *args, str(tmp_path / "ok"), 10, True, False,
                                     expected_loss_fn=expected)
    assert ok.nsteps == 30
    bad = list(args)
    corrupted = args[1][0].clone()
    corrupted[0] = corrupted[0].flip(-1) * 3.0  # a scrambled cube of slice 0
    bad[1] = [corrupted] + list(args[1][1:])
    with pytest.raises(RuntimeError, match="cross-check failed \\(resumed\\)"):
        tb.batched_fit_checkpointed(later, *bad, str(tmp_path), 10, True, False,
                                    expected_loss_fn=expected)
    with pytest.raises(RuntimeError, match="cross-check failed"):
        tb.batched_fit_checkpointed(cfg, *bad, None, 10, True, False,
                                    expected_loss_fn=expected)


@pytest.mark.parametrize("land_in", ["phase_bf16", "phase_f32"])
def test_driver_mixed_schedule_resume_is_bit_exact(multitime, tmp_path, land_in):
    kw = dict(uvdata=as_port(multitime), min_dly=DPSS_DLY, offset=DPSS_DLY, maxsteps=30,
              tol=1e-12,
              model_regularization="post_hoc", shared_basis=False, time_parallel=True,
              comps_precision="mixed", checkpoint_every=8, device="cpu")
    full_dir = str(tmp_path / "full")
    _, r_full, g_full, h_full = tcal.calibrate_and_model_dpss(checkpoint_dir=full_dir, **kw)
    crash_dir = str(tmp_path / "crash")
    shutil.copytree(full_dir, crash_dir)
    base = os.path.join(crash_dir, "batched")
    if land_in == "phase_bf16":
        shutil.rmtree(os.path.join(base, "phase_f32"))
        os.remove(os.path.join(base, "phase1_history.npz"))
        _crash(os.path.join(full_dir, "batched", "phase_bf16"),
               os.path.join(str(tmp_path), "keep"), 16)
        shutil.rmtree(os.path.join(base, "phase_bf16"))
        shutil.copytree(os.path.join(str(tmp_path), "keep"), os.path.join(base, "phase_bf16"))
    else:
        f32 = os.path.join(base, "phase_f32")
        for name in os.listdir(f32):
            if int(name.split("_")[1]) > 8:
                shutil.rmtree(os.path.join(f32, name))
    _, r_res, g_res, h_res = tcal.calibrate_and_model_dpss(checkpoint_dir=crash_dir, **kw)
    assert h_res == h_full
    np.testing.assert_array_equal(g_res.gain_array, g_full.gain_array)
    np.testing.assert_array_equal(r_res.data_array, r_full.data_array)
    # uninterrupted and never checkpointed: the same trajectory
    _, r_plain, g_plain, h_plain = tcal.calibrate_and_model_dpss(**kw)
    assert h_plain == h_full
    np.testing.assert_array_equal(g_plain.gain_array, g_full.gain_array)


@pytest.fixture(scope="module")
def golden_slice():
    from calamity_tpu import models
    from calamity_tpu.io import CalData, VisData
    from calamity_tpu.solver.tensorize import FitSpec

    uvd = VisData.from_uvh5(GOLDEN_GOLOMB)
    comps = models.yield_pbl_dpss_model_comps(uvd, min_dly=DPSS_DLY, offset=DPSS_DLY)
    gains = CalData.blank_from_visdata(uvd)
    rng = np.random.default_rng(11)
    gains.gain_array = gains.gain_array * (1 + 0.05 * rng.standard_normal(gains.gain_array.shape)
                                           + 0.05j * rng.standard_normal(gains.gain_array.shape))
    spec = FitSpec(uvd, comps, {int(a): i for i, a in enumerate(gains.ant_array)},
                   dtype=np.float32)
    t = spec.times[0]
    rms = np.sqrt(np.mean(np.abs(uvd.data_array) ** 2))
    dr, di, w = spec.pack_data(uvd, "xx", t, data_scale_factor=rms)
    g_r, g_i = spec.pack_gains(gains, "xx", t)
    return dict(g_r=g_r, g_i=g_i, fg_r=spec.init_coeffs(dr, w), fg_i=spec.init_coeffs(di, w),
                data_r=dr, data_i=di, wgts=w, chunks=spec.device_chunks())


def _serial(p, **kw):
    from calamity_tpu_torch.solver.fit import fit_gains_and_foregrounds

    def conv(xs):
        return [to_tensor(x, "cpu") for x in xs]

    return fit_gains_and_foregrounds(
        to_tensor(p["g_r"], "cpu"), to_tensor(p["g_i"], "cpu"), conv(p["fg_r"]), conv(p["fg_i"]),
        conv(p["data_r"]), conv(p["data_i"]), conv(p["wgts"]), chunks_from_jax(p["chunks"], "cpu"),
        **kw)


@pytest.mark.parametrize("comps_precision", ["float32", "mixed"])
def test_serial_checkpoint_resume_and_jax_parity(golden_slice, tmp_path, comps_precision):
    from calamity_tpu.solver.fit import fit_gains_and_foregrounds as jax_fit

    kw = dict(maxsteps=24, tol=0.0, learning_rate=1e-2, comps_precision=comps_precision,
              checkpoint_every=5)
    full = _serial(golden_slice, checkpoint_dir=str(tmp_path / "a"), **kw)
    if comps_precision == "float32":
        plain = _serial(golden_slice, **{k: v for k, v in kw.items() if k != "checkpoint_every"})
        assert plain[4]["loss"] == full[4]["loss"]
        crash = [("", 10)]
    else:
        crash = [("phase_f32", 10)]
    shutil.copytree(str(tmp_path / "a"), str(tmp_path / "b"))
    for sub, keep in crash:
        d = os.path.join(str(tmp_path / "b"), sub)
        for name in os.listdir(d):
            if name.startswith("step_") and int(name.split("_")[1]) > keep:
                shutil.rmtree(os.path.join(d, name))
    resumed = _serial(golden_slice, checkpoint_dir=str(tmp_path / "b"), **kw)
    assert resumed[4]["loss"] == full[4]["loss"]
    assert resumed[4].get("phase_steps") == full[4].get("phase_steps")
    assert torch.equal(resumed[0], full[0]) and torch.equal(resumed[2][0], full[2][0])
    p = golden_slice
    jres = jax_fit(p["g_r"], p["g_i"], p["fg_r"], p["fg_i"], p["data_r"], p["data_i"], p["wgts"],
                   p["chunks"], checkpoint_dir=str(tmp_path / "jax"), **kw)
    assert len(jres[4]["loss"]) == len(full[4]["loss"])
    assert jres[4].get("phase_steps") == full[4].get("phase_steps")
    assert rel_err(np.asarray(full[4]["loss"]), np.asarray(jres[4]["loss"])) <= 1e-4
    assert rel_err(full[0], jres[0]) <= 1e-4
