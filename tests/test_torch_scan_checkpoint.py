"""The port's warm-started time scan with ``checkpoint_dir``,
``steps_per_execution``, ``loss_block_ngrps`` or ``comps_precision="mixed"``,
on the CPU: the options that take the JAX scan to its segmented form (the
scenarios of tests/test_checkpoint.py for the JAX scan). The port has one
form, a host loop over times, for every option.

- Completed times persist as ``pol{N}_scan/step_{slot+1}`` markers and the
  time in progress under ``pol{N}_scan/time_{slot}``: a run stopped at a
  marker or inside a time (in either phase of the mixed schedule) resumes
  bit for bit; stale ``time_*`` directories go; a resume with another step
  budget gives ragged histories.
- The trajectory depends neither on ``steps_per_execution`` nor on the
  checkpoint cadence: it equals the run without checkpoints bit for bit.
- ``loss_block_ngrps`` reproduces the unblocked trajectory to rounding.
- The mixed and checkpointed scans agree with the JAX package's
  (tolerances of tests/test_torch_scan.py).

A stop is simulated by deleting markers or by a failure injected into a
checkpoint save, then running again into the same directory.
"""

import os
import shutil

import numpy as np
import pytest
from torch_parity import DPSS_DLY, as_port, gain_corrupted, multitime_visdata, rel_err

from calamity_tpu import calibration as jcal
from calamity_tpu_torch import calibration as tcal
from calamity_tpu_torch.solver import checkpoint as ckpt

RMS = lambda x: float(np.sqrt(np.mean(np.abs(x) ** 2)))  # noqa: E731


@pytest.fixture(scope="module")
def corrupted_multitime(golomb_visdata):
    return gain_corrupted(multitime_visdata(golomb_visdata))


SCAN = dict(min_dly=DPSS_DLY, offset=DPSS_DLY, tol=0.0, learning_rate=1e-2,
            model_regularization="post_hoc", shared_basis=False, time_parallel=True,
            init_guesses_from_previous_time_step=True, correct_resid=True)


def _run(uvd, **kw):
    return tcal.calibrate_and_model_dpss(uvdata=as_port(uvd), device="cpu",
                                         **dict(SCAN, **kw))


def _recorded(hist):
    """Loss and phase steps per (pol, time): what a resume must reproduce
    (a time restored from its marker has no descent seconds)."""
    return {(p, t): (h["loss"], h["phase_steps"]) for p, by_t in hist.items()
            for t, h in by_t.items()}


def _assert_same(a, b):
    assert _recorded(a[3]) == _recorded(b[3])
    np.testing.assert_array_equal(a[2].gain_array, b[2].gain_array)
    np.testing.assert_array_equal(a[0].data_array, b[0].data_array)
    np.testing.assert_array_equal(a[1].data_array, b[1].data_array)


def test_scan_resume_at_a_marker_is_bit_exact(corrupted_multitime, tmp_path):
    ck = str(tmp_path / "scan")
    kw = dict(maxsteps=60, checkpoint_dir=ck, checkpoint_every=25)
    full = _run(corrupted_multitime, **kw)
    scan_dir = os.path.join(ck, "pol0_scan")
    assert sorted(os.listdir(scan_dir)) == ["step_1", "step_2", "step_3"]  # no time_* left
    # stopped after time 0's marker, with a stale time directory of a stop
    # that came after its marker landed
    shutil.rmtree(os.path.join(scan_dir, "step_2"))
    shutil.rmtree(os.path.join(scan_dir, "step_3"))
    shutil.copytree(os.path.join(scan_dir, "step_1"), os.path.join(scan_dir, "time_0",
                                                                   "step_25"))
    resumed = _run(corrupted_multitime, **kw)
    _assert_same(resumed, full)
    assert not os.path.exists(os.path.join(scan_dir, "time_0"))
    assert "phase_seconds" not in resumed[3][0][0]  # restored, not fitted
    # a resume with another step budget: stored rows keep theirs
    shutil.rmtree(os.path.join(scan_dir, "step_3"))
    ragged = _run(corrupted_multitime, **dict(kw, maxsteps=90))
    assert [len(ragged[3][0][t]["loss"]) for t in range(3)] == [60, 60, 90]
    assert ragged[3][0][1]["loss"] == full[3][0][1]["loss"]
    assert np.all(np.isfinite(ragged[3][0][2]["loss"]))


@pytest.mark.parametrize("comps_precision, stop_in", [("float32", "time_1"),
                                                      ("mixed", "phase_bf16"),
                                                      ("mixed", "phase_f32")])
def test_scan_mid_time_stop_and_resume_is_bit_exact(corrupted_multitime, tmp_path,
                                                    monkeypatch, comps_precision, stop_in):
    """A failure inside time 1's descent, after one of its segment
    checkpoints landed: the resume continues from that time's saved state
    (in the phase it was in) and equals the uninterrupted run; the time's
    directory is removed once its marker lands."""
    kw = dict(maxsteps=40, checkpoint_every=10, comps_precision=comps_precision)
    if comps_precision == "float32":
        kw["steps_per_execution"] = 7
    full = _run(corrupted_multitime, checkpoint_dir=str(tmp_path / "full"), **kw)
    ck = str(tmp_path / "stopped")
    real_save = ckpt.save_state

    def failing_save(path, tree_state, scalar_state):
        if "time_1" in path and stop_in in path and path.endswith("step_20"):
            raise RuntimeError("injected stop")
        return real_save(path, tree_state, scalar_state)

    monkeypatch.setattr(ckpt, "save_state", failing_save)
    with pytest.raises(RuntimeError, match="injected stop"):
        _run(corrupted_multitime, checkpoint_dir=ck, **kw)
    monkeypatch.setattr(ckpt, "save_state", real_save)
    scan_dir = os.path.join(ck, "pol0_scan")
    assert os.path.isdir(os.path.join(scan_dir, "step_1"))
    assert not os.path.isdir(os.path.join(scan_dir, "step_2"))
    phase = "" if comps_precision == "float32" else stop_in
    assert ckpt.latest_checkpoint(os.path.join(scan_dir, "time_1", phase)).endswith("step_10")
    resumed = _run(corrupted_multitime, checkpoint_dir=ck, **kw)
    _assert_same(resumed, full)
    assert not os.path.isdir(os.path.join(scan_dir, "time_1"))
    if comps_precision == "mixed":
        assert all(h["phase_steps"] == [40, 40] for h in resumed[3][0].values())


def test_segmented_form_equals_fused_form(corrupted_multitime, tmp_path):
    """The trajectory does not depend on how a time's descent is cut: a run
    without checkpoints (the reference's fused form), a checkpointed run and
    bounded executions agree bit for bit."""
    fused = _run(corrupted_multitime, maxsteps=50)
    cadence = _run(corrupted_multitime, maxsteps=50, checkpoint_dir=str(tmp_path / "a"),
                   checkpoint_every=20)
    bounded = _run(corrupted_multitime, maxsteps=50, steps_per_execution=7)
    _assert_same(cadence, fused)
    _assert_same(bounded, fused)


def test_scan_loss_block_matches_unblocked(corrupted_multitime):
    plain = _run(corrupted_multitime, maxsteps=40, steps_per_execution=9)
    blocked = _run(corrupted_multitime, maxsteps=40, steps_per_execution=9, loss_block_ngrps=4)
    for t, h in plain[3][0].items():
        a, b = np.asarray(h["loss"]), np.asarray(blocked[3][0][t]["loss"])
        assert len(a) == len(b)
        assert np.allclose(a, b, rtol=1e-5, atol=1e-7)
    assert np.max(np.abs(plain[2].gain_array - blocked[2].gain_array)) <= 1e-4


@pytest.mark.parametrize("kw", [dict(comps_precision="mixed"),
                                dict(comps_precision="float32", checkpoint_every=25)],
                         ids=["mixed", "float32_checkpointed"])
def test_segmented_scan_matches_jax(corrupted_multitime, tmp_path, kw):
    kw = dict(SCAN, maxsteps=80, **kw)
    if "checkpoint_every" in kw:
        kw_j = dict(kw, checkpoint_dir=str(tmp_path / "j"))
        kw_t = dict(kw, checkpoint_dir=str(tmp_path / "t"))
    else:
        kw_j = kw_t = kw
    mj, rj, gj, hj = jcal.calibrate_and_model_dpss(uvdata=corrupted_multitime, **kw_j)
    mt, rt, gt, ht = tcal.calibrate_and_model_dpss(uvdata=as_port(corrupted_multitime),
                                                   device="cpu", **kw_t)
    for t, h in hj[0].items():
        got, want = np.asarray(ht[0][t]["loss"]), np.asarray(h["loss"])
        assert len(got) == len(want)
        assert rel_err(got[:25], want[:25]) <= 1e-4
    data_rms = RMS(corrupted_multitime.data_array)
    assert np.max(np.abs(gt.gain_array - gj.gain_array)) <= 1e-3
    assert np.max(np.abs(rt.data_array - rj.data_array)) <= 1e-3 * data_rms
    assert np.max(np.abs(mt.data_array - mj.data_array)) <= 1e-3 * data_rms
