"""The HERA-core configuration (``scripts/hera_core_demo_torch.py``) at cut
size, through the port and through the JAX package with the same flags.

nside 5 (25 antennas, 188 baselines up to 45 m, 14 unique spacings), 64
channels; the default shared-basis packing with ``nvec_bucketing``, lr
1e-2, tol 1e-11, maxsteps 3000, patience 500 with ``use_min``, post_hoc,
both in float64 on the CPU. The two packages pack the same chunks. Their
loss histories agree to rel 1e-10 over the first 1000 steps; near the
floor (about step 1300) the descent amplifies rounding, so the runs may
stop a step apart and end on gains within rel 1e-4 (the degenerate
directions the post_hoc renormalisation leaves), models within rel 1e-6
and corrected resids (which carry the gains' difference) within rel 1e-5
of the model's peak.
"""

import os
import sys

import numpy as np
import pytest

from calamity_tpu import calibration as jcalibration
from calamity_tpu import models as jmodels
from calamity_tpu.io.visdata import VisData as JVisData
from calamity_tpu.solver.tensorize import FitSpec as JFitSpec

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
import hera_core_demo_torch as demo  # noqa: E402


@pytest.fixture(scope="module")
def core(tmp_path_factory):
    corrupted, comps, facts = demo.build(nside=5, nfreqs=64)
    path = str(tmp_path_factory.mktemp("hera") / "core.uvh5")
    corrupted.write_uvh5(path, clobber=True)
    juvd = JVisData.from_uvh5(path)
    jcomps = jmodels.yield_pbl_dpss_model_comps(juvd, min_dly=demo.MIN_DLY_NS,
                                                offset=demo.MIN_DLY_NS)
    return corrupted, comps, facts, juvd, jcomps


def test_core_size_and_layouts_match_the_jax_package(core):
    corrupted, comps, facts, juvd, jcomps = core
    assert (facts["nants"], facts["nbls"], facts["nuniq"]) == (25, 188, 14)
    assert np.array_equal(juvd.data_array, corrupted.data_array)
    layouts = demo.chunk_layouts(corrupted, comps)
    assert {c["kind"] for c in layouts} <= {"dense", "shared", "shared-batched"}
    assert any(c["kind"] != "dense" for c in layouts)
    ants = {int(a): i for i, a in enumerate(sorted(set(juvd.ant_1_array) | set(juvd.ant_2_array)))}
    jspec = JFitSpec(juvd, jcomps, ants, nvec_bucketing=True, shared_basis=True)
    want = [(tuple(c.comps.shape), c.a0.shape[0]) for c in jspec.chunks]
    got = [((c["U"], c["B"], c["F"], c["V"]), c["groups"]) for c in layouts]
    assert got == want


def test_fit_matches_the_jax_package_in_float64(core):
    corrupted, comps, _, juvd, jcomps = core
    tm, tr, tg, th = demo.fit(corrupted, comps, device="cpu", dtype=np.float64)
    jm, jr, jg, jh = jcalibration.calibrate_and_model_dpss(
        uvdata=juvd, gains=None, fg_model_comps_dict=jcomps, maxsteps=3000, tol=1e-11,
        patience=500, use_min=True, learning_rate=1e-2, correct_resid=True,
        correct_model=True, model_regularization="post_hoc", nvec_bucketing=True,
        dtype=np.float64)
    ht, hj = np.asarray(th[0][0]["loss"]), np.asarray(jh[0][0]["loss"])
    assert abs(len(ht) - len(hj)) <= 2 and len(hj) > 1000
    assert np.max(np.abs(ht[:1000] - hj[:1000]) / np.abs(hj[:1000])) <= 1e-10
    assert np.max(np.abs(tg.gain_array - jg.gain_array)) <= 1e-4 * np.max(np.abs(jg.gain_array))
    peak = np.max(np.abs(jm.data_array))
    assert np.max(np.abs(tm.data_array - jm.data_array)) <= 1e-6 * peak
    # the corrected resid carries the gains' difference: data / (g_i g_j*) - model
    assert np.max(np.abs(tr.data_array - jr.data_array)) <= 1e-5 * peak
    rms = lambda x: np.sqrt(np.mean(np.abs(x) ** 2))  # noqa: E731
    assert rms(corrupted.data_array) >= 1e3 * rms(tr.data_array)
