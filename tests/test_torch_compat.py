"""The port's reference-named shims (calamity_tpu_torch.compat) against the
JAX package's (calamity_tpu.compat): the cases of tests/test_compat.py
through both packages on the same inputs, with equal outputs (float64
packing and index tables exactly; coefficients and model cubes to rel
1e-10, two frameworks' Cholesky solves), on the CPU."""

import numpy as np
import pytest
from torch_parity import DPSS_DLY, as_port, rel_err, to_np

from calamity_tpu import cal_utils, compat, models
from calamity_tpu_torch import compat as tcompat


def _spec_inputs(uvd):
    comps = models.yield_pbl_dpss_model_comps(uvd, offset=DPSS_DLY, min_dly=DPSS_DLY)
    gains = cal_utils.blank_uvcal_from_uvdata(uvd)
    ants_map = {int(a): i for i, a in enumerate(gains.ant_array)}
    return comps, gains, ants_map


def test_chunk_alias(golomb_visdata):
    comps, _, _ = _spec_inputs(golomb_visdata)
    assert list(tcompat.chunk_fg_comp_dict_by_nbls(comps)) == list(
        compat.chunk_fg_comp_dict_by_nbls(comps))


def test_tensorize_comps_reference_layout(golomb_visdata):
    comps, _, ants_map = _spec_inputs(golomb_visdata)
    kw = dict(dtype=np.float64)
    jc, ji = compat.tensorize_fg_model_comps_dict(comps, ants_map, golomb_visdata.Nfreqs,
                                                  visdata=golomb_visdata, **kw)
    tc, ti = tcompat.tensorize_fg_model_comps_dict(comps, ants_map, golomb_visdata.Nfreqs,
                                                   visdata=as_port(golomb_visdata),
                                                   device="cpu", **kw)
    assert ji == ti
    assert len(jc) == len(tc)
    for a, b in zip(jc, tc):
        assert a.shape == b.shape and a.shape[1:] == (15, 1, 200)
        np.testing.assert_array_equal(np.asarray(a), b)
    with pytest.raises(ValueError, match="requires visdata"):
        tcompat.tensorize_fg_model_comps_dict(comps, ants_map, 200, device="cpu")


def test_full_compat_pipeline(golomb_visdata):
    comps, gains, ants_map = _spec_inputs(golomb_visdata)
    jspec = compat.make_fit_spec(golomb_visdata, comps, ants_map, dtype=np.float64)
    tspec = tcompat.make_fit_spec(as_port(golomb_visdata), comps, ants_map, dtype=np.float64,
                                  device="cpu")
    t = jspec.times[0]
    jd = compat.tensorize_data(jspec, golomb_visdata, "xx", t)
    td = tcompat.tensorize_data(tspec, as_port(golomb_visdata), "xx", t)
    for a, b in zip(jd, td):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(to_np(x), to_np(y))
    jg = compat.tensorize_gains(jspec, gains, "xx", t)
    tg = tcompat.tensorize_gains(tspec, as_port(gains), "xx", t)
    assert to_np(tg[0]).shape == (6, 200)
    for x, y in zip(jg, tg):
        np.testing.assert_array_equal(to_np(x), to_np(y))
    jfr = compat.tensorize_fg_coeffs(jd[0], jd[2], jspec)
    jfi = compat.tensorize_fg_coeffs(jd[1], jd[2], jspec)
    tfr = tcompat.tensorize_fg_coeffs(td[0], td[2], tspec)
    tfi = tcompat.tensorize_fg_coeffs(td[1], td[2], tspec)
    for x, y in zip(jfr + jfi, tfr + tfi):
        assert rel_err(y, x) <= 1e-10
    jcube = compat.yield_fg_model_array(jspec, jfr, jfi)
    tcube = tcompat.yield_fg_model_array(tspec, tfr, tfi)
    assert tcube.shape == (6, 6, 200)
    assert np.max(np.abs(tcube - jcube)) <= 1e-10 * np.max(np.abs(jcube))
    # the write-back shims into each package's own containers
    jmodel, tmodel = golomb_visdata.copy(), as_port(golomb_visdata)
    compat.insert_model_into_uvdata_tensor(jspec, jmodel, jfr, jfi, "xx", t)
    tcompat.insert_model_into_uvdata_tensor(tspec, tmodel, tfr, tfi, "xx", t)
    assert np.max(np.abs(tmodel.data_array - jmodel.data_array)) <= 1e-10 * np.max(
        np.abs(jmodel.data_array))
    jgains, tgains = gains.copy(), as_port(gains)
    compat.insert_gains_into_uvcal(jspec, jgains, *jg, "xx", t)
    tcompat.insert_gains_into_uvcal(tspec, tgains, *tg, "xx", t)
    np.testing.assert_array_equal(tgains.gain_array, jgains.gain_array)


def test_tensorize_fg_coeffs_shared_basis(redundant_visdata):
    """The coefficient-init shim on shared-basis specs and on the
    reference-layout comps list, both packages."""
    comps, _, ants_map = _spec_inputs(redundant_visdata)
    tuvd = as_port(redundant_visdata)
    jspec = compat.make_fit_spec(redundant_visdata, comps, ants_map, shared_basis=True)
    tspec = tcompat.make_fit_spec(tuvd, comps, ants_map, shared_basis=True, device="cpu")
    t = jspec.times[0]
    jd = compat.tensorize_data(jspec, redundant_visdata, "xx", t)
    td = tcompat.tensorize_data(tspec, tuvd, "xx", t)
    jout = compat.tensorize_fg_coeffs(jd[0], jd[2], jspec)
    tout = tcompat.tensorize_fg_coeffs(td[0], td[2], tspec)
    assert len(tout) == len(tspec.chunks) == len(jout)
    for a, b in zip(jout, tout):
        assert to_np(b).shape == to_np(a).shape
        assert rel_err(b, a) <= 1e-5  # float32 packing

    jcomps, _ = compat.tensorize_fg_model_comps_dict(comps, ants_map, redundant_visdata.Nfreqs,
                                                     visdata=redundant_visdata)
    tcomps, _ = tcompat.tensorize_fg_model_comps_dict(comps, ants_map, tuvd.Nfreqs,
                                                      visdata=tuvd, device="cpu")
    jdense = compat.make_fit_spec(redundant_visdata, comps, ants_map)
    tdense = tcompat.make_fit_spec(tuvd, comps, ants_map, device="cpu")
    jd2 = compat.tensorize_data(jdense, redundant_visdata, "xx", t)
    td2 = tcompat.tensorize_data(tdense, tuvd, "xx", t)
    jout2 = compat.tensorize_fg_coeffs(jd2[0], jd2[2], jcomps)
    tout2 = compat_out = tcompat.tensorize_fg_coeffs(td2[0], td2[2], tcomps)
    for a, b, c in zip(jout2, compat_out, tcomps):
        assert to_np(b).shape == (c.shape[1], c.shape[0])
        assert rel_err(b, a) <= 1e-5
    assert len(tout2) == len(jout2)


def test_yield_fg_model_array_real_and_padding(redundant_visdata):
    """The real-part contract without fg_coeffs_i, and shared-batched
    padding entries that must not write into the cube, in both packages."""
    comps, _, ants_map = _spec_inputs(redundant_visdata)
    tuvd = as_port(redundant_visdata)
    jspec = compat.make_fit_spec(redundant_visdata, comps, ants_map, shared_basis=True)
    tspec = tcompat.make_fit_spec(tuvd, comps, ants_map, shared_basis=True, device="cpu")
    t = jspec.times[0]
    jd = compat.tensorize_data(jspec, redundant_visdata, "xx", t)
    td = tcompat.tensorize_data(tspec, tuvd, "xx", t)
    jfr = compat.tensorize_fg_coeffs(jd[0], jd[2], jspec)
    tfr = tcompat.tensorize_fg_coeffs(td[0], td[2], tspec)
    jreal, treal = compat.yield_fg_model_array(jspec, jfr), tcompat.yield_fg_model_array(tspec,
                                                                                         tfr)
    assert treal.dtype.kind == jreal.dtype.kind == "f"
    assert np.max(np.abs(treal - jreal)) <= 1e-5 * np.max(np.abs(jreal))
    jfi = compat.tensorize_fg_coeffs(jd[1], jd[2], jspec)
    tfi = tcompat.tensorize_fg_coeffs(td[1], td[2], tspec)
    # coefficients forced nonzero in every slot, padded ones included
    jbad = [np.asarray(c) + 7.0 for c in jfr]
    tbad = [to_np(c) + 7.0 for c in tfr]
    jcube = compat.yield_fg_model_array(jspec, jbad, jfi)
    tcube = tcompat.yield_fg_model_array(tspec, tbad, tfi)
    assert tcube.dtype.kind == "c"
    assert np.max(np.abs(tcube - jcube)) <= 1e-5 * np.max(np.abs(jcube))
    np.testing.assert_array_equal(tcube == 0, jcube == 0)
