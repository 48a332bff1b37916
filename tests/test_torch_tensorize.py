"""FitSpec packing of the torch port against calamity_tpu's FitSpec.

The packing is numpy in both packages and only the upload differs, so every
tensor must be equal bit for bit: chunk tensors, antenna indices, row /
conjugation / validity tables, packed data, weights and gains, on the dense
(Golomb, golden file), shared and shared-batched (redundant array) layouts.
Each package packs its own containers and components, built from the same
file or the same numpy arrays.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch_parity import DPSS_DLY, GOLDEN_GOLOMB, as_port, to_np

from calamity_tpu import models
from calamity_tpu.io import CalData, FlagWeights, VisData
from calamity_tpu.solver.tensorize import FitSpec as JaxFitSpec
from calamity_tpu_torch import io as tio
from calamity_tpu_torch import models as tmodels
from calamity_tpu_torch.solver.tensorize import FitSpec, chunk_fitting_groups


def _cross(uvd):
    return uvd.select(inplace=False, bls=[ap for ap in uvd.get_antpairs() if ap[0] != ap[1]])


def _layout(comps, ngrps):
    nu = comps.shape[0]
    if nu == ngrps:
        return "dense"
    return "shared" if nu == 1 else "shared-batched"


@pytest.fixture(params=["golomb", "redundant", "golden"])
def both_specs(request, golomb_visdata, redundant_visdata):
    uvd = {
        "golomb": lambda: golomb_visdata,
        "redundant": lambda: redundant_visdata,
        "golden": lambda: VisData.from_uvh5(GOLDEN_GOLOMB),
    }[request.param]()
    uvd = _cross(uvd)
    comps = models.yield_pbl_dpss_model_comps(uvd, min_dly=DPSS_DLY, offset=DPSS_DLY)
    gains = CalData.blank_from_visdata(uvd)
    rng = np.random.default_rng(7)
    gains.gain_array = gains.gain_array + 0.05 * (
        rng.standard_normal(gains.gain_array.shape)
        + 1j * rng.standard_normal(gains.gain_array.shape)
    )
    ants_map = {int(a): i for i, a in enumerate(gains.ant_array)}
    kw = dict(dtype=np.float32, shared_basis=True)
    tuvd = as_port(uvd)
    tcomps = tmodels.yield_pbl_dpss_model_comps(tuvd, min_dly=DPSS_DLY, offset=DPSS_DLY)
    jax = SimpleNamespace(uvd=uvd, gains=gains, spec=JaxFitSpec(uvd, comps, ants_map, **kw))
    port = SimpleNamespace(uvd=tuvd, gains=as_port(gains),
                           spec=FitSpec(tuvd, tcomps, ants_map, device="cpu", **kw))
    return jax, port


def test_chunks_and_meta_bit_equal(both_specs):
    jspec, tspec = (side.spec for side in both_specs)
    assert len(jspec.chunks) == len(tspec.chunks)
    for jc, tc, hc in zip(jspec.chunks, tspec.chunks, tspec.host_comps):
        for name in ("comps", "a0", "a1"):
            j, t = np.asarray(getattr(jc, name)), getattr(tc, name)
            assert t.device.type == "cpu"
            assert j.dtype == to_np(t).dtype and j.shape == tuple(t.shape)
            np.testing.assert_array_equal(to_np(t), j)
        np.testing.assert_array_equal(hc, np.asarray(jc.comps))  # host copy
    for jm, tm in zip(jspec.meta, tspec.meta):
        assert jm.fit_grps == tm.fit_grps
        for name in ("antpairs", "rows", "conj", "valid"):
            np.testing.assert_array_equal(getattr(tm, name), getattr(jm, name))


def test_layouts_cover_all_three_packings(golomb_visdata, redundant_visdata):
    seen = set()
    for uvd in (golomb_visdata, redundant_visdata):
        uvd = _cross(as_port(uvd))
        comps = tmodels.yield_pbl_dpss_model_comps(uvd, min_dly=DPSS_DLY, offset=DPSS_DLY)
        ants = sorted(set(uvd.ant_1_array.tolist()) | set(uvd.ant_2_array.tolist()))
        spec = FitSpec(uvd, comps, {a: i for i, a in enumerate(ants)}, device="cpu",
                       shared_basis=True)
        seen |= {_layout(c.comps, c.a0.shape[0]) for c in spec.chunks}
    assert seen == {"dense", "shared", "shared-batched"}


@pytest.mark.parametrize("with_weights", [False, True])
def test_pack_data_and_gains_bit_equal(both_specs, with_weights):
    jax, port = both_specs
    jweights = tweights = None
    if with_weights:
        jweights = FlagWeights(jax.uvd, mode="flag")
        jweights.weights_array[:] = np.abs(
            np.random.default_rng(3).standard_normal(jweights.weights_array.shape)
        )
        tweights = tio.FlagWeights(port.uvd, mode="flag")
        tweights.weights_array[:] = jweights.weights_array
    time = jax.spec.times[0]
    kw = dict(data_scale_factor=1.7, nsamples_in_weights=True)
    jd = jax.spec.pack_data(jax.uvd, "xx", time, weights=jweights, **kw)
    td = port.spec.pack_data(port.uvd, "xx", time, weights=tweights, **kw)
    for jlist, tlist in zip(jd, td):
        for j, t in zip(jlist, tlist):
            assert t.dtype == torch.float32
            np.testing.assert_array_equal(to_np(t), np.asarray(j))
    for j, t in zip(jax.spec.pack_gains(jax.gains, "xx", time),
                    port.spec.pack_gains(port.gains, "xx", time)):
        np.testing.assert_array_equal(to_np(t), np.asarray(j))


def test_write_back_bit_equal(both_specs):
    jax, port = both_specs
    nfreqs = jax.uvd.Nfreqs
    rng = np.random.default_rng(5)
    model_chunks = [
        (rng.standard_normal(m.conj.shape + (nfreqs,)),
         rng.standard_normal(m.conj.shape + (nfreqs,)))
        for m in jax.spec.meta
    ]
    time = jax.spec.times[0]
    vj, vt = jax.uvd.copy(), port.uvd.copy()
    jax.spec.insert_model(vj, model_chunks, "xx", time, 2.5)
    port.spec.insert_model(vt, model_chunks, "xx", time, 2.5)
    np.testing.assert_array_equal(vt.data_array, vj.data_array)
    g_r = rng.standard_normal((port.spec.nants, nfreqs)).astype(np.float32)
    g_i = rng.standard_normal((port.spec.nants, nfreqs)).astype(np.float32)
    cj, ct = jax.gains.copy(), port.gains.copy()
    jax.spec.insert_gains(cj, g_r, g_i, "xx", time)
    port.spec.insert_gains(ct, torch.as_tensor(g_r), torch.as_tensor(g_i), "xx", time)
    np.testing.assert_array_equal(ct.gain_array, cj.gain_array)


def test_chunk_fitting_groups_matches_reference(redundant_visdata):
    from calamity_tpu.solver.tensorize import chunk_fitting_groups as jax_chunk

    uvd = _cross(redundant_visdata)
    tuvd = as_port(uvd)
    for use_red in (False, True):
        kw = dict(min_dly=DPSS_DLY, offset=DPSS_DLY, use_redundancy=use_red)
        comps = models.yield_pbl_dpss_model_comps(uvd, **kw)
        tcomps = tmodels.yield_pbl_dpss_model_comps(tuvd, **kw)
        for bucketing in (False, True):
            want = jax_chunk(comps, use_redundancy=use_red, nvec_bucketing=bucketing)
            got = chunk_fitting_groups(tcomps, use_redundancy=use_red, nvec_bucketing=bucketing)
            assert {k: list(v) for k, v in got.items()} == {k: list(v) for k, v in want.items()}


def test_fitspec_requires_a_device(golomb_visdata):
    uvd = _cross(as_port(golomb_visdata))
    comps = tmodels.yield_pbl_dpss_model_comps(uvd, min_dly=DPSS_DLY, offset=DPSS_DLY)
    with pytest.raises(TypeError):
        FitSpec(uvd, comps, {0: 0})  # no device argument
    with pytest.raises(ValueError, match="device is required"):
        FitSpec(uvd, comps, {0: 0}, device=None)
