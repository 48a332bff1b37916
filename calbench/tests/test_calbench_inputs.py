"""The deployments and the inputs made from the seed."""

import json
import os

import numpy as np
import pytest
import torch
from calbench_cuts import ROOT, SEED

from calbench import arrays, dpss, sky


def config(name):
    return json.load(open(os.path.join(ROOT, "calbench", "configs", f"{name}.json")))


@pytest.mark.parametrize("name, nants, nbls, nuniq, nops", [
    ("hera_full", 331, 54615, 630, 112),
    ("hera_core", 361, 4388, 14, 7),
])
def test_deployment_counts(name, nants, nbls, nuniq, nops):
    dep = arrays.build(config(name))
    assert (dep.nants, dep.nbls, len(dep.uniq), len(dep.op_dly_ns)) == (nants, nbls, nuniq, nops)
    assert dep.nfreqs == 1536 and np.all(dep.ant1 < dep.ant2)
    # every spacing reads one delay, and every operator serves two or more baselines
    assert np.bincount(dep.op_of_bl).min() >= 2


def test_dpss_operator_is_an_orthonormal_basis():
    freqs = 100e6 + 100e3 * np.arange(256)
    a = dpss.operator(freqs, 60.0)
    assert np.allclose(a.T @ a, np.eye(a.shape[1]), atol=1e-10)
    assert 2 * 256 * 100e3 * 60e-9 < a.shape[1] < a.shape[0]


def cut_full():
    cfg = config("hera_full")
    cfg["array"]["rings"] = 2
    dep = arrays.build(cfg, nfreqs=64)
    ops = [torch.as_tensor(a) for a in dpss.operators(dep.freqs, dep.op_dly_ns, workers=1)]
    return cfg, dep, ops


def inputs(seed, ntimes=3):
    cfg, dep, ops = cut_full()
    vis = sky.unique_vis(dep, sky.draw_sky(cfg["sky"]["seed"], 50), ops, torch.device("cpu"))
    gains = sky.draw_gains(seed, ntimes, dep.nants, dep.nfreqs, 0.03, torch.device("cpu"))
    out = np.empty((ntimes * dep.nbls, dep.nfreqs), np.complex64)
    for t in range(ntimes):
        sky.slice_into(dep, vis, gains[t], out[t * dep.nbls:(t + 1) * dep.nbls])
    return out


def test_inputs_are_deterministic_in_the_seed():
    a, b, c = inputs(SEED), inputs(SEED), inputs(SEED + 1)
    assert np.array_equal(a, b)
    # another seed moves every visibility (through the gains), not the sky
    assert np.all(a != c)
    assert np.allclose(np.abs(a).mean(), np.abs(c).mean(), rtol=0.01)
    # the slices of one run differ in their gains, not in their sky
    n = len(a) // 3
    assert not np.allclose(a[:n], a[n:2 * n])
    assert np.allclose(np.abs(a[:n]).mean(), np.abs(a[n:2 * n]).mean(), rtol=0.05)


def test_the_sky_is_the_source_demos():
    from calamity_tpu_torch import simulate

    cfg, dep, ops = cut_full()
    got = sky.unique_vis(dep, sky.draw_sky(cfg["sky"]["seed"], 50), ops, torch.device("cpu"))
    demo = torch.as_tensor(simulate.point_source_visibilities(dep.uniq, dep.freqs, nsrc=50,
                                                              seed=cfg["sky"]["seed"]))
    for u in range(len(dep.uniq)):
        a = ops[dep.op_of_uniq[u]]
        want = (demo[u].real @ a) @ a.T + 1j * ((demo[u].imag @ a) @ a.T)
        assert torch.allclose(got[u], want, rtol=1e-9, atol=1e-9 * want.abs().max())


def test_rfi_flags_reach_their_fraction_in_bands():
    for seed in (99, SEED):
        f = sky.rfi_channels(seed, 1536, 0.05)
        assert int(0.05 * 1536) <= f.sum() <= int(0.05 * 1536) + 23
        edges = np.count_nonzero(np.diff(f.astype(int)) == 1)
        assert 1 <= edges < f.sum() / 2  # bands, not single channels


def test_projected_sky_lies_in_each_spacings_basis():
    cfg = config("hera_core")
    cfg["array"]["nside"] = 5
    dep = arrays.build(cfg, nfreqs=64)
    ops = [torch.as_tensor(a) for a in dpss.operators(dep.freqs, dep.op_dly_ns, workers=1)]
    vis = sky.unique_vis(dep, sky.draw_sky(7, 50), ops, torch.device("cpu"))
    for u in range(len(dep.uniq)):
        a = ops[dep.op_of_uniq[u]]
        v = vis[u]
        assert torch.allclose(a @ (a.T @ v.real), v.real, atol=1e-9 * v.abs().max())
