"""Shared helpers of the parity tests between calamity_tpu (JAX) and its
PyTorch port, calamity_tpu_torch: inputs are made once with seeded numpy
and handed to both packages as numpy arrays with explicit dtypes."""

import copy
import os

import numpy as np
import torch

GOLDEN_GOLOMB = os.path.join(os.path.dirname(__file__), "data", "golden_golomb_projected.uvh5")
DPSS_DLY = 2.0 / 0.3  # min_dly = offset of the repo's DPSS fixtures


def to_np(x):
    """numpy copy of a jax array, a tensor (any dtype) or an array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.numpy()
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)
    return arr


def rel_err(got, want):
    """max |got - want| / max |want| (0 when both are zero)."""
    got, want = to_np(got).astype(np.float64), to_np(want).astype(np.float64)
    scale = np.max(np.abs(want)) if want.size else 0.0
    diff = np.max(np.abs(got - want)) if want.size else 0.0
    return diff / scale if scale > 0 else diff


def as_port(obj):
    """The port's own container (``calamity_tpu_torch.io`` VisData, CalData
    or FlagWeights) holding a deep copy of the arrays of a ``calamity_tpu.io``
    one: each package is handed its own objects, built from the same numpy
    arrays. ``None`` stays ``None``."""
    if obj is None:
        return None
    from calamity_tpu_torch import io as tio

    cls = getattr(tio, type(obj).__name__)
    out = cls.__new__(cls)
    out.__dict__ = copy.deepcopy(obj.__dict__)
    return out


def project_onto_dpss(uvd, comps):
    """Project each baseline's spectra onto its DPSS subspace in place
    (same as tests/test_calibration.py)."""
    for key, mat in comps.items():
        ap = key[0][0]
        d = uvd.get_data(ap + ("xx",))
        proj = (mat @ (d @ mat).T).T
        rows, conj = uvd._bl_time_rows(ap[0], ap[1])
        uvd.data_array[rows, 0, :, 0] = np.conj(proj) if conj else proj
    return uvd


def multitime_visdata(uvd, ntimes=3):
    """``uvd`` projected onto its DPSS basis, repeated at ``ntimes`` times
    two days apart (the multi-time fixture of tests/test_parallel.py)."""
    from calamity_tpu import models

    base = uvd.copy()
    project_onto_dpss(base, models.yield_pbl_dpss_model_comps(base, offset=DPSS_DLY,
                                                              min_dly=DPSS_DLY))
    out = base
    for t in range(1, ntimes):
        later = base.copy()
        later.time_array = later.time_array + 2.0 * t
        out = out + later
    return out


def gain_corrupted(uvd, err=0.05, seed=5):
    """``uvd`` with random complex per-antenna gain errors of relative size
    ``err`` applied: fits with real gradients (from a projected sky alone a
    fit starts at its optimum and follows rounding noise)."""
    from calamity_tpu import cal_utils

    truth = cal_utils.blank_uvcal_from_uvdata(uvd)
    rng = np.random.default_rng(seed)
    truth.gain_array = truth.gain_array * (1 + err * rng.standard_normal(truth.gain_array.shape)
                                           + 1j * err * rng.standard_normal(truth.gain_array.shape))
    return cal_utils.apply_gains(uvd, truth, inverse=True)


def flagged_for_skip(uvd):
    """A copy of a 3-time ``uvd`` with time 1 mostly flagged (skipped at
    skip_threshold 0.5) and a band of channels flagged on two baselines at
    time 0, so the weights depend on frequency."""
    uvd = uvd.copy()
    times = np.unique(uvd.time_array)
    rows = np.nonzero(np.isclose(uvd.time_array, times[1], rtol=0.0, atol=1e-7))[0]
    uvd.flag_array[rows, :, : int(0.7 * uvd.Nfreqs)] = True
    rows0 = np.nonzero(np.isclose(uvd.time_array, times[0], rtol=0.0, atol=1e-7))[0][:2]
    uvd.flag_array[rows0, :, 40:60] = True
    return uvd


def batched_problem(uvd, dtype=np.float32, gain_err=0.02, seed=11, shared_basis=False,
                    weights=None):
    """Host stacks of every (time, pol) slice of ``uvd`` packed by the JAX
    FitSpec, perturbed gains and the JAX batched warm start: the inputs
    both packages' batched descents start from. Returns (jspec, dict)."""
    from calamity_tpu import models
    from calamity_tpu.io import CalData
    from calamity_tpu.ops.lstsq import gram_cholesky_chunk, init_coeffs_from_cholesky_batched
    from calamity_tpu.solver.tensorize import FitSpec

    comps = models.yield_pbl_dpss_model_comps(uvd, min_dly=DPSS_DLY, offset=DPSS_DLY)
    gains = CalData.blank_from_visdata(uvd)
    rng = np.random.default_rng(seed)
    gains.gain_array = gains.gain_array * (
        1 + gain_err * rng.standard_normal(gains.gain_array.shape)
        + 1j * gain_err * rng.standard_normal(gains.gain_array.shape))
    spec = FitSpec(uvd, comps, {int(a): i for i, a in enumerate(gains.ant_array)},
                   dtype=dtype, shared_basis=shared_basis)
    slices = [(pol, t) for pol in uvd.get_pols() for t in spec.times]
    nb = len(slices)
    stacks = [[np.zeros((nb,) + tuple(m.conj.shape) + (uvd.Nfreqs,), dtype=dtype)
               for m in spec.meta] for _ in range(3)]
    g_r, g_i = [], []
    for b, (pol, t) in enumerate(slices):
        rms = np.sqrt(np.mean(np.abs(uvd.data_array) ** 2))
        spec.pack_data_into(uvd, pol, t, *stacks, b, data_scale_factor=rms, weights=weights)
        gr, gi = spec.pack_gains(gains, pol, t)
        g_r.append(np.asarray(gr))
        g_i.append(np.asarray(gi))
    chunks = spec.device_chunks()
    fg_r, fg_i = [], []
    for (c, _, _), dr, di, w in zip(chunks, *stacks):
        chol, active = gram_cholesky_chunk(c)
        cr, ci = init_coeffs_from_cholesky_batched(chol, active, c, dr, di, w)
        fg_r.append(np.asarray(cr))
        fg_i.append(np.asarray(ci))
    return spec, dict(chunks=chunks, data_r=stacks[0], data_i=stacks[1], wgts=stacks[2],
                      g_r=np.stack(g_r), g_i=np.stack(g_i), fg_r=fg_r, fg_i=fg_i)


def torch_batched_problem(p, comps_dtype=None, wgts_dtype=None):
    """The tensors of a :func:`batched_problem` on the CPU, comps and
    weights optionally cast (e.g. to torch.bfloat16)."""
    from calamity_tpu_torch.convert import chunks_from_jax, to_tensor

    def t(xs):
        return [to_tensor(x, "cpu") for x in xs]

    chunks = chunks_from_jax(p["chunks"], "cpu")
    if comps_dtype is not None:
        chunks = tuple((c.to(comps_dtype), a0, a1) for c, a0, a1 in chunks)
    wgts = t(p["wgts"])
    if wgts_dtype is not None:
        wgts = [w.to(wgts_dtype) for w in wgts]
    return dict(chunks=chunks, data_r=t(p["data_r"]), data_i=t(p["data_i"]), wgts=wgts,
                g_r=to_tensor(p["g_r"], "cpu"), g_i=to_tensor(p["g_i"], "cpu"),
                fg_r=t(p["fg_r"]), fg_i=t(p["fg_i"]))


# the batched descents' common settings: a few dozen steps at lr 1e-2
BATCHED_DESCENT = dict(maxsteps=60, tol=0.0, opt_kwargs=(("learning_rate", 1e-2),))
