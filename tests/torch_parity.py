"""Shared helpers of the parity tests between calamity_tpu (JAX) and its
PyTorch port, calamity_tpu_torch: inputs are made once with seeded numpy
and handed to both packages as numpy arrays with explicit dtypes."""

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
