"""Analytic multi-baseline flat-sky covariance and its eigenbasis.

Behavior parity with reference simple_cov.py:7-182: the covariance between
stacked (baseline, frequency) samples is a product of sinc factors from a
flat-spectrum, horizon-limited sky plus intrinsic antenna chromaticity:

    C[(b,f),(b',f')] = sinc(2 max(|u_bf - u_b'f'| * horizon + dnu*offset,
                              min_dly * dnu)) * sinc(2 dnu * ant_dly)

with u in wavelengths-like units (uvw * f / c) and dnu in GHz-scaled units
(reference divides by 1e9).

Copy of calamity_tpu/models/simple_cov.py with a torch branch in place of
its JAX one: by default the matrix and its eigendecomposition are numpy
float64 on the host (built once, not in the hot loop); ``use_torch=True``
builds the matrix and runs a float64 ``torch.linalg.eigh`` on ``device``,
as the reference's ``use_jax=True`` does on its device. ``use_jax=True``
raises ``ValueError`` and points at ``use_torch``.
"""

from __future__ import annotations

import datetime

import numpy as np
import torch

from ..utils import echo

C_MS = 3e8  # match the reference's c = 3e8 (modeling.py:168-180, simple_cov.py:67)


def _cov_numpy(uvws, freqs, ant_dly, horizon, offset, min_dly, dtype):
    nbls = uvws.shape[0]
    nfreqs = len(freqs)
    absdiff = np.zeros((nbls * nfreqs, nbls * nfreqs), dtype=dtype)
    for k in range(3):
        coord = np.outer(uvws[:, k], freqs / C_MS).reshape(nbls * nfreqs)
        absdiff += np.abs(coord[:, None] - coord[None, :]) ** 2.0
    absdiff = np.sqrt(absdiff) * horizon
    fvals = np.tile(freqs, nbls)
    dfg = np.abs(fvals[:, None] - fvals[None, :]) / 1e9
    absdiff += dfg * offset
    cmat = np.sinc(2.0 * np.maximum(min_dly * dfg, absdiff))
    cmat = cmat * np.sinc(2.0 * dfg * ant_dly)
    return cmat


def _cov_torch(uvws, freqs, ant_dly, horizon, offset, min_dly, dtype, device):
    """:func:`_cov_numpy` in torch on ``device``, in ``dtype``."""
    tdt = torch.float64 if np.dtype(dtype) == np.float64 else torch.float32
    uvws = torch.as_tensor(uvws, dtype=tdt, device=device)
    freqs = torch.as_tensor(freqs, dtype=tdt, device=device)
    nbls = uvws.shape[0]
    n = nbls * freqs.shape[0]
    absdiff = torch.zeros((n, n), dtype=tdt, device=device)
    for k in range(3):
        coord = torch.outer(uvws[:, k], freqs / C_MS).reshape(n)
        absdiff = absdiff + torch.abs(coord[:, None] - coord[None, :]) ** 2.0
    absdiff = torch.sqrt(absdiff) * horizon
    fvals = freqs.repeat(nbls)
    dfg = torch.abs(fvals[:, None] - fvals[None, :]) / 1e9
    absdiff = absdiff + dfg * offset
    cmat = torch.sinc(2.0 * torch.maximum(min_dly * dfg, absdiff))
    return cmat * torch.sinc(2.0 * dfg * ant_dly)


def _refuse_use_jax(use_jax):
    if use_jax:
        raise ValueError(
            "use_jax=True: this package has no JAX branch; pass use_torch=True (with "
            "a device) for the covariance and its eigendecomposition in torch"
        )


def simple_cov_matrix(
    blvecs,
    freqs,
    ant_dly=0.0,
    horizon=1.0,
    offset=0.0,
    min_dly=0.0,
    dtype=np.float64,
    use_jax=False,
    verbose=False,
    use_torch=False,
    device="cuda",
):
    """(Nbls*Nfreqs)^2 analytic covariance (reference simple_cov.py:7-97):
    a numpy array, or with ``use_torch`` a tensor on ``device``."""
    uvws = np.asarray(blvecs, dtype=dtype).reshape(-1, 3)
    freqs = np.asarray(freqs, dtype=dtype)
    _refuse_use_jax(use_jax)
    if use_torch:
        from .._device import resolve_device

        return _cov_torch(uvws, freqs, ant_dly, horizon, offset, min_dly, dtype,
                          resolve_device(device))
    return _cov_numpy(uvws, freqs, ant_dly, horizon, offset, min_dly, dtype)


def yield_simple_multi_baseline_model_comps(
    blvecs,
    freqs,
    ant_dly=0.0,
    horizon=1.0,
    offset=0.0,
    min_dly=0.0,
    dtype=np.float64,
    verbose=False,
    use_jax=False,
    eigenval_cutoff=1e-10,
    use_torch=False,
    device="cuda",
):
    """Eigenvectors of the analytic covariance with relative eigenvalue
    >= cutoff, in descending eigenvalue order (reference simple_cov.py:100-182).
    ``use_torch``: the covariance and a float64 ``torch.linalg.eigh`` on
    ``device``.

    Returns (Nbls*Nfreqs, Ncomponents) float64 numpy array.
    """
    _refuse_use_jax(use_jax)
    cmat = simple_cov_matrix(
        blvecs,
        freqs,
        ant_dly=ant_dly,
        horizon=horizon,
        offset=offset,
        min_dly=min_dly,
        dtype=dtype,
        use_jax=use_jax,
        verbose=verbose,
        use_torch=use_torch,
        device=device,
    )
    echo(
        f"{datetime.datetime.now()} Deriving modeling components with eigenvalue decomposition...\n",
        verbose=verbose,
    )
    if use_torch:
        evals, evecs = torch.linalg.eigh(cmat.to(torch.float64))
        evals, evecs = evals.cpu().numpy(), evecs.cpu().numpy()
    else:
        evals, evecs = np.linalg.eigh(np.asarray(cmat))
    selection = evals / evals[-1] >= eigenval_cutoff
    echo(
        f"{datetime.datetime.now()} Using {np.count_nonzero(selection)} of "
        f"{len(selection)} eigenvectors to model foregrounds...\n",
        verbose=verbose,
    )
    return evecs[:, selection][:, ::-1]
