"""Batched masked least-squares warm start for foreground coefficients.

Port of calamity_tpu/ops/lstsq.py:25-94: one batched normal-equation solve
per chunk, ``c = (A^T A + ridge I)^{-1} A^T (d * binwgt)``, with
zero-padded basis columns masked out. The gram depends only on the basis,
so its Cholesky factor is computed once per FitSpec.
"""

from __future__ import annotations

import torch


def gram_cholesky_chunk(comps, ridge=1e-6):
    """Cholesky factor of the (static) normal-equation gram per group.

    Zero-padded columns get a unit diagonal, so the padded block decouples
    (it solves to rhs = 0) and the condition number stays ~1; the active
    block gets a small relative ridge. Returns (chol, active)."""
    ngrps, nbls, nfreqs, nvecs = comps.shape
    amat = comps.reshape(ngrps, nbls * nfreqs, nvecs)
    gram = torch.einsum("gnv,gnw->gvw", amat, amat)
    col_norm = torch.sum(torch.square(amat), dim=1)
    active = (col_norm > 0).to(amat.dtype)
    scale = torch.amax(col_norm, dim=1, keepdim=True)
    diag_add = torch.where(active > 0, ridge * scale, torch.ones_like(scale))
    eye = torch.eye(nvecs, dtype=amat.dtype, device=amat.device)
    gram = gram + eye * diag_add[..., None, :]
    return torch.linalg.cholesky(gram), active


def init_coeffs_from_cholesky(chol, active, comps, data, wgts):
    """Warm-start coefficients using a precomputed gram factor.

    Supports the three packings: dense, shared (comps group dim 1, data
    carrying ngrps groups) and shared-batched (blocks of ngrps // nu groups
    per operator)."""
    ngrps_c, nbls, nfreqs, nvecs = comps.shape
    ngrps = data.shape[0]
    binw = (wgts != 0).to(data.dtype)
    dvec = (data * binw).reshape(ngrps, nbls * nfreqs)
    if ngrps_c == 1 and ngrps > 1:
        amat0 = comps.reshape(nbls * nfreqs, nvecs)
        rhs = torch.einsum("nv,gn->gv", amat0, dvec)
        chol0 = chol.reshape(nvecs, nvecs)
        y = torch.linalg.solve_triangular(chol0, rhs.T, upper=False)
        x = torch.linalg.solve_triangular(chol0.T, y, upper=True)
        return x.T * active.reshape(1, nvecs)
    if 1 < ngrps_c < ngrps:
        nu = ngrps_c
        gmax = ngrps // nu
        amat = comps.reshape(nu, nbls * nfreqs, nvecs)
        dblk = dvec.reshape(nu, gmax, nbls * nfreqs)
        rhs = torch.einsum("unv,ugn->ugv", amat, dblk)  # (nu, gmax, nvecs)
        y = torch.linalg.solve_triangular(chol, rhs.transpose(1, 2), upper=False)
        x = torch.linalg.solve_triangular(chol.transpose(1, 2), y, upper=True)
        coeffs = x.transpose(1, 2).reshape(ngrps, nvecs)
        return coeffs * torch.repeat_interleave(active, gmax, dim=0)
    amat = comps.reshape(ngrps, nbls * nfreqs, nvecs)
    rhs = torch.einsum("gnv,gn->gv", amat, dvec)
    coeffs = torch.cholesky_solve(rhs[..., None], chol)[..., 0]
    return coeffs * active
