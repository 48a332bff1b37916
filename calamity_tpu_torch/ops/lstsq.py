"""Batched masked least-squares warm start for foreground coefficients.

Port of calamity_tpu/ops/lstsq.py:25-171: one batched normal-equation
solve per chunk, ``c = (A^T A + ridge I)^{-1} A^T (d * binwgt)``, with
zero-padded basis columns masked out, for one slice or for a batch of
slices (the time-parallel path). The gram depends only on the basis, so
its Cholesky factor is computed once per FitSpec.
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


def init_coeffs_chunk(comps, data, wgts, ridge=1e-6):
    """Least-squares coefficients of one dense chunk (reference
    ops/lstsq.py:174-209): comps (ngrps, nbls, nfreqs, nvecs), data/wgts
    (ngrps, nbls, nfreqs) -> (ngrps, nvecs). The gram's factor is computed
    here rather than kept: :func:`gram_cholesky_chunk` then
    :func:`init_coeffs_from_cholesky`."""
    chol, active = gram_cholesky_chunk(comps, ridge)
    return init_coeffs_from_cholesky(chol, active, comps, data, wgts)


def init_coeffs_from_cholesky_batched(chol, active, comps, data_r, data_i, wgts):
    """Warm-start coefficients for a whole batch of (time, pol) slices at
    once (reference ops/lstsq.py:97-113).

    data_r/data_i/wgts: (nbatch, ngrps, nbls, nfreqs), typically the
    resident stacked fit tensors (wgts may broadcast along the channel
    axis). Written batched: every slice's real and imaginary right-hand
    sides go through one triangular solve per group. Returns (coeffs_r,
    coeffs_i), each (nbatch, ngrps, nvecs)."""
    ngrps_c, nbls, nfreqs, nvecs = comps.shape
    nbatch, ngrps = data_r.shape[0], data_r.shape[1]
    binw = (wgts != 0).to(data_r.dtype)
    # (2, nbatch, ngrps, nbls * nfreqs)
    dvec = (torch.stack([data_r, data_i]) * binw).reshape(2, nbatch, ngrps, nbls * nfreqs)
    if ngrps_c == 1 and ngrps > 1:
        amat0 = comps.reshape(nbls * nfreqs, nvecs)
        rhs = torch.einsum("nv,kbgn->vkbg", amat0, dvec).reshape(nvecs, -1)
        x = torch.cholesky_solve(rhs, chol.reshape(nvecs, nvecs))
        x = x.reshape(nvecs, 2, nbatch, ngrps).permute(1, 2, 3, 0)
        coeffs = x * active.reshape(1, nvecs)
    elif 1 < ngrps_c < ngrps:
        nu = ngrps_c
        gmax = ngrps // nu
        amat = comps.reshape(nu, nbls * nfreqs, nvecs)
        dblk = dvec.reshape(2, nbatch, nu, gmax, nbls * nfreqs)
        rhs = torch.einsum("unv,kbugn->uvkbg", amat, dblk).reshape(nu, nvecs, -1)
        x = torch.cholesky_solve(rhs, chol)  # (nu, nvecs, 2 * nbatch * gmax)
        x = x.reshape(nu, nvecs, 2, nbatch, gmax).permute(2, 3, 0, 4, 1)
        coeffs = x.reshape(2, nbatch, ngrps, nvecs) * torch.repeat_interleave(
            active, gmax, dim=0)
    else:
        amat = comps.reshape(ngrps, nbls * nfreqs, nvecs)
        rhs = torch.einsum("gnv,kbgn->gvkb", amat, dvec).reshape(ngrps, nvecs, -1)
        x = torch.cholesky_solve(rhs, chol)  # (ngrps, nvecs, 2 * nbatch)
        coeffs = x.reshape(ngrps, nvecs, 2, nbatch).permute(2, 3, 0, 1) * active
    return coeffs[0], coeffs[1]


def blocked_init_from_data(chol, active, comps, data_r, data_i, wgts, blk):
    """Batched warm start plus per-slice prior and weight sums over group
    blocks of ``blk`` (reference ops/lstsq.py:116-171).

    A Python loop over group blocks of the resident cubes: each block is a
    view, so the only device memory beyond the operands is one block's
    transients. Shared-batched chunks slice the operator axis on class
    boundaries (``blk`` is a multiple of gmax). bfloat16 weights are upcast
    per block, like the loss. Returns (coeffs_r, coeffs_i, wsum, prior_r,
    prior_i); the sums are (nbatch,)."""
    nbatch, ngrps = data_r.shape[0], data_r.shape[1]
    nu = comps.shape[0]
    gmax = ngrps // nu if 1 < nu < ngrps else 1
    zero = torch.zeros((nbatch,), dtype=data_r.dtype, device=data_r.device)
    wsum, pr, pi = zero, zero, zero
    crs, cis = [], []
    for g0 in range(0, ngrps, blk):
        dr = data_r[:, g0:g0 + blk]
        di = data_i[:, g0:g0 + blk]
        w = wgts[:, g0:g0 + blk]
        if w.dtype != dr.dtype:
            w = w.to(dr.dtype)
        if nu == 1:
            comps_b, chol_b, act_b = comps, chol, active
        elif nu < ngrps:
            u0, u1 = g0 // gmax, (g0 + blk) // gmax
            comps_b, chol_b, act_b = comps[u0:u1], chol[u0:u1], active[u0:u1]
        else:
            comps_b, chol_b, act_b = comps[g0:g0 + blk], chol[g0:g0 + blk], active[g0:g0 + blk]
        cr, ci = init_coeffs_from_cholesky_batched(chol_b, act_b, comps_b, dr, di, w)
        wsum = wsum + torch.sum(w, dim=(1, 2, 3))
        pr = pr + torch.sum(dr * w, dim=(1, 2, 3))
        pi = pi + torch.sum(di * w, dim=(1, 2, 3))
        crs.append(cr)
        cis.append(ci)
    return torch.cat(crs, dim=1), torch.cat(cis, dim=1), wsum, pr, pi
