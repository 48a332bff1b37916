"""Forward visibility model and weighted chi-square loss (torch ops).

Port of calamity_tpu/ops/loss.py. The foreground model per chunk is a
batched matvec of the padded basis tensor against the stacked (real, imag)
coefficients; complex arithmetic is expanded into real products; antenna
gains are gathered by index. Chunks that a kernel's gate accepts go through
that kernel instead (on a CUDA tensor; its plain version on a CPU tensor):
a dense B=1 chunk through ``ops.fused``'s kernel, a shared or
shared-batched B=1 chunk through ``ops.shared``'s (with the "sum" prior,
through their "sum" instances), each as one ``ops.gains.chunk_term`` from
the gains on.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from . import fused, shared
from .fused import explain_fused_loss_inapplicable
from .gains import chunk_term, gain_products
from .shared import explain_shared_loss_inapplicable, group_mask


def fg_model(coeffs_r, coeffs_i, comps):
    """Foreground visibilities from basis coefficients.

    comps: (ngrps, nbls, nfreqs, nvecs); coeffs: (ngrps, nvecs)
    returns (vr, vi) each (ngrps, nbls, nfreqs).

    The real and imaginary coefficient vectors are stacked into one
    contraction, so comps is read once per evaluation. bfloat16 comps are
    upcast to the coefficient dtype first (a materialized copy here).

    Shared-basis chunks (comps group dim 1, ngrps > 1 coefficient rows)
    contract the one basis matrix against all groups; shared-batched chunks
    (1 < nu < ngrps) hold blocks of ngrps // nu consecutive groups per
    operator."""
    if comps.dtype != coeffs_r.dtype:
        comps = comps.to(coeffs_r.dtype)
    coeffs = torch.stack([coeffs_r, coeffs_i], dim=0)  # (2, ngrps, nvecs)
    ngrps = coeffs.shape[1]
    nu = comps.shape[0]
    if nu == 1 and ngrps > 1:
        v = torch.einsum("bfv,kgv->kgbf", comps[0], coeffs)
        return v[0], v[1]
    if 1 < nu < ngrps:
        gmax = ngrps // nu
        c = coeffs.reshape(2, nu, gmax, coeffs.shape[-1])
        v = torch.einsum("ubfv,kugv->kugbf", comps, c)
        v = v.reshape(2, ngrps, comps.shape[1], comps.shape[2])
        return v[0], v[1]
    v = torch.einsum("gbfv,kgv->kgbf", comps, coeffs)
    return v[0], v[1]


def fg_model_batched(coeffs_r, coeffs_i, comps):
    """Foreground model for a batch of (time, pol) slices sharing one basis
    (reference ops/loss.py:90-126).

    coeffs: (nbatch, ngrps, nvecs); comps as in :func:`fg_model`. Returns
    (vr, vi) each (nbatch, ngrps, nbls, nfreqs). One contraction reads
    comps once for all slices: batching widens the matvec's right-hand side
    instead of re-reading the basis per slice."""
    if comps.dtype != coeffs_r.dtype:
        comps = comps.to(coeffs_r.dtype)
    cb = torch.stack([coeffs_r, coeffs_i], dim=1)  # (nbatch, 2, ngrps, nvecs)
    nbatch, _, ngrps, nvecs = cb.shape
    nu = comps.shape[0]
    if nu == 1 and ngrps > 1:
        v = torch.einsum("bfv,nkgv->nkgbf", comps[0], cb)
    elif 1 < nu < ngrps:
        gmax = ngrps // nu
        c = cb.reshape(nbatch, 2, nu, gmax, nvecs)
        v = torch.einsum("ubfv,nkugv->nkugbf", comps, c)
        v = v.reshape(nbatch, 2, ngrps, comps.shape[1], comps.shape[2])
    else:
        v = torch.einsum("gbfv,nkgv->nkgbf", comps, cb)
    return v[:, 0], v[:, 1]


def fg_model_host(coeffs_r, coeffs_i, comps):
    """numpy mirror of :func:`fg_model` for write-back (same three
    packings; BLAS contractions in the basis' dtype). A shared (one
    operator) or shared-batched chunk (operator u serves the groups [u
    gmax, (u + 1) gmax)) takes one product per operator against its
    groups' real and imaginary coefficients: an einsum with the operator as
    a batch axis would leave BLAS for numpy's own loops, minutes at the
    full array's size."""
    comps = np.asarray(comps)
    cr = np.asarray(coeffs_r, dtype=comps.dtype)
    ci = np.asarray(coeffs_i, dtype=comps.dtype)
    nu, nbls, nfreqs, nvecs = comps.shape
    ngrps = cr.shape[0]
    if nu == ngrps:
        vr = np.einsum("gbfv,gv->gbf", comps, cr, optimize=True)
        vi = np.einsum("gbfv,gv->gbf", comps, ci, optimize=True)
        return vr, vi
    gmax = ngrps // nu
    rhs = (np.concatenate([cr, ci]).reshape(2, nu, gmax, nvecs).transpose(1, 3, 0, 2)
           .reshape(nu, nvecs, 2 * gmax))
    v = np.matmul(comps.reshape(nu, nbls * nfreqs, nvecs), rhs)
    v = (v.reshape(nu, nbls, nfreqs, 2, gmax).transpose(3, 0, 4, 1, 2)
         .reshape(2, ngrps, nbls, nfreqs))
    return v[0], v[1]


def fg_model_all_chunks_host(fg_r, fg_i, host_comps):
    """Per-chunk host foreground models (``host_comps``: the numpy basis
    tensors a FitSpec keeps on the host)."""
    return [
        fg_model_host(fg_r[cnum], fg_i[cnum], comps)
        for cnum, comps in enumerate(host_comps)
    ]


def data_model(g_r, g_i, coeffs_r, coeffs_i, comps, a0, a1):
    """Gain-corrupted foreground model (reference data_model, calibration.py:1593-1605)."""
    pr, pi = gain_products(g_r, g_i, a0, a1)
    vr, vi = fg_model(coeffs_r, coeffs_i, comps)
    model_r = pr * vr + pi * vi
    model_i = -pi * vr + pr * vi
    return model_r, model_i


def mse(model_r, model_i, data_r, data_i, wgts):
    """Flag-weighted squared error (reference mse, calibration.py:1608-1609).

    Weights stored at a lower precision are upcast to the model dtype."""
    if wgts.dtype != model_r.dtype:
        wgts = wgts.to(model_r.dtype)
    return torch.sum((torch.square(data_r - model_r) + torch.square(data_i - model_i)) * wgts)


def _chunk_term(g_r, g_i, fr, fi, comps, a0, a1, dr, di, w):
    model_r, model_i = data_model(g_r, g_i, fr, fi, comps, a0, a1)
    return mse(model_r, model_i, dr, di, w)


def _chunk_term_remat(*args):
    # no RNG state to save (the loss draws no random numbers), which a
    # CUDA-graph capture could not read
    return checkpoint(_chunk_term, *args, use_reentrant=False, preserve_rng_state=False)


def chunked_loss(g_r, g_i, fg_r, fg_i, chunks, data_r, data_i, wgts, remat=False):
    """Sum of per-chunk weighted chi-square (reference mse_chunked, calibration.py:1612-1620).

    chunks: tuple of (comps, a0, a1) triples; fg_r/fg_i/data_*/wgts: matching
    sequences; a chunk's weights may be one (..., 1) plane broadcast over
    frequency. A chunk a kernel's gate accepts (B=1, float32 or bfloat16
    comps, float32 operands) goes through that kernel: a dense one through
    ``ops.fused``'s, a shared or shared-batched one through
    ``ops.shared``'s; every other chunk takes the plain torch ops below.

    ``remat`` wraps each plain chunk term in ``torch.utils.checkpoint``,
    so the backward pass recomputes the foreground model instead of saving
    (ngrps, nbls, nfreqs) activations per chunk."""
    total = torch.zeros((), dtype=g_r.dtype, device=g_r.device)
    term = _chunk_term_remat if remat else _chunk_term
    for cnum, (comps, a0, a1) in enumerate(chunks):
        args = (g_r, g_i, fg_r[cnum], fg_i[cnum], comps, a0, a1, data_r[cnum], data_i[cnum],
                wgts[cnum])
        loss = _kernel_term(False, *args)
        total = total + (term(*args) if loss is None else loss)
    return total


def _kernel_term(terms, g_r, g_i, fr, fi, comps, a0, a1, dr, di, w):
    """A chunk's term through a chunk-loss kernel, the dense one or the
    shared-basis one, where its gate accepts the chunk: the chi-square, or
    with ``terms`` the "sum" prior's (3,) terms; None where neither kernel
    takes it."""
    if explain_fused_loss_inapplicable(comps, fr, dr, w) is None:
        inst, valid = fused.SUM_TERM if terms else fused.LOSS_TERM, ()
    elif explain_shared_loss_inapplicable(comps, fr, dr, w) is None:
        inst, valid = shared.SUM_TERM if terms else shared.LOSS_TERM, (group_mask(a0),)
    else:
        return None
    dr = dr[:, 0]
    # a frequency-invariant weights plane (trailing axis 1) reaches the
    # kernel as a stride-0 view of the data's shape
    one = (t.unsqueeze(0) for t in (g_r, g_i, fr, fi))
    planes = (t.unsqueeze(0) for t in (dr, di[:, 0], w[:, 0].expand(dr.shape)))
    return chunk_term(inst, *one, a0, a1, *planes, comps[:, 0], *valid)[..., 0]


def chunked_loss_sum_regularized(
    g_r, g_i, fg_r, fg_i, chunks, data_r, data_i, wgts, prior_r_sum, prior_i_sum
):
    """Chi-square plus the "sum" flux-scale prior
    (reference mse_chunked_sum_regularized, calibration.py:1623-1656):
    penalizes deviation of the weighted model flux sums from the sky-model
    prior sums, pinning the overall amplitude/phase degeneracy. A chunk a
    kernel's gate accepts (as in :func:`chunked_loss`) takes that kernel's
    "sum" instances (the chi-square and both flux sums in one pass, their
    gradients from its pieces or in a second pass at the prior's
    cotangents); every other chunk the torch ops below."""
    total = torch.zeros((), dtype=g_r.dtype, device=g_r.device)
    mr_sum = torch.zeros((), dtype=g_r.dtype, device=g_r.device)
    mi_sum = torch.zeros((), dtype=g_r.dtype, device=g_r.device)
    for cnum, (comps, a0, a1) in enumerate(chunks):
        terms = _kernel_term(True, g_r, g_i, fg_r[cnum], fg_i[cnum], comps, a0, a1,
                             data_r[cnum], data_i[cnum], wgts[cnum])
        if terms is not None:
            chi2, mrs, mis = terms
            total = total + chi2
            mr_sum = mr_sum + mrs
            mi_sum = mi_sum + mis
            continue
        model_r, model_i = data_model(g_r, g_i, fg_r[cnum], fg_i[cnum], comps, a0, a1)
        w = wgts[cnum]
        if w.dtype != model_r.dtype:
            w = w.to(model_r.dtype)
        mr_sum = mr_sum + torch.sum(model_r * w)
        mi_sum = mi_sum + torch.sum(model_i * w)
        total = total + mse(model_r, model_i, data_r[cnum], data_i[cnum], w)
    return total + torch.square(mr_sum - prior_r_sum) + torch.square(mi_sum - prior_i_sum)


def fg_model_all_chunks(fg_r, fg_i, chunks):
    """Per-chunk foreground model arrays (for SNR weights)."""
    return [fg_model(fg_r[cnum], fg_i[cnum], comps) for cnum, (comps, _, _) in enumerate(chunks)]
