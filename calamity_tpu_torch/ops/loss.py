"""Forward visibility model and weighted chi-square loss: the port's one
loss layer, which both descents call.

Port of calamity_tpu/ops/loss.py and of the loss half of
calamity_tpu/parallel/batched.py. The foreground model per chunk is a
batched matvec of the padded basis tensor against the stacked (real, imag)
coefficients; complex arithmetic is expanded into real products; antenna
gains are gathered by index. The losses carry a leading slice axis (the
time-parallel path's (time, pol) slices); the serial loss is the same loss
at one slice.

Each chunk's route is chosen once, by :func:`chunk_route`. A dense
one-baseline-per-group chunk goes through the fused kernel (``ops.fused``:
one comps read for every slice), a shared or shared-batched one through
the shared-basis kernel (``ops.shared``: an operator's tile read once for
a tile of (group, slice) pairs), under the "sum" prior through their "sum"
instances, on a CUDA tensor (their plain versions on a CPU tensor), each
as one ``ops.gains.chunk_term`` from the gains on, whose backward hands the
kernel's gain-product gradients straight to the gain-gradient kernel. Every
other chunk takes the torch ops here, whose contraction also reads comps
once for the batch, its gain gradient ``ops.gains.GainProducts``' backward.
"""

from __future__ import annotations

import warnings
from functools import partial
from typing import Any, NamedTuple, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from . import fused, shared
from .fused import explain_fused_loss_inapplicable
from .gains import carry_valid, chunk_term, gain_products, gain_products_batched
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


def fg_model_all_chunks(fg_r, fg_i, chunks):
    """Per-chunk foreground model arrays (for SNR weights)."""
    return [fg_model(fg_r[cnum], fg_i[cnum], comps) for cnum, (comps, _, _) in enumerate(chunks)]


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


class Route(NamedTuple):
    """A chunk's route (:func:`chunk_route`): a chunk-loss kernel's
    chi-square and "sum" prior instances, ``masked`` where the chunk's
    group mask (``ops.shared.group_mask``) follows their operands; or,
    ``loss`` None, the plain torch ops and why no kernel takes the chunk."""

    loss: Any = None
    sums: Any = None
    masked: bool = False
    reason: Optional[str] = None


def chunk_route(comps, coeffs, data, wgts):
    """A chunk's :class:`Route` (its comps and a coefficient, data and
    weight tensor, of one slice or of a batch): the dense kernel where its
    gate accepts the chunk, else the shared-basis kernel where its gate
    does, else the plain torch ops, with the reason of the kernel whose
    layout the chunk has."""
    dense = explain_fused_loss_inapplicable(comps, coeffs, data, wgts)
    if dense is None:
        return Route(fused.LOSS_TERM, fused.SUM_TERM)
    other = explain_shared_loss_inapplicable(comps, coeffs, data, wgts)
    if other is None:
        return Route(shared.LOSS_TERM, shared.SUM_TERM, masked=True)
    return Route(reason=dense if comps.shape[0] >= coeffs.shape[-2] else other)


def warn_fused_fallbacks(chunks, fg_r, data_r, wgts):
    """Warn (once per fit) naming every chunk that no chunk-loss kernel
    takes, and why; those chunks take the plain torch loss. Returns the
    list of reasons."""
    reasons = []
    for cnum, (comps, _, _) in enumerate(chunks):
        reason = chunk_route(comps, fg_r[cnum], data_r[cnum], wgts[cnum]).reason
        if reason is not None:
            reasons.append(f"chunk {cnum}: {reason}")
    if reasons:
        warnings.warn(
            "these chunks take the plain torch loss, not a kernel: " + "; ".join(reasons),
            stacklevel=3,
        )
    return reasons


# ---------------------------------------------------------------------- #
# per-chunk terms with a slice axis: each returns a tuple of (nbatch,)
# tensors
# ---------------------------------------------------------------------- #
def _chunk_model(gr, gi, fr, fi, comps, a0, a1):
    pr, pi = gain_products_batched(gr, gi, a0, a1)
    vr, vi = fg_model_batched(fr, fi, comps)
    return pr * vr + pi * vi, -pi * vr + pr * vi


def _weights_as(w, dr):
    # bfloat16 weights are stored at half width and upcast at the use
    return w if w.dtype == dr.dtype else w.to(dr.dtype)


def _plain_losses(gr, gi, fr, fi, dr, di, w, comps, a0, a1):
    mr, mi = _chunk_model(gr, gi, fr, fi, comps, a0, a1)
    w = _weights_as(w, dr)
    return (torch.sum(w * (torch.square(dr - mr) + torch.square(di - mi)), dim=(1, 2, 3)),)


def _sum_terms(gr, gi, fr, fi, dr, di, w, comps, a0, a1):
    mr, mi = _chunk_model(gr, gi, fr, fi, comps, a0, a1)
    w = _weights_as(w, dr)
    return (
        torch.sum(w * (torch.square(dr - mr) + torch.square(di - mi)), dim=(1, 2, 3)),
        torch.sum(mr * w, dim=(1, 2, 3)),
        torch.sum(mi * w, dim=(1, 2, 3)),
    )


def _kernel_terms(inst, masked, gr, gi, fr, fi, dr, di, w, comps, a0, a1):
    """A B=1 chunk's term ``inst`` through its chunk-loss kernel, from the
    gains on (``ops.gains.chunk_term``). A frequency-invariant weights
    plane (trailing axis 1) reaches the kernel as a stride-0 view of the
    data's shape."""
    wp = w[:, :, 0].expand(dr.shape[0], dr.shape[1], dr.shape[3])
    valid = (group_mask(a0),) if masked else ()
    out = chunk_term(inst, gr, gi, fr, fi, a0, a1, dr[:, :, 0], di[:, :, 0], wp, comps[:, 0],
                     *valid)
    return (out,) if out.dim() == 1 else tuple(out)  # the "sum" instances' (3, nbatch)


def _chunk_blocks(term, gr, gi, fr, fi, dr, di, w, comps, a0, a1, blk):
    """A chunk's terms summed over group blocks of ``blk``, each block
    recomputed on the backward pass (``torch.utils.checkpoint``), so the
    live activations are one block's. Blocks are views of the resident
    cubes (reference ``_blocked_chunk_scan``, a lax.scan there)."""
    ngrps = a0.shape[0]
    nu = comps.shape[0]
    gmax = _gmax(comps, ngrps)  # blk covers whole operator classes
    total = None
    # the blocks' index views, made once and kept on the chunk's indices,
    # so each keeps the gain-gradient kernel's row lists across steps
    views = a0.__dict__.setdefault("_block_views", {})
    for g0 in range(0, ngrps, blk):
        g1 = g0 + blk
        # one shared operator serves every block
        comps_b = comps if nu == 1 else comps[g0 // gmax:g1 // gmax]
        if (g0, g1) not in views or views[(g0, g1)][0] is not a1:
            views[(g0, g1)] = (a1, a0[g0:g1], a1[g0:g1])
            carry_valid(a0, views[(g0, g1)][1], slice(g0, g1))
        _, a0_b, a1_b = views[(g0, g1)]
        # the loss draws no random numbers: no RNG state to save, which a
        # CUDA-graph capture could not read
        out = checkpoint(term, gr, gi, fr[:, g0:g1], fi[:, g0:g1], dr[:, g0:g1],
                         di[:, g0:g1], w[:, g0:g1], comps_b, a0_b, a1_b,
                         use_reentrant=False, preserve_rng_state=False)
        total = out if total is None else tuple(t + o for t, o in zip(total, out))
    return total


def _loss_block_size(ngrps, gmax, requested, multiple_of=1):
    """Largest group block <= ``requested`` that divides ngrps and is a
    multiple of gmax (shared-batched chunks split on operator-class
    boundaries) and of ``multiple_of``. None when blocking is off or would
    not split the chunk (reference parallel/batched.py:43-63)."""
    if requested is None or requested >= ngrps:
        return None
    if int(requested) < 1:
        raise ValueError(
            f"loss_block_ngrps must be >= 1, got {requested} (use None to "
            "disable group blocking)"
        )
    unit = int(np.lcm(int(gmax), int(multiple_of)))
    b = max(unit, (int(requested) // unit) * unit)
    while b >= unit and ngrps % b:
        b -= unit
    if b < unit:
        return None
    return b if b < ngrps else None


def _gmax(comps, ngrps):
    nu = comps.shape[0]
    return ngrps // nu if 1 < nu < ngrps else 1


def _chunk_terms(terms, g_r, g_i, fg_r, fg_i, chunks, data_r, data_i, wgts, remat=False,
                 loss_block=None):
    """The chunks' terms on their routes, summed in chunk order: a tuple of
    (nbatch,) tensors, the chi-square, or with ``terms`` the "sum" prior's
    (chi-square, M_r, M_i). A chunk is taken in group blocks of
    ``loss_block`` where that splits it; ``remat`` checkpoints a plain chunk
    that no block does."""
    total = (0.0,) * (3 if terms else 1)
    for cnum, (comps, a0, a1) in enumerate(chunks):
        args = (g_r, g_i, fg_r[cnum], fg_i[cnum], data_r[cnum], data_i[cnum], wgts[cnum],
                comps, a0, a1)
        ngrps = a0.shape[0]
        blk = _loss_block_size(ngrps, _gmax(comps, ngrps), loss_block)
        route = chunk_route(comps, fg_r[cnum], data_r[cnum], wgts[cnum])
        if route.loss is not None:
            term = partial(_kernel_terms, route.sums if terms else route.loss, route.masked)
        else:
            term = _sum_terms if terms else _plain_losses
            if remat and blk is None:
                # no RNG state to save (the loss draws no random numbers),
                # which a CUDA-graph capture could not read
                term = partial(checkpoint, term, use_reentrant=False, preserve_rng_state=False)
        out = term(*args) if blk is None else _chunk_blocks(term, *args, blk)
        total = tuple(t + o for t, o in zip(total, out))
    return total


def batched_chunk_losses(g_r, g_i, fg_r, fg_i, chunks, data_r, data_i, wgts,
                         use_pallas=False, remat=False, loss_block=None):
    """Per-slice chi-square, shape (nbatch,) (reference
    parallel/batched.py:139-213).

    A B=1 chunk goes through the fused (dense) or the shared-basis kernel
    wherever its gate accepts it (:func:`chunk_route`); ``use_pallas`` is
    accepted for parity and ignored. ``remat`` recomputes each plain
    chunk's model on the backward pass; ``loss_block`` evaluates each chunk
    over group blocks of that size."""
    del use_pallas
    return _chunk_terms(False, g_r, g_i, fg_r, fg_i, chunks, data_r, data_i, wgts, remat,
                        loss_block)[0]


def batched_chunk_losses_sum_regularized(
    g_r, g_i, fg_r, fg_i, chunks, data_r, data_i, wgts, prior_r, prior_i, loss_block=None,
):
    """Per-slice chi-square plus the "sum" flux prior, one prior pair per
    slice, shape (nbatch,) (reference parallel/batched.py:216-272). A B=1
    chunk goes through a chunk-loss kernel's "sum" instances wherever its
    gate accepts it, as in :func:`batched_chunk_losses`."""
    total, mr_sum, mi_sum = _chunk_terms(True, g_r, g_i, fg_r, fg_i, chunks, data_r, data_i,
                                         wgts, loss_block=loss_block)
    return total + torch.square(mr_sum - prior_r) + torch.square(mi_sum - prior_i)


def _one_slice(g_r, g_i, fg_r, fg_i, chunks, data_r, data_i, wgts):
    """The serial loss's arguments as views of one slice (a leading axis of 1)."""
    return (g_r[None], g_i[None], *([x[None] for x in xs] for xs in (fg_r, fg_i)), chunks,
            *([x[None] for x in xs] for xs in (data_r, data_i, wgts)))


def chunked_loss(g_r, g_i, fg_r, fg_i, chunks, data_r, data_i, wgts, remat=False):
    """Sum of per-chunk weighted chi-square (reference mse_chunked,
    calibration.py:1612-1620), 0-d: :func:`batched_chunk_losses` at one
    slice. chunks: tuple of (comps, a0, a1) triples; fg_r/fg_i/data_*/wgts:
    matching sequences; a chunk's weights may be one (..., 1) plane
    broadcast over frequency. ``remat`` recomputes each plain chunk's
    foreground model on the backward pass instead of saving it."""
    if not chunks:
        return torch.zeros((), dtype=g_r.dtype, device=g_r.device)
    args = _one_slice(g_r, g_i, fg_r, fg_i, chunks, data_r, data_i, wgts)
    return batched_chunk_losses(*args, remat=remat)[0]


def chunked_loss_sum_regularized(
    g_r, g_i, fg_r, fg_i, chunks, data_r, data_i, wgts, prior_r_sum, prior_i_sum
):
    """Chi-square plus the "sum" flux-scale prior
    (reference mse_chunked_sum_regularized, calibration.py:1623-1656), 0-d:
    :func:`batched_chunk_losses_sum_regularized` at one slice. The prior
    penalizes deviation of the weighted model flux sums from the sky-model
    prior sums, pinning the overall amplitude/phase degeneracy."""
    args = _one_slice(g_r, g_i, fg_r, fg_i, chunks, data_r, data_i, wgts)
    priors = (p.reshape(1) if torch.is_tensor(p) else p for p in (prior_r_sum, prior_i_sum))
    return batched_chunk_losses_sum_regularized(*args, *priors)[0]

