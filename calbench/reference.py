"""The plain reference of a fit: the chi-square, its warm start and Adamax steps.

Plain PyTorch in float64, in the benchmark's own layout: one (nbls_k,
nvecs_k) coefficient matrix for the baselines that share operator k, the
gains a pair of real (nants, nfreqs) planes. It imports nothing of the
program and takes nothing the program made: the data, the weights and the
bases are the benchmark's own, the bases rounded to the precision the
configuration states for each phase of the mixed schedule (bfloat16, then
float32) and the weights to their stated storage, and the program's fitted
parameters enter only to be judged.

For a slice with data d (over the rms of its unflagged samples), weights w
(one unflagged sample's share of the slice), gains g and coefficients c,

    chi2 = sum_b sum_f w_bf |d_bf - g_i(b) conj(g_j(b)) (A_k(b) c_b)_f|^2,

with the warm start c_b = (A^T A + 1e-6 max_col |A|^2 I)^-1 A^T (d_b [w_b != 0]),
the gains at 1, and Adamax (lr the configuration's; b1 0.9, b2 0.999, eps
1e-7: mu = (1 - b1) g + b1 mu, nu = max(|g| + eps, b2 nu),
p -= lr mu / (1 - b1^t) / nu) for the steps: one unrecorded warm-up step,
then the recorded ones.

``control=True`` is the control: the same arithmetic in float32 with
every product's operands rounded to TF32 (10-bit mantissa, to nearest, ties
away), the nearest precision below the configuration's float32 with TF32
off; the rounding is done by hand, so the control reads the same on the
card and on the CPU.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

LR, B1, B2, EPS = 1e-2, 0.9, 0.999, 1e-7
RIDGE = 1e-6


class Slice(NamedTuple):
    """One slice on the card, in the reference's layout."""

    d_r: Any  # (nbls, nfreqs) data over the rms of the unflagged samples
    d_i: Any
    w: Any  # (nfreqs,) float64: one unflagged sample's weight, 0 where flagged
    mask: Any  # (nfreqs,) bool: unflagged
    a0: Any  # (nbls,) antenna index of the baseline's first antenna
    a1: Any
    members: Any  # per operator k: (nbls_k,) baseline indices
    nants: int


def make_slice(dep, data, flags, wgts_precision, device):
    """A :class:`Slice` of one slice's host visibilities ``data`` (nbls,
    nfreqs) and flagged channels ``flags`` (nfreqs,)."""
    mask = torch.as_tensor(~np.asarray(flags), device=device)
    d = torch.as_tensor(data, device=device).to(torch.complex128)
    d = torch.where(mask[None, :], d, 0)
    nunfl = int(mask.sum()) * dep.nbls
    d = d / torch.sqrt(torch.sum(d.real ** 2 + d.imag ** 2) / nunfl)
    # the weights' unit total taken in float32, then their storage type
    w1 = torch.tensor(1.0, dtype=torch.float32) / torch.tensor(float(nunfl), dtype=torch.float32)
    if wgts_precision == "bfloat16":
        w1 = w1.to(torch.bfloat16)
    w = mask.to(torch.float64) * float(w1)
    op = torch.as_tensor(dep.op_of_bl, device=device)
    members = [torch.nonzero(op == k).reshape(-1) for k in range(len(dep.op_dly_ns))]
    return Slice(d.real.contiguous(), d.imag.contiguous(), w, mask,
                 torch.as_tensor(dep.ant1, device=device), torch.as_tensor(dep.ant2, device=device),
                 members, dep.nants)


def _tf32(x):
    """float32 ``x`` rounded to TF32's 10-bit mantissa, to nearest, ties away
    (the gradient passes the rounding unchanged)."""
    r = x.detach()
    r = (r.view(torch.int32) + 0x1000).bitwise_and(-0x2000).view(torch.float32)
    return x + (r - x.detach())


class _Arith(NamedTuple):
    dtype: Any
    product: Any  # (coefficients (n, V), basis (F, V)) -> (n, F)


def _arith(control):
    if control:
        return _Arith(torch.float32, lambda c, a: _tf32(c) @ _tf32(a).T)
    return _Arith(torch.float64, lambda c, a: c @ a.T)


def bases(ops, storage, control=False):
    """The operators as a phase computes with them: ``storage`` "bfloat16"
    or "float32", held in the arithmetic's dtype."""
    dtype = _arith(control).dtype
    a = [x.float() for x in ops]
    if storage == "bfloat16":
        a = [x.bfloat16() for x in a]
    return [x.to(dtype) for x in a]


def chi2(s, g_r, g_i, c_r, c_i, comps, control=False, sums=False):
    """The chi-square of slice ``s`` at gains (g_r, g_i) and per-operator
    coefficients (c_r, c_i) with the bases ``comps``; with ``sums`` also
    (sum of the unflagged |residual|^2, sum of the unflagged |d|^2)."""
    ar = _arith(control)
    total = torch.zeros((), dtype=ar.dtype, device=g_r.device)
    rr = dd = torch.zeros((), dtype=torch.float64, device=g_r.device)
    w = s.w.to(ar.dtype)
    for k, idx in enumerate(s.members):
        if len(idx) == 0:
            continue
        v_r, v_i = ar.product(c_r[k], comps[k]), ar.product(c_i[k], comps[k])
        i0, i1 = s.a0[idx], s.a1[idx]
        pr = g_r[i0] * g_r[i1] + g_i[i0] * g_i[i1]
        pi = g_r[i0] * g_i[i1] - g_i[i0] * g_r[i1]
        d_r, d_i = s.d_r[idx].to(ar.dtype), s.d_i[idx].to(ar.dtype)
        res_r = d_r - (pr * v_r + pi * v_i)
        res_i = d_i - (pr * v_i - pi * v_r)
        sq = res_r * res_r + res_i * res_i
        total = total + torch.sum(sq * w)
        if sums:
            rr = rr + torch.sum(sq[:, s.mask].double())
            dd = dd + torch.sum((d_r[:, s.mask] ** 2 + d_i[:, s.mask] ** 2).double())
    return (total, rr, dd) if sums else total


def warm_start(s, comps, control=False):
    """Per operator the (nbls_k, nvecs_k) least-squares coefficients of the
    real and imaginary data, flagged channels zeroed."""
    ar = _arith(control)
    binw = s.mask.to(ar.dtype)
    c_r, c_i = [], []
    for k, idx in enumerate(s.members):
        a = comps[k]
        gram = ar.product(a.T.contiguous(), a.T.contiguous())
        gram = gram + RIDGE * torch.amax(torch.sum(a * a, dim=0)) * torch.eye(
            a.shape[1], dtype=ar.dtype, device=a.device)
        rhs = ar.product(torch.cat([s.d_r[idx].to(ar.dtype) * binw,
                                    s.d_i[idx].to(ar.dtype) * binw]), a.T.contiguous())
        x = torch.cholesky_solve(rhs.T, torch.linalg.cholesky(gram)).T
        c_r.append(x[:len(idx)])
        c_i.append(x[len(idx):])
    return c_r, c_i


def follow(s, ops, nsteps, control=False, lr=LR):
    """The recorded losses of the first ``nsteps`` steps of the bfloat16
    phase, each taken at the parameters before its update (float64 numpy):
    the gains at 1, the warm start (float32 bases), one unrecorded step;
    Adamax at learning rate ``lr``."""
    ar = _arith(control)
    c_r, c_i = warm_start(s, bases(ops, "float32", control), control)
    comps = bases(ops, "bfloat16", control)
    dev, nf, nk = s.d_r.device, s.d_r.shape[1], len(c_r)
    params = [torch.ones((s.nants, nf), dtype=ar.dtype, device=dev),
              torch.zeros((s.nants, nf), dtype=ar.dtype, device=dev)] + c_r + c_i
    mu = [torch.zeros_like(p) for p in params]
    nu = [torch.zeros_like(p) for p in params]
    losses = []
    for t in range(1, nsteps + 2):
        p = [x.detach().requires_grad_(True) for x in params]
        loss = chi2(s, p[0], p[1], p[2:2 + nk], p[2 + nk:], comps, control)
        grads = torch.autograd.grad(loss, p)
        if t > 1:
            losses.append(float(loss.detach()))
        with torch.no_grad():
            for j, g in enumerate(grads):
                mu[j] = (1 - B1) * g + B1 * mu[j]
                nu[j] = torch.maximum(torch.abs(g) + EPS, B2 * nu[j])
                params[j] = params[j] + (mu[j] / (1 - B1 ** t)) / nu[j] * (-lr)
    return np.asarray(losses)


def judge(s, ops, g_r, g_i, c_r, c_i, control=False):
    """(chi-square, resid_ratio) at fitted parameters, with the float32
    phase's bases: resid_ratio is the rms of the unflagged residuals over
    the rms of the unflagged data."""
    dtype = _arith(control).dtype
    with torch.no_grad():
        loss, rr, dd = chi2(s, g_r.to(dtype), g_i.to(dtype), [x.to(dtype) for x in c_r],
                            [x.to(dtype) for x in c_i], bases(ops, "float32", control),
                            control, sums=True)
    return float(loss), float(torch.sqrt(rr / dd))


def gather(dep, nvecs, layout, fg_r, fg_i, row):
    """The program's packed coefficients of its slice ``row`` in the
    reference's layout: per operator (nbls_k, nvecs_k) float64 matrices.
    ``layout`` names each packed group's antenna pair (-1 on padding) and
    whether it holds a baseline; a pair stored the other way round holds
    the conjugate baseline (its imaginary coefficients negated)."""
    dev = fg_r[0].device
    nants = dep.nants
    bl_of_key = np.full(nants * nants, -1, dtype=np.int64)
    bl_of_key[dep.ant1 * nants + dep.ant2] = np.arange(dep.nbls)
    vmax = max(x.shape[-1] for x in fg_r)
    full_r = torch.zeros((dep.nbls, vmax), dtype=torch.float64, device=dev)
    full_i = torch.zeros_like(full_r)
    seen = np.zeros(dep.nbls, dtype=np.int64)
    for (pairs, valid), fr, fi in zip(layout, fg_r, fg_i):
        g = np.nonzero(valid)[0]
        i, j = pairs[g, 0], pairs[g, 1]
        fwd, rev = bl_of_key[i * nants + j], bl_of_key[j * nants + i]
        bl = np.where(fwd >= 0, fwd, rev)
        if np.any(bl < 0):
            raise ValueError("a packed group holds a pair the deployment does not have")
        sign = torch.as_tensor(np.where(fwd >= 0, 1.0, -1.0), device=dev)[:, None]
        gt, bt = torch.as_tensor(g, device=dev), torch.as_tensor(bl, device=dev)
        nv = fr.shape[-1]
        full_r[bt, :nv] = fr[row, gt].double()
        full_i[bt, :nv] = sign * fi[row, gt].double()
        np.add.at(seen, bl, 1)
    if not np.all(seen == 1):
        raise ValueError("the packed groups do not hold every baseline once")
    op = torch.as_tensor(dep.op_of_bl, device=dev)
    idx = [torch.nonzero(op == k).reshape(-1) for k in range(len(nvecs))]
    return ([full_r[i, :nv] for i, nv in zip(idx, nvecs)],
            [full_i[i, :nv] for i, nv in zip(idx, nvecs)])
