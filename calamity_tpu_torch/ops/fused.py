"""Fused forward model + chi-square loss of one dense B=1 chunk.

Port of calamity_tpu/ops/fused.py. Per chunk with one baseline per group:

    v      = comps @ coeffs            (basis matvec, two right-hand columns)
    model  = (g_i conj g_j) * v        (complex product in real arithmetic)
    loss   = sum(w * |data - model|^2) (weighted reduction)

On a CUDA tensor the forward is the hand-written kernel in
``csrc/fused_chunk_loss.cu`` (built on first use by ``ops._build``); on a
CPU tensor it is :func:`fused_chunk_loss_plain`'s torch ops. There is no
other route: a CUDA launch that fails raises. The backward mirrors the
reference's ``_bwd_xla`` in torch ops; a backward kernel is later work.

The gate below is written for this kernel, which takes any G, F and V.
The reference's TPU gate (F and V multiples of 128, a group tile in
{32, 16, 8}) does not apply.
"""

from __future__ import annotations

import warnings

import torch

from .._device import LAUNCHES

KERNEL_NAME = "fused_chunk_loss"
_COMPS_DTYPES = (torch.float32, torch.bfloat16)


def explain_fused_loss_inapplicable(comps, coeffs, data, wgts):
    """Why the fused kernel cannot take a chunk, or None if it can.

    comps: the chunk's (u, nbls, nfreqs, nvecs) basis; coeffs, data, wgts:
    one of its coefficient, data and weight tensors. The chunk must be
    dense (u equal to the data's group count) with one baseline per group,
    comps float32 or bfloat16, the rest float32, all on one device."""
    u, nbls = comps.shape[0], comps.shape[1]
    ngrps = data.shape[0]
    if u != ngrps:
        return (
            "shared-basis operator layout (one basis matrix serves "
            f"{ngrps} groups; kernel covers the dense per-group layout)"
        )
    if nbls != 1:
        return f"nbls={nbls} (kernel covers the per-baseline B=1 layout)"
    if comps.dtype not in _COMPS_DTYPES:
        return f"comps dtype {comps.dtype} (float32/bfloat16 only)"
    for name, t in (("coefficient", coeffs), ("data", data), ("weights", wgts)):
        if t.dtype != torch.float32:
            return f"{name} dtype {t.dtype} (float32 only)"
        if t.device != comps.device:
            return f"{name} on {t.device}, comps on {comps.device}"
    return None


def warn_fused_fallbacks(chunks, fg_r, data_r, wgts):
    """Warn (once per fit) naming every chunk the gate sends to the plain
    torch loss, and why. Returns the list of reasons."""
    reasons = []
    for cnum, (comps, _, _) in enumerate(chunks):
        reason = explain_fused_loss_inapplicable(comps, fg_r[cnum], data_r[cnum], wgts[cnum])
        if reason is not None:
            reasons.append(f"chunk {cnum}: {reason}")
    if reasons:
        warnings.warn(
            "these chunks take the plain torch loss, not the fused kernel: "
            + "; ".join(reasons),
            stacklevel=3,
        )
    return reasons


def _fwd_plain(coeffs2, pr, pi, comps3, dr, di, w):
    """(loss, v) in torch ops; v is (2, G, F) float32."""
    cf = comps3 if comps3.dtype == torch.float32 else comps3.to(torch.float32)
    v = torch.einsum("gfv,kgv->kgf", cf, coeffs2)
    vr, vi = v[0], v[1]
    mr = pr * vr + pi * vi
    mi = -pi * vr + pr * vi
    er = dr - mr
    ei = di - mi
    return torch.sum(w * (er * er + ei * ei)), v


def fused_chunk_loss_plain(coeffs2, pr, pi, comps3, dr, di, w):
    """Plain torch version of the kernel's forward (differentiable by
    autograd): the reference the kernel is held against."""
    return _fwd_plain(coeffs2, pr, pi, comps3, dr, di, w)[0]


def _check_kernel_operands(coeffs2, pr, pi, comps3, dr, di, w):
    ngrps, nfreqs, nvecs = comps3.shape
    if comps3.dtype not in _COMPS_DTYPES:
        raise TypeError(f"comps dtype {comps3.dtype} (float32/bfloat16 only)")
    if tuple(coeffs2.shape) != (2, ngrps, nvecs):
        raise ValueError(f"coeffs2 shape {tuple(coeffs2.shape)}, expected {(2, ngrps, nvecs)}")
    named = (("coeffs2", coeffs2), ("pr", pr), ("pi", pi), ("dr", dr), ("di", di), ("w", w))
    for name, t in named[1:]:
        if tuple(t.shape) != (ngrps, nfreqs):
            raise ValueError(f"{name} shape {tuple(t.shape)}, expected {(ngrps, nfreqs)}")
    for name, t in named + (("comps", comps3),):
        if t.device != comps3.device:
            raise ValueError(f"{name} on {t.device}, comps on {comps3.device}")
        if name != "comps" and t.dtype != torch.float32:
            raise TypeError(f"{name} dtype {t.dtype} (float32 only)")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    if comps3.device.type != "cuda":
        raise ValueError(f"the kernel takes CUDA tensors; comps is on {comps3.device}")


def _fwd_kernel(coeffs2, pr, pi, comps3, dr, di, w):
    """(loss, v) from the CUDA kernel. Raises on any operand the kernel
    does not take and on a failed launch."""
    from ._build import load_kernels

    _check_kernel_operands(coeffs2, pr, pi, comps3, dr, di, w)
    lib = load_kernels()
    ngrps, nfreqs, nvecs = comps3.shape
    dev = comps3.device
    partials = torch.empty((lib.fcl_num_partials(ngrps, nfreqs),), dtype=torch.float32,
                           device=dev)
    v = torch.empty((2, ngrps, nfreqs), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.fused_chunk_loss_fwd(
            comps3.data_ptr(), 0 if comps3.dtype == torch.float32 else 1,
            coeffs2.data_ptr(), pr.data_ptr(), pi.data_ptr(), dr.data_ptr(),
            di.data_ptr(), w.data_ptr(), partials.data_ptr(), v.data_ptr(),
            ngrps, nfreqs, nvecs, torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"{KERNEL_NAME} launch failed: CUDA error {err} "
            f"({lib.fcl_error_string(err).decode()})"
        )
    LAUNCHES.add(KERNEL_NAME)
    # the partials are summed outside the kernel, in a fixed order: no
    # atomics, so the loss is the same from run to run
    return torch.sum(partials), v


def _bwd(v, pr, pi, comps3, dr, di, w, gbar, need_coeffs=True):
    """Backward pass in torch ops (mirror of the reference ``_bwd_xla``).

    bfloat16 comps are upcast to float32 for the coefficient contraction:
    a transient float32 copy of comps per step."""
    vr, vi = v[0], v[1]
    mr = pr * vr + pi * vi
    mi = -pi * vr + pr * vi
    dmr = (-2.0 * gbar) * w * (dr - mr)
    dmi = (-2.0 * gbar) * w * (di - mi)
    dcoeffs = None
    if need_coeffs:
        dvr = pr * dmr - pi * dmi
        dvi = pi * dmr + pr * dmi
        cf = comps3 if comps3.dtype == torch.float32 else comps3.to(torch.float32)
        dv = torch.stack([dvr, dvi], dim=0)  # (2, G, F)
        dcoeffs = torch.einsum("gfv,kgf->kgv", cf, dv)
    dpr = vr * dmr + vi * dmi
    dpi = vi * dmr - vr * dmi
    return dcoeffs, dpr, dpi


class _FusedChunkLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, coeffs2, pr, pi, comps3, dr, di, w):
        if comps3.device.type == "cuda":
            loss, v = _fwd_kernel(coeffs2, pr, pi, comps3, dr, di, w)
        elif comps3.device.type == "cpu":
            loss, v = _fwd_plain(coeffs2, pr, pi, comps3, dr, di, w)
        else:
            raise ValueError(f"unsupported device {comps3.device}")
        ctx.save_for_backward(v, pr, pi, comps3, dr, di, w)
        return loss

    @staticmethod
    def backward(ctx, gbar):
        v, pr, pi, comps3, dr, di, w = ctx.saved_tensors
        dcoeffs, dpr, dpi = _bwd(v, pr, pi, comps3, dr, di, w, gbar,
                                 need_coeffs=ctx.needs_input_grad[0])
        # comps, data and weights are never differentiated parameters
        return dcoeffs, dpr, dpi, None, None, None, None


def fused_chunk_loss(coeffs2, pr, pi, comps3, dr, di, w):
    """Fused weighted chi-square of one B=1 chunk (differentiable in
    coeffs2, pr and pi).

    coeffs2: (2, ngrps, nvecs) stacked (real, imag) coefficients
    pr, pi:  (ngrps, nfreqs) Re / -Im of g_i conj(g_j) per baseline
    comps3:  (ngrps, nfreqs, nvecs) float32 or bfloat16
    dr, di, w: (ngrps, nfreqs)
    """
    return _FusedChunkLoss.apply(coeffs2, pr, pi, comps3, dr, di, w)
