"""The gain products of every baseline and their gradient, summed in a fixed
order.

Port of the reference's ``gain_products`` (calamity_tpu/ops/loss.py:183-196):
four gathers of the antenna gains by index and the products

    pr = gr0 gr1 + gi0 gi1,   pi = gr0 gi1 - gi0 gr1

(Re and -Im of g_i conj(g_j)). The reference differentiates the gathers
with XLA's scatter-add; torch's ``index_select`` backward is an
``index_add_``, which on CUDA adds with atomics, in an order that changes
from run to run. ``GainProducts`` is one autograd Function for every
layout and path: its forward is the gathers and products (torch ops,
deterministic); its backward computes the gains' gradient directly from
the products' cotangents. On a CUDA tensor that is the hand-written kernel
``csrc/gain_grad.cu`` (built by ``ops._build``), which walks each
antenna's (row, side) entries in ascending row order, without atomics, so
two runs of one fit take the same steps. On a CPU tensor it is the plain
version, :func:`gain_grad_plain`: the ``index_select`` backward under
autograd, deterministic on the CPU. A failed launch raises.

The CSR list of each antenna's entries is built from a chunk's ``a0``,
``a1`` once (at packing, for a chunk on the card) and kept on the ``a0``
tensor; every rank of a mesh builds it from its own block.
"""

from __future__ import annotations

import torch

from .._device import LAUNCHES

KERNEL_NAME = "gain_grad"
_DTYPES = {torch.float32: 0, torch.float64: 1}


def _products(g_r, g_i, a0, a1):
    """(pr, pi), each (nbatch, ngrps, nbls, nfreqs), from gains (nbatch,
    nants, nfreqs) and indices (ngrps, nbls)."""
    shape = (g_r.shape[0],) + tuple(a0.shape) + (g_r.shape[-1],)
    i0 = a0.reshape(-1)
    i1 = a1.reshape(-1)
    gr0 = g_r.index_select(1, i0).reshape(shape)
    gr1 = g_r.index_select(1, i1).reshape(shape)
    gi0 = g_i.index_select(1, i0).reshape(shape)
    gi1 = g_i.index_select(1, i1).reshape(shape)
    return gr0 * gr1 + gi0 * gi1, gr0 * gi1 - gi0 * gr1


def build_antenna_csr(a0, a1, nants):
    """Each antenna's (row, side) entries, in ascending row order (side 0,
    the row's first antenna, before side 1): ``(offsets (nants + 1,),
    rowside, other)``, int32 on ``a0``'s device; antenna ``a``'s entries
    are ``[offsets[a], offsets[a + 1])``, each ``row * 2 + side`` and the
    row's other antenna. Rows are those of ``a0.reshape(-1)``."""
    i0 = a0.reshape(-1).long()
    i1 = a1.reshape(-1).long()
    rows = i0.numel()
    ant = torch.cat([i0, i1])
    idx = torch.arange(rows, device=a0.device, dtype=torch.long)
    rowside = torch.cat([2 * idx, 2 * idx + 1])
    other = torch.cat([i1, i0])
    # the keys are unique, so the sort has one result on every device
    order = torch.argsort(ant * (2 * rows) + rowside)
    counts = torch.bincount(ant, minlength=nants)
    offsets = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    return offsets.int(), rowside[order].int(), other[order].int()


def antenna_csr(a0, a1, nants):
    """:func:`build_antenna_csr`, built once per index tensor and kept on
    ``a0`` for later steps."""
    cached = getattr(a0, "_antenna_csr", None)
    if cached is not None and cached[0] is a1 and cached[1] == nants:
        return cached[2]
    csr = build_antenna_csr(a0, a1, nants)
    a0._antenna_csr = (a1, nants, csr)
    return csr


def gain_grad_plain(dpr, dpi, g_r, g_i, a0, a1):
    """Plain torch version of the kernel: ``(dg_r, dg_i)``, each (nbatch,
    nants, nfreqs), the gradient of ``sum(dpr * pr + dpi * pi)`` in the
    gains, through the ``index_select`` backward (an ``index_add_``)."""
    with torch.enable_grad():
        gr = g_r.detach().requires_grad_(True)
        gi = g_i.detach().requires_grad_(True)
        pr, pi = _products(gr, gi, a0, a1)
        dg_r, dg_i = torch.autograd.grad((pr, pi), (gr, gi),
                                         (dpr.reshape(pr.shape), dpi.reshape(pi.shape)))
    return dg_r, dg_i


def gain_grad_kernel(dpr, dpi, g_r, g_i, csr):
    """:func:`gain_grad_plain` from the CUDA kernel: ``dpr, dpi`` (nbatch,
    rows, nfreqs), gains (nbatch, nants, nfreqs), the chunk's antenna CSR.
    Raises on operands the kernel does not take and on a failed launch."""
    from ._build import load_kernels

    nbatch, nants, nfreqs = g_r.shape
    rows = dpr.numel() // max(nbatch * nfreqs, 1)
    dev = g_r.device
    if dev.type != "cuda":
        raise ValueError(f"the kernel takes CUDA tensors; the gains are on {dev}")
    if g_r.dtype not in _DTYPES:
        raise TypeError(f"gain dtype {g_r.dtype} (float32/float64 only)")
    offsets, rowside, other = csr
    if offsets.numel() != nants + 1 or rowside.numel() != 2 * rows:
        raise ValueError(f"the antenna CSR lists {offsets.numel() - 1} antennas and "
                         f"{rowside.numel()} entries; expected {nants} and {2 * rows}")
    operands = [t.contiguous() for t in (dpr, dpi, g_r, g_i)]
    for t in operands + list(csr):
        if t.device != dev:
            raise ValueError(f"an operand is on {t.device}, the gains on {dev}")
    for t in operands:
        if t.dtype != g_r.dtype:
            raise TypeError(f"an operand is {t.dtype}, the gains {g_r.dtype}")
    dg_r = torch.empty_like(operands[2])
    dg_i = torch.empty_like(operands[3])
    if dg_r.numel() == 0:
        return dg_r, dg_i
    lib = load_kernels()
    with torch.cuda.device(dev):
        err = lib.gain_grad(*(t.data_ptr() for t in operands),
                            *(t.data_ptr() for t in csr), dg_r.data_ptr(), dg_i.data_ptr(),
                            nbatch, rows, nants, nfreqs, _DTYPES[g_r.dtype],
                            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL_NAME} launch failed: CUDA error {err} "
                           f"({lib.fcl_error_string(err).decode()})")
    LAUNCHES.add(KERNEL_NAME)
    return dg_r, dg_i


class GainProducts(torch.autograd.Function):
    """(pr, pi) of the gain products, (nbatch, ngrps, nbls, nfreqs), from
    gains (nbatch, nants, nfreqs); the backward is the kernel on a CUDA
    tensor and the plain version on a CPU tensor."""

    @staticmethod
    def forward(ctx, g_r, g_i, a0, a1):
        ctx.save_for_backward(g_r, g_i)
        ctx.a0, ctx.a1 = a0, a1  # static indices, never differentiated; they carry the CSR
        return _products(g_r, g_i, a0, a1)

    @staticmethod
    def backward(ctx, dpr, dpi):
        g_r, g_i = ctx.saved_tensors
        a0, a1 = ctx.a0, ctx.a1
        if g_r.device.type == "cuda":
            nbatch, nants, nfreqs = g_r.shape
            csr = antenna_csr(a0, a1, nants)
            dg_r, dg_i = gain_grad_kernel(dpr.reshape(nbatch, -1, nfreqs),
                                          dpi.reshape(nbatch, -1, nfreqs), g_r, g_i, csr)
        elif g_r.device.type == "cpu":
            dg_r, dg_i = gain_grad_plain(dpr, dpi, g_r, g_i, a0, a1)
        else:
            raise ValueError(f"unsupported device {g_r.device}")
        return dg_r, dg_i, None, None


def gain_products_batched(g_r, g_i, a0, a1):
    """Gain products with a leading slice axis: g_r/g_i (nbatch, nants,
    nfreqs) -> (pr, pi) each (nbatch, ngrps, nbls, nfreqs)."""
    if torch.is_grad_enabled() and (g_r.requires_grad or g_i.requires_grad):
        return GainProducts.apply(g_r, g_i, a0, a1)
    return _products(g_r, g_i, a0, a1)


def gain_products(g_r, g_i, a0, a1):
    """Real-arithmetic expansion of g_i conj(g_j) per baseline.

    g_r/g_i: (nants, nfreqs); a0/a1: (ngrps, nbls) int32.
    Returns (grgr+gigi, grgi-gigr) = (Re, -Im) of g_i conj(g_j),
    each (ngrps, nbls, nfreqs)."""
    pr, pi = gain_products_batched(g_r.unsqueeze(0), g_i.unsqueeze(0), a0, a1)
    return pr[0], pi[0]
