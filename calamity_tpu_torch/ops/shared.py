"""Forward model and weighted chi-square of one shared-basis chunk, with its
gradients, for a batch of slices.

A shared chunk (U = 1 operator for all G groups) or a shared-batched one
(1 < U < G operators, group g using operator ``g // (G // U)``: the
packing lays groups out class-major) computes, per slice n,

    v[n, g] = comps[u(g)] @ coeffs[n, g]    (basis matvec, re and im)
    model   = (g_i conj g_j)[n, g] * v[n, g]
    loss[n] = sum(w[n] * |data[n] - model|^2)

the shared branches of the reference's ``fg_model`` / ``fg_model_batched``
(calamity_tpu/ops/loss.py:62-81, :108-121), ``data_model`` and ``mse``,
which the JAX package leaves to XLA. As for the dense chunk
(``ops.fused``), the gradients at a loss cotangent of 1 come out of the
same pass and the backward only scales them by each slice's cotangent
(``ops.fused.ChiSquareTerm``).

On a CUDA tensor the pass is the hand-written kernel in
``csrc/shared_chunk_loss.cu`` (built on first use by ``ops._build``),
which stages each channel tile of an operator in shared memory once for a
tile of 32 (group, slice) pairs and runs both products on the tensor
cores with split TF32 operands (float32 accuracy); past 64 modes a
cluster of blocks takes the tile, each block 64 of the modes, the
slices' parts of the model summed over the cluster's shared memory in a
fixed order (``KernelLibrary.shared_plan`` in ``ops._build`` reads its
launch plan); on a CPU tensor it is
:func:`loss_and_grads_plain`'s torch ops. There is no other route: a CUDA
launch that fails raises. Groups that hold no baseline (the packing's
record, ``ops.gains.valid_rows``) give zero loss and zero gradients; the
kernel does not read their data. :func:`loss_and_grads_tf32` emulates
the kernel's split products for the tests; no path calls it. The kernel
has modes 0-5 of ``ops.fused``'s numbering: the chi-square's three
instances, and for the "sum" prior its forward (each slice's chi-square,
M_r and M_i) and its backward at the three per-slice cotangents, with
dpr/dpi or every gradient (:func:`shared_chunk_terms_batched`: two
launches a step). It has no one-pass instances (the dense kernel's modes
6 and 7): its basis is a few operators that stay in L2, so a second pass
costs planes, not basis reads, and one pass would move more planes (15 an
entry with the combine, against the two passes' 12).
"""

from __future__ import annotations

import torch

from .fused import (
    _ALL_MODES,
    _COMPS_DTYPES,
    _COT_MODES,
    _DP_MODES,
    _WGTS_DTYPES,
    LOSS_ALL,
    SUM_ALL,
    SUM_DP,
    SUM_FWD,
    ChiSquareTerm,
    _f32,
    after_matvec,
    check_cot,
    count_launch,
    kernel_term,
    n_terms,
    sum_partials,
)
from .gains import valid_rows

KERNEL_NAME = "shared_chunk_loss"
REG_MODES = 64  # modes phase B holds in registers: at most this many, one block a tile of pairs
MAX_CLUSTER = 16  # the H100's largest thread-block cluster (non-portable past 8)
MAX_NVECS = REG_MODES * MAX_CLUSTER  # wider bases: a cluster of 64-mode slices would not fit


def explain_shared_loss_inapplicable(comps, coeffs, data, wgts):
    """Why the shared-basis kernel cannot take a chunk, or None if it can.

    comps: the chunk's (u, nbls, nfreqs, nvecs) basis; coeffs, data, wgts:
    one of its coefficient, data and weight tensors, of one slice or of a
    batch. The chunk must be shared (u = 1 < ngrps) or shared-batched (1 <
    u < ngrps, u dividing ngrps) with one baseline per group, comps and
    weights float32 or bfloat16, coefficients and data float32, all on one
    device, and a basis of at most :data:`MAX_NVECS` modes."""
    u, nbls, _, nvecs = comps.shape
    ngrps = coeffs.shape[-2]
    if not u < ngrps:
        return f"dense operator layout ({u} operators for {ngrps} groups)"
    if ngrps % u:
        return f"{ngrps} groups are not a whole number of groups for each of {u} operators"
    if nbls != 1:
        return f"nbls={nbls} (kernel covers the per-baseline B=1 layout)"
    if comps.dtype not in _COMPS_DTYPES:
        return f"comps dtype {comps.dtype} (float32/bfloat16 only)"
    for name, t, ok in (("coefficient", coeffs, (torch.float32,)),
                        ("data", data, (torch.float32,)),
                        ("weights", wgts, _WGTS_DTYPES)):
        if t.dtype not in ok:
            return f"{name} dtype {t.dtype} ({'/'.join(str(d)[6:] for d in ok)} only)"
        if t.device != comps.device:
            return f"{name} on {t.device}, comps on {comps.device}"
    if nvecs > MAX_NVECS:
        return f"nvecs={nvecs} (wider than a cluster of {MAX_CLUSTER} blocks of {REG_MODES} modes)"
    return None


def group_mask(a0):
    """(ngrps,) bool on ``a0``'s device: the groups of a chunk whose index
    tensor ``a0`` (ngrps, nbls) holds a baseline, as the packing recorded
    them (``ops.gains.mark_valid``); None where none were recorded (every
    group counts). Built once per record and kept on ``a0``."""
    valid = valid_rows(a0)
    if valid is None:
        return None
    cached = getattr(a0, "_group_mask", None)
    if cached is not None and cached[0] is valid:
        return cached[1]
    mask = torch.as_tensor(valid.reshape(valid.shape[0], -1).any(axis=1), device=a0.device)
    a0._group_mask = (valid, mask)
    return mask


def loss_and_grads_plain(coeffs2, pr, pi, dr, di, w, comps3, valid=None, mode=LOSS_ALL,
                         cot=None):
    """Plain torch version of the kernel: ``(losses (N,), dcoeffs (2, N, G,
    V), dpr (N, G, F), dpi (N, G, F))``, the gradients at a loss cotangent
    of 1 (``None`` where ``mode`` does not ask for them); the groups
    ``valid`` leaves out (a (G,) bool mask) count as weight 0 and data 0.
    The "sum" instances as in ``ops.fused.loss_and_grads_plain``:
    ``SUM_FWD`` returns the (3, N) terms (chi-square, M_r, M_i),
    ``SUM_DP`` and ``SUM_ALL`` the gradients at their cotangents ``cot``.
    The reference the kernel is held against, and the CPU path."""
    return _loss_and_grads_with(torch.einsum, coeffs2, pr, pi, dr, di, w, comps3, valid, mode,
                                cot)


def tf32_round(x):
    """float32 ``x`` rounded to TF32 as ``cvt.rna.tf32.f32`` rounds: to the
    nearest value with 10 stored mantissa bits, ties away from zero (the
    low 13 bits cleared); infinities and NaNs unchanged."""
    bits = x.contiguous().view(torch.int32)
    mag = ((bits & 0x7FFFFFFF) + 0x1000) & ~0x1FFF
    rounded = (mag | (bits & ~0x7FFFFFFF)).view(torch.float32)
    return torch.where(torch.isfinite(x), rounded, x)


def tf32_split(x):
    """``(hi, lo)``: ``hi = tf32(x)``, ``lo = tf32(x - hi)`` (the
    subtraction is exact in float32); ``hi + lo`` holds x to about 2^-22."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def loss_and_grads_tf32(coeffs2, pr, pi, dr, di, w, comps3, valid=None, mode=LOSS_ALL,
                        split=True, cot=None):
    """:func:`loss_and_grads_plain` with both products formed as the
    kernel forms them on the tensor cores: each float32 operand split into
    TF32 hi and lo (:func:`tf32_split`) and the products ``x_lo c_hi +
    x_hi c_lo + x_hi c_hi`` summed in float32, small terms first (a
    bfloat16 comps value is exact in TF32: ``x_lo c + x_hi c``). Past
    :data:`REG_MODES` modes the kernel's blocks each hold a slice of 64
    modes: the model is formed per slice and the slices summed in slice
    order, as the cluster sums them; the coefficient gradient of each
    slice is its own. With ``split=False``, one product of the
    TF32-rounded operands: the single TF32 product the kernel does not
    use. For the tests and the smoke test's comparisons only; no path calls
    it."""
    exact = comps3.dtype == torch.bfloat16

    def product(eq, comps, x):
        c_hi, c_lo = (comps, None) if exact else tf32_split(comps)
        if not split:
            return torch.einsum(eq, c_hi, tf32_round(x))
        x_hi, x_lo = tf32_split(x)
        small = torch.einsum(eq, c_hi, x_lo)
        if not exact:
            small = small + torch.einsum(eq, c_lo, x_hi)
        return small + torch.einsum(eq, c_hi, x_hi)

    def sliced(eq, comps, x):
        nvecs = comps.shape[-1]
        if nvecs <= REG_MODES:
            return product(eq, comps, x)
        cuts = [slice(k, k + REG_MODES) for k in range(0, nvecs, REG_MODES)]
        if eq.endswith("v"):  # the coefficient gradient: each slice's own modes
            return torch.cat([product(eq, comps[..., c], x) for c in cuts], dim=-1)
        parts = [product(eq, comps[..., c], x[..., c]) for c in cuts]
        out = parts[0]
        for part in parts[1:]:
            out = out + part
        return out

    return _loss_and_grads_with(sliced, coeffs2, pr, pi, dr, di, w, comps3, valid, mode, cot)


def _loss_and_grads_with(product, coeffs2, pr, pi, dr, di, w, comps3, valid, mode, cot=None):
    """The kernel's function with its two products (the matvec and the
    coefficient contraction) taken by ``product(equation, comps, x)``."""
    nu, nfreqs, nvecs = comps3.shape
    _, nbatch, ngrps, _ = coeffs2.shape
    if mode in _COT_MODES:
        check_cot(cot, nbatch, comps3.device)
    shape = (2, nbatch, nu, ngrps // nu)
    comps = _f32(comps3)
    v = product("ufv,knugv->knugf", comps, coeffs2.reshape(shape + (nvecs,)))

    def contract(dv):  # dv (2, N, G, F)
        out = product("ufv,knugf->knugv", comps, dv.reshape(shape + (nfreqs,)))
        return out.reshape(2, nbatch, ngrps, nvecs)

    keep = None if valid is None else valid.reshape(1, -1, 1)
    return after_matvec(v.reshape(2, nbatch, ngrps, nfreqs), pr, pi, dr, di, _f32(w), mode, cot,
                        contract, keep)


def _check_kernel_operands(coeffs2, pr, pi, dr, di, w, comps3, valid):
    nu, nfreqs, nvecs = comps3.shape
    if comps3.dtype not in _COMPS_DTYPES:
        raise TypeError(f"comps dtype {comps3.dtype} (float32/bfloat16 only)")
    if coeffs2.dim() != 4 or coeffs2.shape[0] != 2 or coeffs2.shape[3] != nvecs:
        raise ValueError(f"coeffs2 shape {tuple(coeffs2.shape)}, expected (2, N, G, {nvecs})")
    nbatch, ngrps = coeffs2.shape[1], coeffs2.shape[2]
    if ngrps % nu:
        raise ValueError(f"{ngrps} groups for {nu} operators: not a whole number each")
    planes = (("pr", pr), ("pi", pi), ("dr", dr), ("di", di), ("w", w))
    for name, t in planes:
        if tuple(t.shape) != (nbatch, ngrps, nfreqs):
            raise ValueError(f"{name} shape {tuple(t.shape)}, expected {(nbatch, ngrps, nfreqs)}")
    named = (("coeffs2", coeffs2),) + planes + (("comps", comps3),)
    if valid is not None:
        if valid.dtype != torch.bool or tuple(valid.shape) != (ngrps,):
            raise ValueError(f"valid {valid.dtype} {tuple(valid.shape)}, expected bool "
                             f"({ngrps},)")
        named += (("valid", valid),)
    for name, t in named:
        if t.device != comps3.device:
            raise ValueError(f"{name} on {t.device}, comps on {comps3.device}")
        if name == "w":
            if t.dtype not in _WGTS_DTYPES:
                raise TypeError(f"w dtype {t.dtype} (float32/bfloat16 only)")
        elif name not in ("comps", "valid") and t.dtype != torch.float32:
            raise TypeError(f"{name} dtype {t.dtype} (float32 only)")
    # comps, coefficients, gain products and the mask are read densely; the
    # data and weight planes through their strides (group-block views, a
    # broadcast channel axis)
    for name, t in named:
        if name not in ("dr", "di", "w") and not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    if dr.stride() != di.stride():
        raise ValueError(f"dr strides {dr.stride()} differ from di strides {di.stride()}")
    if nvecs > MAX_NVECS:
        raise ValueError(f"nvecs={nvecs}: wider than the kernel's {MAX_NVECS} modes")
    if comps3.device.type != "cuda":
        raise ValueError(f"the kernel takes CUDA tensors; comps is on {comps3.device}")


def loss_and_grads_kernel(coeffs2, pr, pi, dr, di, w, comps3, valid=None, mode=LOSS_ALL,
                          cot=None):
    """:func:`loss_and_grads_plain` from the CUDA kernel. Raises on any
    operand the kernel does not take and on a failed launch."""
    from ._build import load_kernels

    _check_kernel_operands(coeffs2, pr, pi, dr, di, w, comps3, valid)
    if mode in _COT_MODES:
        check_cot(cot, coeffs2.shape[1], comps3.device)
        cot = cot.contiguous()
    lib = load_kernels()
    nu, nfreqs, nvecs = comps3.shape
    _, nbatch, ngrps, _ = coeffs2.shape
    dev = comps3.device

    def out(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    nt = n_terms(mode)
    partials = out(nt, nbatch, ngrps) if nt else None
    dpr = dpi = dcoeffs = None
    if mode in _DP_MODES:
        dpr, dpi = out(nbatch, ngrps, nfreqs), out(nbatch, ngrps, nfreqs)
    if mode in _ALL_MODES:
        dcoeffs = out(2, nbatch, ngrps, nvecs)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        err = lib.shared_chunk_loss(
            comps3.data_ptr(), 0 if comps3.dtype == torch.float32 else 1, coeffs2.data_ptr(),
            pr.data_ptr(), pi.data_ptr(), dr.data_ptr(), di.data_ptr(), *dr.stride(),
            w.data_ptr(), 0 if w.dtype == torch.float32 else 1, *w.stride(), ptr(valid),
            ptr(partials), ptr(dcoeffs), ptr(dpr), ptr(dpi), ptr(cot), nbatch, ngrps, nfreqs,
            nvecs, nu, mode, torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{KERNEL_NAME} launch failed: CUDA error {err} "
                           f"({lib.fcl_error_string(err).decode()})")
    count_launch(KERNEL_NAME, mode)
    return sum_partials(partials, mode), dcoeffs, dpr, dpi


def _loss_and_grads(coeffs2, pr, pi, dr, di, w, comps3, valid, mode, cot=None):
    if comps3.device.type == "cuda":
        return loss_and_grads_kernel(coeffs2, pr, pi, dr, di, w, comps3, valid, mode, cot)
    if comps3.device.type == "cpu":
        return loss_and_grads_plain(coeffs2, pr, pi, dr, di, w, comps3, valid, mode, cot)
    raise ValueError(f"unsupported device {comps3.device}")


class _SumTerm:
    """The "sum" prior's terms of a shared or shared-batched chunk, with
    ``ops.fused.ChiSquareTerm``'s methods: the forward runs the "sum"
    forward instance and keeps the operands themselves (no copies: the
    backward instance reads them again), the backward the "sum" backward
    instance at the three cotangents, with only the gain-product gradients
    where the coefficients want none (``scale`` None)."""

    @staticmethod
    def forward(coeffs2, pr, pi, operands, coeff_grad):
        return _loss_and_grads(coeffs2, pr, pi, *operands, SUM_FWD)[0], (coeffs2, pr, pi) + operands

    @staticmethod
    def backward(saved, tbar, coeff_grad):
        mode = SUM_ALL if coeff_grad else SUM_DP
        _, dcoeffs, dpr, dpi = _loss_and_grads(*saved, mode, tbar.contiguous())
        return dcoeffs if coeff_grad else None, dpr, dpi, None

    @staticmethod
    def alone(coeffs2, pr, pi, operands):
        return _loss_and_grads(coeffs2, pr, pi, *operands, SUM_FWD)[0]


# the shared-basis kernel's terms (the pass looked up at each call)
LOSS_TERM = ChiSquareTerm(lambda *args: _loss_and_grads(*args))
SUM_TERM = _SumTerm()


def shared_chunk_loss_batched(coeffs2, pr, pi, dr, di, w, comps3, valid=None):
    """Weighted chi-square of one shared or shared-batched B=1 chunk for N
    slices: (N,) losses, differentiable in coeffs2, pr and pi. With no
    gradient wanted the loss-only instance runs and nothing is saved.

    coeffs2: (2, N, ngrps, nvecs) stacked (real, imag) coefficients
    pr, pi:  (N, ngrps, nfreqs) Re / -Im of g_i conj(g_j) per baseline
    dr, di:  (N, ngrps, nfreqs) float32, any strides (e.g. a group-block view)
    w:       (N, ngrps, nfreqs) float32 or bfloat16, any strides
    comps3:  (nu, nfreqs, nvecs) float32 or bfloat16, nu dividing ngrps
    valid:   (ngrps,) bool, the groups that hold a baseline (None: every one)
    """
    return kernel_term(LOSS_TERM, coeffs2, pr, pi, dr, di, w, comps3, valid)


def shared_chunk_terms_batched(coeffs2, pr, pi, dr, di, w, comps3, valid=None):
    """The "sum" prior's terms of one shared or shared-batched B=1 chunk
    for N slices: a (3, N) tensor of each slice's chi-square, M_r =
    sum(w * model_r) and M_i = sum(w * model_i) (padding groups count
    zero), differentiable in coeffs2, pr and pi (operands as
    :func:`shared_chunk_loss_batched`'s). The forward runs the kernel's
    "sum" forward instance and keeps references to the operands; the
    backward its "sum" backward instance at the three cotangents. With no
    gradient wanted only the forward runs and nothing is saved."""
    return kernel_term(SUM_TERM, coeffs2, pr, pi, dr, di, w, comps3, valid)
