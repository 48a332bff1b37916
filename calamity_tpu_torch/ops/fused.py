"""Fused forward model + chi-square loss of one dense B=1 chunk, with its
gradients, for a batch of slices that share the chunk's basis.

Port of calamity_tpu/ops/fused.py. Per chunk with one baseline per group
and per (time, pol) slice n:

    v[n]    = comps @ coeffs[n]              (basis matvec, two columns per slice)
    model   = (g_i conj g_j)[n] * v[n]       (complex product in real arithmetic)
    loss[n] = sum(w[n] * |data[n] - model|^2) (weighted reduction)

and the reference's backward ``_bwd_xla`` at a loss cotangent of 1: the
chi-square is local per group and its cotangent a scalar per slice, so the
gradients of the coefficients and of the gain products are computed in
the same pass as the loss, and the backward only scales them by each
slice's cotangent (exact: they are linear in it). On the main path the
gain products' gradients are not scaled here: ``ops.gains.ChunkTerm``
hands them to the gain-gradient kernel with the cotangent as its scale
(:class:`ChiSquareTerm`).

On a CUDA tensor the pass is the hand-written kernel in
``csrc/fused_chunk_loss.cu`` (built on first use by ``ops._build``), which
reads each comps row once for the loss and every gradient of up to 8
slices; on a CPU tensor it is :func:`loss_and_grads_plain`'s torch ops.
There is no other route: a CUDA launch that fails raises. The forward
picks one of three instances: the loss only (no gradient wanted), the
loss with the gain-product gradients (frozen coefficients), or the loss
with every gradient. The serial path is the same kernel with one slice.

The "sum" flux prior (``model_regularization="sum"``, the default of the
Python entry points) also needs each slice's weighted model sums M_r =
sum(w * model_r) and M_i, and gives them a cotangent that depends on
every chunk's sums, known only after every chunk's forward. Every
gradient is linear in the three per-slice cotangents, so
:func:`fused_chunk_terms_batched` runs, where a gradient is wanted, the
kernel's one-pass "sum" instance: in one read of comps the chi-square, M_r
and M_i of each slice and the pieces their gradients are made of (the
chi-square's gradients at a cotangent of 1, the planes w * v and the
coefficient sums of w * (pr, pi)); its backward forms the gradients from
the pieces and the cotangents (:func:`combine`, a second, elementwise
kernel of the same source), without reading comps again.

The gate below is written for this kernel, which takes any N, G, F and V.
The reference's TPU gate (F and V multiples of 128, a group tile in
{32, 16, 8}) does not apply.
"""

from __future__ import annotations

import warnings

import torch

from .._device import LAUNCHES

KERNEL_NAME = "fused_chunk_loss"
_COMPS_DTYPES = (torch.float32, torch.bfloat16)
_WGTS_DTYPES = (torch.float32, torch.bfloat16)


def explain_fused_loss_inapplicable(comps, coeffs, data, wgts):
    """Why the fused kernel cannot take a chunk, or None if it can.

    comps: the chunk's (u, nbls, nfreqs, nvecs) basis; coeffs, data, wgts:
    one of its coefficient, data and weight tensors, of one slice
    ((ngrps, nvecs), (ngrps, nbls, nfreqs)) or of a batch (a leading slice
    axis). The chunk must be dense (u equal to the coefficients' group
    count) with one baseline per group, comps and weights float32 or
    bfloat16, coefficients and data float32, all on one device."""
    u, nbls = comps.shape[0], comps.shape[1]
    ngrps = coeffs.shape[-2]
    if u != ngrps:
        return (
            "shared-basis operator layout (one basis matrix serves "
            f"{ngrps} groups; kernel covers the dense per-group layout)"
        )
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
    return None


def warn_fused_fallbacks(chunks, fg_r, data_r, wgts):
    """Warn (once per fit) naming every chunk that neither this kernel nor
    the shared-basis kernel (``ops.shared``) takes, and why; those chunks
    take the plain torch loss. Returns the list of reasons."""
    from .shared import explain_shared_loss_inapplicable

    reasons = []
    for cnum, (comps, _, _) in enumerate(chunks):
        args = (comps, fg_r[cnum], data_r[cnum], wgts[cnum])
        dense = explain_fused_loss_inapplicable(*args)
        shared = explain_shared_loss_inapplicable(*args)
        if dense is not None and shared is not None:
            # the reason of the kernel whose layout the chunk has
            layout_dense = comps.shape[0] >= fg_r[cnum].shape[-2]
            reasons.append(f"chunk {cnum}: {dense if layout_dense else shared}")
    if reasons:
        warnings.warn(
            "these chunks take the plain torch loss, not a kernel: " + "; ".join(reasons),
            stacklevel=3,
        )
    return reasons


# the kernels' instances: the chi-square alone (the loss; with the
# gain-product gradients; with every gradient) and the "sum" prior's terms
# (the forward alone; the backward with the gain-product gradients; with
# every gradient; the one-pass forward with the pieces of the gain-product
# gradients; of every gradient). The shared-basis kernel (ops.shared) has
# the first six, modes 0-5; this module's kernel has modes 0-3, 6 and 7:
# its "sum" gradients come from the one-pass instances and :func:`combine`.
# loss_and_grads_plain takes all eight (SUM_DP and SUM_ALL are the two-pass
# reference the one-pass instances are held against).
LOSS_ONLY, LOSS_DP, LOSS_ALL = 0, 1, 2
SUM_FWD, SUM_DP, SUM_ALL = 3, 4, 5
SUM_FWD_DP, SUM_FWD_ALL = 6, 7
MODE_NAMES = ("loss_only", "loss_dp", "loss_all", "sum_fwd", "sum_dp", "sum_all",
              "sum_fwd_dp", "sum_fwd_all")
KERNEL_MODES = (LOSS_ONLY, LOSS_DP, LOSS_ALL, SUM_FWD, SUM_FWD_DP, SUM_FWD_ALL)
_DP_MODES = (LOSS_DP, LOSS_ALL, SUM_DP, SUM_ALL, SUM_FWD_DP, SUM_FWD_ALL)
_ALL_MODES = (LOSS_ALL, SUM_ALL, SUM_FWD_ALL)
_COT_MODES = (SUM_DP, SUM_ALL)
_ONE_PASS_MODES = (SUM_FWD_DP, SUM_FWD_ALL)
_SUM_TERMS_MODES = (SUM_FWD,) + _ONE_PASS_MODES
COMBINE_NAME = "fused_sum_combine"


def n_terms(mode):
    """Per-slice sums an instance returns: the chi-square; the "sum"
    forward's (and the one-pass instances') chi-square, M_r and M_i; none
    for the "sum" backward."""
    return 3 if mode in _SUM_TERMS_MODES else 0 if mode in _COT_MODES else 1


def _f32(t):
    return t if t.dtype == torch.float32 else t.to(torch.float32)


def check_cot(cot, nbatch, device):
    """A "sum" backward instance's cotangents: (3, N) float32 on ``device``."""
    if cot is None:
        raise ValueError("the \"sum\" backward instances take cot, (3, N) cotangents")
    if tuple(cot.shape) != (3, nbatch) or cot.dtype != torch.float32 or cot.device != device:
        raise ValueError(f"cot {cot.dtype} {tuple(cot.shape)} on {cot.device}, expected "
                         f"float32 (3, {nbatch}) on {device}")


def after_matvec(v, pr, pi, dr, di, wf, mode, cot, contract, keep=None):
    """The kernels' function after the basis matvec ``v`` (2, N, G, F):
    ``(terms, dcoeffs, dpr, dpi)`` as :func:`loss_and_grads_plain` returns
    them, with ``contract(dv)`` the coefficient contraction; groups where
    the (1, G, 1) mask ``keep`` is False count as weight 0 and data 0."""
    vr, vi = v[0], v[1]
    mr = pr * vr + pi * vi
    mi = -pi * vr + pr * vi
    er = dr - mr
    ei = di - mi
    if keep is not None:
        er, ei, wf = (torch.where(keep, x, 0.0) for x in (er, ei, wf))
    terms = None
    if n_terms(mode):
        terms = torch.sum(wf * (er * er + ei * ei), dim=(1, 2))
        if mode in _SUM_TERMS_MODES:
            terms = torch.stack([terms, torch.sum(wf * mr, dim=(1, 2)),
                                 torch.sum(wf * mi, dim=(1, 2))])
    if mode not in _DP_MODES:
        return terms, None, None, None
    if mode in _COT_MODES:
        gx, gr, gi = (c.reshape(-1, 1, 1) for c in cot)
        dmr = wf * (gr - 2.0 * gx * er)
        dmi = wf * (gi - 2.0 * gx * ei)
    else:
        dmr = -2.0 * wf * er
        dmi = -2.0 * wf * ei
    dpr = vr * dmr + vi * dmi
    dpi = vi * dmr - vr * dmi
    dv = [pr * dmr - pi * dmi, pi * dmr + pr * dmi]
    if mode in _ONE_PASS_MODES:
        # the pieces of the "sum" gradients: the planes w v beside the
        # chi-square's dpr, dpi, and the coefficient sums of w (pr, pi)
        # beside its coefficient gradient
        dpr, dpi = torch.stack([dpr, wf * vr]), torch.stack([dpi, wf * vi])
        dv += [wf * pr, wf * pi]
    dcoeffs = contract(torch.stack(dv, dim=0)) if mode in _ALL_MODES else None
    return terms, dcoeffs, dpr, dpi


def loss_and_grads_plain(coeffs2, pr, pi, dr, di, w, comps3, mode=LOSS_ALL, cot=None):
    """Plain torch version of the kernel: ``(losses (N,), dcoeffs (2, N, G,
    V), dpr (N, G, F), dpi (N, G, F))``, the gradients at a loss cotangent
    of 1 (``None`` where ``mode`` does not ask for them): the reference's
    forward and ``_bwd_xla`` with a slice axis. ``SUM_FWD`` returns the
    (3, N) terms (chi-square, M_r, M_i) and no gradient; ``SUM_DP`` and
    ``SUM_ALL`` no terms and the gradients at ``cot``, the (3, N)
    cotangents of those terms (the two-pass reference; the kernel has no
    such instance). ``SUM_FWD_DP`` and ``SUM_FWD_ALL`` return the terms and
    the pieces :func:`combine` forms those gradients from: dpr, dpi (2, N,
    G, F) = the chi-square's at a cotangent of 1 and w * (v_r, v_i); with
    ``SUM_FWD_ALL`` dcoeffs (4, N, G, V) = the chi-square's (re, im) and
    the coefficient sums of w * pr and w * pi. The reference the kernel is
    held against, and the CPU path."""
    if mode in _COT_MODES:
        check_cot(cot, coeffs2.shape[1], comps3.device)
    comps = _f32(comps3)
    v = torch.einsum("gfv,kngv->kngf", comps, coeffs2)
    return after_matvec(v, pr, pi, dr, di, _f32(w), mode, cot,
                        lambda dv: torch.einsum("gfv,kngf->kngv", comps, dv))


def tf32_trunc(x):
    """float32 ``x`` as the tensor cores read a TF32 operand: its low 13
    bits cleared."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def loss_and_grads_tf32(coeffs2, pr, pi, dr, di, w, comps3, mode=SUM_FWD_ALL):
    """:func:`loss_and_grads_plain` with the coefficient contraction
    formed as the one-pass instance forms it on the tensor cores: dv split
    into TF32 hi and lo (``ops.shared.tf32_split``), float32 comps into hi
    = :func:`tf32_trunc` and lo = the TF32 part of the rest, and the
    products ``c_lo x_hi + c_hi x_lo + c_hi x_hi`` summed in float32, small
    terms first (a bfloat16 comps value is exact in TF32: ``c x_lo + c
    x_hi``); the matvec and the rest float32, as in the kernel. For the
    tests and the smoke test's comparisons only; no path calls it."""
    from .shared import tf32_split

    comps = _f32(comps3)
    eq = "gfv,kngf->kngv"

    def contract(dv):
        x_hi, x_lo = tf32_split(dv)
        if comps3.dtype == torch.bfloat16:
            return torch.einsum(eq, comps, x_lo) + torch.einsum(eq, comps, x_hi)
        c_hi = tf32_trunc(comps)
        c_lo = tf32_trunc(comps - c_hi)
        small = torch.einsum(eq, c_lo, x_hi) + torch.einsum(eq, c_hi, x_lo)
        return small + torch.einsum(eq, c_hi, x_hi)

    v = torch.einsum("gfv,kngv->kngf", comps, coeffs2)
    return after_matvec(v, pr, pi, dr, di, _f32(w), mode, None, contract)


def combine_plain(dcoeffs, dpr, dpi, cot):
    """Plain torch version of the combine kernel: the "sum" gradients
    ``(dcoeffs (2, N, G, V) or None, dpr, dpi (N, G, F))`` at the (3, N)
    cotangents ``cot`` = (gx, gr, gi) of (chi-square, M_r, M_i), from a
    one-pass instance's pieces (``dcoeffs`` None: frozen coefficients)."""
    check_cot(cot, dpr.shape[1], dpr.device)
    gx, gr, gi = (c.reshape(-1, 1, 1) for c in cot)
    out_r = gx * dpr[0] + gr * dpr[1] + gi * dpi[1]
    out_i = gx * dpi[0] + gr * dpi[1] - gi * dpr[1]
    if dcoeffs is None:
        return None, out_r, out_i
    d_re, d_im, c_r, c_i = dcoeffs
    return torch.stack([gx * d_re + gr * c_r - gi * c_i, gx * d_im + gr * c_i + gi * c_r]), \
        out_r, out_i


def fused_chunk_loss_batched_plain(coeffs2, pr, pi, dr, di, w, comps3):
    """Plain torch forward of the batched loss, differentiable by autograd:
    (N,) losses."""
    v = torch.einsum("gfv,kngv->kngf", _f32(comps3), coeffs2)
    mr = pr * v[0] + pi * v[1]
    mi = -pi * v[0] + pr * v[1]
    return torch.sum(_f32(w) * ((dr - mr) ** 2 + (di - mi) ** 2), dim=(1, 2))


def _check_kernel_operands(coeffs2, pr, pi, dr, di, w, comps3):
    ngrps, nfreqs, nvecs = comps3.shape
    if comps3.dtype not in _COMPS_DTYPES:
        raise TypeError(f"comps dtype {comps3.dtype} (float32/bfloat16 only)")
    nbatch = coeffs2.shape[1] if coeffs2.dim() == 4 else -1
    if tuple(coeffs2.shape) != (2, nbatch, ngrps, nvecs):
        raise ValueError(
            f"coeffs2 shape {tuple(coeffs2.shape)}, expected {(2, 'N', ngrps, nvecs)}"
        )
    planes = (("pr", pr), ("pi", pi), ("dr", dr), ("di", di), ("w", w))
    for name, t in planes:
        if tuple(t.shape) != (nbatch, ngrps, nfreqs):
            raise ValueError(f"{name} shape {tuple(t.shape)}, expected {(nbatch, ngrps, nfreqs)}")
    for name, t in (("coeffs2", coeffs2),) + planes + (("comps", comps3),):
        if t.device != comps3.device:
            raise ValueError(f"{name} on {t.device}, comps on {comps3.device}")
        if name == "w":
            if t.dtype not in _WGTS_DTYPES:
                raise TypeError(f"w dtype {t.dtype} (float32/bfloat16 only)")
        elif name != "comps" and t.dtype != torch.float32:
            raise TypeError(f"{name} dtype {t.dtype} (float32 only)")
    # comps, coefficients and gain products are read densely; the data and
    # weight planes through their strides (group-block views, a broadcast
    # channel axis)
    for name, t in (("coeffs2", coeffs2), ("pr", pr), ("pi", pi), ("comps", comps3)):
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    if dr.stride() != di.stride():
        raise ValueError(f"dr strides {dr.stride()} differ from di strides {di.stride()}")
    if comps3.device.type != "cuda":
        raise ValueError(f"the kernel takes CUDA tensors; comps is on {comps3.device}")


def loss_and_grads_kernel(coeffs2, pr, pi, dr, di, w, comps3, mode=LOSS_ALL):
    """:func:`loss_and_grads_plain` from the CUDA kernel, in one read of
    comps, for the kernel's modes (:data:`KERNEL_MODES`). Raises on any
    operand the kernel does not take and on a failed launch."""
    from ._build import load_kernels

    if mode not in KERNEL_MODES:
        raise ValueError(f"the fused kernel has no instance {MODE_NAMES[mode]} (mode {mode}); "
                         "its \"sum\" gradients come from the one-pass instances and combine")
    _check_kernel_operands(coeffs2, pr, pi, dr, di, w, comps3)
    lib = load_kernels()
    ngrps, nfreqs, nvecs = comps3.shape
    nbatch = coeffs2.shape[1]
    dev = comps3.device
    comps_dtype = 0 if comps3.dtype == torch.float32 else 1
    plan = lib.plan(nbatch, ngrps, nfreqs, nvecs, comps_dtype, mode, comps3.data_ptr())

    def out(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    partials = out(n_terms(mode), nbatch, ngrps)
    dpr = dpi = dcoeffs = scratch = None
    planes = 2 if mode in _ONE_PASS_MODES else 1
    if mode in _DP_MODES:
        dpr, dpi = (out(planes, nbatch, ngrps, nfreqs).squeeze(0) for _ in range(2))
    if mode in _ALL_MODES:
        dcoeffs = out(2 * planes, nbatch, ngrps, nvecs)
    if not plan["coef_smem"]:
        scratch = out(ngrps * nvecs * 2 * plan["slices_per_tile"])

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        err = lib.fused_chunk_loss(
            comps3.data_ptr(), comps_dtype, coeffs2.data_ptr(), pr.data_ptr(), pi.data_ptr(),
            dr.data_ptr(), di.data_ptr(), *dr.stride(), w.data_ptr(),
            0 if w.dtype == torch.float32 else 1, *w.stride(), ptr(partials),
            ptr(dcoeffs), ptr(dpr), ptr(dpi), ptr(scratch), nbatch, ngrps, nfreqs, nvecs, mode,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(lib, err, KERNEL_NAME)
    count_launch(KERNEL_NAME, mode)
    return sum_partials(partials, mode), dcoeffs, dpr, dpi


def _raise_on(lib, err, name):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                           f"({lib.fcl_error_string(err).decode()})")


def combine_kernel(dcoeffs, dpr, dpi, cot):
    """:func:`combine_plain` from the CUDA kernel: one elementwise launch.
    Raises on operands it does not take and on a failed launch."""
    from ._build import load_kernels

    _, nbatch, ngrps, nfreqs = dpr.shape
    dev = dpr.device
    check_cot(cot, nbatch, dev)
    nvecs = 1 if dcoeffs is None else dcoeffs.shape[-1]
    shapes = (("dpr", dpr, (2, nbatch, ngrps, nfreqs)), ("dpi", dpi, (2, nbatch, ngrps, nfreqs)),
              ("dcoeffs", dcoeffs, (4, nbatch, ngrps, nvecs)), ("cot", cot, (3, nbatch)))
    for name, t, shape in shapes:
        if t is None:
            continue
        if dev.type != "cuda" or t.device != dev or t.dtype != torch.float32:
            raise ValueError(f"{name}: float32 CUDA tensors on one device expected, got "
                             f"{t.dtype} on {t.device}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name} {tuple(t.shape)}, expected contiguous {shape}")
    lib = load_kernels()
    out_r, out_i = (torch.empty((nbatch, ngrps, nfreqs), dtype=torch.float32, device=dev)
                    for _ in range(2))
    dco = None if dcoeffs is None else torch.empty((2, nbatch, ngrps, nvecs),
                                                   dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.fused_sum_combine(
            dpr.data_ptr(), dpi.data_ptr(), None if dcoeffs is None else dcoeffs.data_ptr(),
            cot.data_ptr(), out_r.data_ptr(), out_i.data_ptr(),
            None if dco is None else dco.data_ptr(), nbatch, ngrps, nfreqs, nvecs,
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, err, COMBINE_NAME)
    LAUNCHES.add(COMBINE_NAME)
    return dco, out_r, out_i


def combine(dcoeffs, dpr, dpi, cot):
    """The "sum" gradients (dcoeffs or None, dpr, dpi) at the (3, N)
    cotangents ``cot`` from a one-pass instance's pieces: the kernel on
    CUDA tensors, :func:`combine_plain` on CPU tensors."""
    if dpr.device.type == "cuda":
        return combine_kernel(dcoeffs, dpr, dpi, cot)
    if dpr.device.type == "cpu":
        return combine_plain(dcoeffs, dpr, dpi, cot)
    raise ValueError(f"unsupported device {dpr.device}")


def count_launch(name, mode):
    """One launch of kernel ``name``, counted under its name and under
    its instance's (``name:sum_fwd``, ...)."""
    LAUNCHES.add(name)
    LAUNCHES.add(f"{name}:{MODE_NAMES[mode]}")


def sum_partials(partials, mode):
    """The (T, N, G) partials of a launch summed over the groups outside
    the kernel, in a fixed order (no atomics, so each sum is the same from
    run to run): the (N,) losses, the (3, N) "sum" terms, or None."""
    if partials is None:
        return None
    terms = torch.sum(partials, dim=2)
    return terms if mode in _SUM_TERMS_MODES else terms[0]


def _loss_and_grads(coeffs2, pr, pi, dr, di, w, comps3, mode):
    if comps3.device.type == "cuda":
        return loss_and_grads_kernel(coeffs2, pr, pi, dr, di, w, comps3, mode)
    if comps3.device.type == "cpu":
        return loss_and_grads_plain(coeffs2, pr, pi, dr, di, w, comps3, mode)
    raise ValueError(f"unsupported device {comps3.device}")


class ChiSquareTerm:
    """The chi-square instances of a chunk-loss kernel whose pass is
    ``run(coeffs2, pr, pi, *operands, mode)`` (``ops.fused`` or
    ``ops.shared``'s ``_loss_and_grads``), as the autograd Functions run
    them (:func:`kernel_term`, ``ops.gains.chunk_term``); ``operands``:
    (dr, di, w, comps3), and a shared chunk's group mask after them.

    ``forward(coeffs2, pr, pi, operands, coeff_grad)`` returns the (N,)
    losses and what the backward reads, the gradients at a unit cotangent
    (frozen coefficients: the gain products' alone); ``backward(saved,
    gbar, coeff_grad)`` returns ``(dcoeffs, dpr, dpi, scale)``: the
    coefficients' gradient at the cotangent ``gbar`` (None unless
    ``coeff_grad``), and the gain products' at a unit cotangent with
    ``scale`` = ``gbar``, the (N,) factor that takes them to ``gbar``
    (exact: they are linear in it), left to their reader to apply;
    ``alone(coeffs2, pr, pi, operands)`` the loss-only instance."""

    def __init__(self, run):
        self.run = run

    def forward(self, coeffs2, pr, pi, operands, coeff_grad):
        losses, *grads = self.run(coeffs2, pr, pi, *operands, LOSS_ALL if coeff_grad else LOSS_DP)
        return losses, grads

    def backward(self, saved, gbar, coeff_grad):
        dcoeffs, dpr, dpi = saved
        return (dcoeffs * gbar.reshape(1, -1, 1, 1) if coeff_grad else None), dpr, dpi, gbar

    def alone(self, coeffs2, pr, pi, operands):
        return self.run(coeffs2, pr, pi, *operands, LOSS_ONLY)[0]


class _SumTerm:
    """The "sum" prior's terms of a dense chunk, with :class:`ChiSquareTerm`'s
    methods: the forward runs the one-pass instance (the terms and the
    pieces of every gradient, frozen coefficients: of the gain-product
    gradients), the backward forms the gradients at the (3, N) cotangents
    from the pieces (:func:`combine`; ``scale`` None)."""

    @staticmethod
    def forward(coeffs2, pr, pi, operands, coeff_grad):
        mode = SUM_FWD_ALL if coeff_grad else SUM_FWD_DP
        terms, *pieces = _loss_and_grads(coeffs2, pr, pi, *operands, mode)
        return terms, pieces

    @staticmethod
    def backward(saved, tbar, coeff_grad):
        return combine(*saved, tbar.contiguous()) + (None,)

    @staticmethod
    def alone(coeffs2, pr, pi, operands):
        return _loss_and_grads(coeffs2, pr, pi, *operands, SUM_FWD)[0]


# the dense kernel's terms (the pass looked up at each call)
LOSS_TERM = ChiSquareTerm(lambda *args: _loss_and_grads(*args))
SUM_TERM = _SumTerm()


class _KernelTerm(torch.autograd.Function):
    """A chunk-loss kernel's term (``inst``: :class:`ChiSquareTerm` or a
    "sum" term), differentiable in coeffs2, pr and pi."""

    @staticmethod
    def forward(ctx, inst, coeffs2, pr, pi, *operands):
        out, saved = inst.forward(coeffs2, pr, pi, operands, ctx.needs_input_grad[1])
        ctx.inst, ctx.noperands = inst, len(operands)
        ctx.save_for_backward(*saved)
        return out

    @staticmethod
    def backward(ctx, cot):
        # comps, data, weights and the mask are never differentiated
        want = ctx.needs_input_grad
        dcoeffs, dpr, dpi, scale = ctx.inst.backward(ctx.saved_tensors, cot, want[1])
        if scale is not None:
            g = scale.reshape(-1, 1, 1)
            dpr, dpi = dpr * g, dpi * g
        return (None, dcoeffs, dpr if want[2] else None, dpi if want[3] else None) \
            + (None,) * ctx.noperands


def _wants_grad(coeffs2, pr, pi):
    return torch.is_grad_enabled() and (coeffs2.requires_grad or pr.requires_grad
                                        or pi.requires_grad)


def kernel_term(inst, coeffs2, pr, pi, *operands):
    """The term ``inst`` of one chunk for N slices from its gain products
    ``pr``, ``pi`` (N, G, F), differentiable in coeffs2, pr and pi; with no
    gradient wanted ``inst.alone`` runs and nothing is saved."""
    if _wants_grad(coeffs2, pr, pi):
        return _KernelTerm.apply(inst, coeffs2, pr, pi, *operands)
    return inst.alone(coeffs2, pr, pi, operands)


def fused_chunk_terms_batched(coeffs2, pr, pi, dr, di, w, comps3):
    """The "sum" prior's terms of one dense B=1 chunk for N slices: a (3,
    N) tensor of each slice's chi-square, M_r = sum(w * model_r) and M_i =
    sum(w * model_i), differentiable in coeffs2, pr and pi (operands as
    :func:`fused_chunk_loss_batched`'s). The forward runs the kernel's
    one-pass "sum" instance and keeps its pieces of the gradients (2 planes
    of dpr and 2 of dpi, (N, G, F) each; with every gradient 4 coefficient
    sets); the backward forms the gradients at the three cotangents from
    them (:func:`combine`). With no gradient wanted only the "sum" forward
    runs and nothing is saved."""
    return kernel_term(SUM_TERM, coeffs2, pr, pi, dr, di, w, comps3)


def fused_chunk_terms_batched_plain(coeffs2, pr, pi, dr, di, w, comps3):
    """Plain torch forward of :func:`fused_chunk_terms_batched`,
    differentiable by autograd: (3, N)."""
    return loss_and_grads_plain(coeffs2, pr, pi, dr, di, w, comps3, SUM_FWD)[0]


def fused_chunk_loss_batched(coeffs2, pr, pi, dr, di, w, comps3):
    """Fused weighted chi-square of one B=1 chunk for N slices sharing its
    basis: (N,) losses, differentiable in coeffs2, pr and pi. With no
    gradient wanted (grad mode off, or none of the three requires one) the
    loss-only instance runs and nothing is saved.

    coeffs2: (2, N, ngrps, nvecs) stacked (real, imag) coefficients
    pr, pi:  (N, ngrps, nfreqs) Re / -Im of g_i conj(g_j) per baseline
    dr, di:  (N, ngrps, nfreqs) float32, any strides (e.g. a group-block view)
    w:       (N, ngrps, nfreqs) float32 or bfloat16, any strides
    comps3:  (ngrps, nfreqs, nvecs) float32 or bfloat16
    """
    return kernel_term(LOSS_TERM, coeffs2, pr, pi, dr, di, w, comps3)


# ---------------------------------------------------------------------- #
# one slice: the same kernel with N = 1 (signature of the reference)
# ---------------------------------------------------------------------- #
def _one(coeffs2, pr, pi, dr, di, w):
    return (coeffs2.unsqueeze(1),) + tuple(t.unsqueeze(0) for t in (pr, pi, dr, di, w))


def fused_chunk_loss_plain(coeffs2, pr, pi, comps3, dr, di, w):
    """Plain torch forward of the single-slice loss (differentiable by
    autograd)."""
    return fused_chunk_loss_batched_plain(*_one(coeffs2, pr, pi, dr, di, w), comps3)[0]


def fused_chunk_loss(coeffs2, pr, pi, comps3, dr, di, w):
    """Fused weighted chi-square of one B=1 chunk (differentiable in
    coeffs2, pr and pi).

    coeffs2: (2, ngrps, nvecs) stacked (real, imag) coefficients
    pr, pi:  (ngrps, nfreqs) Re / -Im of g_i conj(g_j) per baseline
    comps3:  (ngrps, nfreqs, nvecs) float32 or bfloat16
    dr, di, w: (ngrps, nfreqs); w float32 or bfloat16
    """
    return fused_chunk_loss_batched(*_one(coeffs2, pr, pi, dr, di, w), comps3)[0]
