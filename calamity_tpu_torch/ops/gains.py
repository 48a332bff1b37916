"""The gain products of every baseline and their gradient, summed in a fixed
order.

Port of the reference's ``gain_products`` (calamity_tpu/ops/loss.py:183-196):
four gathers of the antenna gains by index and the products

    pr = gr0 gr1 + gi0 gi1,   pi = gr0 gi1 - gi0 gr1

(Re and -Im of g_i conj(g_j)). The reference differentiates the gathers
with XLA's scatter-add; torch's ``index_select`` backward is an
``index_add_``, which on CUDA adds with atomics, in an order that changes
from run to run. ``GainProducts`` is one autograd Function for every
layout and path. On a CUDA tensor both of its directions are hand-written
kernels built by ``ops._build``: the forward ``csrc/gain_products.cu``
(one launch for the gathers and products, equal to the torch ops to the
bit), the backward ``csrc/gain_grad.cu``, which sums each antenna's
(row, side) entries in ascending row order, without atomics, so two runs
of one fit take the same steps. On a CPU tensor they are the plain
versions, :func:`_products` and :func:`gain_grad_plain` (the
``index_select`` backward under autograd, deterministic on the CPU). A
failed launch raises.

A chunk a chunk-loss kernel takes (``ops.fused``, ``ops.shared``) is
one :class:`ChunkTerm` from the gains on instead: the products and the
loss kernel in its forward, and in its backward the loss kernel's
gain-product gradients handed to the gradient kernel as they are, each
slice's cotangent its ``scale``, applied as the kernel reads each entry.
``GainProducts`` serves the chunks that take the plain torch loss.

The backward's lists (:class:`GainIndex`) are built from a chunk's ``a0``,
``a1`` and the rows that hold a baseline (``ChunkMeta.valid``). The
packing decides which rows those are and records them on the index tensor
``a0`` (:func:`mark_valid`); each block cut from a chunk (a group-block
view, a mesh rank's block, the groups padded for the mesh) is marked from
its source by :func:`carry_valid`, and a slice of a recorded index that
was not raises. The lists are built from that record alone, never
inferred from ``a0 == a1`` or the weights; an index that carries no record
(a chunk built by hand) lists every row. Padded rows are listed nowhere;
their cotangents are zero, so the sums do not change. Each antenna's list
is cut into segments of at most :data:`SEGMENT` entries; the kernel sums
each segment, then each antenna's segments in ascending order. The lists
are built once per index tensor and kept on it.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import LAUNCHES

KERNEL_NAME = "gain_grad"
PRODUCTS_KERNEL_NAME = "gain_products"
ROUTE_NAME = "chunk_term.direct"  # a kernel chunk term's backward through ChunkTerm
SEGMENT = 64  # entries of a segment of an antenna's list
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


# ---------------------------------------------------------------------- #
# which rows hold a baseline
# ---------------------------------------------------------------------- #
def mark_valid(a0, valid):
    """Record on the index tensor ``a0`` which of its rows hold a baseline
    (``valid``: bool, ``a0``'s shape, as ``ChunkMeta.valid``); the
    gradient's lists leave the others out."""
    a0._valid_rows = np.asarray(valid, dtype=bool).reshape(tuple(a0.shape))


def valid_rows(a0):
    """The rows of ``a0`` that hold a baseline, or None where none were
    recorded (every row is then listed)."""
    return getattr(a0, "_valid_rows", None)


def carry_valid(src, dst, groups=slice(None)):
    """Mark ``dst``, the block ``groups`` of ``src``'s group axis (rows past
    ``src``'s end are padding), with ``src``'s valid rows."""
    valid = valid_rows(src)
    if valid is None or not isinstance(dst, torch.Tensor):
        return
    stop = groups.indices(max(valid.shape[0], groups.stop or 0))[1]
    if stop > valid.shape[0]:
        valid = np.concatenate([valid, np.zeros((stop - valid.shape[0],) + valid.shape[1:],
                                                bool)])
    mark_valid(dst, valid[groups])


# ---------------------------------------------------------------------- #
# the backward's lists
# ---------------------------------------------------------------------- #
def build_antenna_csr(a0, a1, nants, valid=None):
    """Each antenna's (row, side) entries, in ascending row order (side 0,
    the row's first antenna, before side 1), of the rows where ``valid``
    (default every row): ``(offsets (nants + 1,), rowside, other)``, int32
    on ``a0``'s device; antenna ``a``'s entries are ``[offsets[a],
    offsets[a + 1])``, each ``row * 2 + side`` and the row's other antenna.
    Rows are those of ``a0.reshape(-1)``."""
    i0 = a0.detach().reshape(-1).cpu().numpy().astype(np.int64)
    i1 = a1.detach().reshape(-1).cpu().numpy().astype(np.int64)
    if i0.size and (min(i0.min(), i1.min()) < 0 or max(i0.max(), i1.max()) >= nants):
        raise ValueError(f"an antenna index is outside [0, {nants})")
    rows = np.arange(i0.size, dtype=np.int64)
    if valid is not None:
        rows = rows[np.asarray(valid, bool).reshape(-1)]
    ant = np.concatenate([i0[rows], i1[rows]])
    rowside = np.concatenate([2 * rows, 2 * rows + 1])
    other = np.concatenate([i1[rows], i0[rows]])
    order = np.lexsort((rowside, ant))  # by antenna, then (row, side)
    offsets = np.concatenate([[0], np.cumsum(np.bincount(ant, minlength=nants))])
    return tuple(torch.as_tensor(x.astype(np.int32), device=a0.device)
                 for x in (offsets, rowside[order], other[order]))


def build_segments(offsets, seg_len=SEGMENT):
    """The segment table of an antenna CSR (``offsets``, numpy or tensor):
    each antenna's list cut into segments of at most ``seg_len`` entries,
    in order (an antenna with no entries has one empty segment). Returns
    numpy int32 arrays ``seg_start`` (nseg + 1: segment k holds entries
    [seg_start[k], seg_start[k + 1])), ``seg_ant`` (nseg), ``seg_slot``
    (nseg: the scratch slot of a segment of an antenna with several, -1 for
    an antenna's only segment), ``multi_ants`` (the antennas with several
    segments) and ``multi_slot`` (their slots, [multi_slot[j],
    multi_slot[j + 1]))."""
    offsets = np.asarray(torch.as_tensor(offsets).cpu(), dtype=np.int64)
    counts = np.diff(offsets)
    nseg_a = np.maximum(1, -(-counts // seg_len))
    first = np.concatenate([[0], np.cumsum(nseg_a)])
    seg_ant = np.repeat(np.arange(len(counts)), nseg_a)
    k = np.arange(first[-1]) - first[seg_ant]
    seg_start = np.append(offsets[seg_ant] + k * seg_len, offsets[-1])
    multi = nseg_a > 1
    seg_slot = np.full(first[-1], -1, dtype=np.int64)
    in_multi = multi[seg_ant]
    seg_slot[in_multi] = np.arange(int(in_multi.sum()))
    multi_slot = np.concatenate([[0], np.cumsum(nseg_a[multi])])
    return tuple(x.astype(np.int32) for x in (seg_start, seg_ant, seg_slot,
                                               np.flatnonzero(multi), multi_slot))


class GainIndex:
    """What the kernels need of one chunk's indices, on their device: the
    rows' antennas ``i0``, ``i1`` (int32, flat) for the forward; the
    antenna CSR of the valid rows (``offsets``, ``rowside``, ``other``) and
    its segment table (:func:`build_segments`) for the backward. The
    tables' device pointers are taken once (``ptrs``): a launch passes them
    as they are."""

    def __init__(self, a0, a1, nants, valid=None, seg_len=SEGMENT):
        self.device = a0.device
        self.nants = nants
        self.rows = a0.numel()
        self.i0 = a0.reshape(-1).to(torch.int32).contiguous()
        self.i1 = a1.reshape(-1).to(torch.int32).contiguous()
        self.offsets, self.rowside, self.other = build_antenna_csr(a0, a1, nants, valid)
        segs = build_segments(self.offsets, seg_len)
        (self.seg_start, self.seg_ant, self.seg_slot, self.multi_ants,
         self.multi_slot) = (torch.as_tensor(x, device=self.device) for x in segs)
        self.nseg = len(segs[1])
        self.nmulti = len(segs[3])
        self.nslots = int(segs[4][-1])
        self.nentries = self.rowside.numel()
        self.ptrs = tuple(t.data_ptr() for t in self.tables())
        self.index_ptrs = (self.i0.data_ptr(), self.i1.data_ptr())

    def tables(self):
        """The backward's int32 tables, in the kernel's argument order."""
        return (self.rowside, self.other, self.seg_start, self.seg_ant, self.seg_slot,
                self.multi_ants, self.multi_slot)


def antenna_csr(a0, a1, nants):
    """The :class:`GainIndex` of a chunk's indices (its valid rows as
    :func:`mark_valid` recorded them; every row of an index that carries no
    record), built once per index tensor and kept on ``a0`` for later
    steps. Raises on a slice of a recorded index that carries none."""
    valid = valid_rows(a0)
    if valid is None and a0._base is not None and valid_rows(a0._base) is not None:
        raise ValueError(
            f"the index tensor a0 {tuple(a0.shape)} is a slice of a chunk's index whose "
            "record of the rows that hold a baseline it lost: cut blocks of a chunk with "
            "carry_valid, or its padding is listed again")
    cached = getattr(a0, "_antenna_csr", None)
    if (cached is not None and cached[0] is a1 and cached[1] == nants
            and cached[2] is valid):
        return cached[3]
    index = GainIndex(a0, a1, nants, valid)
    a0._antenna_csr = (a1, nants, valid, index)
    return index


# ---------------------------------------------------------------------- #
# plain versions and kernels
# ---------------------------------------------------------------------- #
def gain_grad_plain(dpr, dpi, g_r, g_i, a0, a1, scale=None):
    """Plain torch version of the kernel: ``(dg_r, dg_i)``, each (nbatch,
    nants, nfreqs), the gradient of ``sum(s * (dpr * pr + dpi * pi))`` in
    the gains, ``s`` each slice's ``scale`` ((nbatch,), None for 1), through
    the ``index_select`` backward (an ``index_add_``) at the planes ``s *
    dpr`` and ``s * dpi``."""
    if scale is not None:
        s = scale.reshape((-1,) + (1,) * (dpr.dim() - 1))
        dpr, dpi = dpr * s, dpi * s
    with torch.enable_grad():
        gr = g_r.detach().requires_grad_(True)
        gi = g_i.detach().requires_grad_(True)
        pr, pi = _products(gr, gi, a0, a1)
        dg_r, dg_i = torch.autograd.grad((pr, pi), (gr, gi),
                                         (dpr.reshape(pr.shape), dpi.reshape(pi.shape)))
    return dg_r, dg_i


def _check_gains(g_r, g_i, index):
    """The launch's device index and dtype code; raises on gains the
    kernels do not take."""
    dev = g_r.device
    if dev.type != "cuda":
        raise ValueError(f"the kernel takes CUDA tensors; the gains are on {dev}")
    code = _DTYPES.get(g_r.dtype)
    if code is None or g_i.dtype != g_r.dtype:
        raise TypeError(f"gain dtypes {g_r.dtype}, {g_i.dtype} (float32/float64, one of them)")
    if g_i.shape != g_r.shape or g_r.dim() != 3 or g_r.shape[1] != index.nants:
        raise ValueError(f"gains {tuple(g_r.shape)} and {tuple(g_i.shape)}; expected two of "
                         f"(nbatch, {index.nants}, nfreqs)")
    if g_i.device != dev or index.device != dev:
        raise ValueError(f"the gains are on {dev} and {g_i.device}, the indices on "
                         f"{index.device}")
    return dev.index if dev.index is not None else torch.cuda.current_device(), code


def _launch(dev, fn, *args):
    """``fn(*args, stream)`` on device ``dev``'s current stream; the CUDA
    error it returns."""
    if dev == torch.cuda.current_device():
        return fn(*args, torch._C._cuda_getCurrentRawStream(dev))
    with torch.cuda.device(dev):
        return fn(*args, torch._C._cuda_getCurrentRawStream(dev))


def _raise_on(lib, err, name):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                           f"({lib.fcl_error_string(err).decode()})")


def gain_grad_kernel(dpr, dpi, g_r, g_i, index, scale=None):
    """:func:`gain_grad_plain` from the CUDA kernel: ``dpr, dpi`` (nbatch,
    rows, nfreqs), gains (nbatch, nants, nfreqs), the chunk's
    :class:`GainIndex`, ``scale`` (nbatch,) of the gains' dtype or None;
    the kernel multiplies each dpr and dpi entry by its slice's scale as it
    reads it, so no scaled plane is made. Raises on operands the kernel
    does not take and on a failed launch."""
    from ._build import load_kernels

    dev, code = _check_gains(g_r, g_i, index)
    nbatch, nants, nfreqs = g_r.shape
    if dpr.shape != (nbatch, index.rows, nfreqs) or dpi.shape != dpr.shape:
        raise ValueError(f"cotangents {tuple(dpr.shape)} and {tuple(dpi.shape)}; expected "
                         f"{(nbatch, index.rows, nfreqs)}")
    if dpr.dtype != g_r.dtype or dpi.dtype != g_r.dtype or dpr.device != g_r.device \
            or dpi.device != g_r.device:
        raise TypeError(f"cotangents {dpr.dtype} on {dpr.device} and {dpi.dtype} on "
                        f"{dpi.device}, the gains {g_r.dtype} on {g_r.device}")
    if scale is not None:
        if scale.shape != (nbatch,) or scale.dtype != g_r.dtype or scale.device != g_r.device:
            raise ValueError(f"scale {scale.dtype} {tuple(scale.shape)} on {scale.device}; "
                             f"expected {g_r.dtype} ({nbatch},) on {g_r.device}")
        scale = scale.contiguous()
    dpr, dpi, g_r, g_i = dpr.contiguous(), dpi.contiguous(), g_r.contiguous(), g_i.contiguous()
    dg_r = torch.empty_like(g_r)
    dg_i = torch.empty_like(g_i)
    if dg_r.numel() == 0:
        return dg_r, dg_i
    part = (0, 0)
    if index.nmulti:
        scratch = torch.empty((2, nbatch, index.nslots, nfreqs), dtype=g_r.dtype, device=dev)
        part = (scratch[0].data_ptr(), scratch[1].data_ptr())
    lib = load_kernels()
    err = _launch(dev, lib.gain_grad, dpr.data_ptr(), dpi.data_ptr(),
                  None if scale is None else scale.data_ptr(), g_r.data_ptr(), g_i.data_ptr(),
                  *index.ptrs, dg_r.data_ptr(), dg_i.data_ptr(), *part, nbatch, index.rows,
                  nants, nfreqs, index.nseg, index.nmulti, index.nslots, index.nentries, code)
    _raise_on(lib, err, KERNEL_NAME)
    LAUNCHES.add(KERNEL_NAME)
    return dg_r, dg_i


def gain_products_kernel(g_r, g_i, index):
    """:func:`_products` from the CUDA kernel: gains (nbatch, nants,
    nfreqs), the chunk's :class:`GainIndex`; ``(pr, pi)``, each (nbatch,
    rows, nfreqs), equal to the torch ops to the bit. Raises on operands
    the kernel does not take and on a failed launch."""
    from ._build import load_kernels

    dev, code = _check_gains(g_r, g_i, index)
    nbatch, nants, nfreqs = g_r.shape
    g_r, g_i = g_r.contiguous(), g_i.contiguous()
    pr = torch.empty((nbatch, index.rows, nfreqs), dtype=g_r.dtype, device=g_r.device)
    pi = torch.empty_like(pr)
    if pr.numel() == 0:
        return pr, pi
    lib = load_kernels()
    err = _launch(dev, lib.gain_products, g_r.data_ptr(), g_i.data_ptr(), *index.index_ptrs,
                  pr.data_ptr(), pi.data_ptr(), nbatch, index.rows, nants, nfreqs, code)
    _raise_on(lib, err, PRODUCTS_KERNEL_NAME)
    LAUNCHES.add(PRODUCTS_KERNEL_NAME)
    return pr, pi


def gain_grad(dpr, dpi, g_r, g_i, a0, a1, scale=None):
    """``(dg_r, dg_i)`` of :func:`gain_grad_plain` (``dpr``, ``dpi``:
    (nbatch, ngrps, [nbls,] nfreqs)): the kernel on a CUDA tensor, the
    plain version on a CPU tensor."""
    if g_r.device.type == "cuda":
        nbatch, nants, nfreqs = g_r.shape
        return gain_grad_kernel(dpr.reshape(nbatch, -1, nfreqs), dpi.reshape(nbatch, -1, nfreqs),
                                g_r, g_i, antenna_csr(a0, a1, nants), scale)
    if g_r.device.type == "cpu":
        return gain_grad_plain(dpr, dpi, g_r, g_i, a0, a1, scale)
    raise ValueError(f"unsupported device {g_r.device}")


def products(g_r, g_i, a0, a1):
    """(pr, pi), each (nbatch, ngrps, nbls, nfreqs): the forward kernel on a
    CUDA tensor, :func:`_products` on a CPU tensor."""
    if g_r.device.type == "cuda":
        nbatch, nants, nfreqs = g_r.shape
        pr, pi = gain_products_kernel(g_r, g_i, antenna_csr(a0, a1, nants))
        shape = (nbatch,) + tuple(a0.shape) + (nfreqs,)
        return pr.view(shape), pi.view(shape)
    if g_r.device.type == "cpu":
        return _products(g_r, g_i, a0, a1)
    raise ValueError(f"unsupported device {g_r.device}")


class GainProducts(torch.autograd.Function):
    """(pr, pi) of the gain products, (nbatch, ngrps, nbls, nfreqs), from
    gains (nbatch, nants, nfreqs); both directions are the kernels on a
    CUDA tensor and the plain versions on a CPU tensor."""

    @staticmethod
    def forward(ctx, g_r, g_i, a0, a1):
        ctx.save_for_backward(g_r, g_i)
        ctx.a0, ctx.a1 = a0, a1  # static indices, never differentiated; they carry the lists
        return products(g_r, g_i, a0, a1)

    @staticmethod
    def backward(ctx, dpr, dpi):
        g_r, g_i = ctx.saved_tensors
        dg_r, dg_i = gain_grad(dpr, dpi, g_r, g_i, ctx.a0, ctx.a1)
        return dg_r, dg_i, None, None


def gain_products_batched(g_r, g_i, a0, a1):
    """Gain products with a leading slice axis: g_r/g_i (nbatch, nants,
    nfreqs) -> (pr, pi) each (nbatch, ngrps, nbls, nfreqs)."""
    if torch.is_grad_enabled() and (g_r.requires_grad or g_i.requires_grad):
        return GainProducts.apply(g_r, g_i, a0, a1)
    return products(g_r, g_i, a0, a1)


class ChunkTerm(torch.autograd.Function):
    """One kernel chunk term from the gains on: its gain products and a
    chunk-loss kernel's term ``inst`` (``ops.fused.ChiSquareTerm`` or a
    "sum" term) in the forward, with nothing between them; in the backward
    the kernel's gain-product gradients (N, G, F) go to the gain-gradient
    kernel as they are, with the slice's cotangent as its ``scale`` where
    they were taken at a unit cotangent. So no plane-sized pass lies
    between the two kernels: no select of the products' baseline axis,
    whose backward would zero-fill and copy a plane, and no plane scaled by
    the cotangent. Counted in :data:`LAUNCHES` as :data:`ROUTE_NAME`, once
    a backward that takes the route."""

    @staticmethod
    def forward(ctx, inst, g_r, g_i, fr, fi, a0, a1, *operands):
        pr, pi = products(g_r, g_i, a0, a1)  # (N, G, 1, F)
        coeff_grad = ctx.needs_input_grad[3] or ctx.needs_input_grad[4]
        out, saved = inst.forward(torch.stack([fr, fi]), pr[:, :, 0], pi[:, :, 0], operands,
                                  coeff_grad)
        ctx.inst, ctx.a0, ctx.a1, ctx.noperands = inst, a0, a1, len(operands)
        ctx.save_for_backward(g_r, g_i, *saved)
        return out

    @staticmethod
    def backward(ctx, cot):
        g_r, g_i, *saved = ctx.saved_tensors
        want = ctx.needs_input_grad
        dcoeffs, dpr, dpi, scale = ctx.inst.backward(saved, cot, want[3] or want[4])
        dg_r = dg_i = None
        if want[1] or want[2]:
            dg_r, dg_i = gain_grad(dpr, dpi, g_r, g_i, ctx.a0, ctx.a1, scale)
            LAUNCHES.add(ROUTE_NAME)
        dfr, dfi = (None, None) if dcoeffs is None else dcoeffs
        return (None, dg_r, dg_i, dfr, dfi, None, None) + (None,) * ctx.noperands


def chunk_term(inst, g_r, g_i, fr, fi, a0, a1, *operands):
    """The term ``inst`` of one B=1 chunk a chunk-loss kernel takes, from
    the gains (nbatch, nants, nfreqs) and the coefficients ``fr``, ``fi``
    (nbatch, ngrps, nvecs), differentiable in both (:class:`ChunkTerm`);
    ``a0``, ``a1`` (ngrps, 1) the chunk's indices, ``operands`` the
    kernel's after the gain products. With no gradient wanted the products
    and ``inst.alone`` run and nothing is saved."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (g_r, g_i, fr, fi)):
        return ChunkTerm.apply(inst, g_r, g_i, fr, fi, a0, a1, *operands)
    pr, pi = products(g_r, g_i, a0, a1)
    return inst.alone(torch.stack([fr, fi]), pr[:, :, 0], pi[:, :, 0], operands)


def gain_products(g_r, g_i, a0, a1):
    """Real-arithmetic expansion of g_i conj(g_j) per baseline.

    g_r/g_i: (nants, nfreqs); a0/a1: (ngrps, nbls) int32.
    Returns (grgr+gigi, grgi-gigr) = (Re, -Im) of g_i conj(g_j),
    each (ngrps, nbls, nfreqs)."""
    pr, pi = gain_products_batched(g_r.unsqueeze(0), g_i.unsqueeze(0), a0, a1)
    return pr[0], pi[0]
