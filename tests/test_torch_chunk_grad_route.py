"""A kernel chunk term's gradient route: from the loss kernel to the gain gradient.

A chunk that a chunk-loss kernel takes is one ``ops.gains.ChunkTerm``
from the gains on: the gain products and the loss kernel in its forward,
and in its backward the kernel's gain-product gradients handed to the
gain-gradient kernel as they are, the slice's cotangent applied as each
entry is read. On the CPU both kernels are their plain versions. These
tests hold the route to the composition it replaces, to the bit: the gain
products under autograd, a select of their baseline axis, the plain loss,
its gradients scaled by the cotangent, and the plain gain gradient of a
zero plane that holds them. Dense, shared and shared-batched chunks with
padding groups; the chi-square and the "sum" prior's instances; every
gradient, frozen coefficients and frozen gains; one slice through the
serial path and one or three through the batched path, at a cotangent
other than 1; float32 and bfloat16 comps and weights. A guard runs one
backward of a two-chunk loss under a ``TorchDispatchMode`` and finds no
operation outside the kernels' plain versions that makes a tensor the
size of a data plane.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from calamity_tpu_torch import LAUNCHES
from calamity_tpu_torch.ops import fused, gains, shared
from calamity_tpu_torch.ops import loss as tloss
from calamity_tpu_torch.parallel import batched as tb

NA, NF = 6, 48
KINDS = {"dense": (10, 1, 4), "shared": (1, 8, 5), "shared_batched": (3, 4, 5)}  # (U, gmax, V)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
FREEZE = ("none", "coefficients", "gains")
SITES = {"serial": 1, "batched1": 1, "batched3": 3}  # the call site and its slices


def _chunk(nu, gmax, nv, nbatch, dtype, seed=0, nants=NA, nfreqs=NF, device="cpu"):
    """One B=1 chunk of U = ``nu`` operators of ``gmax`` groups and ``nv``
    modes (dense where gmax is 1) with a padding group in each operator
    class (dense: one padded group), as torch tensors: comps (U, 1, F, V)
    and weights in ``dtype``, the rest float32; indices (G, 1) with the
    packing's record of the rows that hold a baseline."""
    ngrps = nu * gmax
    rng = np.random.default_rng(seed + 31 * nbatch + 7 * nu + nv)
    comps = rng.standard_normal((nu, 1, nfreqs, nv))
    comps /= np.linalg.norm(comps, axis=2, keepdims=True)
    a0 = rng.integers(0, nants, (ngrps, 1))
    a1 = (a0 + 1 + rng.integers(0, nants - 1, (ngrps, 1))) % nants
    valid = np.ones((ngrps, 1), bool)
    valid[gmax - 1::gmax] = gmax == 1
    valid[3] = False
    a1[~valid] = a0[~valid]  # a padding row pairs an antenna with itself
    w = np.abs(rng.standard_normal((nbatch, ngrps, 1, nfreqs))) * valid[None, :, :, None]

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    t0 = torch.as_tensor(a0.astype(np.int32), device=device)
    gains.mark_valid(t0, valid)
    return dict(
        comps=f32(comps).to(dtype), a0=t0,
        a1=torch.as_tensor(a1.astype(np.int32), device=device),
        g_r=f32(1 + 0.1 * rng.standard_normal((nbatch, nants, nfreqs))),
        g_i=f32(0.1 * rng.standard_normal((nbatch, nants, nfreqs))),
        fr=f32(rng.standard_normal((nbatch, ngrps, nv))),
        fi=f32(rng.standard_normal((nbatch, ngrps, nv))),
        dr=f32(rng.standard_normal((nbatch, ngrps, 1, nfreqs))),
        di=f32(rng.standard_normal((nbatch, ngrps, 1, nfreqs))),
        w=f32(w / w.sum()).to(dtype))


def _problem(kind, nbatch, dtype, seed=0):
    """:func:`_chunk` of ``kind`` at the CPU tests' width."""
    return _chunk(*KINDS[kind], nbatch, dtype, seed)


def _leaves(p, freeze, serial):
    """(g_r, g_i, fr, fi): the parameters, those not frozen requiring a
    gradient; one slice's, without the slice axis, for the serial path."""
    out = []
    for name in ("g_r", "g_i", "fr", "fi"):
        x = p[name][0] if serial else p[name]
        frozen = freeze == ("gains" if name.startswith("g") else "coefficients")
        out.append(x.clone().requires_grad_(not frozen))
    return out


def _route(p, kind, terms, leaves, serial):
    """The chunk's term through the port's one route
    (``ops.loss.chunk_route``); for the serial path, of one slice's views
    as the serial loss makes them."""
    g_r, g_i, fr, fi = leaves
    chunk = (p["comps"], p["a0"], p["a1"])
    dr, di, w = p["dr"], p["di"], p["w"]
    if serial:
        g_r, g_i, (fr,), (fi,), _, (dr,), (di,), (w,) = tloss._one_slice(
            g_r, g_i, [fr], [fi], (chunk,), [dr[0]], [di[0]], [w[0]])
    route = tloss.chunk_route(p["comps"], fr, dr, w)
    assert route.loss is (fused if kind == "dense" else shared).LOSS_TERM
    out = tloss._kernel_terms(route.sums if terms else route.loss, route.masked, g_r, g_i, fr,
                              fi, dr, di, w, *chunk)
    out = torch.stack(out) if terms else out[0]
    return out[..., 0] if serial else out


def _composition(p, kind, terms, leaves, serial, cot):
    """The chunk's term and its gradients as the gain products, a select of
    their baseline axis, the plain loss, the gradients scaled by the
    cotangent and the plain gain gradient of a zero plane that holds them
    gave them: ``(out, (dg_r, dg_i, dfr, dfi))``, None where a leaf is
    frozen."""
    g_r, g_i, fr, fi = (x.detach() for x in leaves)
    if serial:
        g_r, g_i, fr, fi = (x.unsqueeze(0) for x in (g_r, g_i, fr, fi))
    want_c = leaves[2].requires_grad
    want_g = leaves[0].requires_grad
    pr, pi = gains._products(g_r, g_i, p["a0"], p["a1"])  # (N, G, 1, F)
    coeffs2 = torch.stack([fr, fi])
    wp = p["w"][:, :, 0].expand(pr.shape[0], pr.shape[1], NF)
    operands = (p["dr"][:, :, 0], p["di"][:, :, 0], wp, p["comps"][:, 0])
    if kind == "dense":
        def run(*args):
            return fused.loss_and_grads_plain(*args[:7], mode=args[7], cot=None)
    else:
        mask = shared.group_mask(p["a0"])

        def run(*args):
            return shared.loss_and_grads_plain(*args[:7], mask, *args[7:])

    cot = cot.reshape(-1) if not terms else cot.reshape(3, -1)
    if not terms:
        out, dcoeffs, dpr, dpi = run(coeffs2, pr[:, :, 0], pi[:, :, 0], *operands,
                                     fused.LOSS_ALL if want_c else fused.LOSS_DP)
        g = cot.reshape(-1, 1, 1)
        dcoeffs = dcoeffs * g.unsqueeze(0) if want_c else None
        dpr, dpi = dpr * g, dpi * g
    elif kind == "dense":
        out, dcoeffs, dpr, dpi = run(coeffs2, pr[:, :, 0], pi[:, :, 0], *operands,
                                     fused.SUM_FWD_ALL if want_c else fused.SUM_FWD_DP)
        dcoeffs, dpr, dpi = fused.combine_plain(dcoeffs, dpr, dpi, cot)
    else:
        out = run(coeffs2, pr[:, :, 0], pi[:, :, 0], *operands, fused.SUM_FWD)[0]
        _, dcoeffs, dpr, dpi = run(coeffs2, pr[:, :, 0], pi[:, :, 0], *operands,
                                   fused.SUM_ALL if want_c else fused.SUM_DP, cot)
    dg_r = dg_i = dfr = dfi = None
    if want_g:
        # the select's backward: a zero plane with the gradients copied in
        plane_r, plane_i = torch.zeros_like(pr), torch.zeros_like(pi)
        plane_r[:, :, 0] = dpr
        plane_i[:, :, 0] = dpi
        dg_r, dg_i = gains.gain_grad_plain(plane_r, plane_i, g_r, g_i, p["a0"], p["a1"])
    if want_c:
        dfr, dfi = dcoeffs
    grads = [dg_r, dg_i, dfr, dfi]
    if serial:
        grads = [None if x is None else x[0] for x in grads]
        out = out[..., 0]
    return out, grads


def _same_bits(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("site", list(SITES))
@pytest.mark.parametrize("freeze", FREEZE)
@pytest.mark.parametrize("terms", [False, True], ids=["chi2", "sum"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_route_equals_the_composition_to_the_bit(kind, terms, freeze, site, dtype):
    """The term, and the gradients in g_r, g_i, fr and fi at a cotangent
    other than 1, through the route and through the composition it
    replaces: equal to the bit; one backward through the route a term."""
    serial = site == "serial"
    p = _problem(kind, SITES[site], DTYPES[dtype])
    leaves = _leaves(p, freeze, serial)
    out = _route(p, kind, terms, leaves, serial)
    rng = np.random.default_rng(5)
    cot = torch.as_tensor(rng.uniform(0.5, 2.0, tuple(out.shape)).astype(np.float32))
    wanted = [x for x in leaves if x.requires_grad]
    LAUNCHES.reset()
    got = iter(torch.autograd.grad(out, wanted, cot))
    assert LAUNCHES.get(gains.ROUTE_NAME) == (freeze != "gains")
    want_out, want = _composition(p, kind, terms, leaves, serial, cot)
    assert _same_bits(out.detach(), want_out)
    for leaf, ref in zip(leaves, want):
        assert (ref is None) == (not leaf.requires_grad)
        if ref is not None:
            assert _same_bits(next(got), ref)


@pytest.mark.parametrize("terms", [False, True], ids=["chi2", "sum"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_route_without_a_gradient_saves_nothing(kind, terms):
    """With no gradient wanted the route is the gain products and the
    kernel's forward alone: no autograd node, the same term."""
    p = _problem(kind, 3, torch.float32)
    out = _route(p, kind, terms, [x.detach() for x in _leaves(p, "none", False)], False)
    assert out.grad_fn is None
    want, _ = _composition(p, kind, terms, _leaves(p, "none", False), False,
                           torch.ones(tuple(out.shape)))
    assert _same_bits(out, want)


# ---------------------------------------------------------------------- #
# the guard: no plane-sized pass outside the kernels
# ---------------------------------------------------------------------- #
class _PlaneGuard(TorchDispatchMode):
    """Records each operation, outside the kernels' plain versions, that
    makes a tensor of at least ``plane`` elements (views excepted: they
    make nothing)."""

    def __init__(self, plane):
        super().__init__()
        self.plane = plane
        self.inside = 0
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not self.inside and not func.is_view:
            flat = out if isinstance(out, (tuple, list)) else (out,)
            sizes = [t.numel() for t in flat if isinstance(t, torch.Tensor)]
            if sizes and max(sizes) >= self.plane:
                self.seen.append((str(func), max(sizes)))
        return out


PLAIN_VERSIONS = ((gains, "_products"), (gains, "gain_grad_plain"),
                  (fused, "loss_and_grads_plain"), (fused, "combine_plain"),
                  (shared, "loss_and_grads_plain"))


def _guarded(monkeypatch, plane):
    """A :class:`_PlaneGuard` that the kernels' plain versions run inside
    of unrecorded."""
    guard = _PlaneGuard(plane)
    for module, name in PLAIN_VERSIONS:
        real = getattr(module, name)

        def quiet(*args, _real=real, **kwargs):
            guard.inside += 1
            try:
                return _real(*args, **kwargs)
            finally:
                guard.inside -= 1

        monkeypatch.setattr(module, name, quiet)
    return guard


def _two_chunks(nbatch, serial):
    """A dense chunk and a shared-batched one, each with its padding:
    ``(args, leaves, plane)``, the loss's arguments, its parameters and the
    smaller data plane (N x G x F) of the two."""
    ps = [_problem(kind, nbatch, torch.float32, seed=3) for kind in ("dense", "shared_batched")]
    leaves = [_leaves(p, "none", serial) for p in ps]
    # one set of gains for both chunks
    g_r, g_i = leaves[0][0], leaves[0][1]
    fr = [lv[2] for lv in leaves]
    fi = [lv[3] for lv in leaves]
    chunks = tuple((p["comps"], p["a0"], p["a1"]) for p in ps)
    pick = (lambda x: x[0]) if serial else (lambda x: x)
    data = [[pick(p[k]) for p in ps] for k in ("dr", "di", "w")]
    plane = min(p["dr"].numel() for p in ps)
    return (g_r, g_i, fr, fi, chunks, *data), [g_r, g_i, *fr, *fi], plane


def _loss(args, path, prior):
    nb = args[0].shape[0]
    if path == "serial":
        if prior:
            return tloss.chunked_loss_sum_regularized(*args, 1.5, -0.5)
        return tloss.chunked_loss(*args)
    if prior:
        return torch.sum(tb.batched_chunk_losses_sum_regularized(
            *args, torch.full((nb,), 1.5), torch.full((nb,), -0.5)))
    return torch.sum(tb.batched_chunk_losses(*args) * torch.linspace(0.5, 2.0, nb))


@pytest.mark.parametrize("prior", [False, True], ids=["chi2", "sum"])
@pytest.mark.parametrize("path, nbatch", [("serial", 1), ("batched", 1), ("batched", 3)])
def test_backward_makes_no_plane_outside_the_kernels(monkeypatch, path, nbatch, prior):
    """One backward of a two-chunk loss: every plane-sized tensor is made
    inside the kernels' plain versions; the route taken once a chunk."""
    args, leaves, plane = _two_chunks(nbatch, path == "serial")
    loss = _loss(args, path, prior)
    guard = _guarded(monkeypatch, plane)
    LAUNCHES.reset()
    with guard:
        torch.autograd.grad(loss, leaves)
    assert guard.seen == []
    assert LAUNCHES.get(gains.ROUTE_NAME) == 2


def test_guard_sees_the_planes_of_the_composition_it_replaced(monkeypatch):
    """The guard's own check: the composition the route replaced (the gain
    products under autograd, a select of their baseline axis and the plain
    loss's gradients scaled by the cotangent) makes planes outside the
    kernels, and the guard records them."""
    p = _problem("shared_batched", 3, torch.float32)
    g_r, g_i, fr, fi = _leaves(p, "none", False)
    pr, pi = gains.gain_products_batched(g_r, g_i, p["a0"], p["a1"])
    wp = p["w"][:, :, 0].expand(pr.shape[0], pr.shape[1], NF)
    losses = shared.shared_chunk_loss_batched(
        torch.stack([fr, fi]), pr[:, :, 0], pi[:, :, 0], p["dr"][:, :, 0], p["di"][:, :, 0],
        wp, p["comps"][:, 0], shared.group_mask(p["a0"]))
    guard = _guarded(monkeypatch, p["dr"].numel())
    with guard:
        torch.autograd.grad(torch.sum(losses * torch.tensor([0.5, 1.0, 2.0])), [g_r, g_i, fr, fi])
    assert len(guard.seen) >= 4, guard.seen


# ---------------------------------------------------------------------- #
# on the card
# ---------------------------------------------------------------------- #
# the full array's widest chunk (chip_smoke.FULL_SHAPES[0]: 22 operators of
# 1024 groups, 256 modes, the sliced kernel) and a chunk of the HERA core's
# kind (64 modes, the unsliced kernel), at the arrays' 331 and 361 antennas
# and 1536 channels: (U, gmax, V, antennas)
CARD_SHAPES = {"full": (22, 1024, 256, 331), "core": (2, 1024, 64, 361)}
CARD_NF = 1536


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("nbatch", [1, 3])
@pytest.mark.parametrize("shape", sorted(CARD_SHAPES))
def test_cuda_gain_grad_scale_on_read_equals_scaled_planes(shape, nbatch, dtype):
    """The gain-gradient kernel with each slice's scale applied as it reads
    dpr and dpi, against the kernel at the planes multiplied by the scale
    first: equal to the bit (the full array's rows give antennas lists of
    more than 64 entries, so its gradient takes the two passes; the core's
    take one)."""
    _need_cuda()
    nu, gmax, _, nants = CARD_SHAPES[shape]
    dt = getattr(torch, dtype)
    p = _chunk(nu, gmax, 4, nbatch, torch.float32, seed=11, nants=nants, nfreqs=CARD_NF,
               device="cuda")
    rng = torch.Generator(device="cuda").manual_seed(3)
    dpr, dpi = (torch.randn((nbatch, nu * gmax, CARD_NF), generator=rng, device="cuda",
                            dtype=dt) for _ in range(2))
    g_r, g_i = p["g_r"].to(dt), p["g_i"].to(dt)
    scale = torch.rand((nbatch,), generator=rng, device="cuda", dtype=dt) * 3 - 1
    index = gains.antenna_csr(p["a0"], p["a1"], nants)
    assert (index.nmulti > 0) == (shape == "full")
    got = gains.gain_grad_kernel(dpr, dpi, g_r, g_i, index, scale)
    s = scale.reshape(-1, 1, 1)
    want = gains.gain_grad_kernel(dpr * s, dpi * s, g_r, g_i, index)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("nbatch", [1, 3])
@pytest.mark.parametrize("terms", [False, True], ids=["chi2", "sum"])
@pytest.mark.parametrize("shape", sorted(CARD_SHAPES))
def test_cuda_route_equals_the_composition_to_the_bit(shape, terms, nbatch):
    """One chunk term through the route on the card (the products kernel,
    the shared-basis kernel, the gain-gradient kernel with the cotangent
    on read) against the composition it replaced on the card (the products
    under autograd, a select, the kernel's term with its gradients scaled
    by the cotangent, the gain-gradient kernel): the term and the
    gradients in g_r, g_i, fr and fi equal to the bit."""
    _need_cuda()
    nu, gmax, nv, nants = CARD_SHAPES[shape]
    p = _chunk(nu, gmax, nv, nbatch, torch.float32, seed=13, nants=nants, nfreqs=CARD_NF,
               device="cuda")
    inst = shared.SUM_TERM if terms else shared.LOSS_TERM
    mask = shared.group_mask(p["a0"])
    wp = p["w"][:, :, 0].expand(nbatch, nu * gmax, CARD_NF)
    operands = (p["dr"][:, :, 0], p["di"][:, :, 0], wp, p["comps"][:, 0], mask)
    rng = torch.Generator(device="cuda").manual_seed(5)
    cot = torch.rand((3, nbatch) if terms else (nbatch,), generator=rng, device="cuda") + 0.5
    sides = []
    for route in (True, False):
        leaves = [p[k].clone().requires_grad_(True) for k in ("g_r", "g_i", "fr", "fi")]
        LAUNCHES.reset()
        if route:
            out = gains.chunk_term(inst, *leaves, p["a0"], p["a1"], *operands)
        else:
            pr, pi = gains.gain_products_batched(leaves[0], leaves[1], p["a0"], p["a1"])
            out = fused.kernel_term(inst, torch.stack(leaves[2:]), pr[:, :, 0], pi[:, :, 0],
                                    *operands)
        grads = torch.autograd.grad(out, leaves, cot)
        torch.cuda.synchronize()
        assert LAUNCHES.get(gains.ROUTE_NAME) == route
        assert LAUNCHES.get(gains.KERNEL_NAME) >= 1
        sides.append((out.detach(), grads))
    (out, grads), (want_out, want) = sides
    assert torch.equal(out, want_out)
    for g, w in zip(grads, want):
        assert torch.equal(g, w)
