"""The port's fused chunk loss against calamity_tpu's Pallas kernel.

On the CPU the port's ``fused_chunk_loss`` runs its plain one-pass version
(the loss and its gradients at a unit cotangent, scaled by the cotangent
in the autograd Function's backward); the JAX ``fused_chunk_loss`` runs
its Pallas kernel in interpret mode, as tests/test_fused.py runs it (NG=16,
NF=256, NV=128, the shapes its TPU gate accepts), with its XLA backward.
At ragged shapes that the TPU gate refuses, the reference is the JAX
einsum ``chunked_loss``. float32 tolerances: loss rel 1e-5, gradients rel
1e-4 (float32 sums over NF*NV terms in different orders). The
kernel-against-plain tests need a CUDA card and are skipped without one.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import rel_err

from calamity_tpu.ops import fused as jfused
from calamity_tpu.ops import loss as jloss
from calamity_tpu.parallel import batched as jb
from calamity_tpu_torch import LAUNCHES
from calamity_tpu_torch.ops import fused
from calamity_tpu_torch.ops import loss as tloss
from calamity_tpu_torch.parallel import batched as tb

NA = 8


def _inputs(ng, nf, nv, seed=0):
    rng = np.random.default_rng(seed)
    comps = rng.standard_normal((ng, nf, nv)).astype(np.float32)
    comps /= np.linalg.norm(comps, axis=1, keepdims=True)
    coeffs2 = rng.standard_normal((2, ng, nv)).astype(np.float32)
    pr = (1 + 0.1 * rng.standard_normal((ng, nf))).astype(np.float32)
    pi = (0.1 * rng.standard_normal((ng, nf))).astype(np.float32)
    dr = rng.standard_normal((ng, nf)).astype(np.float32)
    di = rng.standard_normal((ng, nf)).astype(np.float32)
    w = np.abs(rng.standard_normal((ng, nf))).astype(np.float32)
    w /= w.sum()
    return coeffs2, pr, pi, comps, dr, di, w


def _torch_grads(fn, args, comps_dtype=torch.float32):
    t = [torch.as_tensor(a) for a in args]
    t[3] = t[3].to(comps_dtype)
    for i in (0, 1, 2):
        t[i].requires_grad_(True)
    loss = fn(*t)
    return loss, torch.autograd.grad(loss, t[:3])


@pytest.mark.parametrize("comps_dtype", ["float32", "bfloat16"])
def test_matches_pallas_kernel_interpret(comps_dtype):
    args = _inputs(16, 256, 128)
    jargs = [jnp.asarray(a) for a in args]
    tdt = torch.float32
    if comps_dtype == "bfloat16":
        jargs[3] = jargs[3].astype(jnp.bfloat16)
        tdt = torch.bfloat16
    jval, jgrad = jax.value_and_grad(jfused.fused_chunk_loss, argnums=(0, 1, 2))(*jargs)
    tval, tgrad = _torch_grads(fused.fused_chunk_loss, args, tdt)
    pval = fused.fused_chunk_loss_plain(
        *[torch.as_tensor(a) if i != 3 else torch.as_tensor(a).to(tdt)
          for i, a in enumerate(args)])
    assert rel_err(tval, jval) <= 1e-5
    assert rel_err(pval, jval) <= 1e-5
    for got, want in zip(tgrad, jgrad):
        assert rel_err(got, want) <= 1e-4


@pytest.mark.parametrize("shape", [(5, 37, 3), (7, 129, 130), (1, 1, 1)])
def test_ragged_shapes_match_jax_chunked_loss(shape):
    ng, nf, nv = shape
    rng = np.random.default_rng(1)
    comps = rng.standard_normal((ng, 1, nf, nv)).astype(np.float32)
    a0 = rng.integers(0, NA, (ng, 1)).astype(np.int32)
    a1 = ((a0 + 1) % NA).astype(np.int32)
    g_r = (1 + 0.1 * rng.standard_normal((NA, nf))).astype(np.float32)
    g_i = (0.1 * rng.standard_normal((NA, nf))).astype(np.float32)
    fr, fi = (rng.standard_normal((ng, nv)).astype(np.float32) for _ in range(2))
    dr, di = (rng.standard_normal((ng, 1, nf)).astype(np.float32) for _ in range(2))
    w = np.abs(rng.standard_normal((ng, 1, nf))).astype(np.float32)
    assert not jfused.fused_loss_applicable(jnp.asarray(comps))  # the TPU gate refuses

    def jfn(gr, gi, f_r, f_i):
        return jloss.chunked_loss(gr, gi, (f_r,), (f_i,),
                                  ((jnp.asarray(comps), jnp.asarray(a0), jnp.asarray(a1)),),
                                  (jnp.asarray(dr),), (jnp.asarray(di),), (jnp.asarray(w),))

    jval, jgrad = jax.value_and_grad(jfn, argnums=(0, 1, 2, 3))(
        jnp.asarray(g_r), jnp.asarray(g_i), jnp.asarray(fr), jnp.asarray(fi))
    t = [torch.as_tensor(x).requires_grad_(True) for x in (g_r, g_i, fr, fi)]
    chunk = (torch.as_tensor(comps), torch.as_tensor(a0), torch.as_tensor(a1))
    assert fused.explain_fused_loss_inapplicable(chunk[0], t[2], torch.as_tensor(dr),
                                                 torch.as_tensor(w)) is None
    tval = tloss.chunked_loss(t[0], t[1], [t[2]], [t[3]], (chunk,), [torch.as_tensor(dr)],
                              [torch.as_tensor(di)], [torch.as_tensor(w)])
    tgrad = torch.autograd.grad(tval, t)
    assert rel_err(tval, jval) <= 1e-5
    for got, want in zip(tgrad, jgrad):
        assert rel_err(got, want) <= 1e-4


def _gate(comps, ngrps=None, coeffs_dtype=torch.float32, data_dtype=torch.float32,
          wgts_dtype=torch.float32):
    ngrps = comps.shape[0] if ngrps is None else ngrps
    nf, nv = comps.shape[2], comps.shape[3]
    return fused.explain_fused_loss_inapplicable(
        comps,
        torch.zeros((ngrps, nv), dtype=coeffs_dtype),
        torch.zeros((ngrps, comps.shape[1], nf), dtype=data_dtype),
        torch.zeros((ngrps, comps.shape[1], nf), dtype=wgts_dtype),
    )


def test_hopper_gate():
    c = torch.zeros((5, 1, 37, 3))
    assert _gate(c) is None  # any G, F, V
    assert _gate(torch.zeros((2016, 1, 1536, 119), dtype=torch.bfloat16)) is None
    assert "shared-basis" in _gate(torch.zeros((1, 1, 37, 3)), ngrps=4)
    assert "shared-basis" in _gate(torch.zeros((2, 1, 37, 3)), ngrps=4)
    assert "nbls=2" in _gate(torch.zeros((5, 2, 37, 3)))
    assert "comps dtype" in _gate(c.double())
    assert "coefficient dtype" in _gate(c, coeffs_dtype=torch.float64)
    assert "data dtype" in _gate(c, data_dtype=torch.float64)
    assert _gate(c, wgts_dtype=torch.bfloat16) is None  # widened on load
    assert "weights dtype" in _gate(c, wgts_dtype=torch.float64)


def test_fallback_warning_names_each_chunk():
    # the shared chunk goes to the shared-basis kernel; only the
    # multi-baseline chunk, which neither kernel takes, is named
    dense = (torch.zeros((3, 1, 8, 2)), torch.zeros((3, 1), dtype=torch.int32), None)
    shared = (torch.zeros((1, 1, 8, 2)), torch.zeros((4, 1), dtype=torch.int32), None)
    dense_b2 = (torch.zeros((3, 2, 8, 2)), torch.zeros((3, 2), dtype=torch.int32), None)
    fr = [torch.zeros((3, 2)), torch.zeros((4, 2)), torch.zeros((3, 2))]
    data = [torch.zeros((3, 1, 8)), torch.zeros((4, 1, 8)), torch.zeros((3, 2, 8))]
    with pytest.warns(UserWarning, match="chunk 2: nbls=2"):
        reasons = tloss.warn_fused_fallbacks((dense, shared, dense_b2), fr, data, data)
    assert len(reasons) == 1


def _kernel_args(coeffs2, pr, pi, comps, dr, di, w):
    """The kernel's batched operands (N = 1) from one slice's."""
    return (coeffs2.unsqueeze(1), pr[None], pi[None], dr[None], di[None], w[None], comps)


def test_kernel_wrapper_refuses_cpu_tensors_and_bad_operands():
    t = [torch.as_tensor(a) for a in _inputs(3, 8, 2)]
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused.loss_and_grads_kernel(*_kernel_args(*t))
    bad = list(t)
    bad[1] = torch.zeros((8, 3)).t()  # the right shape, not contiguous
    with pytest.raises(ValueError, match="not contiguous"):
        fused.loss_and_grads_kernel(*_kernel_args(*bad))
    bad = list(t)
    bad[0] = t[0][:, :2]
    with pytest.raises(ValueError, match="coeffs2 shape"):
        fused.loss_and_grads_kernel(*_kernel_args(*bad))
    bad = list(t)
    bad[4] = t[4].double()
    with pytest.raises(TypeError, match="dr dtype"):
        fused.loss_and_grads_kernel(*_kernel_args(*bad))


def test_cpu_forward_launches_no_kernel():
    LAUNCHES.reset()
    _torch_grads(fused.fused_chunk_loss, _inputs(4, 16, 3))
    assert LAUNCHES.get(fused.KERNEL_NAME) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("comps_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(5, 37, 3), (7, 129, 130), (64, 256, 119), (2, 3, 60000)])
def test_cuda_kernel_matches_plain(shape, comps_dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    args = [torch.as_tensor(a, device=dev) for a in _inputs(*shape)]
    args[3] = args[3].to(comps_dtype)
    for mode in (fused.LOSS_ONLY, fused.LOSS_DP, fused.LOSS_ALL):
        before = LAUNCHES.get(fused.KERNEL_NAME)
        got = fused.loss_and_grads_kernel(*_kernel_args(*args), mode=mode)
        assert LAUNCHES.get(fused.KERNEL_NAME) == before + 1
        want = fused.loss_and_grads_plain(*_kernel_args(*args), mode=mode)
        torch.cuda.synchronize()
        assert rel_err(got[0], want[0]) <= 1e-5
        for g, p in zip(got[1:], want[1:]):
            assert (g is None) == (p is None)
            if p is not None:
                assert rel_err(g, p) <= 1e-4
    cpu = [a.cpu() for a in args]
    _, g_k = _torch_grads(fused.fused_chunk_loss, [a.cuda() for a in cpu], comps_dtype)
    _, g_p = _torch_grads(fused.fused_chunk_loss_plain, [a.cuda() for a in cpu], comps_dtype)
    for got, want in zip(g_k, g_p):
        assert rel_err(got, want) <= 1e-4


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    from calamity_tpu_torch.ops import _build

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_LOADED", [])
    try:
        _build.find_nvcc()
    except RuntimeError:
        pass
    else:
        pytest.skip("this machine has nvcc at the default toolkit location")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load_kernels()
    assert [os.path.basename(s) for s in _build.sources()] == ["adamax_step.cu",
                                                                "fused_chunk_loss.cu",
                                                                "gain_grad.cu",
                                                                "gain_products.cu",
                                                                "shared_chunk_loss.cu"]


# ---------------------------------------------------------------------- #
# the one-pass loss and gradients
# ---------------------------------------------------------------------- #
def _batched_inputs(nbatch, ng, nf, nv, seed=2):
    rng = np.random.default_rng(seed)
    comps = rng.standard_normal((ng, nf, nv)).astype(np.float32)
    comps /= np.linalg.norm(comps, axis=1, keepdims=True)
    coeffs2 = rng.standard_normal((2, nbatch, ng, nv)).astype(np.float32)
    pr = (1 + 0.1 * rng.standard_normal((nbatch, ng, nf))).astype(np.float32)
    pi = (0.1 * rng.standard_normal((nbatch, ng, nf))).astype(np.float32)
    dr, di = (rng.standard_normal((nbatch, ng, nf)).astype(np.float32) for _ in range(2))
    w = np.abs(rng.standard_normal((nbatch, ng, nf))).astype(np.float32)
    return coeffs2, pr, pi, dr, di, w / w.sum(), comps


@pytest.mark.parametrize("cotangent", ["unit", "per_slice"])
@pytest.mark.parametrize("comps_dtype", ["float32", "bfloat16"])
def test_one_pass_matches_jax_value_and_grad(comps_dtype, cotangent):
    """The plain one-pass version's (losses, dcoeffs, dpr, dpi) against
    jax.value_and_grad of the Pallas kernel (interpret mode) slice by slice,
    and the autograd Function's gradients at a per-slice cotangent."""
    nbatch = 3
    coeffs2, pr, pi, dr, di, w, comps = _batched_inputs(nbatch, 16, 256, 128)
    jcomps = jnp.asarray(comps).astype(jnp.bfloat16 if comps_dtype == "bfloat16" else jnp.float32)
    gbar = np.ones(nbatch, np.float32) if cotangent == "unit" else np.array([0.5, -2.0, 3.0],
                                                                           np.float32)
    jl, jg = [], []
    for n in range(nbatch):
        val, grads = jax.value_and_grad(jfused.fused_chunk_loss, argnums=(0, 1, 2))(
            jnp.asarray(coeffs2[:, n]), jnp.asarray(pr[n]), jnp.asarray(pi[n]), jcomps,
            jnp.asarray(dr[n]), jnp.asarray(di[n]), jnp.asarray(w[n]))
        jl.append(val)
        jg.append([np.asarray(x) * gbar[n] for x in grads])
    want_dcoeffs = np.stack([g[0] for g in jg], axis=1)  # (2, N, G, V)
    want_dpr = np.stack([g[1] for g in jg])
    want_dpi = np.stack([g[2] for g in jg])
    tdt = torch.bfloat16 if comps_dtype == "bfloat16" else torch.float32
    t = [torch.as_tensor(x) for x in (coeffs2, pr, pi, dr, di, w)] + [
        torch.as_tensor(comps).to(tdt)]
    losses, dcoeffs, dpr, dpi = fused.loss_and_grads_plain(*t)
    assert rel_err(losses, np.asarray(jl)) <= 1e-5
    if cotangent == "unit":
        for got, want in ((dcoeffs, want_dcoeffs), (dpr, want_dpr), (dpi, want_dpi)):
            assert rel_err(got, want) <= 1e-4
    leaves = [x.clone().requires_grad_(i < 3) for i, x in enumerate(t)]
    out = fused.fused_chunk_loss_batched(*leaves)
    grads = torch.autograd.grad(out, leaves[:3], grad_outputs=torch.as_tensor(gbar))
    assert rel_err(out, np.asarray(jl)) <= 1e-5
    for got, want in zip(grads, (want_dcoeffs, want_dpr, want_dpi)):
        assert rel_err(got, want) <= 1e-4


@pytest.mark.parametrize("case, want_mode", [
    ("no_grad_wanted", fused.LOSS_ONLY),
    ("grad_mode_off", fused.LOSS_ONLY),
    ("frozen_coefficients", fused.LOSS_DP),
    ("all_gradients", fused.LOSS_ALL),
])
def test_instance_choice(monkeypatch, case, want_mode):
    """A call that needs no gradient runs the loss-only instance; frozen
    coefficients (``freeze_model``) the gain-product instance; otherwise
    every gradient."""
    seen = []
    plain = fused.loss_and_grads_plain

    def spy(*args):
        seen.append(args[-1])
        return plain(*args)

    monkeypatch.setattr(fused, "_loss_and_grads", spy)
    t = [torch.as_tensor(x) for x in _batched_inputs(2, 3, 8, 4)]
    if case in ("grad_mode_off", "all_gradients"):
        for x in t[:3]:
            x.requires_grad_(True)
    elif case == "frozen_coefficients":
        t[1].requires_grad_(True)
        t[2].requires_grad_(True)
    if case == "grad_mode_off":
        with torch.no_grad():
            losses = fused.fused_chunk_loss_batched(*t)
    else:
        losses = fused.fused_chunk_loss_batched(*t)
    assert seen == [want_mode]
    assert losses.requires_grad == (want_mode != fused.LOSS_ONLY)
    if want_mode == fused.LOSS_DP:
        dpr, dpi = torch.autograd.grad(losses.sum(), t[1:3])
        _, _, want_dpr, want_dpi = plain(*[x.detach() for x in t])
        assert torch.equal(dpr, want_dpr) and torch.equal(dpi, want_dpi)
    plain_out = plain(*[x.detach() for x in t], want_mode)
    assert [x is None for x in plain_out[1:]] == {
        fused.LOSS_ONLY: [True, True, True], fused.LOSS_DP: [True, False, False],
        fused.LOSS_ALL: [False, False, False]}[want_mode]


def test_group_block_checkpoint_path_matches_jax():
    """``batched_chunk_losses`` over group blocks (views of the data cubes,
    each block under ``torch.utils.checkpoint``) against the JAX package's
    blocked loss, values and gradients."""
    rng = np.random.default_rng(6)
    nbatch, ng, nf, nv, nants = 3, 12, 40, 7, 6
    comps = rng.standard_normal((ng, 1, nf, nv)).astype(np.float32)
    a0 = rng.integers(0, nants, (ng, 1)).astype(np.int32)
    a1 = ((a0 + 1 + rng.integers(0, nants - 1, (ng, 1))) % nants).astype(np.int32)
    shape = (nbatch, ng, 1, nf)
    g_r = (1 + 0.1 * rng.standard_normal((nbatch, nants, nf))).astype(np.float32)
    g_i = (0.1 * rng.standard_normal((nbatch, nants, nf))).astype(np.float32)
    fr, fi = (rng.standard_normal((nbatch, ng, nv)).astype(np.float32) for _ in range(2))
    dr, di = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    w = np.abs(rng.standard_normal(shape)).astype(np.float32)

    def jfn(gr, gi, f_r, f_i):
        losses = jb.batched_chunk_losses(
            gr, gi, (f_r,), (f_i,), ((jnp.asarray(comps), jnp.asarray(a0), jnp.asarray(a1)),),
            (jnp.asarray(dr),), (jnp.asarray(di),), (jnp.asarray(w),), loss_block=4)
        return jnp.sum(losses * jnp.arange(1, nbatch + 1)), losses

    (_, jl), jg = jax.value_and_grad(jfn, argnums=(0, 1, 2, 3), has_aux=True)(
        *(jnp.asarray(x) for x in (g_r, g_i, fr, fi)))
    leaves = [torch.as_tensor(x).requires_grad_(True) for x in (g_r, g_i, fr, fi)]
    chunk = tuple(torch.as_tensor(x) for x in (comps, a0, a1))
    assert tloss._loss_block_size(ng, 1, 4) == 4  # three blocks of four groups
    tl = tb.batched_chunk_losses(leaves[0], leaves[1], [leaves[2]], [leaves[3]], (chunk,),
                                 [torch.as_tensor(dr)], [torch.as_tensor(di)],
                                 [torch.as_tensor(w)], loss_block=4)
    tg = torch.autograd.grad(torch.sum(tl * torch.arange(1, nbatch + 1)), leaves)
    assert rel_err(tl, jl) <= 1e-5
    for got, want in zip(tg, jg):
        assert rel_err(got, want) <= 1e-4
