"""The "sum" flux prior on both chunk-loss kernels against calamity_tpu.

``model_regularization="sum"`` (the default of the Python entry points)
adds to the chi-square the squared distance of each slice's weighted model
flux sums, M_r = sum(w * model_r) and M_i, from the sky model's. Its chunk
terms (chi-square, M_r, M_i) come from each kernel's "sum" forward
instance. Their gradients come, for a shared chunk, from the shared
kernel's "sum" backward instance at the three per-slice cotangents
(``ops.shared.shared_chunk_terms_batched``) and, for a dense chunk, from
the fused kernel's one-pass instance, which writes in the forward's read
of comps the pieces the gradients are made of, and the combine, which
forms them at the cotangents (``ops.fused.fused_chunk_terms_batched``). On
the CPU those instances are their plain versions, held here against the
JAX package on the same seeded numpy inputs:

- each plain instance against ``jax.vjp`` of the chunk terms, for dense,
  shared and shared-batched chunks (with padding groups), float32 and
  bfloat16 comps and weights, at random cotangents and at a chi-square
  cotangent of 0; the dense one-pass instances plus the combine also
  against the two-pass plain version (``SUM_DP``, ``SUM_ALL``), and near
  a fit, with the split TF32 emulation of their coefficient sums;
- the routed losses, ``ops.loss.chunked_loss_sum_regularized`` (serial)
  and ``parallel.batched.batched_chunk_losses_sum_regularized`` (blocked
  and not), against the JAX package's, value and gradients, and the mesh's
  objective (``_batched_step_fn`` under a one-rank shard) against the JAX
  package's gradient;
- the split TF32 emulation of the shared kernel's "sum" instances near a
  fit;
- a default ``calibrate_and_model_dpss`` fit: no B=1 float32 chunk takes
  the plain torch terms, and a "sum" fit warns of the chunks no kernel
  takes.

Tolerances: the chi-square rel 1e-5 per slice; M_r and M_i within 1e-5 of
sum(w |m|), the scale they are summed from (near a fit M - P is a small
difference of large sums, so the sums themselves are held, not only the
squared prior term); gradients rel 1e-4; the one-pass instances plus the
combine against the two-pass plain version (both float32 torch ops in
another order) rel 1e-5; a float32 fit's history rel 1e-4.
The kernel-against-plain tests need a CUDA card and are skipped without
one.
"""

import os
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import zero_plateau_fit_args
from test_torch_fit import _compare, _run_both, golden_problem  # noqa: F401  (a fixture)
from test_torch_shared_tf32 import _near_fit
from torch_parity import rel_err

from calamity_tpu.ops import loss as jloss
from calamity_tpu.parallel import batched as jb
from calamity_tpu_torch import LAUNCHES
from calamity_tpu_torch import calibration as tcal
from calamity_tpu_torch.convert import chunks_from_jax, to_tensor
from calamity_tpu_torch.ops import fused, shared
from calamity_tpu_torch.ops import loss as tloss
from calamity_tpu_torch.ops.gains import mark_valid
from calamity_tpu_torch.parallel import batched as tb
from calamity_tpu_torch.solver.fit import FitConfig
from calamity_tpu_torch.solver.fit import fit_gains_and_foregrounds as torch_fit

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
import hera_core_demo_torch as demo  # noqa: E402

NA, NF = 7, 40
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4
# (U operators, gmax groups an operator, V modes); U groups of one operator each: dense
KINDS = {"dense": (5, 1, 6), "shared": (1, 4, 6), "shared_batched": (3, 4, 5)}
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _problem(kind, nbatch, seed=0, nbls=1):
    """numpy inputs of one chunk: comps (U, B, F, V), indices (G, B), the
    record of the groups that hold a baseline (in the shared-batched chunk
    each class's last group is padding, with zero weight), gains (N, NA,
    F), coefficients (N, G, V), data and weights (N, G, B, F)."""
    nu, gmax, nv = KINDS[kind]
    ngrps = nu * gmax
    rng = np.random.default_rng(seed + 17 * nbatch + nu + 5 * nbls)
    comps = rng.standard_normal((nu, nbls, NF, nv))
    comps /= np.linalg.norm(comps, axis=2, keepdims=True)
    a0 = rng.integers(0, NA, (ngrps, nbls))
    a1 = (a0 + 1 + rng.integers(0, NA - 1, (ngrps, nbls))) % NA
    valid = np.ones((ngrps, nbls), bool)
    if kind == "shared_batched":
        valid[gmax - 1::gmax] = False
        a1[~valid] = a0[~valid]  # a padding row pairs an antenna with itself
    f32 = np.float32
    p = dict(comps=comps.astype(f32), a0=a0.astype(np.int32), a1=a1.astype(np.int32),
             valid=valid,
             g_r=(1 + 0.1 * rng.standard_normal((nbatch, NA, NF))).astype(f32),
             g_i=(0.1 * rng.standard_normal((nbatch, NA, NF))).astype(f32),
             fr=rng.standard_normal((nbatch, ngrps, nv)).astype(f32),
             fi=rng.standard_normal((nbatch, ngrps, nv)).astype(f32),
             dr=rng.standard_normal((nbatch, ngrps, nbls, NF)).astype(f32),
             di=rng.standard_normal((nbatch, ngrps, nbls, NF)).astype(f32))
    w = np.abs(rng.standard_normal((nbatch, ngrps, nbls, NF))) * valid[None, :, :, None]
    p["w"] = (w / w.sum()).astype(f32)
    return p


def _cotangents(nbatch, seed):
    """(3, N) cotangents of (chi-square, M_r, M_i): random, and the same
    with the chi-square's set to 0."""
    cot = np.random.default_rng(seed).standard_normal((3, nbatch)).astype(np.float32)
    zero = cot.copy()
    zero[0] = 0.0
    return {"random": cot, "gx=0": zero}


def _op_inputs(p, seed):
    """The op's operands as numpy float32: coeffs2 (2, N, G, V), pr, pi,
    dr, di, w (N, G, F), comps (U, F, V)."""
    rng = np.random.default_rng(seed)
    nb, ngrps = p["fr"].shape[:2]
    pr = (1 + 0.1 * rng.standard_normal((nb, ngrps, NF))).astype(np.float32)
    pi = (0.1 * rng.standard_normal((nb, ngrps, NF))).astype(np.float32)
    return [np.stack([p["fr"], p["fi"]]), pr, pi, p["dr"][:, :, 0], p["di"][:, :, 0],
            p["w"][:, :, 0], p["comps"][:, 0]]


def _jax_terms(ops, comps_dtype, wgts_dtype, cot):
    """(terms (3, N), (dcoeffs, dpr, dpi) at ``cot``, flux scale (2, N))
    from the JAX package: the chunk's model through ``fg_model_batched``
    (any layout), ``data_model``'s products, ``mse``'s and the flux sums
    under ``jax.vjp``."""
    coeffs2, pr, pi, dr, di, w, comps = (jnp.asarray(x) for x in ops)
    comps = comps.astype(comps_dtype)[:, None]
    wf = w.astype(wgts_dtype).astype(jnp.float32)

    def model(c2, p_r, p_i):
        vr, vi = jloss.fg_model_batched(c2[0], c2[1], comps)
        vr, vi = vr[:, :, 0], vi[:, :, 0]
        return p_r * vr + p_i * vi, -p_i * vr + p_r * vi

    def terms(c2, p_r, p_i):
        mr, mi = model(c2, p_r, p_i)
        return jnp.stack([jnp.sum((jnp.square(dr - mr) + jnp.square(di - mi)) * wf, axis=(1, 2)),
                          jnp.sum(mr * wf, axis=(1, 2)), jnp.sum(mi * wf, axis=(1, 2))])

    out, vjp = jax.vjp(terms, coeffs2, pr, pi)
    mr, mi = model(coeffs2, pr, pi)
    scale = jnp.stack([jnp.sum(jnp.abs(mr) * wf, axis=(1, 2)),
                       jnp.sum(jnp.abs(mi) * wf, axis=(1, 2))])
    return out, vjp(jnp.asarray(cot)), scale


def _assert_terms(got, want, scale):
    got, want, scale = (np.asarray(x, np.float64) for x in (got, want, scale))
    assert np.max(np.abs(got[0] - want[0]) / np.abs(want[0])) <= LOSS_TOL
    assert np.max(np.abs(got[1:] - want[1:]) / scale) <= LOSS_TOL


def _plain(kind):
    """The plain version of the kernel that takes ``kind``, as f(*ops,
    valid, mode, cot)."""
    if kind == "dense":
        return lambda *ops, valid, mode, cot=None: fused.loss_and_grads_plain(
            *ops, mode=mode, cot=cot)
    return lambda *ops, valid, mode, cot=None: shared.loss_and_grads_plain(
        *ops, valid, mode=mode, cot=cot)


# ---------------------------------------------------------------------- #
# the plain instances against the JAX package
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("wgts_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("comps_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nbatch", [1, 3])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_plain_sum_instances_match_jax_vjp(kind, nbatch, comps_dtype, wgts_dtype):
    """The "sum" forward's (chi-square, M_r, M_i) and the "sum" backward's
    gradients (with dpr/dpi only and with every gradient) at random
    cotangents and at a chi-square cotangent of 0, against ``jax.vjp`` of
    the chunk's terms; padding groups count zero."""
    p = _problem(kind, nbatch, seed=1)
    (tcd, jcd), (twd, jwd) = DTYPES[comps_dtype], DTYPES[wgts_dtype]
    ops = _op_inputs(p, seed=2)
    args = [torch.as_tensor(x) for x in ops]
    args[5] = args[5].to(twd)
    args[6] = args[6].to(tcd)
    valid = torch.as_tensor(p["valid"][:, 0])
    plain = _plain(kind)
    for cname, cot in _cotangents(nbatch, seed=3).items():
        want_terms, want_grads, scale = _jax_terms(ops, jcd, jwd, cot)
        got = plain(*args, valid=valid, mode=fused.SUM_FWD)
        assert got[0].shape == (3, nbatch) and all(g is None for g in got[1:])
        _assert_terms(got[0], want_terms, scale)
        for mode in (fused.SUM_DP, fused.SUM_ALL):
            got = plain(*args, valid=valid, mode=mode, cot=torch.as_tensor(cot))
            assert got[0] is None
            assert (got[1] is None) == (mode == fused.SUM_DP)
            for g, w in zip(got[1:], want_grads):
                if g is not None:
                    assert rel_err(g, w) <= GRAD_TOL, (cname, mode)


def test_sum_backward_at_unit_chi2_cotangent_is_the_loss_gradient():
    """At cotangents (1, 0, 0) the "sum" backward is the chi-square's own
    gradient instance (``LOSS_ALL``)."""
    p = _problem("shared_batched", 2, seed=4)
    args = [torch.as_tensor(x) for x in _op_inputs(p, seed=5)]
    valid = torch.as_tensor(p["valid"][:, 0])
    unit = torch.zeros((3, 2))
    unit[0] = 1.0
    got = shared.loss_and_grads_plain(*args, valid, fused.SUM_ALL, cot=unit)
    want = shared.loss_and_grads_plain(*args, valid, fused.LOSS_ALL)
    for g, w in zip(got[1:], want[1:]):
        assert rel_err(g, w) <= 1e-6


def test_backward_instances_need_their_cotangents():
    args = [torch.as_tensor(x) for x in _op_inputs(_problem("dense", 2), seed=6)]
    with pytest.raises(ValueError, match="cot"):
        fused.loss_and_grads_plain(*args, mode=fused.SUM_ALL)
    with pytest.raises(ValueError, match=r"float32 \(3, 2\)"):
        fused.loss_and_grads_plain(*args, mode=fused.SUM_DP, cot=torch.zeros((3, 3)))
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused.loss_and_grads_kernel(*args, mode=fused.SUM_FWD)


# ---------------------------------------------------------------------- #
# the dense kernel's one-pass instances and the combine
# ---------------------------------------------------------------------- #
# each one-pass instance and the two-pass "sum" backward it replaces
ONE_PASS = {"frozen_coefficients": (fused.SUM_FWD_DP, fused.SUM_DP),
            "all_gradients": (fused.SUM_FWD_ALL, fused.SUM_ALL)}
TWO_PASS_TOL = 1e-5


def _check_one_pass(args, cot_sets, want, one_pass=fused.loss_and_grads_plain, grad_tol=GRAD_TOL):
    """Each one-pass instance (``one_pass``: the plain version or its
    emulation) plus the plain combine against the two-pass plain version
    and against ``want[cname]`` = the JAX package's (terms, gradients,
    flux scale) at each set of cotangents."""
    nbatch, ngrps, nfreqs = args[1].shape
    nvecs = args[0].shape[-1]
    for case, (one, two) in ONE_PASS.items():
        got = one_pass(*args, mode=one)
        assert got[1] is None if one == fused.SUM_FWD_DP else \
            got[1].shape == (4, nbatch, ngrps, nvecs)
        assert got[2].shape == got[3].shape == (2, nbatch, ngrps, nfreqs)
        two_terms = fused.loss_and_grads_plain(*args, mode=fused.SUM_FWD)[0]
        assert rel_err(got[0], two_terms) <= TWO_PASS_TOL
        for cname, cot in cot_sets.items():
            want_terms, want_grads, scale = want[cname]
            _assert_terms(got[0], want_terms, scale)
            grads = fused.combine(*got[1:], torch.as_tensor(cot))
            ref = fused.loss_and_grads_plain(*args, mode=two, cot=torch.as_tensor(cot))[1:]
            for name, g, r, j in zip(("dcoeffs", "dpr", "dpi"), grads, ref, want_grads):
                assert (g is None) == (r is None) == (name == "dcoeffs" and case != "all_gradients")
                if g is not None:
                    assert rel_err(g, r) <= TWO_PASS_TOL, (case, cname, name)
                    assert rel_err(g, j) <= grad_tol, (case, cname, name)


@pytest.mark.parametrize("wgts_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("comps_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nbatch", [1, 3])
def test_one_pass_plain_and_combine_match_two_pass_and_jax(nbatch, comps_dtype, wgts_dtype):
    """The dense kernel's one-pass instances (frozen coefficients: the
    pieces of dpr/dpi; every gradient: also the four coefficient sets),
    plain version, plus the plain combine at random cotangents and at a
    chi-square cotangent of 0: the terms equal the "sum" forward's, the
    gradients the two-pass "sum" backward's (rel 1e-5), and both match
    ``jax.vjp`` of the chunk terms."""
    p = _problem("dense", nbatch, seed=12)
    (tcd, jcd), (twd, jwd) = DTYPES[comps_dtype], DTYPES[wgts_dtype]
    ops = _op_inputs(p, seed=13)
    args = [torch.as_tensor(x) for x in ops]
    args[5] = args[5].to(twd)
    args[6] = args[6].to(tcd)
    cots = _cotangents(nbatch, seed=14)
    _check_one_pass(args, cots, {c: _jax_terms(ops, jcd, jwd, cot) for c, cot in cots.items()})


def _dense_near_fit(nbatch, comps_dtype, seed, noise=1e-2):
    """numpy operands of a dense chunk near a fit: the data the model of
    the coefficients (with comps as rounded to ``comps_dtype``) plus
    ``noise`` of its rms, the coefficients then moved by a tenth of that;
    and the (3, N) cotangents the "sum" prior gives there, (1, 2 (M_r -
    P_r), 2 (M_i - P_i)) with the priors P within 1e-3 of the model's flux
    sums M: the flux terms' cotangents are small against the chi-square's,
    and M - P a small difference of large sums."""
    p = _problem("dense", nbatch, seed=seed)
    ops = _op_inputs(p, seed=seed + 1)
    coeffs2, pr, pi, _, _, w, comps = (x.astype(np.float64) for x in ops)
    comps = torch.as_tensor(comps.astype(np.float32)).to(comps_dtype).double().numpy()
    v = np.einsum("gfv,kngv->kngf", comps, coeffs2)
    mr, mi = pr * v[0] + pi * v[1], -pi * v[0] + pr * v[1]
    rng = np.random.default_rng(seed + 2)
    scale = np.sqrt(np.mean(mr ** 2 + mi ** 2))
    dr = mr + noise * scale * rng.standard_normal(mr.shape)
    di = mi + noise * scale * rng.standard_normal(mi.shape)
    coeffs2 = coeffs2 + 0.1 * noise * rng.standard_normal(coeffs2.shape)
    flux = np.stack([np.sum(w * mr, axis=(1, 2)), np.sum(w * mi, axis=(1, 2))])
    cot = np.concatenate([np.ones((1, nbatch)), 2e-3 * flux])
    out = [x.astype(np.float32) for x in (coeffs2, pr, pi, dr, di, w)] + [ops[6]]
    return out, cot.astype(np.float32)


@pytest.mark.parametrize("comps_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nbatch", [1, 3])
def test_one_pass_near_a_fit_matches_jax(nbatch, comps_dtype):
    """Near a fit, at the cotangents the "sum" prior gives there: the
    one-pass instances' plain version and the emulation of their split
    TF32 coefficient sums (``ops.fused.loss_and_grads_tf32``, as the kernel
    forms them on the tensor cores), each plus the combine, against the
    two-pass plain version and ``jax.vjp`` (terms rel 1e-5, M within 1e-5
    of sum w |m|, gradients rel 1e-4)."""
    tcd, jcd = DTYPES[comps_dtype]
    ops, cot = _dense_near_fit(nbatch, tcd, seed=15)
    args = [torch.as_tensor(x) for x in ops]
    args[6] = args[6].to(tcd)
    want = {"near_fit": _jax_terms(ops, jcd, jnp.float32, cot)}
    for one_pass in (fused.loss_and_grads_plain, fused.loss_and_grads_tf32):
        _check_one_pass(args, {"near_fit": cot}, want, one_pass)


def test_combine_takes_its_cotangents():
    """The combine's cotangents are (3, N) float32 on the pieces' device;
    its kernel takes CUDA tensors only."""
    args = [torch.as_tensor(x) for x in _op_inputs(_problem("dense", 2), seed=16)]
    _, dcoeffs, dpr, dpi = fused.loss_and_grads_plain(*args, mode=fused.SUM_FWD_ALL)
    with pytest.raises(ValueError, match=r"float32 \(3, 2\)"):
        fused.combine(dcoeffs, dpr, dpi, torch.zeros((3, 3)))
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused.combine_kernel(dcoeffs, dpr, dpi, torch.zeros((3, 2)))
    with pytest.raises(ValueError, match="no instance sum_all"):
        fused.loss_and_grads_kernel(*args, mode=fused.SUM_ALL)


# ---------------------------------------------------------------------- #
# the autograd Functions
# ---------------------------------------------------------------------- #
def _spy_combine(monkeypatch):
    """Record every combine of ``ops.fused`` (whether it had coefficient
    pieces)."""
    calls = []
    real = fused.combine

    def spy(dcoeffs, *args):
        calls.append(dcoeffs is not None)
        return real(dcoeffs, *args)

    monkeypatch.setattr(fused, "combine", spy)
    return calls


def _spy(monkeypatch, module):
    """Record the mode of every pass of ``module``'s op (``ops.fused`` or
    ``ops.shared``)."""
    calls = []
    real = module._loss_and_grads
    at = 8 if module is shared else 7  # the mode's place: after the operands (and the mask)

    def spy(*args, **kw):
        calls.append(kw["mode"] if "mode" in kw else args[at])
        return real(*args, **kw)

    monkeypatch.setattr(module, "_loss_and_grads", spy)
    return calls


# the passes of each kind, and the combines of the dense kind
@pytest.mark.parametrize("case, want_modes", [
    ("no_grad_wanted", {"dense": ([fused.SUM_FWD], 0), "shared_batched": [fused.SUM_FWD]}),
    ("frozen_coefficients", {"dense": ([fused.SUM_FWD_DP], 1),
                             "shared_batched": [fused.SUM_FWD, fused.SUM_DP]}),
    ("all_gradients", {"dense": ([fused.SUM_FWD_ALL], 1),
                       "shared_batched": [fused.SUM_FWD, fused.SUM_ALL]}),
])
@pytest.mark.parametrize("kind", ["dense", "shared_batched"])
def test_terms_function_runs_the_forward_then_the_backward_instance(monkeypatch, kind, case,
                                                                    want_modes):
    """Shared kernel: the forward runs the "sum" forward instance, the
    backward the "sum" backward instance, with dpr/dpi only where the
    coefficients are frozen. Dense kernel: where a gradient is wanted, one
    pass, the one-pass instance (the pieces of dpr/dpi only where the
    coefficients are frozen), and in the backward one combine; no second
    pass. With no gradient wanted only the "sum" forward runs. The
    gradients equal the plain terms' under autograd."""
    module = fused if kind == "dense" else shared
    p = _problem(kind, 2, seed=7)
    args = [torch.as_tensor(x) for x in _op_inputs(p, seed=8)]
    extra = () if kind == "dense" else (torch.as_tensor(p["valid"][:, 0]),)
    want_grad = {"no_grad_wanted": (), "frozen_coefficients": (1, 2),
                 "all_gradients": (0, 1, 2)}[case]
    ref = [a.clone().requires_grad_(i in want_grad) for i, a in enumerate(args)]
    ref_terms = module.loss_and_grads_plain(*ref, *extra, mode=fused.SUM_FWD)[0]
    calls = _spy(monkeypatch, module)
    combines = _spy_combine(monkeypatch)
    for i in want_grad:
        args[i].requires_grad_(True)
    fn = (fused.fused_chunk_terms_batched if kind == "dense"
          else shared.shared_chunk_terms_batched)
    terms = fn(*args, *extra)
    assert torch.equal(terms.detach(), ref_terms.detach())
    cot = torch.as_tensor(_cotangents(2, seed=9)["random"])
    if want_grad:
        got = torch.autograd.grad(torch.sum(terms * cot), [args[i] for i in want_grad])
        want = torch.autograd.grad(torch.sum(ref_terms * cot), [ref[i] for i in want_grad])
        for g, w in zip(got, want):
            assert rel_err(g, w) <= 1e-6
    want_modes, want_combines = want_modes[kind] if kind == "dense" else (want_modes[kind], 0)
    assert calls == want_modes
    assert len(combines) == want_combines


def test_cpu_terms_launch_no_kernel():
    LAUNCHES.reset()
    args = [torch.as_tensor(x).requires_grad_(i < 3)
            for i, x in enumerate(_op_inputs(_problem("dense", 2), seed=10))]
    torch.sum(fused.fused_chunk_terms_batched(*args)).backward()
    assert LAUNCHES.get(fused.KERNEL_NAME) == 0


# ---------------------------------------------------------------------- #
# the routed losses against the JAX package
# ---------------------------------------------------------------------- #
# the chunks of one problem: dense, shared, shared-batched (B = 1: the
# kernels), and a dense chunk of two baselines a group (the torch ops)
CHUNKS = (("dense", 1), ("shared", 1), ("shared_batched", 1), ("dense", 2))


def _chunks(nbatch, seed):
    return [_problem(kind, nbatch, seed=seed + i, nbls=nbls)
            for i, (kind, nbls) in enumerate(CHUNKS)]


def _shared_gains(ps):
    """One set of gains for every chunk (the first chunk's)."""
    return ps[0]["g_r"], ps[0]["g_i"]


def _jax_chunks(ps, cdt=jnp.float32):
    return tuple((jnp.asarray(p["comps"]).astype(cdt), jnp.asarray(p["a0"]),
                  jnp.asarray(p["a1"])) for p in ps)


def _torch_chunks(ps, cdt=torch.float32):
    out = []
    for p in ps:
        a0 = torch.as_tensor(p["a0"])
        if not p["valid"].all():
            mark_valid(a0, p["valid"])  # as the packing records it
        out.append((torch.as_tensor(p["comps"]).to(cdt), a0, torch.as_tensor(p["a1"])))
    return tuple(out)


def _priors(ps, g_r, g_i, offset=0.05):
    """Per-slice prior sums near the model's flux sums, (N,) each: the
    prior term is a small difference of large sums, as near a fit."""
    jg_r, jg_i = jnp.asarray(g_r), jnp.asarray(g_i)
    pr, pi = [], []
    for n in range(g_r.shape[0]):
        mr = mi = 0.0
        for c, p in zip(_jax_chunks(ps), ps):
            model_r, model_i = jloss.data_model(jg_r[n], jg_i[n], jnp.asarray(p["fr"][n]),
                                                jnp.asarray(p["fi"][n]), *c)
            mr += float(jnp.sum(model_r * p["w"][n]))
            mi += float(jnp.sum(model_i * p["w"][n]))
        pr.append(mr * (1 + offset) + offset)
        pi.append(mi * (1 - offset) - offset)
    return np.asarray(pr, np.float32), np.asarray(pi, np.float32)


@pytest.mark.parametrize("comps_dtype", ["float32", "bfloat16"])
def test_serial_sum_loss_matches_jax(comps_dtype, monkeypatch):
    """One slice through ``chunked_loss_sum_regularized`` (the serial path)
    against the JAX package's under ``jax.value_and_grad``: each B=1 chunk
    through its kernel's "sum" forward and backward instances, the B=2
    chunk through the torch ops."""
    ps = _chunks(1, seed=20)
    tcd, jcd = DTYPES[comps_dtype]
    g_r, g_i = _shared_gains(ps)
    prior_r, prior_i = _priors(ps, g_r, g_i)
    modes = {m: _spy(monkeypatch, m) for m in (fused, shared)}

    def jfn(gr, gi, fr, fi):
        return jloss.chunked_loss_sum_regularized(
            gr, gi, fr, fi, _jax_chunks(ps, jcd), tuple(jnp.asarray(p["dr"][0]) for p in ps),
            tuple(jnp.asarray(p["di"][0]) for p in ps), tuple(jnp.asarray(p["w"][0]) for p in ps),
            jnp.asarray(prior_r[0]), jnp.asarray(prior_i[0]))

    jval, jgrad = jax.value_and_grad(jfn, argnums=(0, 1, 2, 3))(
        jnp.asarray(g_r[0]), jnp.asarray(g_i[0]), tuple(jnp.asarray(p["fr"][0]) for p in ps),
        tuple(jnp.asarray(p["fi"][0]) for p in ps))
    gr = torch.as_tensor(g_r[0]).requires_grad_(True)
    gi = torch.as_tensor(g_i[0]).requires_grad_(True)
    fr = [torch.as_tensor(p["fr"][0]).requires_grad_(True) for p in ps]
    fi = [torch.as_tensor(p["fi"][0]).requires_grad_(True) for p in ps]
    tval = tloss.chunked_loss_sum_regularized(
        gr, gi, fr, fi, _torch_chunks(ps, tcd), [torch.as_tensor(p["dr"][0]) for p in ps],
        [torch.as_tensor(p["di"][0]) for p in ps], [torch.as_tensor(p["w"][0]) for p in ps],
        torch.as_tensor(prior_r[0]), torch.as_tensor(prior_i[0]))
    tgrad = torch.autograd.grad(tval, [gr, gi] + fr + fi)
    assert modes[fused] == [fused.SUM_FWD_ALL]
    assert modes[shared] == [fused.SUM_FWD] * 2 + [fused.SUM_ALL] * 2
    assert rel_err(tval, jval) <= LOSS_TOL
    jflat = [jgrad[0], jgrad[1]] + list(jgrad[2]) + list(jgrad[3])
    for got, want in zip(tgrad, jflat):
        assert rel_err(got, want) <= GRAD_TOL


def _batched_inputs(ps, cdt=torch.float32):
    g_r, g_i = _shared_gains(ps)
    leaves = ([torch.as_tensor(g_r).requires_grad_(True), torch.as_tensor(g_i).requires_grad_(True)]
              + [torch.as_tensor(p[k]).requires_grad_(True) for k in ("fr", "fi") for p in ps])
    n = len(ps)
    return leaves, (leaves[0], leaves[1], leaves[2:2 + n], leaves[2 + n:], _torch_chunks(ps, cdt),
                    [torch.as_tensor(p["dr"]) for p in ps], [torch.as_tensor(p["di"]) for p in ps],
                    [torch.as_tensor(p["w"]) for p in ps])


def _jax_batched(ps, prior_r, prior_i, cot, loss_block=None, cdt=jnp.float32):
    g_r, g_i = _shared_gains(ps)

    def fn(gr, gi, fr, fi):
        losses = jb.batched_chunk_losses_sum_regularized(
            gr, gi, fr, fi, _jax_chunks(ps, cdt), tuple(jnp.asarray(p["dr"]) for p in ps),
            tuple(jnp.asarray(p["di"]) for p in ps), tuple(jnp.asarray(p["w"]) for p in ps),
            jnp.asarray(prior_r), jnp.asarray(prior_i), loss_block=loss_block)
        return jnp.sum(losses * cot), losses

    (_, losses), grads = jax.value_and_grad(fn, argnums=(0, 1, 2, 3), has_aux=True)(
        jnp.asarray(g_r), jnp.asarray(g_i), tuple(jnp.asarray(p["fr"]) for p in ps),
        tuple(jnp.asarray(p["fi"]) for p in ps))
    return losses, [grads[0], grads[1]] + list(grads[2]) + list(grads[3])


@pytest.mark.parametrize("loss_block", [None, 2])
@pytest.mark.parametrize("comps_dtype", ["float32", "bfloat16"])
def test_batched_sum_losses_match_jax(comps_dtype, loss_block, monkeypatch):
    """Three slices through ``batched_chunk_losses_sum_regularized`` (the
    time-parallel path; with ``loss_block`` 2 each chunk in group blocks,
    checkpointed, three terms a block) against the JAX package's, at a
    different cotangent per slice."""
    ps = _chunks(3, seed=30)
    tcd, jcd = DTYPES[comps_dtype]
    prior_r, prior_i = _priors(ps, *_shared_gains(ps))
    cot = np.arange(1, 4, dtype=np.float32)
    modes = {m: _spy(monkeypatch, m) for m in (fused, shared)}
    sums = []
    real_sum_terms = tloss._sum_terms
    monkeypatch.setattr(tloss, "_sum_terms",
                        lambda *a: sums.append(a[7].shape) or real_sum_terms(*a))
    jl, jg = _jax_batched(ps, prior_r, prior_i, cot, loss_block, jcd)
    leaves, args = _batched_inputs(ps, tcd)
    tl = tb.batched_chunk_losses_sum_regularized(*args, torch.as_tensor(prior_r),
                                                 torch.as_tensor(prior_i), loss_block=loss_block)
    tg = torch.autograd.grad(torch.sum(tl * torch.as_tensor(cot)), leaves)
    # the dense chunk: one pass (recomputed per block under the blocks' checkpoint)
    assert set(modes[fused]) == {fused.SUM_FWD_ALL}
    assert set(modes[shared]) == {fused.SUM_FWD, fused.SUM_ALL}
    assert sums and all(s[1] == 2 for s in sums)  # only the B=2 chunk took the torch ops
    assert rel_err(tl, jl) <= LOSS_TOL
    for got, want in zip(tg, jg):
        assert rel_err(got, want) <= GRAD_TOL


class _OneRank:
    """The mesh's reductions in a world of one: a value, no graph."""

    @staticmethod
    def sum_bl(t):
        return t.detach()


class _Recorder:
    """An optimizer that keeps the gradients it is given and moves nothing."""

    def update(self, grads, state, params):
        self.grads = grads
        return params, state


def test_mesh_objective_matches_jax_gradient(monkeypatch):
    """The mesh's "sum" objective (``_batched_step_fn`` with a shard:
    total + 2 (M_r - P_r) M_r + 2 (M_i - P_i) M_i, the flux sums' cotangents
    constants) through the kernels' instances, in a world of one, against
    the JAX package's gradient of the per-slice losses, and its losses."""
    ps = _chunks(2, seed=40)
    prior_r, prior_i = _priors(ps, *_shared_gains(ps))
    rec = _Recorder()
    monkeypatch.setattr(tb, "_optimizer", lambda cfg, shard: rec)
    modes = {m: _spy(monkeypatch, m) for m in (fused, shared)}
    leaves, (g_r, g_i, fr, fi, chunks, dr, di, w) = _batched_inputs(ps)
    cfg = FitConfig(regularization="sum")
    _, one_step = tb._batched_step_fn(cfg, chunks, dr, di, w, fr, fi, torch.as_tensor(prior_r),
                                      torch.as_tensor(prior_i), shard=_OneRank())
    params = {"g_r": g_r.detach(), "g_i": g_i.detach(), "fg_r": [x.detach() for x in fr],
              "fg_i": [x.detach() for x in fi]}
    losses, _, _ = one_step(params, None)
    jl, jg = _jax_batched(ps, prior_r, prior_i, np.ones(2, np.float32))
    assert set(modes[fused]) == {fused.SUM_FWD_ALL}
    assert set(modes[shared]) == {fused.SUM_FWD, fused.SUM_ALL}
    assert rel_err(losses, jl) <= LOSS_TOL
    got = [rec.grads["g_r"], rec.grads["g_i"]] + list(rec.grads["fg_r"]) + list(rec.grads["fg_i"])
    for g, want in zip(got, jg):
        assert rel_err(g, want) <= GRAD_TOL


def test_sum_fit_float32_matches_jax(golden_problem):  # noqa: F811
    """A float32 "sum" fit of the golden Golomb slice (dense B=1 chunks:
    the fused kernel's "sum" instances), 25 steps, against the JAX
    package's: histories and final parameters rel 1e-4."""
    jres, tres = _run_both(golden_problem["float32"], maxsteps=25, tol=0.0, learning_rate=1e-2,
                           comps_precision="float32", model_regularization="sum")
    assert len(tres[4]["loss"]) == 25
    _compare(jres, tres, 1e-4)


# ---------------------------------------------------------------------- #
# the split TF32 emulation near a fit
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("comps_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nbatch", [1, 3])
@pytest.mark.parametrize("kind", ["shared", "shared_batched"])
def test_tf32_emulation_of_sum_instances_near_a_fit(kind, nbatch, comps_dtype):
    """``ops.shared.loss_and_grads_tf32``'s "sum" instances (the products
    as the kernel forms them on the tensor cores) against the JAX
    package's terms and gradients at ``Precision.HIGHEST``, on inputs near
    a fit (data the model plus 1% noise), where a rounding of the model
    shows in the chi-square."""
    tcd, jcd = DTYPES[comps_dtype]
    ops = _near_fit(kind, nbatch, tcd, seed=50)
    args = [torch.as_tensor(x) for x in ops]
    args[6] = args[6].to(tcd)
    valid = args[5].sum(dim=(0, 2)) > 0
    for cname, cot in _cotangents(nbatch, seed=51).items():
        want_terms, want_grads, scale = _jax_terms(ops, jcd, jnp.float32, cot)
        got = shared.loss_and_grads_tf32(*args, valid, mode=fused.SUM_FWD)
        _assert_terms(got[0], want_terms, scale)
        got = shared.loss_and_grads_tf32(*args, valid, mode=fused.SUM_ALL,
                                         cot=torch.as_tensor(cot))
        for g, w in zip(got[1:], want_grads):
            assert rel_err(g, w) <= GRAD_TOL, cname


# ---------------------------------------------------------------------- #
# the default entry point
# ---------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def cut_core():
    return demo.build(nside=5, nfreqs=64)


@pytest.mark.parametrize("time_parallel", [False, True])
@pytest.mark.parametrize("shared_basis", [True, False])
def test_default_fit_takes_no_plain_terms(cut_core, monkeypatch, shared_basis, time_parallel):
    """``calibrate_and_model_dpss`` with its defaults (the "sum" prior) on
    the HERA core at cut size (25 antennas, 64 channels; shared chunks, or
    with ``shared_basis=False`` dense ones), serial and time-parallel: no
    B=1 float32 chunk reaches the torch terms (``ops.loss._sum_terms`` or
    its plain model ``_chunk_model``, which the serial and the batched
    losses share), every step runs the shared
    kernel's "sum" forward and backward instances or the dense kernel's
    one-pass instance and a combine, and no chunk is named as a
    fallback."""
    corrupted, comps, _ = cut_core

    def refuse(*args, **kw):
        raise AssertionError("a B=1 float32 chunk took the plain torch terms")

    monkeypatch.setattr(tloss, "_sum_terms", refuse)
    monkeypatch.setattr(tloss, "_chunk_model", refuse)
    modes = {m: _spy(monkeypatch, m) for m in (fused, shared)}
    combines = _spy_combine(monkeypatch)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        _, _, _, info = tcal.calibrate_and_model_dpss(
            uvdata=corrupted, fg_model_comps_dict=comps, maxsteps=10, tol=0.0,
            comps_precision="float32", nvec_bucketing=True, shared_basis=shared_basis,
            time_parallel=time_parallel, device="cpu")
    assert not [w for w in caught if "plain torch loss" in str(w.message)]
    calls = modes[shared] if shared_basis else modes[fused]
    grad_mode = fused.SUM_ALL if shared_basis else fused.SUM_FWD_ALL
    assert calls.count(grad_mode) >= 10
    assert not (modes[fused] if shared_basis else modes[shared])
    if shared_basis:
        assert calls.count(fused.SUM_FWD) >= 10 and not combines
    else:  # one pass a chunk and step; the "sum" forward alone only where no gradient is wanted
        assert combines.count(True) == calls.count(fused.SUM_FWD_ALL)
    assert set(calls) <= {fused.SUM_FWD, grad_mode}
    hist = info[0][next(iter(info[0]))] if time_parallel else info[0][0]
    assert np.all(np.isfinite(hist["loss"]))


def test_sum_fit_warns_of_a_float64_chunk():
    """A "sum" fit names the chunks no kernel takes, as every other fit
    does: here a float64 one."""
    chunks, data_r, data_i, wgts, g_r, g_i, fg = zero_plateau_fit_args()

    def conv(xs):
        return [to_tensor(x, "cpu") for x in xs]

    with pytest.warns(UserWarning, match="chunk 0: comps dtype torch.float64"):
        torch_fit(to_tensor(g_r, "cpu"), to_tensor(g_i, "cpu"), conv(fg), conv(fg),
                  conv(data_r), conv(data_i), conv(wgts), chunks_from_jax(chunks, "cpu"),
                  maxsteps=2, tol=0.0, model_regularization="sum", sky_model_r=conv(data_r),
                  sky_model_i=conv(data_i))


# ---------------------------------------------------------------------- #
# on the card
# ---------------------------------------------------------------------- #
def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("comps_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nbatch", [1, 3, 9])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_cuda_sum_instances_match_plain(kind, nbatch, comps_dtype):
    """Each "sum" instance of the kernel that takes ``kind`` against its
    plain version, two launches equal to the bit; for the dense kernel its
    one-pass instances' pieces and, at each set of cotangents, the combine
    of the kernel's pieces against the two-pass plain gradients."""
    dev = _cuda()
    module = fused if kind == "dense" else shared
    p = _problem(kind, nbatch, seed=60)
    args = [torch.as_tensor(x, device=dev) for x in _op_inputs(p, seed=61)]
    args[6] = args[6].to(comps_dtype)
    extra = () if kind == "dense" else (torch.as_tensor(p["valid"][:, 0], device=dev),)

    def twice(fn, *a, **kw):
        got, again = fn(*a, **kw), fn(*a, **kw)
        for g, x in zip(got, again):
            assert (g is None and x is None) or torch.equal(g, x)
        return got

    got = twice(module.loss_and_grads_kernel, *args, *extra, mode=fused.SUM_FWD)
    want = module.loss_and_grads_plain(*args, *extra, mode=fused.SUM_FWD)
    assert rel_err(got[0][0], want[0][0]) <= LOSS_TOL
    cots = [torch.as_tensor(c, device=dev) for c in _cotangents(nbatch, seed=62).values()]
    if kind == "dense":
        for one, two in ONE_PASS.values():
            got = twice(fused.loss_and_grads_kernel, *args, mode=one)
            want = fused.loss_and_grads_plain(*args, mode=one)
            assert rel_err(got[0][0], want[0][0]) <= LOSS_TOL
            for g, w in zip(got[1:], want[1:]):
                assert (g is None) == (w is None)
                if w is not None:
                    assert rel_err(g, w) <= GRAD_TOL
            for cot in cots:
                grads = twice(fused.combine_kernel, *got[1:], cot)
                ref = fused.loss_and_grads_plain(*args, mode=two, cot=cot)[1:]
                for g, w in zip(grads, ref):
                    assert (g is None) == (w is None)
                    if w is not None:
                        assert rel_err(g, w) <= GRAD_TOL
        return
    for cot in cots:
        for mode in (fused.SUM_DP, fused.SUM_ALL):
            got = twice(module.loss_and_grads_kernel, *args, *extra, mode=mode, cot=cot)
            want = module.loss_and_grads_plain(*args, *extra, mode=mode, cot=cot)
            for g, w in zip(got[1:], want[1:]):
                assert (g is None) == (w is None)
                if w is not None:
                    assert rel_err(g, w) <= GRAD_TOL
