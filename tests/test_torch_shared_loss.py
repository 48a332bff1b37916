"""The port's shared-basis chunk loss against calamity_tpu.

A shared chunk (one operator for every group, U = 1) and a shared-batched
chunk (U = 3 operators of gmax = 4 groups each, class-major) go through
``calamity_tpu_torch.ops.shared`` on the CPU, which runs the kernel's
plain version, and through the JAX package's XLA path (``chunked_loss``,
``batched_chunk_losses`` and the shared branches of ``fg_model_batched``
under ``jax.grad``), with the same seeded numpy inputs in explicit float32
or bfloat16. Padding groups (the packing's record of the groups that hold
no baseline) carry zero weight, as the packing gives them. Tolerances:
loss rel 1e-5, gradients rel 1e-4, float32 and bfloat16 comps and weights
alike (both packages round comps and weights to the same bfloat16 values
and accumulate in float32; only the order of the float32 sums differs).
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
from torch_parity import rel_err

from calamity_tpu.ops import loss as jloss
from calamity_tpu.parallel import batched as jb
from calamity_tpu_torch import LAUNCHES
from calamity_tpu_torch.ops import fused, shared
from calamity_tpu_torch.ops import loss as tloss
from calamity_tpu_torch.ops.gains import carry_valid, mark_valid
from calamity_tpu_torch.parallel import batched as tb

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402
import hera_core_demo_torch as demo  # noqa: E402

NA, NF = 7, 40
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4
KINDS = {"shared": (1, 4, 6), "shared_batched": (3, 4, 5)}  # (U, gmax, V)
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _problem(kind, nbatch, seed=0, plane=False):
    """numpy inputs of one chunk: comps (U, 1, F, V), indices (G, 1), the
    record of the groups that hold a baseline (in the shared-batched chunk
    the last group of each class is padding, with zero weight), gains
    (N, NA, F), coefficients (N, G, V), data and weights (N, G, 1, F); with
    ``plane`` the weights are one (N, G, 1, 1) plane."""
    nu, gmax, nv = KINDS[kind]
    ngrps = nu * gmax
    rng = np.random.default_rng(seed + 17 * nbatch + nu)
    comps = rng.standard_normal((nu, 1, NF, nv))
    comps /= np.linalg.norm(comps, axis=2, keepdims=True)
    a0 = rng.integers(0, NA, (ngrps, 1))
    a1 = (a0 + 1 + rng.integers(0, NA - 1, (ngrps, 1))) % NA
    valid = np.ones((ngrps, 1), bool)
    if nu > 1:
        valid[gmax - 1::gmax] = False
        a1[~valid] = a0[~valid]  # a padding row pairs an antenna with itself
    f32 = np.float32
    p = dict(comps=comps.astype(f32), a0=a0.astype(np.int32), a1=a1.astype(np.int32),
             valid=valid,
             g_r=(1 + 0.1 * rng.standard_normal((nbatch, NA, NF))).astype(f32),
             g_i=(0.1 * rng.standard_normal((nbatch, NA, NF))).astype(f32),
             fr=rng.standard_normal((nbatch, ngrps, nv)).astype(f32),
             fi=rng.standard_normal((nbatch, ngrps, nv)).astype(f32),
             dr=rng.standard_normal((nbatch, ngrps, 1, NF)).astype(f32),
             di=rng.standard_normal((nbatch, ngrps, 1, NF)).astype(f32))
    w = np.abs(rng.standard_normal((nbatch, ngrps, 1, 1 if plane else NF)))
    w *= valid[None, :, :, None]
    p["w"] = (w / w.sum()).astype(f32)
    return p


def _jax_chunks(p, cdt):
    return ((jnp.asarray(p["comps"]).astype(cdt), jnp.asarray(p["a0"]), jnp.asarray(p["a1"])),)


def _torch_chunk(p, cdt):
    a0 = torch.as_tensor(p["a0"])
    mark_valid(a0, p["valid"])  # as the packing records it
    return (torch.as_tensor(p["comps"]).to(cdt), a0, torch.as_tensor(p["a1"]))


def _jax_batched(p, cdt, wdt, cot, loss_block=None):
    def fn(g_r, g_i, fr, fi):
        losses = jb.batched_chunk_losses(
            g_r, g_i, (fr,), (fi,), _jax_chunks(p, cdt), (jnp.asarray(p["dr"]),),
            (jnp.asarray(p["di"]),), (jnp.asarray(p["w"]).astype(wdt),), loss_block=loss_block)
        return jnp.sum(losses * cot), losses

    (_, losses), grads = jax.value_and_grad(fn, argnums=(0, 1, 2, 3), has_aux=True)(
        *(jnp.asarray(p[k]) for k in ("g_r", "g_i", "fr", "fi")))
    return losses, grads


def _torch_batched(p, cdt, wdt, cot, loss_block=None):
    leaves = [torch.as_tensor(p[k]).requires_grad_(True) for k in ("g_r", "g_i", "fr", "fi")]
    losses = tb.batched_chunk_losses(
        leaves[0], leaves[1], [leaves[2]], [leaves[3]], (_torch_chunk(p, cdt),),
        [torch.as_tensor(p["dr"])], [torch.as_tensor(p["di"])],
        [torch.as_tensor(p["w"]).to(wdt)], loss_block=loss_block)
    grads = torch.autograd.grad(torch.sum(losses * torch.as_tensor(np.asarray(cot))), leaves)
    return losses, grads


def _spy(monkeypatch):
    """Record the (U, G) of every call of the shared op's pass."""
    calls = []
    real = shared._loss_and_grads

    def spy(coeffs2, pr, pi, dr, di, w, comps3, valid, mode):
        calls.append((comps3.shape[0], coeffs2.shape[2], mode))
        return real(coeffs2, pr, pi, dr, di, w, comps3, valid, mode)

    monkeypatch.setattr(shared, "_loss_and_grads", spy)
    return calls


# ---------------------------------------------------------------------- #
# the plain version against the JAX package
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("wgts_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("comps_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_serial_chunked_loss_matches_jax(kind, comps_dtype, wgts_dtype, monkeypatch):
    """One slice through ``ops.loss.chunked_loss`` (the serial path) against
    the JAX package's ``chunked_loss`` under ``jax.value_and_grad``."""
    p = _problem(kind, 1)
    (tcd, jcd), (twd, jwd) = DTYPES[comps_dtype], DTYPES[wgts_dtype]
    calls = _spy(monkeypatch)

    def jfn(g_r, g_i, fr, fi):
        return jloss.chunked_loss(g_r, g_i, (fr,), (fi,), _jax_chunks(p, jcd),
                                  (jnp.asarray(p["dr"][0]),), (jnp.asarray(p["di"][0]),),
                                  (jnp.asarray(p["w"][0]).astype(jwd),))

    jval, jgrad = jax.value_and_grad(jfn, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(p[k][0]) for k in ("g_r", "g_i", "fr", "fi")))
    leaves = [torch.as_tensor(p[k][0]).requires_grad_(True) for k in ("g_r", "g_i", "fr", "fi")]
    tval = tloss.chunked_loss(leaves[0], leaves[1], [leaves[2]], [leaves[3]],
                              (_torch_chunk(p, tcd),), [torch.as_tensor(p["dr"][0])],
                              [torch.as_tensor(p["di"][0])],
                              [torch.as_tensor(p["w"][0]).to(twd)])
    tgrad = torch.autograd.grad(tval, leaves)
    assert calls == [(KINDS[kind][0], KINDS[kind][0] * KINDS[kind][1], fused.LOSS_ALL)]
    assert rel_err(tval, jval) <= LOSS_TOL
    for got, want in zip(tgrad, jgrad):
        assert rel_err(got, want) <= GRAD_TOL


@pytest.mark.parametrize("comps_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nbatch", [1, 3])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_batched_losses_match_jax(kind, nbatch, comps_dtype, monkeypatch):
    """N slices through ``batched_chunk_losses`` (the time-parallel path)
    against the JAX package's, at a different cotangent per slice."""
    p = _problem(kind, nbatch, seed=1)
    tcd, jcd = DTYPES[comps_dtype]
    cot = np.arange(1, nbatch + 1, dtype=np.float32)
    calls = _spy(monkeypatch)
    jl, jg = _jax_batched(p, jcd, jnp.float32, cot)
    tl, tg = _torch_batched(p, tcd, torch.float32, cot)
    assert [c[:2] for c in calls] == [(KINDS[kind][0], KINDS[kind][0] * KINDS[kind][1])]
    assert rel_err(tl, jl) <= LOSS_TOL
    for got, want in zip(tg, jg):
        assert rel_err(got, want) <= GRAD_TOL


@pytest.mark.parametrize("nbatch", [1, 3])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_group_blocks_and_weight_plane_match_jax(kind, nbatch, monkeypatch):
    """Group blocks of ``loss_block`` (views of the data cubes; a
    shared-batched block covers whole classes, a block of the shared chunk
    keeps the whole operator) with a frequency-invariant weights plane,
    which reaches the op as a stride-0 view, against the JAX package's
    blocked loss."""
    nu, gmax, _ = KINDS[kind]
    p = _problem(kind, nbatch, seed=2, plane=True)
    cot = np.arange(1, nbatch + 1, dtype=np.float32)
    seen = []
    real = shared._loss_and_grads

    def spy(coeffs2, pr, pi, dr, di, w, comps3, valid, mode):
        seen.append((comps3.shape[0], coeffs2.shape[2], w.stride()[-1],
                     None if valid is None else valid.tolist()))
        return real(coeffs2, pr, pi, dr, di, w, comps3, valid, mode)

    monkeypatch.setattr(shared, "_loss_and_grads", spy)
    blk = gmax if nu > 1 else 2
    jl, jg = _jax_batched(p, jnp.float32, jnp.float32, cot, loss_block=blk)
    tl, tg = _torch_batched(p, torch.float32, torch.float32, cot, loss_block=blk)
    ngrps = nu * gmax
    assert len(seen) >= ngrps // blk  # the forward, then the recompute of each block
    for u_b, g_b, w_stride, valid in seen:
        assert (u_b, g_b) == (1, blk) and w_stride == 0
        assert valid == [True] * (blk - 1) + [False] if nu > 1 else valid == [True] * blk
    assert rel_err(tl, jl) <= LOSS_TOL
    for got, want in zip(tg, jg):
        assert rel_err(got, want) <= GRAD_TOL


def _jax_op(comps, coeffs2, pr, pi, dr, di, w):
    """The op's outputs from the JAX package: per-slice losses through the
    shared branches of ``fg_model_batched``, ``data_model``'s products and
    ``mse``'s sum, and their gradients in (coeffs2, pr, pi) at a unit
    cotangent per slice (``jax.vjp``)."""
    def losses(c2, p_r, p_i):
        vr, vi = jloss.fg_model_batched(c2[0], c2[1], comps)
        vr, vi = vr[:, :, 0], vi[:, :, 0]
        mr = p_r * vr + p_i * vi
        mi = -p_i * vr + p_r * vi
        return jnp.sum((jnp.square(dr - mr) + jnp.square(di - mi)) * w.astype(jnp.float32),
                       axis=(1, 2))

    out, vjp = jax.vjp(losses, coeffs2, pr, pi)
    return (out,) + vjp(jnp.ones_like(out))


@pytest.mark.parametrize("comps_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nbatch", [1, 3])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_plain_version_matches_jax_op_by_op(kind, nbatch, comps_dtype):
    """Every instance of the plain version (the loss; with dpr/dpi; with
    every gradient) against the JAX package's shared matvec and its
    transpose under ``jax.vjp``."""
    p = _problem(kind, nbatch, seed=3)
    tcd, jcd = DTYPES[comps_dtype]
    rng = np.random.default_rng(4)
    ngrps = p["fr"].shape[1]
    pr = (1 + 0.1 * rng.standard_normal((nbatch, ngrps, NF))).astype(np.float32)
    pi = (0.1 * rng.standard_normal((nbatch, ngrps, NF))).astype(np.float32)
    coeffs2 = np.stack([p["fr"], p["fi"]])
    planes = (p["dr"][:, :, 0], p["di"][:, :, 0], p["w"][:, :, 0])
    want = _jax_op(jnp.asarray(p["comps"]).astype(jcd), *(jnp.asarray(x) for x in
                                                            (coeffs2, pr, pi) + planes))
    args = [torch.as_tensor(x) for x in (coeffs2, pr, pi) + planes]
    comps3 = torch.as_tensor(p["comps"][:, 0]).to(tcd)
    valid = torch.as_tensor(p["valid"][:, 0])
    for mode in (fused.LOSS_ONLY, fused.LOSS_DP, fused.LOSS_ALL):
        got = shared.loss_and_grads_plain(*args, comps3, valid, mode)
        assert rel_err(got[0], want[0]) <= LOSS_TOL
        expect = {fused.LOSS_ONLY: (), fused.LOSS_DP: (2, 3), fused.LOSS_ALL: (1, 2, 3)}[mode]
        for i in (1, 2, 3):
            assert (got[i] is None) == (i not in expect)
            if i in expect:
                assert rel_err(got[i], want[i]) <= GRAD_TOL


def test_padding_groups_give_zeros_whatever_their_data():
    """Groups the mask leaves out give zero loss and zero gradients even
    where their data and weights are not zero (the kernel does not read
    them)."""
    p = _problem("shared_batched", 2, seed=5)
    rng = np.random.default_rng(6)
    ngrps = p["fr"].shape[1]
    w = np.abs(rng.standard_normal((2, ngrps, NF))).astype(np.float32) + 1.0
    args = [torch.as_tensor(x) for x in (np.stack([p["fr"], p["fi"]]),
                                         rng.standard_normal((2, ngrps, NF)).astype(np.float32),
                                         rng.standard_normal((2, ngrps, NF)).astype(np.float32),
                                         p["dr"][:, :, 0], p["di"][:, :, 0], w)]
    comps3 = torch.as_tensor(p["comps"][:, 0])
    valid = torch.as_tensor(p["valid"][:, 0])
    losses, dcoeffs, dpr, dpi = shared.loss_and_grads_plain(*args, comps3, valid)
    pad = ~valid
    assert torch.all(dcoeffs[:, :, pad] == 0) and torch.all(dpr[:, pad] == 0)
    assert torch.all(dpi[:, pad] == 0)
    keep = [a.clone() for a in args]
    keep[5] = keep[5] * valid.reshape(1, -1, 1)
    for a in (3, 4):
        keep[a] = keep[a] * valid.reshape(1, -1, 1)
    want = shared.loss_and_grads_plain(*keep, comps3, None)
    assert torch.equal(losses, want[0])
    for got, ref in zip((dcoeffs, dpr, dpi), want[1:]):
        assert torch.equal(got, ref)


def test_group_mask_follows_the_record():
    a0 = torch.zeros((6, 1), dtype=torch.int32)
    assert shared.group_mask(a0) is None
    mark_valid(a0, np.array([1, 1, 0, 1, 1, 0], bool).reshape(6, 1))
    mask = shared.group_mask(a0)
    assert mask.tolist() == [True, True, False, True, True, False]
    assert shared.group_mask(a0) is mask  # kept on the index tensor
    block = a0[3:6]
    carry_valid(a0, block, slice(3, 6))
    assert shared.group_mask(block).tolist() == [True, True, False]


# ---------------------------------------------------------------------- #
# the gate, the warning, the wrapper
# ---------------------------------------------------------------------- #
def _gate(comps, ngrps, coeffs_dtype=torch.float32, data_dtype=torch.float32,
          wgts_dtype=torch.float32):
    nf, nv = comps.shape[2], comps.shape[3]
    return shared.explain_shared_loss_inapplicable(
        comps, torch.zeros((ngrps, nv), dtype=coeffs_dtype),
        torch.zeros((ngrps, comps.shape[1], nf), dtype=data_dtype),
        torch.zeros((ngrps, comps.shape[1], nf), dtype=wgts_dtype))


def test_shared_gate():
    c = torch.zeros((1, 1, 37, 3))
    assert _gate(c, 4) is None
    assert _gate(torch.zeros((2, 1, 37, 3)), 4) is None
    assert _gate(torch.zeros((1, 1, 1536, 64), dtype=torch.bfloat16), 2048) is None
    assert "dense" in _gate(torch.zeros((4, 1, 37, 3)), 4)
    assert "whole number" in _gate(torch.zeros((3, 1, 37, 3)), 4)
    assert "nbls=2" in _gate(torch.zeros((1, 2, 37, 3)), 4)
    assert "comps dtype" in _gate(c.double(), 4)
    assert "coefficient dtype" in _gate(c, 4, coeffs_dtype=torch.float64)
    assert "data dtype" in _gate(c, 4, data_dtype=torch.float64)
    assert _gate(c, 4, wgts_dtype=torch.bfloat16) is None
    assert "weights dtype" in _gate(c, 4, wgts_dtype=torch.float64)
    # the widest basis: a cluster of 16 blocks of 64 modes
    for dtype in (torch.float32, torch.bfloat16):
        assert _gate(torch.zeros((1, 1, 8, 1024), dtype=dtype), 4) is None
        assert "nvecs=1025" in _gate(torch.zeros((1, 1, 8, 1025), dtype=dtype), 4)


def _gate_takes(nu, gmax, nfreqs, nvecs, comps_dtype):
    """The gate takes the chunk (a view of zeros: it reads shapes and types
    only)."""
    z, ngrps = torch.zeros(()), nu * gmax
    comps = z.to(comps_dtype).expand(nu, 1, nfreqs, nvecs)
    assert shared.explain_shared_loss_inapplicable(
        comps, z.expand(ngrps, nvecs), z.expand(ngrps, 1, nfreqs), z.expand(ngrps, 1, nfreqs)
    ) is None


@pytest.mark.parametrize("comps_dtype", [torch.float32, torch.bfloat16])
def test_gate_takes_every_width_past_the_register_tile(comps_dtype):
    """Every basis from 65 modes to the widest the gate took before the
    slices (600 float32, 720 bfloat16) goes to the kernel (its launch plans
    are checked on the card: ``chip_smoke.check_shared_plans``)."""
    top = 600 if comps_dtype == torch.float32 else 720
    for nvecs in range(65, top + 1):
        _gate_takes(1, 7, 1536, nvecs, comps_dtype)


@pytest.mark.parametrize("shape", chip_smoke.FULL_SHAPES)
def test_gate_takes_the_full_arrays_chunks(shape):
    """The full HERA array's six timed chunks, both comps types."""
    nu, gmax, nvecs = shape
    for comps_dtype in (torch.float32, torch.bfloat16):
        _gate_takes(nu, gmax, 1536, nvecs, comps_dtype)


@pytest.mark.parametrize("case", chip_smoke.SHARED_RAGGED, ids=str)
def test_gate_takes_the_ragged_shapes(case):
    """Every ragged shape of ``chip_smoke.py``'s phase 3s, in its comps
    types."""
    nu, gmax, nfreqs, nvecs = case[:4]
    for name in (case[4:] or ("float32", "bfloat16")):
        _gate_takes(nu, gmax, nfreqs, nvecs, getattr(torch, name))


def test_warning_names_only_chunks_no_kernel_takes():
    chunks = [(torch.zeros((3, 1, 8, 2)), torch.zeros((3, 1), dtype=torch.int32), None),
              (torch.zeros((1, 1, 8, 2)), torch.zeros((4, 1), dtype=torch.int32), None),
              (torch.zeros((2, 1, 8, 2)), torch.zeros((4, 1), dtype=torch.int32), None),
              (torch.zeros((1, 1, 8, 2), dtype=torch.float64),
               torch.zeros((4, 1), dtype=torch.int32), None)]
    fr = [torch.zeros((3, 2)), torch.zeros((4, 2)), torch.zeros((4, 2)), torch.zeros((4, 2))]
    data = [torch.zeros((3, 1, 8))] + [torch.zeros((4, 1, 8))] * 3
    with pytest.warns(UserWarning, match="chunk 3: comps dtype torch.float64"):
        reasons = tloss.warn_fused_fallbacks(chunks, fr, data, data)
    assert len(reasons) == 1


def _op_args(p, device="cpu"):
    ngrps = p["fr"].shape[1]
    rng = np.random.default_rng(7)
    nb = p["fr"].shape[0]
    pr = (1 + 0.1 * rng.standard_normal((nb, ngrps, NF))).astype(np.float32)
    pi = (0.1 * rng.standard_normal((nb, ngrps, NF))).astype(np.float32)
    return [torch.as_tensor(x, device=device) for x in
            (np.stack([p["fr"], p["fi"]]), pr, pi, p["dr"][:, :, 0], p["di"][:, :, 0],
             p["w"][:, :, 0], p["comps"][:, 0])]


def test_kernel_wrapper_refuses_cpu_tensors_and_bad_operands():
    t = _op_args(_problem("shared_batched", 2))
    with pytest.raises(ValueError, match="CUDA tensors"):
        shared.loss_and_grads_kernel(*t)
    bad = list(t)
    bad[1] = t[1].transpose(1, 2).contiguous().transpose(1, 2)  # the right shape, strided
    with pytest.raises(ValueError, match="pr is not contiguous"):
        shared.loss_and_grads_kernel(*bad)
    bad = list(t)
    bad[6] = torch.cat([t[6], t[6][:2]])  # 5 operators for 12 groups
    with pytest.raises(ValueError, match="not a whole number"):
        shared.loss_and_grads_kernel(*bad)
    bad = list(t)
    bad[3] = t[3].double()
    with pytest.raises(TypeError, match="dr dtype"):
        shared.loss_and_grads_kernel(*bad)
    with pytest.raises(ValueError, match="valid"):
        shared.loss_and_grads_kernel(*t, torch.ones(5, dtype=torch.bool))


def test_cpu_forward_launches_no_kernel():
    LAUNCHES.reset()
    t = [x.requires_grad_(i < 3) for i, x in enumerate(_op_args(_problem("shared", 2)))]
    torch.sum(shared.shared_chunk_loss_batched(*t)).backward()
    assert LAUNCHES.get(shared.KERNEL_NAME) == 0


@pytest.mark.parametrize("nvecs, sliced", [(3, 0), (64, 0), (65, 1), (256, 1), (1024, 1)])
def test_launches_past_the_register_tile_are_counted_as_sliced(nvecs, sliced):
    """A launch counts under the kernel's name and its instance's; past 64
    modes, where the cluster's mode slices run it, also under
    ``shared_chunk_loss.sliced``, so a run's launch counts show that the
    sliced path ran, and how often (none on the HERA core)."""
    LAUNCHES.reset()
    for mode in (fused.LOSS_ONLY, fused.LOSS_ALL):
        shared.count_shared_launch(mode, nvecs)
    assert LAUNCHES.get(shared.KERNEL_NAME) == 2
    assert LAUNCHES.get(f"{shared.KERNEL_NAME}:{fused.MODE_NAMES[fused.LOSS_ALL]}") == 1
    assert LAUNCHES.get(shared.SLICED_NAME) == 2 * sliced
    assert shared.SLICED_NAME == "shared_chunk_loss.sliced"


@pytest.mark.parametrize("case, want_mode", [
    ("no_grad_wanted", fused.LOSS_ONLY),
    ("frozen_coefficients", fused.LOSS_DP),
    ("all_gradients", fused.LOSS_ALL),
])
def test_instance_choice(monkeypatch, case, want_mode):
    """A call that needs no gradient runs the loss-only instance; frozen
    coefficients the gain-product instance; otherwise every gradient."""
    calls = _spy(monkeypatch)
    t = _op_args(_problem("shared_batched", 2))
    if case == "all_gradients":
        for x in t[:3]:
            x.requires_grad_(True)
    elif case == "frozen_coefficients":
        t[1].requires_grad_(True)
        t[2].requires_grad_(True)
    losses = shared.shared_chunk_loss_batched(*t)
    assert [c[2] for c in calls] == [want_mode]
    assert losses.requires_grad == (want_mode != fused.LOSS_ONLY)


# ---------------------------------------------------------------------- #
# routing on the HERA core's packing
# ---------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def cut_core():
    return demo.build(nside=5, nfreqs=64)


def test_hera_packing_routes_every_shared_chunk_and_keeps_its_history(cut_core, monkeypatch):
    """The HERA core at cut size (25 antennas, 188 baselines, 64 channels;
    the default shared-basis packing) fitted in float32 for 50 steps a
    phase of the mixed schedule: every shared and shared-batched chunk goes
    through the shared op, no chunk is named as a fallback, and the loss
    history equals that of the plain torch ops (the gate refused) within
    rel 1e-5."""
    corrupted, comps, _ = cut_core
    layouts = demo.chunk_layouts(corrupted, comps)
    want = sorted((c["U"], c["groups"]) for c in layouts if c["kind"] != "dense")
    assert want and all(c["kind"] != "dense" for c in layouts)
    calls = _spy(monkeypatch)
    kw = dict(device="cpu", maxsteps=50, tol=0.0, patience=0)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        _, _, _, routed = demo.fit(corrupted, comps, **kw)
    assert not [w for w in caught if "plain torch loss" in str(w.message)]
    assert sorted(set(c[:2] for c in calls)) == want
    refuse = lambda *a: "refused"  # noqa: E731
    monkeypatch.setattr(tloss, "explain_shared_loss_inapplicable", refuse)
    n = len(calls)
    with pytest.warns(UserWarning, match="plain torch loss"):
        _, _, _, plain = demo.fit(corrupted, comps, **kw)
    assert len(calls) == n
    h_r, h_p = (np.asarray(h[0][0]["loss"]) for h in (routed, plain))
    assert routed[0][0]["phase_steps"] == plain[0][0]["phase_steps"] == [50, 50]
    assert np.max(np.abs(h_r - h_p) / np.abs(h_p)) <= 1e-5


# ---------------------------------------------------------------------- #
# on the card
# ---------------------------------------------------------------------- #
def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("comps_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nbatch", [1, 3, 9])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_cuda_kernel_matches_plain(kind, nbatch, comps_dtype):
    dev = _cuda()
    p = _problem(kind, nbatch, seed=8)
    args = _op_args(p, dev)
    args[6] = args[6].to(comps_dtype)
    valid = torch.as_tensor(p["valid"][:, 0], device=dev)
    for mode in (fused.LOSS_ONLY, fused.LOSS_DP, fused.LOSS_ALL):
        before = LAUNCHES.get(shared.KERNEL_NAME)
        got = shared.loss_and_grads_kernel(*args, valid, mode)
        again = shared.loss_and_grads_kernel(*args, valid, mode)
        assert LAUNCHES.get(shared.KERNEL_NAME) == before + 2
        want = shared.loss_and_grads_plain(*args, valid, mode)
        torch.cuda.synchronize()
        assert rel_err(got[0], want[0]) <= LOSS_TOL
        for g, a, w in zip(got, again, want):
            assert (g is None) == (w is None)
            if w is not None:
                assert torch.equal(g, a)
                assert rel_err(g, w) <= GRAD_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 2, 37, 3), (2, 64, 1536, 64), (3, 5, 100, 130),
                                   (1, 33, 64, 557)])
def test_cuda_kernel_matches_plain_at_ragged_and_wide_shapes(shape):
    """Channels not a whole number of tiles, pair tiles cut short, modes
    past the register tile (a cluster of 64-mode slices), rows not a whole
    number of 16-byte units (copied by plain loads)."""
    dev = _cuda()
    nu, gmax, nf, nv = shape
    rng = np.random.default_rng(9)
    ngrps = nu * gmax
    comps3 = torch.as_tensor(rng.standard_normal((nu, nf, nv)), dtype=torch.float32,
                             device=dev) / np.sqrt(nf)
    args = [torch.as_tensor(x, dtype=torch.float32, device=dev) for x in (
        rng.standard_normal((2, 2, ngrps, nv)), 1 + 0.1 * rng.standard_normal((2, ngrps, nf)),
        0.1 * rng.standard_normal((2, ngrps, nf)), rng.standard_normal((2, ngrps, nf)),
        rng.standard_normal((2, ngrps, nf)), np.abs(rng.standard_normal((2, ngrps, nf))))]
    got = shared.loss_and_grads_kernel(*args, comps3)
    want = shared.loss_and_grads_plain(*args, comps3)
    torch.cuda.synchronize()
    assert rel_err(got[0], want[0]) <= LOSS_TOL
    for g, w in zip(got[1:], want[1:]):
        assert rel_err(g, w) <= GRAD_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("comps_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nvecs", [64, 128])
def test_cuda_kernel_keeps_nan_operands(nvecs, comps_dtype):
    """A coefficient made NaN on the card (0/0) gives a NaN loss and a data
    value made NaN NaN gradients, as the plain version does, at one block a
    tile of pairs (V = 64) and a cluster of two mode slices (V = 128): the
    kernel's TF32 split keeps a NaN a NaN."""
    dev = _cuda()
    rng = np.random.default_rng(nvecs)
    ngrps, nf = 4, 100
    comps3 = torch.as_tensor(rng.standard_normal((1, nf, nvecs)), dtype=torch.float32,
                             device=dev).to(comps_dtype)
    args = [torch.as_tensor(x, dtype=torch.float32, device=dev) for x in (
        rng.standard_normal((2, 1, ngrps, nvecs)), 1 + 0.1 * rng.standard_normal((1, ngrps, nf)),
        0.1 * rng.standard_normal((1, ngrps, nf)), rng.standard_normal((1, ngrps, nf)),
        rng.standard_normal((1, ngrps, nf)), np.abs(rng.standard_normal((1, ngrps, nf))))]
    zero = torch.zeros((), device=dev)
    coeffs = args[0].clone()
    coeffs[0, 0, 1, nvecs - 1] = zero / zero
    for fn in (shared.loss_and_grads_kernel, shared.loss_and_grads_plain):
        loss = fn(coeffs, *args[1:], comps3, None, fused.LOSS_ONLY)[0]
        assert bool(torch.isnan(loss).all())
    dr = args[3].clone()
    dr[0, 2, 7] = zero / zero
    loss, dcoeffs, dpr, _ = shared.loss_and_grads_kernel(*args[:3], dr, *args[4:], comps3, None,
                                                         fused.LOSS_ALL)
    assert bool(torch.isnan(loss).all()) and bool(torch.isnan(dcoeffs[:, 0, 2]).all())
    assert bool(torch.isnan(dpr[0, 2, 7]))
