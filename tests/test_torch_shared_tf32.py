"""The shared-basis kernel's split TF32 products, emulated on the CPU,
against calamity_tpu.

``csrc/shared_chunk_loss.cu`` runs both of its products (the basis matvec
and the coefficient gradient) on the tensor cores with TF32 operands, each
float32 operand split into a TF32 high and low part. The card is not
here, so ``ops.shared.loss_and_grads_tf32`` forms the same products on
the CPU (``cvt.rna`` rounding, hi/lo split, the two or three products
summed in float32, small terms first), and these tests hold it against the
JAX package's shared branches (``fg_model`` for one slice,
``fg_model_batched`` for three, both at ``Precision.HIGHEST``, under
``jax.vjp``) on the same seeded numpy inputs: loss rel 1e-5, gradients rel
1e-4, the tolerances the kernel is held to on the card.

The inputs sit near a fit, as the descent's late steps do: the data are
the model of the coefficients plus 1% noise, so the loss is small against
the model and an error in the model shows in it. There a single TF32
product (each operand rounded once, about 1e-3 relative) fails the loss
tolerance, which the control test asserts: the split is needed, and the
comparison can tell.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import rel_err

from calamity_tpu.ops import loss as jloss
from calamity_tpu_torch.ops import fused, shared

NF = 40
NOISE = 1e-2  # the data's distance from the model, relative to its rms
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4
KINDS = {"shared": (1, 4, 6), "shared_batched": (3, 4, 5)}  # (U, gmax, V)
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _near_fit(kind, nbatch, comps_dtype, seed=0, shape=None, nfreqs=NF):
    """numpy operands of the op, (coeffs2, pr, pi, dr, di, w, comps (U, F,
    V)), float32: data the model of the coefficients (with ``comps`` as
    rounded to ``comps_dtype``) plus NOISE, coefficients then moved by a
    tenth of NOISE. In the shared-batched chunk each class's last group
    is padding (zero weight). ``shape`` (U, gmax, V) and ``nfreqs`` replace
    those of ``kind``."""
    nu, gmax, nv = shape or KINDS[kind]
    ngrps = nu * gmax
    rng = np.random.default_rng(seed + 17 * nbatch + nu)
    f32 = np.float32
    comps = rng.standard_normal((nu, nfreqs, nv))
    comps /= np.linalg.norm(comps, axis=1, keepdims=True)
    comps = torch.as_tensor(comps.astype(f32)).to(comps_dtype).float().numpy()
    coeffs2 = rng.standard_normal((2, nbatch, ngrps, nv))
    pr = 1 + 0.1 * rng.standard_normal((nbatch, ngrps, nfreqs))
    pi = 0.1 * rng.standard_normal((nbatch, ngrps, nfreqs))
    v = np.einsum("ufv,knugv->knugf", comps.astype(np.float64),
                  coeffs2.reshape(2, nbatch, nu, gmax, nv)).reshape(2, nbatch, ngrps, nfreqs)
    mr = pr * v[0] + pi * v[1]
    mi = -pi * v[0] + pr * v[1]
    scale = np.sqrt(np.mean(mr ** 2 + mi ** 2))
    dr = mr + NOISE * scale * rng.standard_normal(mr.shape)
    di = mi + NOISE * scale * rng.standard_normal(mi.shape)
    w = np.abs(rng.standard_normal((nbatch, ngrps, nfreqs)))
    if nu > 1:
        w[:, gmax - 1::gmax] = 0.0
    coeffs2 = coeffs2 + 0.1 * NOISE * rng.standard_normal(coeffs2.shape)
    return [x.astype(f32) for x in (coeffs2, pr, pi, dr, di, w / w.sum(), comps)]


def _jax_op(ops, comps_dtype):
    """Per-slice losses and their gradients in (coeffs2, pr, pi) at a unit
    cotangent from the JAX package: ``fg_model`` for one slice,
    ``fg_model_batched`` for more, then ``data_model``'s products and
    ``mse``'s sum."""
    coeffs2, pr, pi, dr, di, w, comps = (jnp.asarray(x) for x in ops)
    comps = comps.astype(comps_dtype)[:, None]  # (U, 1, F, V)
    nbatch = coeffs2.shape[1]

    def losses(c2, p_r, p_i):
        if nbatch == 1:
            vr, vi = jloss.fg_model(c2[0, 0], c2[1, 0], comps)
            vr, vi = vr[None, :, 0], vi[None, :, 0]
        else:
            vr, vi = jloss.fg_model_batched(c2[0], c2[1], comps)
            vr, vi = vr[:, :, 0], vi[:, :, 0]
        mr = p_r * vr + p_i * vi
        mi = -p_i * vr + p_r * vi
        return jnp.sum((jnp.square(dr - mr) + jnp.square(di - mi)) * w, axis=(1, 2))

    out, vjp = jax.vjp(losses, coeffs2, pr, pi)
    return (out,) + vjp(jnp.ones_like(out))


def _torch_operands(ops, comps_dtype, kind, shape=None):
    args = [torch.as_tensor(x) for x in ops]
    args[6] = args[6].to(comps_dtype)
    nu, gmax, _ = shape or KINDS[kind]
    valid = torch.ones(nu * gmax, dtype=torch.bool)
    if nu > 1:
        valid[gmax - 1::gmax] = False
    return args, valid


@pytest.mark.parametrize("scale", [1e-30, 1e-3, 1.0, 1e30])
def test_tf32_round_clears_the_low_bits_and_the_split_rebuilds(scale):
    rng = np.random.default_rng(11)
    x = torch.as_tensor((scale * rng.standard_normal(4096)).astype(np.float32))
    hi, lo = shared.tf32_split(x)
    for part in (hi, lo):
        assert not torch.any(part.view(torch.int32) & 0x1FFF)
    assert float(((hi - x).abs() / x.abs()).max()) <= 2.0 ** -11
    assert float(((hi + lo - x).abs() / x.abs()).max()) <= 2.0 ** -22


def test_tf32_round_ties_away_from_zero():
    half = 2.0 ** -11  # half a TF32 unit of the last place at 1
    x = torch.tensor([1 + half, -(1 + half), 1 + half / 2, 1 + 3 * half, 0.0, -0.0,
                      float("inf"), float("-inf")], dtype=torch.float32)
    want = [1 + 2 * half, -(1 + 2 * half), 1.0, 1 + 4 * half, 0.0, -0.0, float("inf"),
            float("-inf")]
    assert shared.tf32_round(x).tolist() == want
    assert torch.isnan(shared.tf32_round(torch.tensor([float("nan")]))).all()


@pytest.mark.parametrize("comps_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nbatch", [1, 3])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_split_products_match_jax(kind, nbatch, comps_dtype):
    """Every instance of the emulated kernel (the loss; with dpr/dpi; with
    every gradient) against the JAX package near a fit."""
    tcd, jcd = DTYPES[comps_dtype]
    ops = _near_fit(kind, nbatch, tcd)
    want = _jax_op(ops, jcd)
    args, valid = _torch_operands(ops, tcd, kind)
    for mode in (fused.LOSS_ONLY, fused.LOSS_DP, fused.LOSS_ALL):
        got = shared.loss_and_grads_tf32(*args, valid, mode)
        assert rel_err(got[0], want[0]) <= LOSS_TOL
        expect = {fused.LOSS_ONLY: (), fused.LOSS_DP: (2, 3), fused.LOSS_ALL: (1, 2, 3)}[mode]
        for i in (1, 2, 3):
            assert (got[i] is None) == (i not in expect)
            if i in expect:
                assert rel_err(got[i], want[i]) <= GRAD_TOL


@pytest.mark.parametrize("comps_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nbatch", [1, 3])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_single_tf32_product_fails_the_loss_tolerance(kind, nbatch, comps_dtype):
    """The control: on the same inputs, one product of TF32-rounded
    operands misses the loss tolerance that the split products meet."""
    tcd, jcd = DTYPES[comps_dtype]
    ops = _near_fit(kind, nbatch, tcd)
    want = _jax_op(ops, jcd)
    args, valid = _torch_operands(ops, tcd, kind)
    single = shared.loss_and_grads_tf32(*args, valid, fused.LOSS_ONLY, split=False)
    split = shared.loss_and_grads_tf32(*args, valid, fused.LOSS_ONLY)
    assert rel_err(single[0], want[0]) > LOSS_TOL
    assert rel_err(split[0], want[0]) <= LOSS_TOL


def test_split_emulation_of_bfloat16_comps_splits_only_the_coefficients():
    """bfloat16 comps are exact in TF32: their emulation forms two
    products, and equals the three-product form of the same comps widened
    to float32 (whose low part is zero) to the bit."""
    ops = _near_fit("shared_batched", 3, torch.bfloat16)
    args, valid = _torch_operands(ops, torch.bfloat16, "shared_batched")
    assert torch.equal(shared.tf32_round(args[6].float()), args[6].float())
    got = shared.loss_and_grads_tf32(*args, valid)
    wide = list(args)
    wide[6] = args[6].float()
    want = shared.loss_and_grads_tf32(*wide, valid)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# ---------------------------------------------------------------------- #
# past 64 modes: the model per 64-mode slice, the slices summed in order
# ---------------------------------------------------------------------- #
WIDE_NF = 1536
WIDE_CLASSES = (2, 4)  # (U, gmax): two operators, each class's last group padding
# the widths of the full HERA array's chunks (128, 256, 512) and the widest
# bases of ``chip_smoke.SHARED_RAGGED``, each with its comps type
WIDE = [(128, "float32"), (256, "float32"), (512, "float32"), (600, "float32"),
        (128, "bfloat16"), (256, "bfloat16"), (512, "bfloat16"), (720, "bfloat16")]


def _jax_sum_terms(ops, comps_dtype, cot):
    """The "sum" prior's terms from the JAX package, (terms (3, N),
    (dcoeffs, dpr, dpi) at ``cot``, flux scale (2, N)): ``fg_model`` for one
    slice, ``fg_model_batched`` for more, ``data_model``'s products and the
    weighted sums under ``jax.vjp``."""
    coeffs2, pr, pi, dr, di, w, comps = (jnp.asarray(x) for x in ops)
    comps = comps.astype(comps_dtype)[:, None]
    nbatch = coeffs2.shape[1]

    def model(c2, p_r, p_i):
        if nbatch == 1:
            vr, vi = jloss.fg_model(c2[0, 0], c2[1, 0], comps)
            vr, vi = vr[None, :, 0], vi[None, :, 0]
        else:
            vr, vi = jloss.fg_model_batched(c2[0], c2[1], comps)
            vr, vi = vr[:, :, 0], vi[:, :, 0]
        return p_r * vr + p_i * vi, -p_i * vr + p_r * vi

    def terms(c2, p_r, p_i):
        mr, mi = model(c2, p_r, p_i)
        return jnp.stack([jnp.sum((jnp.square(dr - mr) + jnp.square(di - mi)) * w, axis=(1, 2)),
                          jnp.sum(mr * w, axis=(1, 2)), jnp.sum(mi * w, axis=(1, 2))])

    out, vjp = jax.vjp(terms, coeffs2, pr, pi)
    mr, mi = model(coeffs2, pr, pi)
    scale = jnp.stack([jnp.sum(jnp.abs(mr) * w, axis=(1, 2)),
                       jnp.sum(jnp.abs(mi) * w, axis=(1, 2))])
    return out, vjp(jnp.asarray(cot, out.dtype)), scale


@pytest.mark.parametrize("nbatch", [1, 3])
@pytest.mark.parametrize("nvecs,comps_dtype", WIDE)
def test_sliced_products_match_jax(nvecs, comps_dtype, nbatch):
    """Past 64 modes, where the kernel's cluster forms the model of each
    64-mode slice in its own block and sums the slices in rank order: every
    instance of the emulation (the chi-square's three and the "sum" prior's
    forward and backwards) against the JAX package near a fit at 1536
    channels, loss rel 1e-5 (M_r and M_i against sum w|m|), gradients rel
    1e-4, the reference in float64."""
    tcd = DTYPES[comps_dtype][0]
    shape = WIDE_CLASSES + (nvecs,)
    ops = _near_fit("shared_batched", nbatch, tcd, seed=nvecs, shape=shape, nfreqs=WIDE_NF)
    # the reference in float64 (comps as rounded to their type, exactly)
    ops64 = [x.astype(np.float64) for x in ops]
    want = _jax_op(ops64, jnp.float64)
    args, valid = _torch_operands(ops, tcd, "shared_batched", shape)
    for mode in (fused.LOSS_ONLY, fused.LOSS_DP, fused.LOSS_ALL):
        got = shared.loss_and_grads_tf32(*args, valid, mode)
        assert rel_err(got[0], want[0]) <= LOSS_TOL
        expect = {fused.LOSS_ONLY: (), fused.LOSS_DP: (2, 3), fused.LOSS_ALL: (1, 2, 3)}[mode]
        for i in (1, 2, 3):
            assert (got[i] is None) == (i not in expect)
            if i in expect:
                assert rel_err(got[i], want[i]) <= GRAD_TOL
    cot = np.random.default_rng(nvecs + nbatch).standard_normal((3, nbatch)).astype(np.float32)
    want_terms, want_grads, scale = _jax_sum_terms(ops64, jnp.float64, cot)
    want_terms, scale = np.asarray(want_terms), np.asarray(scale)
    terms = np.asarray(shared.loss_and_grads_tf32(*args, valid, fused.SUM_FWD)[0], np.float64)
    assert np.max(np.abs(terms[0] - want_terms[0]) / np.abs(want_terms[0])) <= LOSS_TOL
    assert np.max(np.abs(terms[1:] - want_terms[1:]) / scale) <= LOSS_TOL
    for mode in (fused.SUM_DP, fused.SUM_ALL):
        got = shared.loss_and_grads_tf32(*args, valid, mode, cot=torch.as_tensor(cot))
        assert got[0] is None and (got[1] is None) == (mode == fused.SUM_DP)
        for g, w in zip(got[1:], want_grads):
            if g is not None:
                assert rel_err(g, w) <= GRAD_TOL


def test_sliced_model_sums_the_slices_in_order():
    """Past 64 modes the emulation's model is the sum of the slices' split
    products taken in slice order, as the kernel's cluster sums them (130
    modes: slices of 64, 64 and 2), to the bit."""
    tcd = torch.float32
    shape = WIDE_CLASSES + (130,)
    ops = _near_fit("shared_batched", 1, tcd, seed=3, shape=shape, nfreqs=64)
    args, valid = _torch_operands(ops, tcd, "shared_batched", shape)
    coeffs2, comps = args[0], args[6]

    def split_product(c, x):
        c_hi, c_lo = shared.tf32_split(c)
        x_hi, x_lo = shared.tf32_split(x)
        eq = "ufv,knugv->knugf"
        return (torch.einsum(eq, c_hi, x_lo) + torch.einsum(eq, c_lo, x_hi)
                + torch.einsum(eq, c_hi, x_hi))

    x = coeffs2.reshape(2, 1, 2, 4, 130)
    parts = [split_product(comps[..., k:k + 64], x[..., k:k + 64]) for k in (0, 64, 128)]
    v = ((parts[0] + parts[1]) + parts[2]).reshape(2, 1, 8, 64)
    pr, pi = args[1], args[2]
    mr, mi = pr * v[0] + pi * v[1], -pi * v[0] + pr * v[1]
    w = args[5] * valid.reshape(1, -1, 1)
    want = torch.sum(w * ((args[3] - mr) ** 2 + (args[4] - mi) ** 2), dim=(1, 2))
    got = shared.loss_and_grads_tf32(*args, valid, fused.LOSS_ONLY)[0]
    assert torch.equal(got, want)
