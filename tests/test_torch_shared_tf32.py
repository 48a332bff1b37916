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


def _near_fit(kind, nbatch, comps_dtype, seed=0):
    """numpy operands of the op, (coeffs2, pr, pi, dr, di, w, comps (U, F,
    V)), float32: data the model of the coefficients (with ``comps`` as
    rounded to ``comps_dtype``) plus NOISE, coefficients then moved by a
    tenth of NOISE. In the shared-batched chunk each class's last group
    is padding (zero weight)."""
    nu, gmax, nv = KINDS[kind]
    ngrps = nu * gmax
    rng = np.random.default_rng(seed + 17 * nbatch + nu)
    f32 = np.float32
    comps = rng.standard_normal((nu, NF, nv))
    comps /= np.linalg.norm(comps, axis=1, keepdims=True)
    comps = torch.as_tensor(comps.astype(f32)).to(comps_dtype).float().numpy()
    coeffs2 = rng.standard_normal((2, nbatch, ngrps, nv))
    pr = 1 + 0.1 * rng.standard_normal((nbatch, ngrps, NF))
    pi = 0.1 * rng.standard_normal((nbatch, ngrps, NF))
    v = np.einsum("ufv,knugv->knugf", comps.astype(np.float64),
                  coeffs2.reshape(2, nbatch, nu, gmax, nv)).reshape(2, nbatch, ngrps, NF)
    mr = pr * v[0] + pi * v[1]
    mi = -pi * v[0] + pr * v[1]
    scale = np.sqrt(np.mean(mr ** 2 + mi ** 2))
    dr = mr + NOISE * scale * rng.standard_normal(mr.shape)
    di = mi + NOISE * scale * rng.standard_normal(mi.shape)
    w = np.abs(rng.standard_normal((nbatch, ngrps, NF)))
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


def _torch_operands(ops, comps_dtype, kind):
    args = [torch.as_tensor(x) for x in ops]
    args[6] = args[6].to(comps_dtype)
    nu, gmax, _ = KINDS[kind]
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
