"""Forward model and chunked loss of the torch port against calamity_tpu.

Same seeded numpy inputs go to ``calamity_tpu.ops.loss`` (under
``jax.value_and_grad``) and to ``calamity_tpu_torch.ops.loss`` (under
torch autograd), for the three chunk packings (dense, shared,
shared-batched) and a dense multi-baseline chunk. Tolerances:
float64 rel 1e-10 (only summation order differs); float32 rel 1e-5 for
values and 1e-4 for gradients (float32 rounding over sums of a few
thousand terms); bfloat16 comps the same as float32, since both packages
round comps to the same bf16 values and accumulate in float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import rel_err, to_np

from calamity_tpu.ops import loss as jloss
from calamity_tpu_torch.ops import loss as tloss

NA, NF = 6, 24
TOL = {"float64": (1e-10, 1e-10), "float32": (1e-5, 1e-4), "bfloat16": (1e-5, 1e-4)}


def _chunk(rng, kind):
    """(comps, a0, a1, ngrps) of one chunk in the given packing."""
    if kind == "dense":
        ngrps, comps_shape = 5, (5, 1, NF, 4)
    elif kind == "dense_b2":
        ngrps, comps_shape = 3, (3, 2, NF, 4)
    elif kind == "shared":
        ngrps, comps_shape = 4, (1, 1, NF, 6)
    else:  # shared-batched: 2 operators x 3 groups each
        ngrps, comps_shape = 6, (2, 1, NF, 5)
    comps = rng.standard_normal(comps_shape)
    comps /= np.linalg.norm(comps, axis=2, keepdims=True)
    nbls = comps_shape[1]
    a0 = rng.integers(0, NA, (ngrps, nbls)).astype(np.int32)
    a1 = ((a0 + 1 + rng.integers(0, NA - 1, (ngrps, nbls))) % NA).astype(np.int32)
    return comps, a0, a1, ngrps


def _problem(seed, kinds):
    rng = np.random.default_rng(seed)
    chunks, fr, fi, dr, di, w, sky_r, sky_i = [], [], [], [], [], [], [], []
    for kind in kinds:
        comps, a0, a1, ngrps = _chunk(rng, kind)
        nbls, nv = comps.shape[1], comps.shape[3]
        chunks.append((comps, a0, a1))
        fr.append(rng.standard_normal((ngrps, nv)))
        fi.append(rng.standard_normal((ngrps, nv)))
        for lst in (dr, di, sky_r, sky_i):
            lst.append(rng.standard_normal((ngrps, nbls, NF)))
        w.append(np.abs(rng.standard_normal((ngrps, nbls, NF))))
    wsum = sum(x.sum() for x in w)
    w = [x / wsum for x in w]
    g_r = 1 + 0.1 * rng.standard_normal((NA, NF))
    g_i = 0.1 * rng.standard_normal((NA, NF))
    return dict(g_r=g_r, g_i=g_i, fr=fr, fi=fi, chunks=chunks, dr=dr, di=di, w=w,
                sky_r=sky_r, sky_i=sky_i)


def _cast(p, dtype):
    """The problem as (jax arrays, torch tensors) in ``dtype``; bf16 casts
    only comps (coefficients, data and gains stay float32)."""
    fdt = np.float64 if dtype == "float64" else np.float32

    def jarr(x):
        return jnp.asarray(np.asarray(x, fdt))

    def tarr(x):
        return torch.as_tensor(np.asarray(x, fdt))

    jchunks, tchunks = [], []
    for comps, a0, a1 in p["chunks"]:
        cj, ct = jarr(comps), tarr(comps)
        if dtype == "bfloat16":
            cj, ct = cj.astype(jnp.bfloat16), ct.to(torch.bfloat16)
        jchunks.append((cj, jnp.asarray(a0), jnp.asarray(a1)))
        tchunks.append((ct, torch.as_tensor(a0), torch.as_tensor(a1)))
    out = []
    for conv, chunks in ((jarr, jchunks), (tarr, tchunks)):
        out.append(dict(
            g_r=conv(p["g_r"]), g_i=conv(p["g_i"]), chunks=tuple(chunks),
            **{k: [conv(x) for x in p[k]] for k in ("fr", "fi", "dr", "di", "w", "sky_r",
                                                   "sky_i")},
        ))
    return out


def _torch_value_and_grad(fn, *params):
    leaves = []
    for x in params:
        if isinstance(x, list):
            leaves.extend(y.requires_grad_(True) for y in x)
        else:
            leaves.append(x.requires_grad_(True))
    val = fn(*params)
    return val, torch.autograd.grad(val, leaves)


def _flat(tree):
    return [x for part in tree for x in (part if isinstance(part, (list, tuple)) else [part])]


@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["dense", "dense_b2", "shared", "shared_batched"])
def test_fg_model_and_data_model(kind, dtype):
    p = _problem(1, [kind])
    j, t = _cast(p, dtype)
    vtol, _ = TOL[dtype]
    (cj, a0j, a1j), (ct, a0t, a1t) = j["chunks"][0], t["chunks"][0]
    for got, want in zip(tloss.fg_model(t["fr"][0], t["fi"][0], ct),
                         jloss.fg_model(j["fr"][0], j["fi"][0], cj)):
        assert tuple(got.shape) == want.shape
        assert rel_err(got, want) <= vtol
    for got, want in zip(
        tloss.data_model(t["g_r"], t["g_i"], t["fr"][0], t["fi"][0], ct, a0t, a1t),
        jloss.data_model(j["g_r"], j["g_i"], j["fr"][0], j["fi"][0], cj, a0j, a1j),
    ):
        assert rel_err(got, want) <= vtol


def test_gain_products_exact():
    p = _problem(2, ["dense_b2"])
    j, t = _cast(p, "float64")
    _, a0, a1 = p["chunks"][0]
    got = tloss.gain_products(t["g_r"], t["g_i"], torch.as_tensor(a0), torch.as_tensor(a1))
    want = jloss.gain_products(j["g_r"], j["g_i"], jnp.asarray(a0), jnp.asarray(a1))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(to_np(g), np.asarray(w))


def test_fg_model_host_matches_device():
    p = _problem(3, ["dense", "shared", "shared_batched"])
    _, t = _cast(p, "float32")
    host = tloss.fg_model_all_chunks_host(
        [to_np(x) for x in t["fr"]], [to_np(x) for x in t["fi"]],
        [to_np(c) for c, _, _ in t["chunks"]],
    )
    dev = tloss.fg_model_all_chunks(t["fr"], t["fi"], t["chunks"])
    for (hr, hi), (dr_, di_) in zip(host, dev):
        assert rel_err(hr, dr_) <= 1e-5 and rel_err(hi, di_) <= 1e-5


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
def test_chunked_loss_value_and_grad(dtype, remat):
    # every packing in one loss: the dense B=1 chunk goes through the fused
    # path (its plain version on the CPU), the others through torch ops
    p = _problem(4, ["dense", "dense_b2", "shared", "shared_batched"])
    j, t = _cast(p, dtype)
    vtol, gtol = TOL[dtype]

    def jfn(g_r, g_i, fr, fi):
        return jloss.chunked_loss(g_r, g_i, fr, fi, j["chunks"], j["dr"], j["di"], j["w"],
                                  remat=remat)

    jval, jgrad = jax.jit(jax.value_and_grad(jfn, argnums=(0, 1, 2, 3)))(
        j["g_r"], j["g_i"], tuple(j["fr"]), tuple(j["fi"]))

    def tfn(g_r, g_i, fr, fi):
        return tloss.chunked_loss(g_r, g_i, fr, fi, t["chunks"], t["dr"], t["di"], t["w"],
                                  remat=remat)

    tval, tgrad = _torch_value_and_grad(tfn, t["g_r"], t["g_i"], t["fr"], t["fi"])
    assert rel_err(tval, jval) <= vtol
    for got, want in zip(tgrad, _flat(jgrad)):
        assert rel_err(got, want) <= gtol


@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
def test_chunked_loss_sum_regularized_value_and_grad(dtype):
    p = _problem(5, ["dense", "shared", "shared_batched"])
    j, t = _cast(p, dtype)
    vtol, gtol = TOL[dtype]
    prior = [sum(float(np.sum(np.asarray(s) * np.asarray(w))) for s, w in zip(p[k], p["w"]))
             for k in ("sky_r", "sky_i")]

    def jfn(g_r, g_i, fr, fi):
        return jloss.chunked_loss_sum_regularized(
            g_r, g_i, fr, fi, j["chunks"], j["dr"], j["di"], j["w"], prior[0], prior[1])

    jval, jgrad = jax.jit(jax.value_and_grad(jfn, argnums=(0, 1, 2, 3)))(
        j["g_r"], j["g_i"], tuple(j["fr"]), tuple(j["fi"]))

    def tfn(g_r, g_i, fr, fi):
        return tloss.chunked_loss_sum_regularized(
            g_r, g_i, fr, fi, t["chunks"], t["dr"], t["di"], t["w"], prior[0], prior[1])

    tval, tgrad = _torch_value_and_grad(tfn, t["g_r"], t["g_i"], t["fr"], t["fi"])
    assert rel_err(tval, jval) <= vtol
    for got, want in zip(tgrad, _flat(jgrad)):
        assert rel_err(got, want) <= gtol


def test_mse_upcasts_low_precision_weights():
    rng = np.random.default_rng(6)
    m = [torch.as_tensor(rng.standard_normal((3, 1, 8)).astype(np.float32)) for _ in range(4)]
    w = torch.as_tensor(np.abs(rng.standard_normal((3, 1, 8))).astype(np.float32))
    want = tloss.mse(*m, w.to(torch.bfloat16).float())
    got = tloss.mse(*m, w.to(torch.bfloat16))
    assert got.dtype == torch.float32
    assert float(got) == float(want)


def test_convert_carries_bfloat16_bits():
    from calamity_tpu_torch.convert import chunks_from_jax

    rng = np.random.default_rng(7)
    comps = rng.standard_normal((3, 1, 8, 2)).astype(np.float32)
    a0 = np.arange(3, dtype=np.int32).reshape(3, 1)
    ((ct, a0t, _),) = chunks_from_jax(((jnp.asarray(comps).astype(jnp.bfloat16), a0, a0),),
                                      "cpu")
    assert ct.dtype == torch.bfloat16 and a0t.dtype == torch.int32
    assert torch.equal(ct, torch.as_tensor(comps).to(torch.bfloat16))


def _compressed_weights_case(dtype, device):
    """A problem whose weights do not depend on frequency, as the full cubes
    and as the (ngrps, nbls, 1) planes a scan stores."""
    p = _problem(8, ["dense", "shared"])
    p["w"] = [np.broadcast_to(x[..., :1], x.shape).copy() for x in p["w"]]
    _, t = _cast(p, dtype)
    t = {k: (v.to(device) if isinstance(v, torch.Tensor)
             else tuple(tuple(c.to(device) for c in ch) for ch in v) if k == "chunks"
             else [x.to(device) for x in v]) for k, v in t.items()}
    planes = [w[..., :1].clone() for w in t["w"]]
    return t, planes


def _loss_and_grads_with(t, wgts):
    def fn(g_r, g_i, fr, fi):
        return tloss.chunked_loss(g_r, g_i, fr, fi, t["chunks"], t["dr"], t["di"], wgts)

    leaves = [t["g_r"].clone(), t["g_i"].clone(), [x.clone() for x in t["fr"]],
              [x.clone() for x in t["fi"]]]
    return _torch_value_and_grad(fn, *leaves)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_loss_takes_a_compressed_weights_plane(dtype, monkeypatch):
    """Frequency-invariant weights stored as one (..., 1) plane: the dense
    chunk reaches the fused loss with weights of the data's shape (a
    stride-0 view, the operand shape the kernel checks), and the loss and
    its gradients equal those of the full weight cube."""
    t, planes = _compressed_weights_case(dtype, "cpu")
    seen = []
    real = tloss.fused_chunk_loss

    def spy(coeffs2, pr, pi, comps3, dr, di, w):
        seen.append((tuple(w.shape), tuple(dr.shape), w.stride()[-1]))
        return real(coeffs2, pr, pi, comps3, dr, di, w)

    monkeypatch.setattr(tloss, "fused_chunk_loss", spy)
    full_val, full_grad = _loss_and_grads_with(t, t["w"])
    val, grad = _loss_and_grads_with(t, planes)
    assert len(seen) == 2 and seen[1][0] == seen[1][1] and seen[1][2] == 0
    assert float(val) == float(full_val)
    for got, want in zip(grad, full_grad):
        assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_chunked_loss_takes_a_compressed_weights_plane(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from calamity_tpu_torch import LAUNCHES
    from calamity_tpu_torch.ops.fused import KERNEL_NAME

    t, planes = _compressed_weights_case(dtype, "cuda")
    full_val, full_grad = _loss_and_grads_with(t, t["w"])
    before = LAUNCHES.get(KERNEL_NAME)
    val, grad = _loss_and_grads_with(t, planes)
    assert LAUNCHES.get(KERNEL_NAME) == before + 1
    assert rel_err(val, full_val) <= 1e-6
    for got, want in zip(grad, full_grad):
        assert rel_err(got, want) <= 1e-6
