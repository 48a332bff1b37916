"""The port's fused chunk loss against calamity_tpu's Pallas kernel.

On the CPU the port's ``fused_chunk_loss`` runs its plain torch forward and
the autograd Function's backward; the JAX ``fused_chunk_loss`` runs its
Pallas kernel in interpret mode, as tests/test_fused.py runs it (NG=16,
NF=256, NV=128, the shapes its TPU gate accepts). At ragged shapes that the
TPU gate refuses, the reference is the JAX einsum ``chunked_loss``.
float32 tolerances: loss rel 1e-5, gradients rel 1e-4 (float32 sums over
NF*NV terms in different orders). The kernel-against-plain test needs a
CUDA card and is skipped without one.
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
from calamity_tpu_torch import LAUNCHES
from calamity_tpu_torch.ops import fused
from calamity_tpu_torch.ops import loss as tloss

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
    dense = (torch.zeros((3, 1, 8, 2)), torch.zeros((3, 1), dtype=torch.int32), None)
    shared = (torch.zeros((1, 1, 8, 2)), torch.zeros((4, 1), dtype=torch.int32), None)
    fr = [torch.zeros((3, 2)), torch.zeros((4, 2))]
    data = [torch.zeros((3, 1, 8)), torch.zeros((4, 1, 8))]
    with pytest.warns(UserWarning, match="chunk 1: shared-basis"):
        reasons = fused.warn_fused_fallbacks((dense, shared), fr, data, data)
    assert len(reasons) == 1


def test_kernel_wrapper_refuses_cpu_tensors_and_bad_operands():
    t = [torch.as_tensor(a) for a in _inputs(3, 8, 2)]
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused._fwd_kernel(*t)
    bad = list(t)
    bad[1] = torch.zeros((8, 3)).t()  # the right shape, not contiguous
    with pytest.raises(ValueError, match="not contiguous"):
        fused._fwd_kernel(*bad)
    bad = list(t)
    bad[0] = t[0][:, :2]
    with pytest.raises(ValueError, match="coeffs2 shape"):
        fused._fwd_kernel(*bad)
    bad = list(t)
    bad[4] = t[4].double()
    with pytest.raises(TypeError, match="dr dtype"):
        fused._fwd_kernel(*bad)


def test_cpu_forward_launches_no_kernel():
    LAUNCHES.reset()
    _torch_grads(fused.fused_chunk_loss, _inputs(4, 16, 3))
    assert LAUNCHES.get(fused.KERNEL_NAME) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("comps_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(5, 37, 3), (7, 129, 130), (64, 256, 119)])
def test_cuda_kernel_matches_plain(shape, comps_dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    args = [torch.as_tensor(a, device=dev) for a in _inputs(*shape)]
    args[3] = args[3].to(comps_dtype)
    before = LAUNCHES.get(fused.KERNEL_NAME)
    loss_k, v_k = fused._fwd_kernel(*args)
    assert LAUNCHES.get(fused.KERNEL_NAME) == before + 1
    loss_p, v_p = fused._fwd_plain(*args)
    torch.cuda.synchronize()
    assert rel_err(loss_k, loss_p) <= 1e-5
    assert rel_err(v_k, v_p) <= 1e-5
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
    assert [os.path.basename(s) for s in _build.sources()] == ["fused_chunk_loss.cu"]
