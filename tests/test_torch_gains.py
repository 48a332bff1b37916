"""The gain products and their gradient (``calamity_tpu_torch.ops.gains``)
against the old torch ops and the JAX package.

``GainProducts``' backward on the CPU is the plain version, the
``index_select`` backward under autograd; it is held against the JAX
package's ``jax.vjp`` through ``calamity_tpu.ops.loss.gain_products`` in
float64 (rel 1e-12: only the order of a few dozen additions differs), for
the dense, dense multi-baseline, shared and shared-batched chunk layouts,
a slice axis, a padded row and an antenna with no rows. The CUDA kernel
sums each antenna's entries in the order of its CSR list: the list is
checked, and a numpy loop in that order is held against the plain version
(rel 1e-12). The kernel itself runs on the card only (``gpu`` test; it has
no CPU mode).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import rel_err

from calamity_tpu.ops import loss as jloss
from calamity_tpu_torch.ops import gains

NA, NF = 7, 16  # antenna 6 is in no row


def _indices(rng, kind):
    """(a0, a1) of one chunk in the given layout: (ngrps, nbls) int32."""
    ngrps, nbls = {"dense": (5, 1), "dense_b2": (3, 2), "shared": (4, 1),
                   "shared_batched": (6, 1), "padded": (5, 1)}[kind]
    a0 = rng.integers(0, NA - 1, (ngrps, nbls)).astype(np.int32)
    a1 = ((a0 + 1 + rng.integers(0, NA - 2, (ngrps, nbls))) % (NA - 1)).astype(np.int32)
    if kind == "padded":  # a padding row: antenna 0 with itself, zero cotangent
        a0[-1], a1[-1] = 0, 0
    return a0, a1


def _problem(kind, nbatch, seed=3):
    rng = np.random.default_rng(seed)
    a0, a1 = _indices(rng, kind)
    g_r = 1 + 0.1 * rng.standard_normal((nbatch, NA, NF))
    g_i = 0.1 * rng.standard_normal((nbatch, NA, NF))
    dpr = rng.standard_normal((nbatch,) + a0.shape + (NF,))
    dpi = rng.standard_normal((nbatch,) + a0.shape + (NF,))
    if kind == "padded":
        dpr[:, -1] = dpi[:, -1] = 0.0
    return a0, a1, g_r, g_i, dpr, dpi


def _jax_grads(a0, a1, g_r, g_i, dpr, dpi):
    out = []
    for n in range(g_r.shape[0]):
        _, vjp = jax.vjp(lambda gr, gi: jloss.gain_products(gr, gi, jnp.asarray(a0),
                                                            jnp.asarray(a1)),
                         jnp.asarray(g_r[n]), jnp.asarray(g_i[n]))
        out.append(vjp((jnp.asarray(dpr[n]), jnp.asarray(dpi[n]))))
    return (np.stack([np.asarray(o[0]) for o in out]),
            np.stack([np.asarray(o[1]) for o in out]))


@pytest.mark.parametrize("nbatch", [1, 3])
@pytest.mark.parametrize("kind", ["dense", "dense_b2", "shared", "shared_batched", "padded"])
def test_gain_products_backward_matches_old_autograd_and_jax(kind, nbatch):
    a0, a1, g_r, g_i, dpr, dpi = _problem(kind, nbatch)
    t = [torch.as_tensor(x) for x in (g_r, g_i, dpr, dpi)]
    gr, gi = (x.clone().requires_grad_(True) for x in t[:2])
    ia0, ia1 = torch.as_tensor(a0), torch.as_tensor(a1)
    pr, pi = gains.gain_products_batched(gr, gi, ia0, ia1)
    got = torch.autograd.grad((pr, pi), (gr, gi), (t[2], t[3]))
    # the old ops: index_select under autograd
    gr2, gi2 = (x.clone().requires_grad_(True) for x in t[:2])
    shape = (nbatch,) + a0.shape + (NF,)
    old = [g.index_select(1, i.reshape(-1)).reshape(shape) for g, i in
           ((gr2, ia0), (gr2, ia1), (gi2, ia0), (gi2, ia1))]
    old_pr, old_pi = old[0] * old[1] + old[2] * old[3], old[0] * old[3] - old[2] * old[1]
    want_old = torch.autograd.grad((old_pr, old_pi), (gr2, gi2), (t[2], t[3]))
    want_jax = _jax_grads(a0, a1, g_r, g_i, dpr, dpi)
    for g, w_old, w_jax in zip(got, want_old, want_jax):
        assert torch.equal(g, w_old)
        assert rel_err(g, w_jax) <= 1e-12
        assert torch.all(g[:, NA - 1] == 0)  # the antenna with no rows
    # the forward equals the reference's products exactly
    jr, ji = jloss.gain_products(jnp.asarray(g_r[0]), jnp.asarray(g_i[0]), jnp.asarray(a0),
                                 jnp.asarray(a1))
    assert np.array_equal(pr[0].detach().numpy(), np.asarray(jr))
    assert np.array_equal(pi[0].detach().numpy(), np.asarray(ji))


def test_serial_gain_products_backward_matches_jax():
    a0, a1, g_r, g_i, dpr, dpi = _problem("dense_b2", 1)
    gr, gi = (torch.as_tensor(x[0]).requires_grad_(True) for x in (g_r, g_i))
    pr, pi = gains.gain_products(gr, gi, torch.as_tensor(a0), torch.as_tensor(a1))
    got = torch.autograd.grad((pr, pi), (gr, gi), (torch.as_tensor(dpr[0]),
                                                   torch.as_tensor(dpi[0])))
    for g, w in zip(got, _jax_grads(a0, a1, g_r, g_i, dpr, dpi)):
        assert rel_err(g, w[0]) <= 1e-12


@pytest.mark.parametrize("kind", ["dense_b2", "padded"])
def test_antenna_csr_lists_each_row_side_once_in_ascending_order(kind):
    a0, a1, *_ = _problem(kind, 1)
    a0[0, 0] = a1[0, 0] = 2  # an autocorrelation row: antenna 2 on both sides
    offsets, rowside, other = (x.numpy() for x in gains.build_antenna_csr(
        torch.as_tensor(a0), torch.as_tensor(a1), NA))
    i0, i1 = a0.reshape(-1), a1.reshape(-1)
    assert offsets[0] == 0 and offsets[-1] == 2 * i0.size == rowside.size
    assert offsets[NA] == offsets[NA - 1]  # antenna 6: no entries
    seen = []
    for ant in range(NA):
        entries = rowside[offsets[ant]:offsets[ant + 1]]
        assert np.all(np.diff(entries) > 0)  # ascending rows, side 0 before side 1
        for rs, o in zip(entries, other[offsets[ant]:offsets[ant + 1]]):
            row, side = divmod(int(rs), 2)
            assert (i0 if side == 0 else i1)[row] == ant
            assert o == (i1 if side == 0 else i0)[row]
            seen.append(int(rs))
    assert sorted(seen) == list(range(2 * i0.size))  # each (row, side) exactly once
    # kept on the index tensor: built once
    t0, t1 = torch.as_tensor(a0), torch.as_tensor(a1)
    assert gains.antenna_csr(t0, t1, NA) is gains.antenna_csr(t0, t1, NA)


@pytest.mark.parametrize("kind", ["dense", "dense_b2", "shared_batched", "padded"])
def test_numpy_loop_in_the_kernels_order_matches_plain(kind):
    """The kernel's arithmetic, in its summation order, in numpy."""
    a0, a1, g_r, g_i, dpr, dpi = _problem(kind, 2)
    offsets, rowside, other = (x.numpy() for x in gains.build_antenna_csr(
        torch.as_tensor(a0), torch.as_tensor(a1), NA))
    nbatch = g_r.shape[0]
    pr2, pi2 = dpr.reshape(nbatch, -1, NF), dpi.reshape(nbatch, -1, NF)
    dg_r, dg_i = np.zeros_like(g_r), np.zeros_like(g_i)
    for ant in range(NA):
        for e in range(offsets[ant], offsets[ant + 1]):
            row, side = divmod(int(rowside[e]), 2)
            o = other[e]
            p_r, p_i, gr, gi = pr2[:, row], pi2[:, row], g_r[:, o], g_i[:, o]
            if side == 0:
                dg_r[:, ant] += p_r * gr + p_i * gi
                dg_i[:, ant] += p_r * gi - p_i * gr
            else:
                dg_r[:, ant] += p_r * gr - p_i * gi
                dg_i[:, ant] += p_r * gi + p_i * gr
    want = gains.gain_grad_plain(*(torch.as_tensor(x) for x in (dpr, dpi, g_r, g_i, a0, a1)))
    assert rel_err(dg_r, want[0]) <= 1e-12 and rel_err(dg_i, want[1]) <= 1e-12


def test_kernel_takes_only_cuda_tensors():
    a0, a1, g_r, g_i, dpr, dpi = _problem("dense", 1)
    csr = gains.build_antenna_csr(torch.as_tensor(a0), torch.as_tensor(a1), NA)
    with pytest.raises(ValueError, match="CUDA tensors"):
        gains.gain_grad_kernel(torch.as_tensor(dpr).reshape(1, -1, NF),
                               torch.as_tensor(dpi).reshape(1, -1, NF),
                               torch.as_tensor(g_r), torch.as_tensor(g_i), csr)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["dense_b2", "padded"])
def test_cuda_kernel_matches_plain_and_repeats_bit_for_bit(kind, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    a0, a1, g_r, g_i, dpr, dpi = _problem(kind, 3)
    dev = torch.device("cuda")
    t = [torch.as_tensor(x, device=dev, dtype=dtype) for x in (dpr, dpi, g_r, g_i)]
    ia = [torch.as_tensor(x, device=dev) for x in (a0, a1)]
    csr = gains.antenna_csr(*ia, NA)
    got = gains.gain_grad_kernel(t[0].reshape(3, -1, NF), t[1].reshape(3, -1, NF), t[2], t[3],
                                 csr)
    again = gains.gain_grad_kernel(t[0].reshape(3, -1, NF), t[1].reshape(3, -1, NF), t[2], t[3],
                                   csr)
    want = gains.gain_grad_plain(*t, *ia)
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        assert rel_err(g, w) <= (1e-5 if dtype == torch.float32 else 1e-12)
