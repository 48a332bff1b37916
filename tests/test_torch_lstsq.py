"""Cholesky warm start of the torch port against calamity_tpu.ops.lstsq,
in the dense, shared and shared-batched packings, with zero-padded basis
columns (their unit diagonal keeps the padded block decoupled).
Tolerances: float64 rel 1e-10; float32 rel 1e-5 (well-conditioned grams:
the basis columns are normalized, the ridge is 1e-6 relative)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import rel_err, to_np

from calamity_tpu.ops import lstsq as jlstsq
from calamity_tpu_torch.ops import lstsq as tlstsq

SHAPES = {  # packing: (comps shape, ngrps)
    "dense": ((5, 2, 40, 6), 5),
    "shared": ((1, 1, 40, 6), 4),
    "shared_batched": ((3, 1, 40, 6), 6),
}


@pytest.mark.parametrize("ridge", [1e-6, 1e-3])
@pytest.mark.parametrize("dtype, tol", [(np.float64, 1e-10), (np.float32, 1e-5)])
def test_init_coeffs_chunk_matches_reference(dtype, tol, ridge):
    rng = np.random.default_rng(8)
    comps = rng.standard_normal((5, 2, 40, 6))
    comps /= np.linalg.norm(comps, axis=2, keepdims=True)
    comps[..., -2:] = 0.0  # zero-padded columns
    data = rng.standard_normal((5, 2, 40))
    wgts = np.abs(rng.standard_normal(data.shape))
    wgts[wgts < 0.3] = 0.0
    comps, data, wgts = (x.astype(dtype) for x in (comps, data, wgts))
    want = jlstsq.init_coeffs_chunk(jnp.asarray(comps), jnp.asarray(data), jnp.asarray(wgts),
                                    ridge=ridge)
    got = tlstsq.init_coeffs_chunk(torch.as_tensor(comps), torch.as_tensor(data),
                                   torch.as_tensor(wgts), ridge=ridge)
    assert tuple(got.shape) == want.shape == (5, 6) and got.dtype == torch.as_tensor(data).dtype
    assert rel_err(got, want) <= tol
    assert np.all(to_np(got)[:, -2:] == 0.0)


@pytest.mark.parametrize("dtype, tol", [(np.float64, 1e-10), (np.float32, 1e-5)])
@pytest.mark.parametrize("packing", list(SHAPES))
def test_warm_start_matches_reference(packing, dtype, tol):
    shape, ngrps = SHAPES[packing]
    rng = np.random.default_rng(3)
    comps = rng.standard_normal(shape)
    comps /= np.linalg.norm(comps, axis=2, keepdims=True)
    comps[..., -2:] = 0.0  # zero-padded columns
    data = rng.standard_normal((ngrps, shape[1], shape[2]))
    wgts = np.abs(rng.standard_normal(data.shape))
    wgts[wgts < 0.3] = 0.0  # flagged samples
    comps, data, wgts = (x.astype(dtype) for x in (comps, data, wgts))

    jchol, jact = jlstsq.gram_cholesky_chunk(jnp.asarray(comps))
    tchol, tact = tlstsq.gram_cholesky_chunk(torch.as_tensor(comps))
    assert rel_err(tchol, jchol) <= tol
    np.testing.assert_array_equal(to_np(tact), np.asarray(jact))
    # padded columns: unit diagonal, zero off-diagonal
    np.testing.assert_array_equal(to_np(tchol)[..., -2:, -2:], np.broadcast_to(
        np.eye(2, dtype=dtype), tchol.shape[:-2] + (2, 2)))

    want = jlstsq.init_coeffs_from_cholesky(jchol, jact, jnp.asarray(comps),
                                            jnp.asarray(data), jnp.asarray(wgts))
    got = tlstsq.init_coeffs_from_cholesky(tchol, tact, torch.as_tensor(comps),
                                           torch.as_tensor(data), torch.as_tensor(wgts))
    assert got.dtype == (torch.float64 if dtype == np.float64 else torch.float32)
    assert tuple(got.shape) == want.shape == (ngrps, shape[3])
    assert rel_err(got, want) <= tol
    assert np.all(to_np(got)[:, -2:] == 0.0)
