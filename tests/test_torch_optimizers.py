"""The port's functional Adamax against optax.adamax (through the reference
registry, with its TensorFlow-keyword defaults), on a fixed sequence of
gradients over the fit's parameter tree, and with an optax state carried
into the port through calamity_tpu_torch.convert. Same op order as optax:
float32 parameters agree to rel 1e-6 (a division by the bias correction
may round differently), float64 to rel 1e-12."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_parity import rel_err

from calamity_tpu.solver.optimizers import get_optimizer as jax_get_optimizer
from calamity_tpu_torch.convert import adamax_state_from_optax, params_from_jax
from calamity_tpu_torch.solver.optimizers import get_optimizer, tree_leaves


def _tree(rng, dtype):
    return (rng.standard_normal((4, 6)).astype(dtype), rng.standard_normal((4, 6)).astype(dtype),
            (rng.standard_normal((3, 5)).astype(dtype), rng.standard_normal((2, 5)).astype(dtype)),
            (rng.standard_normal((3, 5)).astype(dtype), rng.standard_normal((2, 5)).astype(dtype)))


def _jax_run(opt, params, grads_seq, state=None):
    state = opt.init(params) if state is None else state
    for g in grads_seq:
        updates, state = opt.update(g, state, params)
        params = optax.apply_updates(params, updates)
    return params, state


def _torch_run(opt, params, grads_seq, state=None):
    state = opt.init(params) if state is None else state
    for g in grads_seq:
        params, state = opt.update(params_from_jax(*g, device="cpu"), state, params)
    return params, state


@pytest.mark.parametrize("dtype, tol", [(np.float32, 1e-6), (np.float64, 1e-12)])
@pytest.mark.parametrize("kwargs", [{}, {"learning_rate": 1e-2},
                                    {"learning_rate": 3e-2, "beta_1": 0.8, "beta_2": 0.99,
                                     "epsilon": 1e-6}])
def test_adamax_matches_optax(kwargs, dtype, tol):
    rng = np.random.default_rng(0)
    params = _tree(rng, dtype)
    grads_seq = [_tree(rng, dtype) for _ in range(12)]
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jout, jstate = _jax_run(jax_get_optimizer("Adamax", **kwargs), jparams, grads_seq)
    tout, tstate = _torch_run(get_optimizer("Adamax", **kwargs),
                              params_from_jax(*params, device="cpu"),
                              grads_seq)
    assert tstate.count == int(jstate[0].count) == len(grads_seq)
    for got, want in zip(tree_leaves(tout), jax.tree_util.tree_leaves(jout)):
        assert got.dtype == (torch.float32 if dtype == np.float32 else torch.float64)
        assert rel_err(got, want) <= tol
    for got, want in zip(tree_leaves(tstate.nu), jax.tree_util.tree_leaves(jstate[0].nu)):
        assert rel_err(got, want) <= tol


def test_optax_state_carried_through_convert():
    rng = np.random.default_rng(1)
    params = _tree(rng, np.float32)
    first = [_tree(rng, np.float32) for _ in range(5)]
    second = [_tree(rng, np.float32) for _ in range(5)]
    jopt = jax_get_optimizer("Adamax", learning_rate=1e-2)
    jmid, jstate = _jax_run(jopt, jax.tree_util.tree_map(jnp.asarray, params), first)
    jout, _ = _jax_run(jopt, jmid, second, jstate)
    carried = adamax_state_from_optax(jstate, device="cpu")
    assert carried.count == 5
    tout, _ = _torch_run(get_optimizer("Adamax", learning_rate=1e-2),
                         params_from_jax(*jmid, device="cpu"), second, carried)
    for got, want in zip(tree_leaves(tout), jax.tree_util.tree_leaves(jout)):
        assert rel_err(got, want) <= 1e-6


def test_freeze_model_tree():
    # gains only: the optimizer takes any tree of tensors
    rng = np.random.default_rng(2)
    g = [torch.as_tensor(rng.standard_normal((3, 4)).astype(np.float32)) for _ in range(2)]
    opt = get_optimizer("Adamax")
    params = {"g_r": g[0], "g_i": g[1]}
    new, state = opt.update({"g_r": torch.ones(3, 4), "g_i": -torch.ones(3, 4)},
                            opt.init(params), params)
    # first step of Adamax moves every coordinate by lr against the gradient sign
    assert torch.allclose(new["g_r"], g[0] - 1e-3, atol=1e-6)
    assert torch.allclose(new["g_i"], g[1] + 1e-3, atol=1e-6)
    assert state.count == 1


def test_unported_and_unknown_optimizers_raise():
    with pytest.raises(KeyError, match="not ported yet"):
        get_optimizer("Adam")
    with pytest.raises(KeyError, match="unknown optimizer 'Bogus'"):
        get_optimizer("Bogus")
    with pytest.raises(TypeError):
        get_optimizer("Adamax", momentum=0.9)
