"""The port's functional optimizers against the reference registry
(calamity_tpu.solver.optimizers: optax transforms with TensorFlow-keyword
defaults, and the in-repo FTRL), on a fixed sequence of gradients over the
fit's parameter tree; Adamax also with an optax state carried into the port
through calamity_tpu_torch.convert; every optimizer's state through a
checkpoint of the batched descent. Same op order as optax: float32
parameters agree to rel 1e-6 (a division by the bias correction may round
differently), float64 to rel 1e-12."""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_parity import rel_err

from calamity_tpu.solver.optimizers import OPTIMIZERS as JAX_OPTIMIZERS
from calamity_tpu.solver.optimizers import get_optimizer as jax_get_optimizer
from calamity_tpu_torch.convert import adamax_state_from_optax, params_from_jax
from calamity_tpu_torch.solver.optimizers import OPTIMIZERS, get_optimizer, tree_leaves


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
    # every name of the reference registry is ported
    assert sorted(OPTIMIZERS) == sorted(JAX_OPTIMIZERS)
    with pytest.raises(KeyError, match="unknown optimizer 'Bogus'; options: .*'LAMB'"):
        get_optimizer("Bogus")
    with pytest.raises(TypeError):
        get_optimizer("Adamax", momentum=0.9)
    with pytest.raises(TypeError):
        get_optimizer("Nadam", nesterov=False)  # optax.nadam takes no nesterov either


# (name, TensorFlow-style keywords): defaults, and the options each reference
# factory maps (momentum, Nesterov, centering, accumulators, regularization)
REGISTRY_CASES = [
    ("Adam", {}),
    ("Adam", {"learning_rate": 1e-2, "beta_1": 0.8, "beta_2": 0.99, "epsilon": 1e-6}),
    ("Adam", {"nesterov": True, "eps_root": 1e-8}),
    ("Nadam", {}),
    ("Nadam", {"learning_rate": 3e-2, "beta_1": 0.7}),
    ("SGD", {}),
    ("SGD", {"momentum": 0.9}),
    ("SGD", {"momentum": 0.9, "nesterov": True, "learning_rate": 1e-3}),
    ("RMSprop", {}),
    ("RMSprop", {"rho": 0.8, "momentum": 0.5, "centered": True, "learning_rate": 1e-2}),
    ("Adagrad", {}),
    ("Adagrad", {"initial_accumulator_value": 0.5, "learning_rate": 1e-2, "epsilon": 1e-5}),
    ("Adadelta", {}),
    ("Adadelta", {"rho": 0.9, "learning_rate": 1.0}),
    ("LAMB", {}),
    ("LAMB", {"weight_decay": 1e-2, "learning_rate": 1e-2}),
    ("Ftrl", {}),
    ("Ftrl", {"learning_rate": 0.1, "learning_rate_power": -0.6, "initial_accumulator_value": 0.3,
              "l1_regularization_strength": 1e-3, "l2_regularization_strength": 1e-2}),
]


@pytest.mark.parametrize("dtype, tol", [(np.float32, 1e-6), (np.float64, 1e-12)])
@pytest.mark.parametrize("name, kwargs", REGISTRY_CASES)
def test_optimizers_match_jax_registry(name, kwargs, dtype, tol):
    rng = np.random.default_rng(3)
    params = _tree(rng, dtype)
    grads_seq = [_tree(rng, dtype) for _ in range(20)]
    jout, _ = _jax_run(jax_get_optimizer(name, **kwargs),
                       jax.tree_util.tree_map(jnp.asarray, params), grads_seq)
    tout, tstate = _torch_run(get_optimizer(name, **kwargs),
                              params_from_jax(*params, device="cpu"), grads_seq)
    if "count" in tstate._fields:
        assert tstate.count == len(grads_seq)
    for got, want in zip(tree_leaves(tout), jax.tree_util.tree_leaves(jout)):
        assert got.dtype == (torch.float32 if dtype == np.float32 else torch.float64)
        assert rel_err(got, want) <= tol


@pytest.mark.parametrize("name, kwargs", [c for c in REGISTRY_CASES if c[1]] + [("Adamax", {})])
def test_every_optimizer_state_survives_a_checkpoint(name, kwargs, tmp_path):
    """The batched descent cut after a checkpoint and resumed: the restored
    optimizer state (momentum buffers, accumulators, empty fields, the step
    count) continues the uninterrupted trajectory bit for bit."""
    from calamity_tpu_torch.parallel import batched as tb
    from calamity_tpu_torch.solver.fit import FitConfig

    rng = np.random.default_rng(4)
    ngrps, nfreqs, nvecs, nants, nbatch = 5, 12, 3, 4, 2
    comps = torch.as_tensor(rng.standard_normal((ngrps, 1, nfreqs, nvecs)), dtype=torch.float32)
    a0 = torch.as_tensor([[0], [0], [1], [1], [2]])
    a1 = torch.as_tensor([[1], [2], [2], [3], [3]])

    def cube(*shape):
        return torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32)

    args = (((comps, a0, a1),), [cube(nbatch, ngrps, 1, nfreqs)], [cube(nbatch, ngrps, 1, nfreqs)],
            [torch.ones((nbatch, ngrps, 1, 1))], 1 + 0.1 * cube(nbatch, nants, nfreqs),
            0.1 * cube(nbatch, nants, nfreqs), [cube(nbatch, ngrps, nvecs)],
            [cube(nbatch, ngrps, nvecs)], None, None)
    cfg = FitConfig(optimizer=name, opt_kwargs=tuple(sorted(kwargs.items())), maxsteps=12,
                    tol=0.0)
    full = tb.batched_fit_checkpointed(cfg, *args, str(tmp_path / "a"), 4, True, False)
    os.makedirs(tmp_path / "b")
    shutil.copytree(tmp_path / "a" / "step_4", tmp_path / "b" / "step_4")
    resumed = tb.batched_fit_checkpointed(cfg, *args, str(tmp_path / "b"), 4, True, False)
    assert resumed.nsteps == full.nsteps == 12
    np.testing.assert_array_equal(resumed.loss_history, full.loss_history)
    for x, y in zip(tree_leaves(resumed.opt_state) + [resumed.g_r, *resumed.fg_r],
                    tree_leaves(full.opt_state) + [full.g_r, *full.fg_r]):
        assert torch.equal(torch.as_tensor(x), torch.as_tensor(y))
