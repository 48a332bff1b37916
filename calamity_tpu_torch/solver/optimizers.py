"""First-order optimizers as functional updates over an explicit state.

Port of calamity_tpu/solver/optimizers.py. Each optimizer is a pair of
plain functions, ``init(params) -> state`` and ``update(grads, state,
params) -> (new_params, state)``, over a parameter tree (a dict whose
values are tensors or lists of tensors). The state is explicit because the
mixed precision schedule carries it across its precision switch. The
semantics are optax's, with TensorFlow keyword names and defaults
(learning_rate 1e-3, epsilon 1e-7). ``torch.optim`` is not used: its
defaults and update rules differ from optax's.

Only Adamax, the default of the fit, is ported so far; the other names of
the reference registry raise.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch


def tree_map(fn, *trees):
    """Apply ``fn`` leafwise over parameter trees of one structure
    (dicts, lists and tuples of tensors)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(tree_map(fn, *xs) for xs in zip(*trees)))
    if isinstance(first, (list, tuple)):
        return type(first)(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def tree_leaves(tree):
    """Leaves of a parameter tree, in a fixed order."""
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for x in tree for leaf in tree_leaves(x)]
    return [tree]


class AdamaxState(NamedTuple):
    """optax ``ScaleByAdamState`` of adamax: step count and the two moments."""

    count: int
    mu: Any
    nu: Any


class Optimizer(NamedTuple):
    init: Callable
    update: Callable


def adamax(learning_rate=1e-3, beta_1=0.9, beta_2=0.999, epsilon=1e-7):
    """optax ``adamax``: mu = (1-b1) g + b1 mu; nu = max(|g| + eps, b2 nu);
    p += -lr * (mu / (1 - b1**t)) / nu, with every product taken in the
    parameter dtype in that order."""
    b1, b2, eps, lr = float(beta_1), float(beta_2), float(epsilon), float(learning_rate)

    def init(params):
        zeros = tree_map(torch.zeros_like, params)
        return AdamaxState(count=0, mu=zeros, nu=tree_map(torch.zeros_like, params))

    @torch.no_grad()
    def update(grads, state, params):
        count = state.count + 1
        mu = tree_map(lambda g, m: (1 - b1) * g + b1 * m, grads, state.mu)
        nu = tree_map(lambda g, n: torch.maximum(torch.abs(g) + eps, b2 * n), grads, state.nu)
        # the bias correction is formed in double precision and rounded to
        # the moment dtype, as optax does under 64-bit mode
        bc = 1 - b1**count
        new_params = tree_map(
            lambda p, m, n: p + (m / torch.tensor(bc, dtype=m.dtype)) / n * (-lr),
            params, mu, nu,
        )
        return new_params, AdamaxState(count=count, mu=mu, nu=nu)

    return Optimizer(init, update)


OPTIMIZERS = {"Adamax": adamax}
# names of the reference registry (calamity_tpu/solver/optimizers.py:149-159)
# not ported yet
_NOT_PORTED = ("Adadelta", "Adam", "Ftrl", "Nadam", "SGD", "RMSprop", "Adagrad", "LAMB")


def get_optimizer(name, **opt_kwargs):
    """Instantiate an optimizer by reference-registry name."""
    if name not in OPTIMIZERS:
        extra = (
            f" ({name} is in the reference registry and is not ported yet; "
            "ROADMAP queue A item 5)"
            if name in _NOT_PORTED
            else ""
        )
        raise KeyError(f"unknown optimizer {name!r}{extra}; ported: {sorted(OPTIMIZERS)}")
    return OPTIMIZERS[name](**dict(opt_kwargs))
