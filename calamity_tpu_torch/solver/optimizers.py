"""First-order optimizers as functional updates over an explicit state.

Port of calamity_tpu/solver/optimizers.py. Each optimizer is a pair of
plain functions, ``init(params) -> state`` and ``update(grads, state,
params) -> (new_params, state)``, over a parameter tree (a dict whose
values are tensors or lists of tensors). The state is explicit because the
mixed precision schedule carries it across its precision switch. The
semantics are optax's, with TensorFlow keyword names and defaults
(learning_rate 1e-3, epsilon 1e-7). ``torch.optim`` is not used: its
defaults and update rules differ from optax's.

Every name of the reference registry is here: Adadelta, Adam, Adamax,
Ftrl, Nadam, SGD, RMSprop, Adagrad and LAMB. Each update follows the
arithmetic of optax's transform chain (the reference's in-repo one for
Ftrl), so a float64 run agrees with the reference to rounding. A state
field that an optimizer does not use is an empty tuple, so every state
saves in a checkpoint; ``count`` is the step count where optax keeps one:
a 0-d int64 tensor on the parameters' device, so that an update reads no
host value and a captured step (``solver.graph``) replays at every count.
The bias corrections ``1 - b**count`` come from a table the host forms
once per optimizer, dtype and device (:class:`_BiasCorrection`), indexed on
the device by the count.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

# the longest bias-correction table: a beta whose correction has not
# rounded to 1 by then (one within about 4e-5 of 1) takes the last entry
# for every later count
_BIAS_TABLE_MAX = 1 << 20


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


def _zero_count(params):
    """A fresh step count: 0-d int64 on the parameters' device."""
    return torch.zeros((), dtype=torch.int64, device=tree_leaves(params)[0].device)


def _next_count(count, params):
    """``count + 1`` as a tensor on the parameters' device (a state may
    carry a Python int, as one converted from optax or written by hand)."""
    if not isinstance(count, torch.Tensor):
        count = torch.tensor(int(count), dtype=torch.int64,
                             device=tree_leaves(params)[0].device)
    return count + 1


def _bias_values(b):
    """``1 - b**k`` for k = 0, 1, ... as Python floats (double precision,
    as the update formed it on the host), up to the first k where it
    rounds to 1, so that every later count reads the last entry exactly."""
    values = []
    for k in range(_BIAS_TABLE_MAX):
        try:
            v = 1 - b**k
        except OverflowError:  # |b| > 1: the correction overflows, as it did per step
            break
        values.append(v)
        if k > 0 and v == 1.0:
            break
    return values


class _BiasCorrection:
    """``1 - b**count`` rounded to a moment's dtype, for a count on the
    device: one table per dtype and device, formed on the host at the first
    update (before any capture) and indexed by the count, equal to the bit
    to forming the value on the host at each step."""

    def __init__(self, b):
        self._values = None
        self.b = b
        self._tables = {}

    def table(self, like):
        key = (like.dtype, like.device)
        if key not in self._tables:
            if self._values is None:
                self._values = _bias_values(self.b)
            self._tables[key] = torch.tensor(self._values, dtype=like.dtype, device=like.device)
        return self._tables[key]

    def at(self, count):
        """A function of a moment tensor: this count's correction in its
        dtype, 0-d on its device (one lookup per dtype)."""
        looked = {}

        def of(t):
            if t.dtype not in looked:
                table = self.table(t)
                idx = torch.clamp(count, max=table.numel() - 1).reshape(1)
                looked[t.dtype] = torch.index_select(table, 0, idx).reshape(())
            return looked[t.dtype]

        return of


class AdamaxState(NamedTuple):
    """optax ``ScaleByAdamState`` of adamax: step count and the two moments."""

    count: Any  # 0-d int64 tensor
    mu: Any
    nu: Any


class AdamaxHyper(NamedTuple):
    """What the descents need to run :func:`adamax` as their kernel
    (``ops.adamax``): its hyperparameters, as the update reads them, and
    its bias-correction table."""

    learning_rate: float
    beta_1: float
    beta_2: float
    epsilon: float
    bias1: Any  # _BiasCorrection of beta_1


class Optimizer(NamedTuple):
    init: Callable
    update: Callable
    # an AdamaxHyper for adamax, whose descent step runs on two kernels on
    # the card (ops.adamax); None for the others
    hyper: Any = None


def adamax(learning_rate=1e-3, beta_1=0.9, beta_2=0.999, epsilon=1e-7):
    """optax ``adamax``: mu = (1-b1) g + b1 mu; nu = max(|g| + eps, b2 nu);
    p += -lr * (mu / (1 - b1**t)) / nu, with every product taken in the
    parameter dtype in that order."""
    b1, b2, eps, lr = float(beta_1), float(beta_2), float(epsilon), float(learning_rate)
    bias1 = _BiasCorrection(b1)

    def init(params):
        zeros = tree_map(torch.zeros_like, params)
        return AdamaxState(count=_zero_count(params), mu=zeros,
                           nu=tree_map(torch.zeros_like, params))

    @torch.no_grad()
    def update(grads, state, params):
        count = _next_count(state.count, params)
        mu = tree_map(lambda g, m: (1 - b1) * g + b1 * m, grads, state.mu)
        nu = tree_map(lambda g, n: torch.maximum(torch.abs(g) + eps, b2 * n), grads, state.nu)
        # the bias correction is formed in double precision and rounded to
        # the moment dtype, as optax does under 64-bit mode
        bc = bias1.at(count)
        new_params = tree_map(lambda p, m, n: p + (m / bc(m)) / n * (-lr), params, mu, nu)
        return new_params, AdamaxState(count=count, mu=mu, nu=nu)

    return Optimizer(init, update, AdamaxHyper(lr, b1, b2, eps, bias1))


class AdamState(NamedTuple):
    """optax ``ScaleByAdamState`` (adam, nadam and the first stage of lamb)."""

    count: Any  # 0-d int64 tensor
    mu: Any
    nu: Any


def _moment(g, m, decay, order):
    # optax tree_update_moment: (1 - decay) * g**order + decay * m
    return (1 - decay) * (g * g if order == 2 else g) + decay * m


def _scaled(bc, t):
    # bias correction formed in double precision, rounded to the moment
    # dtype, then divided in that dtype (optax tree_bias_correction)
    return t / bc(t)


def _apply(params, updates):
    return tree_map(lambda p, u: p + u, params, updates)


def _adam_updates(grads, state, params, bias1, bias2, eps, eps_root, nesterov):
    """optax ``scale_by_adam``: (updates, new state), before the learning
    rate; ``bias1``, ``bias2``: the :class:`_BiasCorrection` of beta_1 and
    beta_2."""
    b1 = bias1.b
    count = _next_count(state.count, params)
    mu = tree_map(lambda g, m: _moment(g, m, b1, 1), grads, state.mu)
    nu = tree_map(lambda g, n: _moment(g, n, bias2.b, 2), grads, state.nu)
    if nesterov:
        bc_next, bc_now = bias1.at(count + 1), bias1.at(count)
        mu_hat = tree_map(lambda m, g: b1 * _scaled(bc_next, m) + (1 - b1) * _scaled(bc_now, g),
                          mu, grads)
    else:
        bc1 = bias1.at(count)
        mu_hat = tree_map(lambda m: _scaled(bc1, m), mu)
    bc2 = bias2.at(count)
    updates = tree_map(lambda m, n: m / (torch.sqrt(_scaled(bc2, n) + eps_root) + eps),
                       mu_hat, nu)
    return updates, AdamState(count=count, mu=mu, nu=nu)


def _adam_init(params):
    return AdamState(count=_zero_count(params), mu=tree_map(torch.zeros_like, params),
                     nu=tree_map(torch.zeros_like, params))


def adam(learning_rate=1e-3, beta_1=0.9, beta_2=0.999, epsilon=1e-7, eps_root=0.0,
         nesterov=False):
    """optax ``adam`` (``nadam`` with ``nesterov=True``): u = mu_hat /
    (sqrt(nu_hat + eps_root) + eps), p += -lr * u."""
    eps, lr = float(epsilon), float(learning_rate)
    bias1, bias2 = _BiasCorrection(float(beta_1)), _BiasCorrection(float(beta_2))

    @torch.no_grad()
    def update(grads, state, params):
        updates, state = _adam_updates(grads, state, params, bias1, bias2, eps, float(eps_root),
                                       nesterov)
        return _apply(params, tree_map(lambda u: -lr * u, updates)), state

    return Optimizer(_adam_init, update)


def nadam(learning_rate=1e-3, beta_1=0.9, beta_2=0.999, epsilon=1e-7, eps_root=0.0):
    """optax ``nadam``: adam with the Nesterov first moment (no momentum
    decay schedule, unlike ``torch.optim.NAdam``)."""
    return adam(learning_rate, beta_1, beta_2, epsilon, eps_root, nesterov=True)


def lamb(learning_rate=1e-3, beta_1=0.9, beta_2=0.999, epsilon=1e-6, weight_decay=0.0,
         norm_psum=None):
    """optax ``lamb``: adam's update plus decayed weights, scaled per leaf
    by ||p|| / ||u|| (1 where either norm is zero), then by -lr.

    ``norm_psum``: on a device mesh, where each rank holds blocks of the
    leaves, a function that sums a tree of squared leaf norms over the
    ranks each leaf is split across (``parallel.mesh.MeshShard``), so the
    norms are the whole leaves'."""
    eps, lr = float(epsilon), float(learning_rate)
    bias1, bias2 = _BiasCorrection(float(beta_1)), _BiasCorrection(float(beta_2))
    wd = float(weight_decay)

    def ratio_of(pn, un):
        return torch.where((pn == 0) | (un == 0), torch.ones_like(pn), pn / un)

    def norms(tree):
        if norm_psum is None:
            return tree_map(torch.linalg.vector_norm, tree)
        return tree_map(torch.sqrt, norm_psum(tree_map(lambda x: torch.sum(x * x), tree)))

    @torch.no_grad()
    def update(grads, state, params):
        updates, state = _adam_updates(grads, state, params, bias1, bias2, eps, 0.0, False)
        updates = tree_map(lambda u, p: u + wd * p, updates, params)
        updates = tree_map(lambda u, pn, un: u * ratio_of(pn, un), updates, norms(params),
                           norms(updates))
        return _apply(params, tree_map(lambda u: -lr * u, updates)), state

    return Optimizer(_adam_init, update)


class TraceState(NamedTuple):
    """optax ``TraceState``: the momentum buffer (an empty tuple without
    momentum)."""

    trace: Any


def _trace_update(updates, state, decay, nesterov):
    trace = tree_map(lambda g, t: g + decay * t, updates, state.trace)
    if nesterov:
        updates = tree_map(lambda g, t: g + decay * t, updates, trace)
    else:
        updates = trace
    return updates, TraceState(trace)


def sgd(learning_rate=1e-2, momentum=0.0, nesterov=False):
    """optax ``sgd``, momentum 0 meaning none (as the reference registry
    maps it): t = g + m t; p += -lr * (t, or g + m t with Nesterov)."""
    lr, mom = float(learning_rate), float(momentum or 0.0)

    def init(params):
        return TraceState(tree_map(torch.zeros_like, params) if mom else ())

    @torch.no_grad()
    def update(grads, state, params):
        updates = grads
        if mom:
            updates, state = _trace_update(grads, state, mom, nesterov)
        return _apply(params, tree_map(lambda u: -lr * u, updates)), state

    return Optimizer(init, update)


class RmsState(NamedTuple):
    """optax ``ScaleByRmsState`` / ``ScaleByRStdDevState`` with the
    momentum buffer of the chain's trace (empty tuples where unused)."""

    mu: Any
    nu: Any
    trace: Any


def rmsprop(learning_rate=1e-3, rho=0.9, momentum=0.0, epsilon=1e-7, centered=False):
    """optax ``rmsprop`` as the reference registry builds it: nu = (1-rho)
    g^2 + rho nu; u = g / sqrt(nu [- mu^2] + eps) * -lr, then the momentum
    trace on the scaled update."""
    lr, rho, eps, mom = float(learning_rate), float(rho), float(epsilon), float(momentum or 0.0)

    def init(params):
        zeros = lambda: tree_map(torch.zeros_like, params)  # noqa: E731
        return RmsState(mu=zeros() if centered else (), nu=zeros(),
                        trace=zeros() if mom else ())

    @torch.no_grad()
    def update(grads, state, params):
        nu = tree_map(lambda g, n: _moment(g, n, rho, 2), grads, state.nu)
        mu = state.mu
        if centered:
            mu = tree_map(lambda g, m: _moment(g, m, rho, 1), grads, state.mu)
            updates = tree_map(lambda m, n, g: torch.rsqrt(n - m * m + eps) * g, mu, nu, grads)
        else:
            updates = tree_map(lambda n, g: torch.rsqrt(n + eps) * g, nu, grads)
        updates = tree_map(lambda u: -lr * u, updates)
        trace = state.trace
        if mom:
            updates, trace = _trace_update(updates, TraceState(trace), mom, False)
            trace = trace.trace
        return _apply(params, updates), RmsState(mu=mu, nu=nu, trace=trace)

    return Optimizer(init, update)


class AdagradState(NamedTuple):
    """optax ``ScaleByRssState``."""

    sum_of_squares: Any


def adagrad(learning_rate=1e-3, initial_accumulator_value=0.1, epsilon=1e-7):
    """optax ``adagrad``: s += g^2; u = g / sqrt(s + eps) (0 where s is
    not positive) * -lr."""
    lr, iav, eps = float(learning_rate), float(initial_accumulator_value), float(epsilon)

    def init(params):
        return AdagradState(tree_map(lambda p: torch.full_like(p, iav), params))

    @torch.no_grad()
    def update(grads, state, params):
        sos = tree_map(lambda g, t: g * g + t, grads, state.sum_of_squares)
        updates = tree_map(
            lambda t, g: torch.where(t > 0, torch.rsqrt(t + eps), torch.zeros_like(t)) * g,
            sos, grads)
        return _apply(params, tree_map(lambda u: -lr * u, updates)), AdagradState(sos)

    return Optimizer(init, update)


class AdadeltaState(NamedTuple):
    """optax ``ScaleByAdaDeltaState``."""

    e_g: Any
    e_x: Any


def adadelta(learning_rate=1e-3, rho=0.95, epsilon=1e-7):
    """optax ``adadelta``: e_g = (1-rho) g^2 + rho e_g; u = sqrt(e_x + eps)
    / sqrt(e_g + eps) g; e_x = (1-rho) u^2 + rho e_x; p += -lr * u."""
    lr, rho, eps = float(learning_rate), float(rho), float(epsilon)

    def init(params):
        return AdadeltaState(tree_map(torch.zeros_like, params),
                             tree_map(torch.zeros_like, params))

    @torch.no_grad()
    def update(grads, state, params):
        e_g = tree_map(lambda g, e: _moment(g, e, rho, 2), grads, state.e_g)
        updates = tree_map(lambda g, eg, ex: (torch.sqrt(ex + eps) / torch.sqrt(eg + eps)) * g,
                           grads, e_g, state.e_x)
        e_x = tree_map(lambda u, e: _moment(u, e, rho, 2), updates, state.e_x)
        return (_apply(params, tree_map(lambda u: -lr * u, updates)),
                AdadeltaState(e_g, e_x))

    return Optimizer(init, update)


class FtrlState(NamedTuple):
    """The reference's in-repo FTRL state: accumulated squared gradients
    and the linear term."""

    n: Any
    z: Any


def ftrl(learning_rate=1e-3, learning_rate_power=-0.5, initial_accumulator_value=0.1,
         l1_regularization_strength=0.0, l2_regularization_strength=0.0):
    """FTRL-proximal as the reference implements it
    (calamity_tpu/solver/optimizers.py:84-141, tf.keras.optimizers.Ftrl
    semantics): the new parameter in closed form, applied as an update."""
    alpha, lrp = float(learning_rate), float(learning_rate_power)
    l1, l2 = float(l1_regularization_strength), float(l2_regularization_strength)
    iav = float(initial_accumulator_value)

    def init(params):
        return FtrlState(tree_map(lambda p: torch.full_like(p, iav), params),
                         tree_map(torch.zeros_like, params))

    @torch.no_grad()
    def update(grads, state, params):
        n_new = tree_map(lambda g, n: n + g * g, grads, state.n)
        z_new = tree_map(
            lambda g, n, nn, z, p: z + g - ((torch.pow(nn, -lrp) - torch.pow(n, -lrp)) / alpha) * p,
            grads, state.n, n_new, state.z, params)

        def step(z, nn, p):
            p_new = torch.where(torch.abs(z) <= l1, torch.zeros_like(p),
                                (torch.sign(z) * l1 - z) / (torch.pow(nn, -lrp) / alpha + 2.0 * l2))
            return p_new - p

        updates = tree_map(step, z_new, n_new, params)
        return _apply(params, updates), FtrlState(n_new, z_new)

    return Optimizer(init, update)


# the reference registry (calamity_tpu/solver/optimizers.py:149-159), with
# its TensorFlow keyword names and defaults
OPTIMIZERS = {
    "Adadelta": adadelta,
    "Adam": adam,
    "Adamax": adamax,
    "Ftrl": ftrl,
    "Nadam": nadam,
    "SGD": sgd,
    "RMSprop": rmsprop,
    "Adagrad": adagrad,
    "LAMB": lamb,
}


def get_optimizer(name, norm_psum=None, **opt_kwargs):
    """Instantiate an optimizer by reference-registry name. ``norm_psum``
    reaches LAMB, the one optimizer that is not elementwise (see
    :func:`lamb`); every other update is the same on a leaf's blocks as on
    the whole leaf."""
    if name not in OPTIMIZERS:
        raise KeyError(f"unknown optimizer {name!r}; options: {sorted(OPTIMIZERS)}")
    if name == "LAMB" and norm_psum is not None:
        opt_kwargs = dict(opt_kwargs, norm_psum=norm_psum)
    return OPTIMIZERS[name](**dict(opt_kwargs))
