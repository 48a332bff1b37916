"""The descents' Adamax update and carry as kernels (``ops.adamax``).

- The plain versions (``adamax_step_plain``, ``descent_carry_plain``) and
  the wrappers on CPU tensors against the torch sequence the descents ran
  before the kernels (``opt.update``, a ``where`` a leaf, the carry's scalar
  ops; kept here as it was), equal to the bit, float32 and float64: the
  serial carry live, not live, with patience, with a NaN and an inf
  gradient and a NaN loss, and with a count past the end of the bias
  table; the batched carry with frozen rows and the warm-up step, with
  patience and use_min, with non-finite gradients and losses, with the
  mesh's live flag given, and past the bias table.
- The same inputs through the JAX package's loop bodies: ``optax.adamax``
  (the reference registry's Adamax), ``_tree_where``
  (calamity_tpu/solver/fit.py:79) and ``keep_frozen``
  (calamity_tpu/parallel/batched.py:505-513, a local function, kept here
  as it is written there), float64, within
  ``test_torch_optimizers.py::test_adamax_matches_optax``'s float64
  tolerance, rel 1e-12 (same op order; a division by the bias correction
  may round differently).
- The wrappers refuse trees and carries the kernels do not take.
- ``gpu``: each kernel against its plain version on the card, equal to the
  bit, float32 and float64, serial and batched with frozen rows (left
  untouched byte for byte), at unaligned offsets and lengths not a
  multiple of 4, and with more leaves than one launch's table.
"""

import numpy as np
import optax
import pytest
import torch
from torch_parity import rel_err

import jax
import jax.numpy as jnp
from calamity_tpu.solver.fit import _tree_where
from calamity_tpu.solver.optimizers import get_optimizer as jax_get_optimizer
from calamity_tpu_torch import LAUNCHES
from calamity_tpu_torch.ops import adamax as A
from calamity_tpu_torch.solver.optimizers import AdamaxState, get_optimizer, tree_leaves, tree_map

NANTS, NF = 5, 8  # gains (nants, F)
CHUNKS = ((3, 4), (2, 6))  # coefficient lists (G, V)
NBATCH = 4
STEPS = 6
LR = 3e-2
# test_torch_optimizers.py::test_adamax_matches_optax's float64 tolerance
JAX_TOL = 1e-12


def _big(dtype):
    return 9e99 if dtype == np.float64 else float(np.float32(3e38))


def _tree(rng, dtype, lead=(), positive=False):
    def a(shape):
        x = rng.standard_normal(lead + shape)
        return (np.abs(x) if positive else x).astype(dtype)

    return {"g_r": a((NANTS, NF)), "g_i": a((NANTS, NF)), "fg_r": [a(s) for s in CHUNKS],
            "fg_i": [a(s) for s in CHUNKS]}


# the serial cases: the carry's entry state, what the inputs hold and the
# live steps the case takes before its stop
SERIAL = {
    "live": dict(moves=STEPS),
    "not_live": dict(end=0, moves=0),
    "patience": dict(patience=2, rising=True, moves=4),
    "nonfinite": dict(nan_grad=1, inf_grad=2, nan_loss=4, moves=5),
    "bias_end": dict(count_from_end=2, moves=STEPS),
}
# the batched cases
BATCHED = {
    "frozen_warmup": dict(frozen=(1,), warmup=1, moves=STEPS),
    "patience_use_min": dict(frozen=(3,), warmup=1, patience=2, use_min=True, nan_loss=(3, 2),
                             rising=True, moves=4),
    "nonfinite": dict(nan_grad=1, inf_grad=2, nan_loss=(2, 0), use_min=True, moves=STEPS),
    "mesh_live": dict(frozen=(0, 1, 2, 3), live=True, moves=STEPS),
    "bias_end": dict(frozen=(2,), count_from_end=2, step0=5, moves=STEPS),
}


def _problem(kind, case, dtype, seed=0):
    """numpy inputs of ``STEPS`` steps: the entry state and each step's
    gradients and losses."""
    opts = (SERIAL if kind == "serial" else BATCHED)[case]
    rng = np.random.default_rng(seed)
    lead = () if kind == "serial" else (NBATCH,)
    big = _big(dtype)
    p = {"params": _tree(rng, dtype, lead), "mu": _tree(rng, dtype, lead),
         "nu": _tree(rng, dtype, lead, positive=True), "best": _tree(rng, dtype, lead),
         "grads": [_tree(rng, dtype, lead) for _ in range(STEPS)]}
    shape = () if kind == "serial" else (NBATCH,)
    noise = 1 + 0.1 * rng.random((STEPS,) + (shape or (1,)))
    losses = 10.0 * np.exp(-0.3 * np.arange(STEPS))[:, None] * noise
    if opts.get("rising"):  # no new best after the second step
        losses[2:] = losses[1] * (1.5 + np.arange(STEPS - 2))[:, None]
    losses = losses.reshape((STEPS,) + shape).astype(dtype)
    if "nan_grad" in opts:
        p["grads"][opts["nan_grad"]]["fg_r"][1][..., 2] = np.nan
        p["grads"][opts["inf_grad"]]["g_i"][..., 1, 3] = -np.inf
    if "nan_loss" in opts:
        losses[opts["nan_loss"]] = np.nan
    p["losses"] = losses
    bias_len = len(get_optimizer("Adamax").hyper.bias1.table(torch.zeros((), dtype=torch.float64)))
    p["count"] = bias_len - opts["count_from_end"] if "count_from_end" in opts else 3
    p["opts"] = dict(opts, tol=1e-12, big=big)
    if kind == "batched":
        frozen = np.zeros(NBATCH, bool)
        frozen[list(opts.get("frozen", ()))] = True
        p["frozen"] = frozen
    return p


def _t(x, dtype=None):
    return tree_map(lambda a: torch.tensor(a, dtype=dtype), x)


class _State:
    """One side's torch state of a problem: the trees and the carry."""

    def __init__(self, kind, p):
        o = p["opts"]
        self.kind = kind
        self.params, self.best = _t(p["params"]), _t(p["best"])
        self.state = AdamaxState(count=torch.tensor(p["count"], dtype=torch.int64),
                                 mu=_t(p["mu"]), nu=_t(p["nu"]))
        dt = self.params["g_r"].dtype
        i64 = torch.int64
        cap = STEPS + 2
        if kind == "serial":
            self.carry = A.SerialCarry(
                torch.tensor(0, dtype=i64), torch.tensor(o.get("end", STEPS), dtype=i64),
                torch.tensor(o["big"], dtype=dt), torch.tensor(o["big"], dtype=dt),
                torch.tensor(o["big"], dtype=dt), torch.tensor(0, dtype=i64),
                torch.full((cap,), float("nan"), dtype=dt), o["tol"], o.get("patience", 0),
                o["big"])
        else:
            n = NBATCH
            track = o.get("use_min") or o.get("patience", 0) > 0
            self.carry = A.BatchedCarry(
                torch.tensor(0, dtype=i64), torch.tensor(STEPS, dtype=i64),
                torch.tensor(o.get("warmup", 0), dtype=i64),
                torch.tensor(o.get("step0", 0), dtype=i64), torch.tensor(p["frozen"]),
                torch.full((n,), o["big"], dtype=dt),
                torch.full((n,), o["big"], dtype=dt) if track else None,
                torch.zeros(n, dtype=i64) if o.get("patience", 0) > 0 else None,
                torch.full((n,), 100, dtype=i64), torch.full((cap, n), float("nan")),
                o["tol"], o.get("patience", 0),
                torch.tensor(True) if o.get("live") else None)
            if not o.get("use_min"):
                self.best = None

    def tensors(self):
        c = [x for x in self.carry if isinstance(x, torch.Tensor)]
        best = [] if self.best is None else tree_leaves(self.best)
        return tree_leaves(self.params) + tree_leaves(self.state) + best + c


def _keep(cond, new, old):
    # solver/fit.py's _keep before the kernels
    tree_map(lambda n, o: torch.where(cond, n, o, out=o), new, old)


def _keep_rows(mask, new, old, live=None):
    # parallel/batched.py's _keep before the kernels
    nbatch = mask.shape[0]

    def sel(n, o):
        if n.dim() == 0 or n.shape[0] != nbatch:
            torch.where(live, n, o, out=o)
        else:
            torch.where(mask.reshape((nbatch,) + (1,) * (n.dim() - 1)), n, o, out=o)

    tree_map(sel, new, old)


def _step_before(opt, s, grads, loss):
    """The descents' step after the loss as it was before the kernels
    (solver/fit.py:_Descent._step, parallel/batched.py:_BatchedDescent._step)."""
    c = s.carry
    if s.kind == "serial":
        live = (c.step < c.end) & (c.delta >= c.tol) & torch.isfinite(c.prev)
        if c.patience > 0:
            live = live & (c.since < c.patience)
        new_params, new_opt = opt.update(grads, s.state, s.params)
        is_best = live & (loss < c.best_loss)
        _keep(is_best, new_params, s.best)
        _keep(live, new_params, s.params)
        _keep(live, new_opt, s.state)
        slot = torch.clamp(c.step, max=c.history.numel() - 1).reshape(1)
        c.history.index_copy_(0, slot, torch.where(live, loss, c.history.index_select(0, slot)))
        delta = torch.where(c.prev < c.big, torch.abs(loss - c.prev), c.big)
        torch.where(live, delta, c.delta, out=c.delta)
        torch.where(live, torch.minimum(loss, c.best_loss), c.best_loss, out=c.best_loss)
        torch.where(live, torch.where(is_best, 0, c.since + 1), c.since, out=c.since)
        torch.where(live, loss, c.prev, out=c.prev)
        c.step.add_(live.to(torch.int64))
        return
    live = (c.it < c.total) & ~c.frozen.all() if c.live is None else c.live
    losses = loss
    new_params, new_opt = opt.update(grads, s.state, s.params)
    active = ~c.frozen & live
    _keep_rows(active, new_params, s.params)
    _keep_rows(active, new_opt, s.state, live)
    idx = c.it - c.warmup
    rec = idx >= 0
    gstep = c.step0 + idx
    slot = torch.clamp(idx, 0, c.history.shape[0] - 1).reshape(1)
    recording = active & rec
    c.history.index_copy_(0, slot, torch.where(
        recording, losses.to(torch.float32), c.history.index_select(0, slot)[0])[None])
    recorded_live = live & rec
    stop = ~torch.isfinite(losses)
    stop = stop | ((gstep >= 1) & (torch.abs(losses - c.prev) < c.tol))
    newly = recording & stop
    if c.best_loss is not None:
        is_best = recorded_live & (losses < c.best_loss)
        torch.where(is_best, losses, c.best_loss, out=c.best_loss)
    if c.since is not None:
        torch.where(recording, torch.where(is_best, 0, c.since + 1), c.since, out=c.since)
        newly = newly | (recording & (c.since >= c.patience))
    torch.where(newly, gstep + 1, c.nsteps_slice, out=c.nsteps_slice)
    c.frozen.logical_or_(newly)
    torch.where(recorded_live, losses, c.prev, out=c.prev)
    if s.best is not None:
        _keep_rows(is_best, s.params, s.best)
    c.it.add_(live.to(torch.int64))


def _run(kind, p, how):
    opt = get_optimizer("Adamax", learning_rate=LR)
    s = _State(kind, p)
    for k in range(STEPS):
        grads, loss = _t(p["grads"][k]), torch.tensor(p["losses"][k])
        if how == "before":
            _step_before(opt, s, grads, loss)
        elif how == "plain":
            A.adamax_step_plain(opt, s.params, grads, s.state, s.best, s.carry, loss)
            A.descent_carry_plain(s.carry, loss, s.state.count)
        else:
            A.adamax_step(opt, s.params, grads, s.state, s.best, s.carry, loss)
            A.descent_carry(s.carry, loss, s.state.count)
    return s


def _same_bits(a, b):
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.numpy().tobytes() == b.numpy().tobytes())


CASES = [("serial", c) for c in SERIAL] + [("batched", c) for c in BATCHED]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kind, case", CASES)
def test_plain_versions_equal_the_torch_sequence_to_the_bit(kind, case, dtype):
    p = _problem(kind, case, dtype)
    before = _run(kind, p, "before")
    for how in ("plain", "wrapper"):
        got = _run(kind, p, how)
        for x, y in zip(got.tensors(), before.tensors()):
            assert _same_bits(x, y)
    if kind == "batched":  # a frozen slice's rows stay as they entered
        start = _State(kind, p)
        for x, y in zip(tree_leaves((before.params, before.state.mu, before.state.nu)),
                        tree_leaves((start.params, start.state.mu, start.state.nu))):
            assert _same_bits(x[p["frozen"]], y[p["frozen"]])
    c = before.carry
    moved = int(c.step if kind == "serial" else c.it)
    assert moved == p["opts"]["moves"]  # each case reaches the stop it is about
    assert int(before.state.count) == p["count"] + moved


def _jax_reference(kind, p):
    """The JAX package's loop bodies on the same inputs, float64:
    solver/fit.py:_fit_segment's and parallel/batched.py:_batched_segment_impl's,
    with the step's gradients and losses given."""
    o = p["opts"]
    jopt = jax_get_optimizer("Adamax", learning_rate=LR)
    params = jax.tree_util.tree_map(jnp.asarray, p["params"])
    state = jopt.init(params)
    state = (state[0]._replace(count=jnp.asarray(p["count"], jnp.int32),
                               mu=jax.tree_util.tree_map(jnp.asarray, p["mu"]),
                               nu=jax.tree_util.tree_map(jnp.asarray, p["nu"])),) + state[1:]
    best_params = jax.tree_util.tree_map(jnp.asarray, p["best"])
    big = jnp.asarray(o["big"])
    if kind == "serial":
        step, prev, delta, best_loss, since = 0, big, big, big, 0
        history = np.full(STEPS + 2, np.nan)
        for k in range(STEPS):
            ok = step < o.get("end", STEPS) and delta >= o["tol"] and bool(jnp.isfinite(prev))
            if o.get("patience", 0) > 0:
                ok = ok and since < o["patience"]
            if not ok:
                break
            loss = jnp.asarray(p["losses"][k])
            grads = jax.tree_util.tree_map(jnp.asarray, p["grads"][k])
            updates, state = jopt.update(grads, state, params)
            new_params = optax.apply_updates(params, updates)
            history[step] = float(loss)
            delta = jnp.where(prev < big, jnp.abs(loss - prev), big)
            is_best = loss < best_loss
            best_loss = jnp.minimum(loss, best_loss)
            best_params = _tree_where(is_best, new_params, best_params)
            since = int(jnp.where(is_best, 0, since + 1))
            step, params, prev = step + 1, new_params, loss
        carry = dict(step=step, prev=prev, delta=delta, best_loss=best_loss, since=since,
                     history=history)
        return params, state, best_params, carry
    nbatch = NBATCH
    frozen = jnp.asarray(p["frozen"])
    prev = jnp.full(nbatch, o["big"])
    track = o.get("use_min") or o.get("patience", 0) > 0
    best_loss = jnp.full(nbatch, o["big"])
    since = jnp.zeros(nbatch, jnp.int32)
    nsteps_slice = jnp.full(nbatch, 100)
    history = jnp.full((STEPS + 2, nbatch), jnp.nan, dtype=jnp.float32)
    warmup, step0 = o.get("warmup", 0), o.get("step0", 0)
    step = 0
    for k in range(STEPS):
        # the mesh case's flag stands for another rank's running slices
        if not (step < STEPS and (o.get("live") or not bool(jnp.all(frozen)))):
            break
        idx = step - warmup
        rec = idx >= 0
        gstep = step0 + idx
        losses = jnp.asarray(p["losses"][k])
        grads = jax.tree_util.tree_map(jnp.asarray, p["grads"][k])
        updates, new_state = jopt.update(grads, state, params)
        new_params = optax.apply_updates(params, updates)

        def keep_frozen(new, old):
            # calamity_tpu/parallel/batched.py:505-513
            if new.ndim == 0 or new.shape[0] != nbatch:
                return new
            bshape = (nbatch,) + (1,) * (new.ndim - 1)
            return jnp.where(frozen.reshape(bshape), old, new)

        new_params = jax.tree_util.tree_map(keep_frozen, new_params, params)
        state = jax.tree_util.tree_map(keep_frozen, new_state, state)
        slot = max(idx, 0)
        history = history.at[slot].set(
            jnp.where(rec & ~frozen, losses.astype(jnp.float32), history[slot]))
        delta = jnp.where(gstep >= 1, jnp.abs(losses - prev), big)
        newly = rec & (~frozen) & (((gstep >= 1) & (delta < o["tol"])) | ~jnp.isfinite(losses))
        if track:
            is_best = rec & (losses < best_loss)
            best_loss = jnp.where(is_best, losses, best_loss)
        if o.get("patience", 0) > 0:
            since = jnp.where(rec & ~frozen, jnp.where(is_best, 0, since + 1), since)
            newly = newly | (rec & ~frozen & (since >= o["patience"]))
        nsteps_slice = jnp.where(newly, gstep + 1, nsteps_slice)
        frozen = frozen | newly
        prev = jnp.where(rec, losses, prev)
        if o.get("use_min"):
            best_params = jax.tree_util.tree_map(
                lambda n, b: jnp.where(is_best.reshape((nbatch,) + (1,) * (n.ndim - 1)), n, b),
                new_params, best_params)
        params = new_params
        step += 1
    carry = dict(it=step, prev=prev, frozen=frozen, nsteps_slice=nsteps_slice,
                 history=history, best_loss=best_loss if track else None,
                 since=since if o.get("patience", 0) > 0 else None)
    return params, state, best_params if o.get("use_min") else None, carry


def _close(got, want):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    assert rel_err(got[fin], want[fin]) <= JAX_TOL


def _ordered(tree):
    """A parameter tree's leaves in the port's order (JAX sorts dict keys)."""
    return [tree["g_r"], tree["g_i"], *tree["fg_r"], *tree["fg_i"]]


@pytest.mark.parametrize("kind, case", CASES)
def test_matches_the_jax_package_in_float64(kind, case):
    p = _problem(kind, case, np.float64, seed=1)
    s = _run(kind, p, "wrapper")
    params, state, best, carry = _jax_reference(kind, p)
    for got, want in zip(_ordered(s.params), _ordered(params)):
        _close(got, want)
    for name in ("mu", "nu"):
        for got, want in zip(_ordered(getattr(s.state, name)), _ordered(getattr(state[0], name))):
            _close(got, want)
    assert int(s.state.count) == int(state[0].count)
    if best is not None:
        for got, want in zip(_ordered(s.best), _ordered(best)):
            _close(got, want)
    c = s.carry
    for name, want in carry.items():
        got = getattr(c, name)
        if want is None:
            assert got is None
        elif name in ("step", "it", "since") and np.ndim(want) == 0:
            assert int(got) == int(want)
        elif name in ("frozen", "nsteps_slice", "since"):
            assert np.array_equal(got.numpy(), np.asarray(want))
        else:
            _close(got, want)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    p = _problem("batched", "frozen_warmup", np.float32)
    opt = get_optimizer("Adamax")
    s = _State("batched", p)
    grads, loss = _t(p["grads"][0]), torch.tensor(p["losses"][0])
    short = dict(grads, fg_r=grads["fg_r"][:1])
    with pytest.raises(ValueError, match="leaves"):
        A.adamax_step(opt, s.params, short, s.state, s.best, s.carry, loss)
    wide = dict(grads, g_r=grads["g_r"][:, :, :4])
    with pytest.raises(ValueError, match="must agree"):
        A.adamax_step(opt, s.params, wide, s.state, s.best, s.carry, loss)
    unbatched = tree_map(lambda x: x[0], (s.params, grads, s.state.mu, s.state.nu))
    state = AdamaxState(s.state.count, unbatched[2], unbatched[3])
    with pytest.raises(ValueError, match="leading axis"):
        A.adamax_step(opt, unbatched[0], unbatched[1], state, None, s.carry, loss)
    half = tree_map(lambda x: x.half(), (s.params, grads, s.state.mu, s.state.nu))
    with pytest.raises(TypeError, match="float32 or float64"):
        A.adamax_step(opt, half[0], half[1], AdamaxState(s.state.count, half[2], half[3]),
                      None, s.carry, loss)
    meta = tree_map(lambda x: torch.empty_like(x, device="meta"),
                    (s.params, grads, s.state.mu, s.state.nu))
    with pytest.raises(ValueError, match="unsupported device"):
        A.adamax_step(opt, meta[0], meta[1], AdamaxState(s.state.count, meta[2], meta[3]),
                      None, s.carry, loss)


# ---------------------------------------------------------------------- #
# on the card
# ---------------------------------------------------------------------- #
def _on_card(s, layout):
    """``s``'s state on the card; ``layout`` "unaligned": every in-place
    leaf a view one element into a buffer of its own (no 16-byte vectors)."""
    dev = torch.device("cuda")

    def move(x):
        if layout != "unaligned" or x.dim() == 0:
            return x.to(dev)
        buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)
        view = buf[1:].view(x.shape)
        view.copy_(x.to(dev))
        return view

    s.params = tree_map(move, s.params)
    s.best = None if s.best is None else tree_map(move, s.best)
    s.state = AdamaxState(s.state.count.to(dev), tree_map(move, s.state.mu),
                          tree_map(move, s.state.nu))
    s.carry = s.carry._replace(**{k: v.to(dev) for k, v in s.carry._asdict().items()
                                  if isinstance(v, torch.Tensor)})
    return s


def _many_leaves(p, n):
    """``p`` with its coefficient lists lengthened to ``n`` leaves in all, of
    ragged lengths (not a multiple of 4)."""
    rng = np.random.default_rng(5)
    extra = (n - 2) // 2 - len(CHUNKS)
    lead = p["params"]["g_r"].shape[:-2]
    dtype = p["params"]["g_r"].dtype
    shapes = [(1 + k % 3, 3 + k % 5) for k in range(extra)]

    def grow(tree, positive=False):
        for name in ("fg_r", "fg_i"):
            for s in shapes:
                x = rng.standard_normal(lead + s).astype(dtype)
                tree[name] = tree[name] + [np.abs(x) if positive else x]

    for key in ("params", "mu", "best"):
        grow(p[key])
    grow(p["nu"], positive=True)
    for g in p["grads"]:
        grow(g)
    return p


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["aligned", "unaligned", "many_leaves"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kind, case", [("serial", "nonfinite"), ("serial", "patience"),
                                        ("batched", "patience_use_min"),
                                        ("batched", "nonfinite")])
def test_cuda_kernels_match_plain_to_the_bit(kind, case, dtype, layout):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    p = _problem(kind, case, dtype, seed=2)
    if layout == "many_leaves":
        p = _many_leaves(p, A.LEAVES_PER_LAUNCH + 6)
    opt = get_optimizer("Adamax", learning_rate=LR)
    sides = {how: _on_card(_State(kind, p), layout) for how in ("kernel", "plain")}
    start = _on_card(_State(kind, p), "aligned")
    nleaves = len(tree_leaves(start.params))
    per_step = -(-nleaves // A.LEAVES_PER_LAUNCH)
    for k in range(STEPS):
        grads = tree_map(lambda x: x.cuda(), _t(p["grads"][k]))
        loss = torch.tensor(p["losses"][k]).cuda()
        for how, s in sides.items():
            LAUNCHES.reset()
            if how == "kernel":
                A.adamax_step(opt, s.params, grads, s.state, s.best, s.carry, loss)
                A.descent_carry(s.carry, loss, s.state.count)
                assert LAUNCHES.get(A.KERNEL_NAME) == per_step
                assert LAUNCHES.get(A.CARRY_KERNEL_NAME) == 1
            else:
                with A.plain_versions():
                    A.adamax_step(opt, s.params, grads, s.state, s.best, s.carry, loss)
                    A.descent_carry(s.carry, loss, s.state.count)
                assert not LAUNCHES.counts()
        torch.cuda.synchronize()
        for x, y in zip(sides["kernel"].tensors(), sides["plain"].tensors()):
            assert _same_bits(x.cpu(), y.cpu())
    if kind == "batched":
        rows = torch.as_tensor(p["frozen"])
        for x, y in zip(tree_leaves((sides["kernel"].params, sides["kernel"].state)),
                        tree_leaves((start.params, start.state))):
            if x.dim():
                assert _same_bits(x.cpu()[rows], y.cpu()[rows])
