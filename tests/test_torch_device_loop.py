"""The descent loop on the device: ``solver.fit._Descent``,
``parallel.batched._BatchedDescent``, ``solver.graph.StepGraph`` and the
launch counter's replay accounting.

- A serial segment from explicit state (the last loss, the best loss and
  the steps since it) against the JAX package's ``_fit_segment`` in
  float64, rel 1e-9 (summation order only): the tol stop inside a segment,
  the seg_len cap, a patience stop on a zero-loss plateau and one that
  enters with steps since the best, use_min's best parameters, a
  non-finite loss (during the segment and on entry), freeze_model and the
  "sum" prior. The entry point's stops and modes against the JAX fit are in
  ``test_torch_fit.py``, its checkpoint resume in ``test_torch_checkpoint.py``.
- The trajectory does not depend on the host's poll interval K: the serial
  fit (mixed schedule with its carried state, use_min with patience, a
  checkpointed fit cut and resumed) and the batched descent are equal to
  the bit for K = 1, 3 and 16, with stops that land inside a block.
- Every optimizer with its step count on the device against a reference
  kept here that forms each bias correction on the host from a Python
  count (the update before the count moved to the device): 50 updates
  through the descent's carry, equal to the bit, float32 and float64.
- The batched descent's steps per slice, the NaN rows after a freeze and
  the final step count against the values of the host loop it replaced.
- ``LaunchCounter.recording`` / ``replayed``, ``StepGraph`` on the CPU and
  the capture failure's named site.
- ``gpu``: on a card, a captured fit against the same fit uncaptured
  (``graph.eager_steps``), equal to the bit with equal launches, and a
  capture that meets a host read raises naming it.
"""

import os
import shutil

import numpy as np
import pytest
import torch
from conftest import zero_plateau_fit_args
from torch_parity import (
    DPSS_DLY,
    GOLDEN_GOLOMB,
    batched_problem,
    multitime_visdata,
    rel_err,
    to_np,
    torch_batched_problem,
)

import jax.numpy as jnp
from calamity_tpu import models
from calamity_tpu.io import CalData, VisData
from calamity_tpu.solver import fit as jfit
from calamity_tpu.solver.optimizers import get_optimizer as jax_get_optimizer
from calamity_tpu.solver.tensorize import FitSpec
from calamity_tpu_torch import LAUNCHES
from calamity_tpu_torch._device import LaunchCounter
from calamity_tpu_torch.convert import chunks_from_jax, to_tensor
from calamity_tpu_torch.parallel import batched as tb
from calamity_tpu_torch.solver import fit as tfit
from calamity_tpu_torch.solver import graph
from calamity_tpu_torch.solver.optimizers import get_optimizer, tree_leaves, tree_map


@pytest.fixture(scope="module")
def golden():
    uvd = VisData.from_uvh5(GOLDEN_GOLOMB)
    comps = models.yield_pbl_dpss_model_comps(uvd, min_dly=DPSS_DLY, offset=DPSS_DLY)
    gains = CalData.blank_from_visdata(uvd)
    rng = np.random.default_rng(11)
    gains.gain_array = gains.gain_array * (1 + 0.05 * rng.standard_normal(gains.gain_array.shape)
                                           + 0.05j * rng.standard_normal(gains.gain_array.shape))
    out = {}
    for name, dtype in (("float32", np.float32), ("float64", np.float64)):
        spec = FitSpec(uvd, comps, {int(a): i for i, a in enumerate(gains.ant_array)},
                       dtype=dtype)
        t = spec.times[0]
        rms = np.sqrt(np.mean(np.abs(uvd.data_array) ** 2))
        dr, di, w = spec.pack_data(uvd, "xx", t, data_scale_factor=rms)
        g_r, g_i = spec.pack_gains(gains, "xx", t)
        out[name] = dict(g_r=g_r, g_i=g_i, fg_r=spec.init_coeffs(dr, w),
                         fg_i=spec.init_coeffs(di, w), data_r=dr, data_i=di, wgts=w,
                         chunks=spec.device_chunks())
    return out


def _plateau_problem():
    chunks, data_r, data_i, wgts, g_r, g_i, fg = zero_plateau_fit_args()
    return dict(g_r=g_r, g_i=g_i, fg_r=fg, fg_i=fg, data_r=data_r, data_i=data_i, wgts=wgts,
                chunks=chunks)


def _conv(xs, device="cpu"):
    return [to_tensor(x, device) for x in xs]


# ---------------------------------------------------------------------- #
# a segment from explicit state against the JAX package's _fit_segment
# ---------------------------------------------------------------------- #
SEGMENT_CASES = {
    # name: (FitConfig fields, learning rate, seg_len, entry (prev, best, since))
    "tol_stop": (dict(tol=1e-8), 1e-2, 400, None),
    "seg_len_cap": (dict(tol=0.0), 1e-2, 7, None),
    "entry_state": (dict(tol=0.0, patience=5, use_min=True), 0.3, 200, (2.5e-3, 1.0e-3, 2)),
    "plateau": (dict(tol=0.0, patience=4, use_min=True), 1e-2, 50, None),
    "use_min": (dict(tol=0.0, use_min=True), 5e-2, 40, None),
    "nan_loss": (dict(tol=0.0), 1e-2, 20, None),
    "nan_on_entry": (dict(tol=0.0), 1e-2, 20, (float("nan"), 1.0, 0)),
    "freeze_model": (dict(tol=1e-10, freeze_model=True), 1e-2, 400, None),
    "sum_prior": (dict(tol=1e-8, regularization="sum"), 1e-2, 400, None),
}


def _segment_pair(p, fields, lr, seg_len, entry):
    """The segment through both packages from the same state: (JAX out,
    port out) as (history, nsteps, converged, prev, best_loss, since,
    params, best_params), params as (g_r, g_i, fg_r..., fg_i...)."""
    big = 9e99
    prev, best, since = (big, big, 0) if entry is None else entry
    prior = (None, None)
    if fields.get("regularization") == "sum":
        # the sky model is the data (identity-gains alias)
        prior = tuple(float(sum(np.sum(np.asarray(d) * np.asarray(w))
                                for d, w in zip(p[k], p["wgts"]))) for k in ("data_r", "data_i"))
    jcfg = jfit.FitConfig(opt_kwargs=(("learning_rate", lr),), maxsteps=seg_len, **fields)
    jopt = jax_get_optimizer("Adamax", learning_rate=lr)
    jparams = ((p["g_r"], p["g_i"]) if jcfg.freeze_model
               else (p["g_r"], p["g_i"], tuple(p["fg_r"]), tuple(p["fg_i"])))
    f64 = jnp.float64
    jp = (None, None) if prior[0] is None else tuple(jnp.asarray(x, f64) for x in prior)
    jout = jfit._fit_segment(jcfg, seg_len, tuple(p["chunks"]), tuple(p["data_r"]),
                             tuple(p["data_i"]), tuple(p["wgts"]), tuple(p["fg_r"]),
                             tuple(p["fg_i"]), *jp, jparams, jopt.init(jparams),
                             jnp.asarray(prev, f64), jnp.asarray(best, f64), jparams, since)
    jpar, _, jprev, jbest, jbest_params, jhist, jstep, jconv, jsince = jout
    n = int(jstep)
    jflat = lambda t: [t[0], t[1], *t[2], *t[3]] if len(t) == 4 else list(t)  # noqa: E731
    want = (np.asarray(jhist)[:n], n, bool(jconv), float(jprev), float(jbest), int(jsince),
            jflat(jpar), jflat(jbest_params))

    cfg = tfit.FitConfig(maxsteps=seg_len, **fields)
    fr, fi = _conv(p["fg_r"]), _conv(p["fg_i"])
    tp = (None, None) if prior[0] is None else tuple(torch.tensor(x, dtype=torch.float64)
                                                     for x in prior)
    loss_fn = tfit.make_loss_fn(cfg, chunks_from_jax(p["chunks"], "cpu"), _conv(p["data_r"]),
                                _conv(p["data_i"]), _conv(p["wgts"]), fr, fi, *tp)
    opt = get_optimizer("Adamax", learning_rate=lr)
    params = tfit.init_params(cfg, to_tensor(p["g_r"], "cpu"), to_tensor(p["g_i"], "cpu"), fr, fi)
    d = tfit._Descent(cfg, loss_fn, opt, params, opt.init(params), seg_len)
    hist, nsteps, conv, tprev, tbest, tsince = d.segment(seg_len, prev, best, since)
    flat = lambda t: [t["g_r"], t["g_i"], *t.get("fg_r", []), *t.get("fg_i", [])]  # noqa: E731
    got = (np.asarray(hist), nsteps, conv, float(tprev), float(tbest), tsince,
           flat(d.params), flat(d.best_params))
    return want, got


def _same_or_close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = np.isfinite(want)
    if fin.any():
        assert rel_err(got[fin], want[fin]) <= tol


@pytest.mark.parametrize("case", sorted(SEGMENT_CASES))
def test_segment_matches_jax_fit_segment(golden, case):
    fields, lr, seg_len, entry = SEGMENT_CASES[case]
    if case == "plateau":
        p = _plateau_problem()
    else:
        p = dict(golden["float64"])
    if case == "nan_loss":
        w = np.array(p["wgts"][0])
        w[0, 0, 0] = np.nan
        p["wgts"] = [w] + list(p["wgts"][1:])
    want, got = _segment_pair(p, fields, lr, seg_len, entry)
    hist, nsteps, conv, prev, best, since, params, best_params = got
    assert nsteps == want[1] and conv == want[2] and since == want[5]
    expected_steps = {"seg_len_cap": 7, "plateau": 5, "nan_loss": 1, "nan_on_entry": 0}
    if case in expected_steps:
        assert nsteps == expected_steps[case]
    if case in ("tol_stop", "entry_state", "freeze_model", "sum_prior"):
        assert 0 < nsteps < seg_len and conv  # the stop fired inside the segment
    _same_or_close(hist, want[0], 1e-9)
    _same_or_close([prev, best], [want[3], want[4]], 1e-9)
    for got_p, want_p in zip(params + best_params, want[6] + want[7]):
        _same_or_close(to_np(got_p), to_np(want_p), 1e-9)


def test_segment_rejects_a_segment_past_its_history(golden):
    """A segment longer than the carry's history raises, and the failure's
    site names the descent's own line (what a failed capture reports)."""
    p = golden["float64"]
    cfg = tfit.FitConfig(maxsteps=5)
    fr, fi = _conv(p["fg_r"]), _conv(p["fg_i"])
    loss_fn = tfit.make_loss_fn(cfg, chunks_from_jax(p["chunks"], "cpu"), _conv(p["data_r"]),
                                _conv(p["data_i"]), _conv(p["wgts"]), fr, fi, None, None)
    opt = get_optimizer("Adamax")
    params = tfit.init_params(cfg, to_tensor(p["g_r"], "cpu"), to_tensor(p["g_i"], "cpu"), fr, fi)
    d = tfit._Descent(cfg, loss_fn, opt, params, opt.init(params), 5)
    with pytest.raises(ValueError, match="a segment of 6 steps in a history of 5") as info:
        d.segment(6, 1.0, 1.0)
    site = graph._failing_site(info.value)
    assert site.startswith(os.path.join("calamity_tpu_torch", "solver", "fit.py"))
    assert "in segment" in site and "ValueError" in site


# ---------------------------------------------------------------------- #
# the host's poll interval does not change the trajectory
# ---------------------------------------------------------------------- #
def _serial(p, **kw):
    return tfit.fit_gains_and_foregrounds(
        to_tensor(p["g_r"], "cpu"), to_tensor(p["g_i"], "cpu"), _conv(p["fg_r"]),
        _conv(p["fg_i"]), _conv(p["data_r"]), _conv(p["data_i"]), _conv(p["wgts"]),
        chunks_from_jax(p["chunks"], "cpu"), **kw)


def _assert_fits_equal(a, b):
    assert a[4]["loss"] == b[4]["loss"]
    assert a[4].get("phase_steps") == b[4].get("phase_steps")
    for x, y in zip([a[0], a[1], *a[2], *a[3]], [b[0], b[1], *b[2], *b[3]]):
        assert torch.equal(x, y)


SERIAL_POLL_CASES = {
    # the mixed schedule's tol stops, and use_min with a patience stop
    "mixed_tol": dict(maxsteps=300, tol=1e-7, learning_rate=1e-2, comps_precision="mixed"),
    "patience": dict(maxsteps=300, tol=0.0, learning_rate=0.3, patience=5, use_min=True,
                     comps_precision="float32"),
}


@pytest.mark.parametrize("case", sorted(SERIAL_POLL_CASES))
def test_serial_trajectory_does_not_depend_on_the_poll_interval(golden, monkeypatch, case):
    kw = SERIAL_POLL_CASES[case]
    runs = {}
    for k in (1, 3, 16):
        monkeypatch.setattr(tfit, "POLL_EVERY", k)
        runs[k] = _serial(golden["float32"], **kw)
    steps = runs[1][4].get("phase_steps", [len(runs[1][4]["loss"])])
    assert all(0 < n < kw["maxsteps"] for n in steps)  # every phase stopped early
    # the stops land inside a block of 3 and of 16
    assert any(n % 3 for n in steps) and any(n % 16 for n in steps)
    _assert_fits_equal(runs[3], runs[1])
    _assert_fits_equal(runs[16], runs[1])


def test_checkpointed_serial_fit_does_not_depend_on_the_poll_interval(golden, monkeypatch,
                                                                      tmp_path):
    """A checkpointed mixed fit (one carry for every segment of a phase)
    with K = 3, and one cut and resumed with K = 16, equal the same fit
    with K = 1."""
    kw = dict(maxsteps=40, tol=0.0, learning_rate=1e-2, comps_precision="mixed",
              checkpoint_every=7)
    monkeypatch.setattr(tfit, "POLL_EVERY", 1)
    plain = _serial(golden["float32"], checkpoint_dir=str(tmp_path / "one"), **kw)
    monkeypatch.setattr(tfit, "POLL_EVERY", 3)
    full = _serial(golden["float32"], checkpoint_dir=str(tmp_path / "a"), **kw)
    _assert_fits_equal(full, plain)
    shutil.copytree(str(tmp_path / "a"), str(tmp_path / "b"))
    cut = tmp_path / "b" / "phase_f32"
    for name in os.listdir(cut):
        if int(name.split("_")[1]) > 14:
            shutil.rmtree(cut / name)
    monkeypatch.setattr(tfit, "POLL_EVERY", 16)
    resumed = _serial(golden["float32"], checkpoint_dir=str(tmp_path / "b"), **kw)
    _assert_fits_equal(resumed, plain)


# ---------------------------------------------------------------------- #
# the optimizers with their step count on the device
# ---------------------------------------------------------------------- #
def _host_bc(b, count, t):
    # the bias correction formed on the host from a Python count, rounded
    # to the moment dtype (the update before the count moved to the device)
    return torch.tensor(1 - b**count, dtype=t.dtype, device=t.device)


def _reference_adamax(lr=1e-3, b1=0.9, b2=0.999, eps=1e-7):
    def update(grads, state, params):
        count = int(state[0]) + 1
        mu = tree_map(lambda g, m: (1 - b1) * g + b1 * m, grads, state[1])
        nu = tree_map(lambda g, n: torch.maximum(torch.abs(g) + eps, b2 * n), grads, state[2])
        new = tree_map(lambda p, m, n: p + (m / _host_bc(b1, count, m)) / n * (-lr),
                       params, mu, nu)
        return new, (count, mu, nu)

    return update


def _reference_adam(lr=1e-3, b1=0.9, b2=0.999, eps=1e-7, eps_root=0.0, nesterov=False,
                    lamb_wd=None):
    def update(grads, state, params):
        count = int(state[0]) + 1
        mu = tree_map(lambda g, m: (1 - b1) * g + b1 * m, grads, state[1])
        nu = tree_map(lambda g, n: (1 - b2) * (g * g) + b2 * n, grads, state[2])
        if nesterov:
            mu_hat = tree_map(lambda m, g: b1 * (m / _host_bc(b1, count + 1, m))
                              + (1 - b1) * (g / _host_bc(b1, count, g)), mu, grads)
        else:
            mu_hat = tree_map(lambda m: m / _host_bc(b1, count, m), mu)
        u = tree_map(lambda m, n: m / (torch.sqrt(n / _host_bc(b2, count, n) + eps_root) + eps),
                     mu_hat, nu)
        if lamb_wd is not None:
            u = tree_map(lambda x, p: x + lamb_wd * p, u, params)
            ratio = lambda pn, un: torch.where((pn == 0) | (un == 0),  # noqa: E731
                                               torch.ones_like(pn), pn / un)
            u = tree_map(lambda x, p: x * ratio(torch.linalg.vector_norm(p),
                                                torch.linalg.vector_norm(x)), u, params)
        return tree_map(lambda p, x: p + -lr * x, params, u), (count, mu, nu)

    return update


# (name, keywords, reference update or None where the update reads no count)
OPTIMIZER_CASES = [
    ("Adamax", {"learning_rate": 1e-2}, _reference_adamax(lr=1e-2)),
    ("Adamax", {"beta_1": 0.8, "beta_2": 0.99}, _reference_adamax(b1=0.8, b2=0.99)),
    ("Adam", {"learning_rate": 1e-2}, _reference_adam(lr=1e-2)),
    ("Adam", {"nesterov": True, "eps_root": 1e-8}, _reference_adam(eps_root=1e-8,
                                                                   nesterov=True)),
    ("Nadam", {"beta_1": 0.7}, _reference_adam(b1=0.7, nesterov=True)),
    ("LAMB", {"weight_decay": 1e-2}, _reference_adam(eps=1e-6, lamb_wd=1e-2)),
    ("SGD", {"momentum": 0.9, "nesterov": True}, None),
    ("RMSprop", {"momentum": 0.5, "centered": True}, None),
    ("Adagrad", {}, None),
    ("Adadelta", {"learning_rate": 1.0}, None),
    ("Ftrl", {"l1_regularization_strength": 1e-3}, None),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name, kwargs, reference", OPTIMIZER_CASES)
def test_optimizer_device_count_matches_host_count(name, kwargs, reference, dtype):
    """50 updates through the descent's carry (a stop test that never
    fires, K = 16) against 50 direct updates with the count on the host."""
    gen = torch.Generator().manual_seed(3)

    def t(*shape):
        return torch.randn(shape, generator=gen, dtype=dtype)

    params = {"g_r": 1 + 0.1 * t(5, 8), "g_i": 0.1 * t(5, 8), "fg_r": [t(3, 4), t(2, 6)],
              "fg_i": [t(3, 4), t(2, 6)]}
    target = tree_map(lambda x: x + 0.3 * torch.randn(x.shape, generator=gen, dtype=dtype),
                      params)

    def loss_fn(p):
        return sum(torch.sum(torch.cos(x) * torch.square(x - y))
                   for x, y in zip(tree_leaves(p), tree_leaves(target)))

    opt = get_optimizer(name, **kwargs)
    cfg = tfit.FitConfig(tol=0.0, maxsteps=50)
    d = tfit._Descent(cfg, loss_fn, opt, params, opt.init(params), 50)
    hist, nsteps, *_ = d.segment(50, d.big, d.big)
    assert nsteps == 50

    ref_update = opt.update if reference is None else reference
    state = opt.init(params)
    if reference is not None:
        state = (0, state.mu, state.nu)
    p = params
    losses = []
    for _ in range(50):
        loss, grads = tfit.value_and_grad(loss_fn, p)
        losses.append(float(loss))
        p, state = ref_update(grads, state, p)
    assert hist == losses
    for got, want in zip(tree_leaves(d.params), tree_leaves(p)):
        assert torch.equal(got, want)
    if reference is not None:
        assert d.opt_state.count.dtype == torch.int64 and int(d.opt_state.count) == state[0] == 50
        for got, want in zip(tree_leaves(d.opt_state.nu), tree_leaves(state[2])):
            assert torch.equal(got, want)


def test_bias_table_saturates_and_matches_the_host_formula():
    """The table ends where 1 - b**k rounds to 1, so every later count reads
    the exact value; each entry equals the host's formula rounded to the
    dtype."""
    from calamity_tpu_torch.solver.optimizers import _BiasCorrection, _bias_values

    values = _bias_values(0.999)
    assert values[-1] == 1.0 and values[-2] < 1.0 and len(values) < 40000
    bias = _BiasCorrection(0.999)
    like = torch.zeros((), dtype=torch.float32)
    for k in (0, 1, 2, 17, 1000, len(values) - 1, len(values), 10 ** 6):
        got = bias.at(torch.tensor(k))(like)
        assert got.dtype == torch.float32 and got == torch.tensor(1 - 0.999**k,
                                                                  dtype=torch.float32)


def test_step_count_saves_as_an_int_and_loads_either_way(tmp_path):
    """The checkpoint format keeps the step count an int: a state with the
    count on the device saves as one with a Python count did, and either
    save loads into either template."""
    from calamity_tpu_torch.solver.checkpoint import load_state, save_state
    from calamity_tpu_torch.solver.optimizers import AdamaxState

    params = {"g": torch.arange(6.0).reshape(2, 3)}
    opt = get_optimizer("Adamax")
    device_state = opt.init(params)
    _, device_state = opt.update({"g": torch.ones(2, 3)}, device_state, params)
    host_state = AdamaxState(count=1, mu=device_state.mu, nu=device_state.nu)
    save_state(str(tmp_path / "device"), {"opt": device_state}, {})
    save_state(str(tmp_path / "host"), {"opt": host_state}, {})
    with open(tmp_path / "device" / "treedef.pkl", "rb") as a, \
            open(tmp_path / "host" / "treedef.pkl", "rb") as b:
        assert a.read() == b.read()
    for saved in ("device", "host"):
        got, _ = load_state(str(tmp_path / saved), {"opt": opt.init(params)}, ())
        assert got["opt"].count.dtype == torch.int64 and int(got["opt"].count) == 1
        got, _ = load_state(str(tmp_path / saved), {"opt": host_state._replace(count=0)}, ())
        assert got["opt"].count == 1 and isinstance(got["opt"].count, int)
        assert torch.equal(got["opt"].nu["g"], device_state.nu["g"])


# ---------------------------------------------------------------------- #
# the batched descent
# ---------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def batched64(golomb_visdata):
    p = batched_problem(multitime_visdata(golomb_visdata), dtype=np.float64)[1]
    t = torch_batched_problem(p)
    return (t["chunks"], t["data_r"], t["data_i"], t["wgts"], t["g_r"], t["g_i"], t["fg_r"],
            t["fg_i"])


# the host loop's values on this problem (per-step polling, the step count
# rewound past the last freeze): recorded steps, steps per slice, the first
# NaN row of each slice (-1: none) and the final step count (warm-up included)
HOST_LOOP_VALUES = {
    "tol": (106, [106, 98, 98], [-1, 98, 98], 107),
    "patience": (7, [7, 7, 7], [-1, -1, -1], 8),
}
BATCHED_CASES = {
    "tol": dict(maxsteps=400, tol=1e-9, opt_kwargs=(("learning_rate", 1e-2),)),
    "patience": dict(maxsteps=200, tol=0.0, patience=4, use_min=True,
                     opt_kwargs=(("learning_rate", 0.3),)),
}


@pytest.mark.parametrize("case", sorted(BATCHED_CASES))
def test_batched_descent_against_the_host_loop_and_every_poll_interval(batched64, case):
    cfg = tfit.FitConfig(**BATCHED_CASES[case])
    runs = {k: tb.batched_fit_core(cfg, *batched64, poll_every=k) for k in (1, 3, 16)}
    one = runs[1]
    nsteps, per_slice, nan_from, count = HOST_LOOP_VALUES[case]
    assert one.nsteps == nsteps and one.nsteps_slice.tolist() == per_slice
    h = one.loss_history
    assert np.isnan(h[nsteps:]).all()
    for b, first in enumerate(nan_from):
        if first < 0:
            assert np.isfinite(h[:nsteps, b]).all()
        else:  # a frozen slice records nothing after its freeze
            assert np.isfinite(h[:first, b]).all() and np.isnan(h[first:, b]).all()
    assert one.opt_state.count.dtype == torch.int64 and int(one.opt_state.count) == count
    for k in (3, 16):
        other = runs[k]
        assert other.nsteps == nsteps and nsteps % k  # the last block overran the stop
        np.testing.assert_array_equal(other.nsteps_slice, one.nsteps_slice)
        np.testing.assert_array_equal(other.loss_history, one.loss_history)
        for x, y in zip(tree_leaves(other.opt_state) + [other.g_r, *other.fg_r, other.final_loss],
                        tree_leaves(one.opt_state) + [one.g_r, *one.fg_r, one.final_loss]):
            assert torch.equal(x, y)


def test_batched_segment_past_a_full_freeze_changes_nothing(batched64):
    """A segment entered with every slice frozen takes no step; steps
    issued past the segment's end (a block longer than what is left)
    change nothing, the step count included."""
    cfg = tfit.FitConfig(maxsteps=10, tol=0.0, opt_kwargs=(("learning_rate", 1e-2),))
    opt, one_step = tb._batched_step_fn(cfg, batched64[0], *batched64[1:4], *batched64[6:8],
                                        None, None)
    params = tfit.init_params(cfg, *batched64[4:8])
    carry = tb._fresh_carry(cfg, 3, tb._np_dtype(batched64[4]), torch.device("cpu"), None)
    d = tb._BatchedDescent(cfg, one_step, params, opt.init(params), carry, 5)
    hist, rec = d.segment(0, 5, warmup=1, poll_every=4)
    assert rec == 5 and hist.shape == (5, 3) and int(d.opt_state.count) == 6

    def state():
        leaves = tree_leaves((d.params, d.opt_state, d.carry())) + [d.history]
        return [x.clone() for x in leaves if x is not None]

    before = state()
    for _ in range(2):
        d.graph()  # steps past the segment's end
    assert all(torch.equal(x, y) for x, y in zip(state(), before))
    d.frozen.fill_(True)
    before = state()
    hist, rec = d.segment(5, 5, poll_every=4)
    assert rec == 0 and hist.shape == (0, 3) and int(d.opt_state.count) == 6
    assert all(torch.equal(x, y) for x, y in zip(state(), before))


# ---------------------------------------------------------------------- #
# launches through replays, and the step runner on the CPU
# ---------------------------------------------------------------------- #
def test_launch_counter_counts_replays():
    c = LaunchCounter()
    c.add("k")
    with c.recording() as rec:
        c.add("k")
        c.add("k:mode")
        c.add("j")
    # a capture launches nothing: its counts go to the record alone
    assert rec == {"k": 1, "k:mode": 1, "j": 1}
    assert (c.get("k"), c.get("k:mode"), c.get("j")) == (1, 0, 0)
    c.replayed(rec)
    c.replayed(rec, times=3)
    assert (c.get("k"), c.get("k:mode"), c.get("j")) == (5, 4, 4)
    with pytest.raises(RuntimeError):
        with c.recording():
            c.add("k")
            raise RuntimeError("a capture that failed")
    assert c.get("k") == 5  # the totals are restored
    c.reset()
    assert c.get("k") == 0


def test_step_graph_runs_each_step_on_the_cpu():
    calls = []
    captures = len(graph.CAPTURES)
    runner = graph.StepGraph(lambda: calls.append(1), "cpu", "probe")
    assert not runner.capture
    for _ in range(5):
        runner()
    runner.close()
    assert len(calls) == 5 and runner.graph is None and len(graph.CAPTURES) == captures
    with graph.eager_steps():
        assert not graph.StepGraph(lambda: None, "cpu", "probe").capture
    assert graph._SWITCH.capture


# ---------------------------------------------------------------------- #
# on a card
# ---------------------------------------------------------------------- #
def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode")


@pytest.mark.gpu
@pytest.mark.parametrize("comps_precision", ["float32", "mixed"])
def test_cuda_serial_fit_graphed_equals_eager(golden, comps_precision):
    _need_cuda()
    p = golden["float32"]

    def run():
        LAUNCHES.reset()
        out = tfit.fit_gains_and_foregrounds(
            to_tensor(p["g_r"], "cuda"), to_tensor(p["g_i"], "cuda"), _conv(p["fg_r"], "cuda"),
            _conv(p["fg_i"], "cuda"), _conv(p["data_r"], "cuda"), _conv(p["data_i"], "cuda"),
            _conv(p["wgts"], "cuda"), chunks_from_jax(p["chunks"], "cuda"), maxsteps=120,
            tol=1e-7, learning_rate=1e-2, comps_precision=comps_precision)
        torch.cuda.synchronize()
        return out, dict(LAUNCHES._counts)

    captures = len(graph.CAPTURES)
    graphed, n_graphed = run()
    assert len(graph.CAPTURES) == captures + (2 if comps_precision == "mixed" else 1)
    with graph.eager_steps():
        eager, n_eager = run()
    assert len(graph.CAPTURES) == captures + (2 if comps_precision == "mixed" else 1)
    assert graphed[4]["loss"] == eager[4]["loss"]
    for x, y in zip([graphed[0], graphed[1], *graphed[2]], [eager[0], eager[1], *eager[2]]):
        assert torch.equal(x, y)
    assert n_graphed == n_eager and n_graphed


@pytest.mark.gpu
def test_cuda_batched_descent_graphed_equals_eager(batched64):
    _need_cuda()
    cfg = tfit.FitConfig(maxsteps=150, tol=1e-9, opt_kwargs=(("learning_rate", 1e-2),))
    args = [x.to("cuda") if isinstance(x, torch.Tensor)
            else [tuple(y.to("cuda") for y in c) if isinstance(c, tuple) else c.to("cuda")
                  for c in x] for x in batched64]
    graphed = tb.batched_fit_core(cfg, *args, poll_every=16)
    with graph.eager_steps():
        eager = tb.batched_fit_core(cfg, *args, poll_every=16)
    assert graphed.nsteps == eager.nsteps
    np.testing.assert_array_equal(graphed.loss_history, eager.loss_history)
    for x, y in zip(tree_leaves(graphed.opt_state) + [graphed.g_r, *graphed.fg_r],
                    tree_leaves(eager.opt_state) + [eager.g_r, *eager.fg_r]):
        assert torch.equal(x, y)


@pytest.mark.gpu
def test_cuda_capture_that_reads_the_host_raises_naming_it():
    _need_cuda()
    x = torch.zeros(4, device="cuda")

    def step():
        x.add_(1)
        if x.sum().item() < 0:  # a host read inside the step
            x.zero_()

    runner = graph.StepGraph(step, "cuda", "probe")
    for _ in range(graph.EAGER_STEPS):
        runner()
    with pytest.raises(RuntimeError, match="capture of probe's step failed at tests/"
                                           "test_torch_device_loop.py:[0-9]+ in step "
                                           r"\(if x.sum\(\).item\(\) < 0:"):
        runner()
    torch.cuda.synchronize()
    assert to_np(x).tolist() == [2.0] * 4
