"""The port's batched time-parallel building blocks against calamity_tpu's.

On the 6-antenna Golomb array at three times (the multi-time fixture of
tests/test_parallel.py, ``shared_basis=False`` so every chunk is dense
B=1), both packages start from the same host stacks, packed by the JAX
FitSpec and carried over as tensors:

- batched losses and their gradients (float32 and bfloat16 comps and
  weights), the "sum"-regularized loss, blocked against unblocked
  evaluation, and the fused route against the JAX package's vmapped Pallas
  kernel in interpret mode at shapes its TPU gate takes;
- the batched forward model in its three packings (on the device and its
  host mirror for the write-back), the batched warm starts, and
  ``pack_data_into`` (bit-equal host stacks);
- ``batched_fit_core``: per-slice histories, step counts and final state,
  per-slice freeze, patience, use_min, freeze_model, the sum prior and a
  slice that diverges;
- blocked polling of the freeze mask against per-step polling (exact).

Tolerances: float64 rel 1e-9 (summation order only); float32 losses rel
1e-5 and gradients rel 1e-4; float32 and bfloat16 descents rel 1e-4 on
histories and final parameters.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (
    BATCHED_DESCENT,
    DPSS_DLY,
    as_port,
    batched_problem,
    multitime_visdata,
    rel_err,
    to_np,
    torch_batched_problem,
)

from calamity_tpu import models
from calamity_tpu.io import FlagWeights
from calamity_tpu.ops import loss as jloss
from calamity_tpu.ops import lstsq as jlstsq
from calamity_tpu.parallel import batched as jb
from calamity_tpu.solver.fit import FitConfig as JaxFitConfig
from calamity_tpu.solver.tensorize import FitSpec as JaxFitSpec
from calamity_tpu_torch import LAUNCHES
from calamity_tpu_torch import models as tmodels
from calamity_tpu_torch.convert import to_tensor
from calamity_tpu_torch.ops import fused
from calamity_tpu_torch.ops import loss as tloss
from calamity_tpu_torch.ops import lstsq as tlstsq
from calamity_tpu_torch.parallel import batched as tb
from calamity_tpu_torch.solver.fit import FitConfig
from calamity_tpu_torch.solver.tensorize import FitSpec


@pytest.fixture(scope="module")
def multitime(golomb_visdata):
    return multitime_visdata(golomb_visdata)


@pytest.fixture(scope="module")
def problem(multitime):
    # float32 descents start from 10% gain errors: at 2% the gradients of
    # some channels sit at float32 rounding noise, where Adamax's normalized
    # steps turn the two frameworks' summation orders into full-size steps
    return {"float32": batched_problem(multitime, dtype=np.float32, gain_err=0.1)[1],
            "float64": batched_problem(multitime, dtype=np.float64)[1]}


def _jax_problem(p, comps_dtype=None, wgts_dtype=None):
    chunks = tuple(p["chunks"])
    if comps_dtype is not None:
        chunks = tuple((c.astype(comps_dtype), a0, a1) for c, a0, a1 in chunks)
    wgts = tuple(jnp.asarray(w) if wgts_dtype is None else jnp.asarray(w).astype(wgts_dtype)
                 for w in p["wgts"])
    return dict(chunks=chunks, data_r=tuple(jnp.asarray(x) for x in p["data_r"]),
                data_i=tuple(jnp.asarray(x) for x in p["data_i"]), wgts=wgts,
                g_r=jnp.asarray(p["g_r"]), g_i=jnp.asarray(p["g_i"]),
                fg_r=tuple(jnp.asarray(x) for x in p["fg_r"]),
                fg_i=tuple(jnp.asarray(x) for x in p["fg_i"]))


def _jax_value_and_grads(fn, q):
    import jax

    def total(gr, gi, fr, fi):
        losses = fn(gr, gi, fr, fi)
        return jnp.sum(losses), losses

    (_, losses), grads = jax.value_and_grad(total, argnums=(0, 1, 2, 3), has_aux=True)(
        q["g_r"], q["g_i"], q["fg_r"], q["fg_i"])
    return losses, grads


def _torch_value_and_grads(fn, q):
    leaves = [q["g_r"].clone().requires_grad_(True), q["g_i"].clone().requires_grad_(True),
              [x.clone().requires_grad_(True) for x in q["fg_r"]],
              [x.clone().requires_grad_(True) for x in q["fg_i"]]]
    losses = fn(*leaves)
    flat = [leaves[0], leaves[1], *leaves[2], *leaves[3]]
    grads = torch.autograd.grad(torch.sum(losses), flat)
    nc = len(leaves[2])
    return losses, (grads[0], grads[1], grads[2:2 + nc], grads[2 + nc:])


def _assert_grads(tg, jg, tol):
    assert rel_err(tg[0], jg[0]) <= tol and rel_err(tg[1], jg[1]) <= tol
    for got, want in zip(list(tg[2]) + list(tg[3]), list(jg[2]) + list(jg[3])):
        assert rel_err(got, want) <= tol


@pytest.mark.parametrize("comps_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("wgts_dtype", ["float32", "bfloat16"])
def test_batched_losses_match_jax(problem, comps_dtype, wgts_dtype):
    p = problem["float32"]
    jdt = {"float32": None, "bfloat16": jnp.bfloat16}
    tdt = {"float32": None, "bfloat16": torch.bfloat16}
    q = _jax_problem(p, jdt[comps_dtype], jdt[wgts_dtype])
    jl, jg = _jax_value_and_grads(
        lambda gr, gi, fr, fi: jb.batched_chunk_losses(
            gr, gi, fr, fi, q["chunks"], q["data_r"], q["data_i"], q["wgts"]), q)
    t = torch_batched_problem(p, tdt[comps_dtype], tdt[wgts_dtype])
    # every chunk is dense B=1: the whole loss is the fused route
    for cnum, (c, _, _) in enumerate(t["chunks"]):
        assert fused.explain_fused_loss_inapplicable(
            c, t["fg_r"][cnum], t["data_r"][cnum], t["wgts"][cnum]) is None
    tl, tg = _torch_value_and_grads(
        lambda gr, gi, fr, fi: tb.batched_chunk_losses(
            gr, gi, fr, fi, t["chunks"], t["data_r"], t["data_i"], t["wgts"]), t)
    assert tl.shape == (3,)
    assert rel_err(tl, jl) <= 1e-5
    _assert_grads(tg, jg, 1e-4)


def test_blocked_losses_match_unblocked(problem):
    t = torch_batched_problem(problem["float64"])

    def fn(blk):
        return lambda gr, gi, fr, fi: tb.batched_chunk_losses(
            gr, gi, fr, fi, t["chunks"], t["data_r"], t["data_i"], t["wgts"], loss_block=blk)

    ul, ug = _torch_value_and_grads(fn(None), t)
    bl, bg = _torch_value_and_grads(fn(4), t)  # 15 groups -> blocks of 3
    assert rel_err(bl, ul) <= 1e-12
    _assert_grads(bg, ug, 1e-12)
    rl, rg = _torch_value_and_grads(
        lambda gr, gi, fr, fi: tb.batched_chunk_losses(
            gr, gi, fr, fi, t["chunks"], t["data_r"], t["data_i"], t["wgts"], remat=True), t)
    assert rel_err(rl, ul) <= 1e-12
    _assert_grads(rg, ug, 1e-12)


@pytest.mark.parametrize("ngrps, gmax, requested, unit", [
    (15, 1, None, 1), (15, 1, 4, 1), (15, 1, 20, 1), (64, 16, 40, 1), (64, 16, 8, 1),
    (60, 4, 25, 2), (7, 1, 3, 1), (96, 8, 50, 3),
])
def test_loss_block_size_matches_jax(ngrps, gmax, requested, unit):
    assert (tloss._loss_block_size(ngrps, gmax, requested, unit)
            == jb._loss_block_size(ngrps, gmax, requested, unit))


def test_sum_regularized_matches_jax(problem):
    p = problem["float64"]
    prior_r, prior_i = np.array([0.3, -0.1, 0.7]), np.array([0.05, 0.2, -0.4])
    q = _jax_problem(p)
    jl, jg = _jax_value_and_grads(
        lambda gr, gi, fr, fi: jb.batched_chunk_losses_sum_regularized(
            gr, gi, fr, fi, q["chunks"], q["data_r"], q["data_i"], q["wgts"],
            jnp.asarray(prior_r), jnp.asarray(prior_i), loss_block=4), q)
    t = torch_batched_problem(p)
    tl, tg = _torch_value_and_grads(
        lambda gr, gi, fr, fi: tb.batched_chunk_losses_sum_regularized(
            gr, gi, fr, fi, t["chunks"], t["data_r"], t["data_i"], t["wgts"],
            torch.as_tensor(prior_r), torch.as_tensor(prior_i), loss_block=4), t)
    assert rel_err(tl, jl) <= 1e-9
    _assert_grads(tg, jg, 1e-9)


def _kernel_shaped(nbatch, ngrps, nfreqs, nvecs, nants=8, seed=0):
    rng = np.random.default_rng(seed)
    comps = rng.standard_normal((ngrps, 1, nfreqs, nvecs)).astype(np.float32)
    comps /= np.linalg.norm(comps, axis=2, keepdims=True)
    a0 = rng.integers(0, nants, (ngrps, 1)).astype(np.int32)
    a1 = ((a0 + 1 + rng.integers(0, nants - 1, (ngrps, 1))) % nants).astype(np.int32)
    shape = (nbatch, ngrps, 1, nfreqs)
    w = np.abs(rng.standard_normal(shape)).astype(np.float32)
    return dict(
        chunks=((comps, a0, a1),),
        g_r=(1 + 0.1 * rng.standard_normal((nbatch, nants, nfreqs))).astype(np.float32),
        g_i=(0.1 * rng.standard_normal((nbatch, nants, nfreqs))).astype(np.float32),
        fg_r=[rng.standard_normal((nbatch, ngrps, nvecs)).astype(np.float32)],
        fg_i=[rng.standard_normal((nbatch, ngrps, nvecs)).astype(np.float32)],
        data_r=[rng.standard_normal(shape).astype(np.float32)],
        data_i=[rng.standard_normal(shape).astype(np.float32)],
        wgts=[w / w.sum(axis=(1, 2, 3), keepdims=True)],
    )


@pytest.mark.parametrize("comps_dtype", ["float32", "bfloat16"])
def test_fused_route_matches_vmapped_pallas_interpret(comps_dtype):
    from calamity_tpu.ops.fused import fused_loss_applicable

    p = _kernel_shaped(3, 16, 256, 128)
    jdt = jnp.bfloat16 if comps_dtype == "bfloat16" else None
    q = _jax_problem(p, jdt)
    assert fused_loss_applicable(q["chunks"][0][0])  # the TPU gate takes it
    jl, jg = _jax_value_and_grads(
        lambda gr, gi, fr, fi: jb.batched_chunk_losses(
            gr, gi, fr, fi, q["chunks"], q["data_r"], q["data_i"], q["wgts"],
            use_pallas=True), q)
    t = torch_batched_problem(p, torch.bfloat16 if comps_dtype == "bfloat16" else None)
    tl, tg = _torch_value_and_grads(
        lambda gr, gi, fr, fi: tb.batched_chunk_losses(
            gr, gi, fr, fi, t["chunks"], t["data_r"], t["data_i"], t["wgts"]), t)
    assert rel_err(tl, jl) <= 1e-5
    _assert_grads(tg, jg, 1e-4)


def test_fused_batched_matches_single_slice_and_plain():
    rng = np.random.default_rng(3)
    n, g, f, v = 3, 5, 37, 7
    comps = torch.as_tensor(rng.standard_normal((g, f, v)), dtype=torch.float32)
    coeffs2 = torch.as_tensor(rng.standard_normal((2, n, g, v)), dtype=torch.float32)
    planes = [torch.as_tensor(rng.standard_normal((n, g, f)), dtype=torch.float32)
              for _ in range(5)]
    planes[4] = planes[4].abs()
    losses = fused.fused_chunk_loss_batched(coeffs2, *planes, comps)
    plain = fused.fused_chunk_loss_batched_plain(coeffs2, *planes, comps)
    assert rel_err(losses, plain) <= 1e-6
    for k in range(n):
        one = fused.fused_chunk_loss(coeffs2[:, k], planes[0][k], planes[1][k], comps,
                                     planes[2][k], planes[3][k], planes[4][k])
        assert rel_err(one, losses[k]) <= 1e-6


@pytest.mark.parametrize("layout", ["dense", "shared", "shared-batched"])
def test_fg_model_batched_and_warm_starts_match_jax(layout, golomb_visdata, redundant_visdata):
    uvd = golomb_visdata if layout == "dense" else redundant_visdata
    uvd = uvd.select(inplace=False, bls=[ap for ap in uvd.get_antpairs() if ap[0] != ap[1]])
    comps = models.yield_pbl_dpss_model_comps(uvd, min_dly=DPSS_DLY, offset=DPSS_DLY)
    ants = sorted(set(uvd.ant_1_array.tolist()) | set(uvd.ant_2_array.tolist()))
    spec = JaxFitSpec(uvd, comps, {a: i for i, a in enumerate(ants)}, dtype=np.float64,
                      shared_basis=layout != "dense")
    rng = np.random.default_rng(4)
    seen = False
    for c, a0, _ in spec.device_chunks():
        ngrps, nu = a0.shape[0], c.shape[0]
        kind = "dense" if nu == ngrps else ("shared" if nu == 1 else "shared-batched")
        if kind != layout:
            continue
        seen = True
        nb = 2
        cr, ci = (rng.standard_normal((nb, ngrps, c.shape[-1])) for _ in range(2))
        jv = jloss.fg_model_batched(jnp.asarray(cr), jnp.asarray(ci), c)
        tv = tloss.fg_model_batched(torch.as_tensor(cr), torch.as_tensor(ci), to_tensor(c, "cpu"))
        # the write-back's host model, slice by slice
        hv = [np.stack(x) for x in zip(*(tloss.fg_model_host(cr[b], ci[b], np.asarray(c))
                                         for b in range(nb)))]
        for got, host, want in zip(tv, hv, jv):
            assert rel_err(got, want) <= 1e-9 and rel_err(host, want) <= 1e-9
        for b in range(nb):
            for host, want in zip(hv, jloss.fg_model_host(cr[b], ci[b], np.asarray(c))):
                assert rel_err(host[b], want) <= 1e-9
        shape = (nb,) + tuple(a0.shape) + (c.shape[2],)
        dr, di = (rng.standard_normal(shape) for _ in range(2))
        w = (rng.uniform(size=shape) > 0.2).astype(np.float64)
        chol, active = jlstsq.gram_cholesky_chunk(c)
        jc = jlstsq.init_coeffs_from_cholesky_batched(chol, active, c, dr, di, w)
        tchol, tact = tlstsq.gram_cholesky_chunk(to_tensor(c, "cpu"))
        tc = tlstsq.init_coeffs_from_cholesky_batched(
            tchol, tact, to_tensor(c, "cpu"), *(torch.as_tensor(x) for x in (dr, di, w)))
        for got, want in zip(tc, jc):
            assert rel_err(got, want) <= 1e-9
        gmax = ngrps // nu if 1 < nu < ngrps else 1
        blk = tloss._loss_block_size(ngrps, gmax, max(1, ngrps // 2)) or ngrps
        jout = jlstsq.blocked_init_from_data(chol, active, c, dr, di, w, blk=blk)
        tout = tlstsq.blocked_init_from_data(tchol, tact, to_tensor(c, "cpu"),
                                             *(torch.as_tensor(x) for x in (dr, di, w)), blk)
        for got, want in zip(tout, jout):
            assert rel_err(got, want) <= 1e-9
    assert seen


@pytest.mark.parametrize("with_weights", [False, True])
def test_pack_data_into_bit_equal(multitime, with_weights):
    # each package packs its own containers, built from the same arrays
    uvd, tuvd = multitime, as_port(multitime)
    comps = models.yield_pbl_dpss_model_comps(uvd, min_dly=DPSS_DLY, offset=DPSS_DLY)
    tcomps = tmodels.yield_pbl_dpss_model_comps(tuvd, min_dly=DPSS_DLY, offset=DPSS_DLY)
    ants = sorted(set(uvd.ant_1_array.tolist()) | set(uvd.ant_2_array.tolist()))
    amap = {a: i for i, a in enumerate(ants)}
    jspec = JaxFitSpec(uvd, comps, amap, dtype=np.float32)
    tspec = FitSpec(tuvd, tcomps, amap, device="cpu")
    weights = tweights = None
    if with_weights:
        weights = FlagWeights(uvd, mode="flag")
        weights.weights_array[:] = np.abs(
            np.random.default_rng(3).standard_normal(weights.weights_array.shape))
        tweights = as_port(weights)
    nb = len(jspec.times)

    def stacks():
        # two padded groups per chunk: rows past the real groups stay zero
        return [np.zeros((nb + 1, m.conj.shape[0] + 2, m.conj.shape[1], uvd.Nfreqs),
                         dtype=np.float32) for m in jspec.meta]

    outs = {}
    for name, spec, vis, wts in (("jax", jspec, uvd, weights), ("torch", tspec, tuvd, tweights)):
        r, i, w = stacks(), stacks(), stacks()
        sr, si = stacks(), stacks()
        for b, t in enumerate(spec.times):
            kw = dict(data_scale_factor=1.3 + b, weights=wts, nsamples_in_weights=True)
            spec.pack_data_into(vis, "xx", t, r, i, w, b, **kw)
            spec.pack_data_into(vis, "xx", t, sr, si, None, b, data_scale_factor=0.7)
        outs[name] = (r, i, w, sr, si)
        outs[name + "_np"] = spec.pack_data(vis, "xx", spec.times[1], data_scale_factor=2.3,
                                            weights=wts, as_numpy=True)
    for got, want in zip(outs["torch"], outs["jax"]):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    for got, want in zip(outs["torch_np"], outs["jax_np"]):
        for g, w in zip(got, want):
            assert isinstance(g, np.ndarray)
            np.testing.assert_array_equal(g, np.asarray(w))
    # a slot packed alone equals that slice's pack_data
    r = outs["torch"][0]
    single = tspec.pack_data(tuvd, "xx", tspec.times[0], data_scale_factor=1.3, weights=tweights,
                             nsamples_in_weights=True)
    for cnum, d in enumerate(single[0]):
        np.testing.assert_array_equal(r[cnum][0, : d.shape[0]], to_np(d))


# ---------------------------------------------------------------------- #
# the batched descent
# ---------------------------------------------------------------------- #
def _run_cores(p, cfg_kw, comps_dtype=None, poll_every=1, prior=None):
    jcfg = JaxFitConfig(**cfg_kw)
    q = _jax_problem(p, None if comps_dtype is None else jnp.bfloat16)
    jargs = (q["chunks"], q["data_r"], q["data_i"], q["wgts"], q["g_r"], q["g_i"], q["fg_r"],
             q["fg_i"])
    tcfg = FitConfig(**cfg_kw)
    t = torch_batched_problem(p, comps_dtype)
    targs = (t["chunks"], t["data_r"], t["data_i"], t["wgts"], t["g_r"], t["g_i"], t["fg_r"],
             t["fg_i"])
    jp = tp = (None, None)
    if prior is not None:
        jp = tuple(jnp.asarray(x) for x in prior)
        tp = tuple(torch.as_tensor(x) for x in prior)
    jres = jb.batched_fit_core(jcfg, *jargs, *jp)
    tres = tb.batched_fit_core(tcfg, *targs, *tp, poll_every=poll_every)
    return jres, tres


def _complex_rel(got_r, got_i, want_r, want_i):
    got = to_np(got_r).astype(np.float64) + 1j * to_np(got_i)
    want = to_np(want_r).astype(np.float64) + 1j * to_np(want_i)
    scale = np.max(np.abs(want))
    return np.max(np.abs(got - want)) / scale if scale > 0 else np.max(np.abs(got - want))


def _compare_cores(jres, tres, tol):
    n = int(jres.nsteps)
    assert tres.nsteps == n
    np.testing.assert_array_equal(tres.nsteps_slice, np.asarray(jres.nsteps_slice))
    jh = np.asarray(jres.loss_history)[:n]
    th = tres.loss_history[:n]
    np.testing.assert_array_equal(np.isnan(th), np.isnan(jh))
    finite = np.isfinite(jh)
    if finite.any():
        assert rel_err(th[finite], jh[finite]) <= tol
    fin = np.isfinite(np.asarray(jres.final_loss))
    assert rel_err(to_np(tres.final_loss)[fin], np.asarray(jres.final_loss)[fin]) <= tol
    for b in range(th.shape[1]):
        if not np.all(np.isfinite(np.asarray(jres.g_r[b]))):
            continue
        assert _complex_rel(tres.g_r[b], tres.g_i[b], jres.g_r[b], jres.g_i[b]) <= tol
        for parts in zip(tres.fg_r, tres.fg_i, jres.fg_r, jres.fg_i):
            assert _complex_rel(*(x[b] for x in parts)) <= tol


@pytest.mark.parametrize("case", ["tol_freeze", "patience", "use_min", "freeze_model",
                                  "sum_prior", "diverging_slice"])
def test_batched_fit_core_matches_jax_float64(problem, case):
    p = dict(problem["float64"])
    kw = dict(BATCHED_DESCENT)
    prior = None
    if case == "tol_freeze":
        kw.update(maxsteps=400, tol=1e-9)
    elif case == "patience":
        kw.update(patience=4, use_min=True, maxsteps=200, opt_kwargs=(("learning_rate", 0.3),))
    elif case == "use_min":
        kw.update(use_min=True, opt_kwargs=(("learning_rate", 5e-2),))
    elif case == "freeze_model":
        kw.update(freeze_model=True)
    elif case == "sum_prior":
        kw.update(regularization="sum")
        prior = (np.array([0.9, 1.0, 1.1]), np.array([0.01, -0.02, 0.0]))
    elif case == "diverging_slice":
        w = p["wgts"][0].copy()
        w[1, 0, 0, 0] = np.nan
        p["wgts"] = [w] + list(p["wgts"][1:])
    jres, tres = _run_cores(p, kw, prior=prior)
    ns = np.asarray(jres.nsteps_slice)
    if case == "tol_freeze":
        assert np.all(ns < kw["maxsteps"]) and len(set(ns.tolist())) > 1  # per-slice freezes
    if case == "patience":
        assert np.all(ns < kw["maxsteps"])
    if case == "diverging_slice":
        assert np.asarray(jres.nsteps_slice)[1] == 1 and tres.nsteps_slice[1] == 1
    _compare_cores(jres, tres, 1e-9)


@pytest.mark.parametrize("comps_dtype", [None, torch.bfloat16])
def test_batched_fit_core_matches_jax_float32(problem, comps_dtype):
    jres, tres = _run_cores(problem["float32"], dict(BATCHED_DESCENT, maxsteps=25), comps_dtype)
    assert tres.nsteps == 25
    _compare_cores(jres, tres, 1e-4)


@pytest.mark.parametrize("case", ["tol", "patience"])
def test_blocked_polling_equals_per_step_polling(problem, case):
    p = problem["float64"]
    kw = dict(maxsteps=300, tol=1e-9, opt_kwargs=(("learning_rate", 1e-2),))
    if case == "patience":
        kw.update(tol=0.0, patience=3, use_min=True, opt_kwargs=(("learning_rate", 0.3),))
    cfg = FitConfig(**kw)
    t = torch_batched_problem(p)
    args = (t["chunks"], t["data_r"], t["data_i"], t["wgts"], t["g_r"], t["g_i"], t["fg_r"],
            t["fg_i"])
    one = tb.batched_fit_core(cfg, *args, poll_every=1)
    blocked = tb.batched_fit_core(cfg, *args, poll_every=7)
    assert one.nsteps < cfg.maxsteps and one.nsteps % 7  # the block overran the last freeze
    assert blocked.nsteps == one.nsteps
    np.testing.assert_array_equal(blocked.nsteps_slice, one.nsteps_slice)
    np.testing.assert_array_equal(blocked.loss_history, one.loss_history)
    assert blocked.opt_state.count == one.opt_state.count
    for a, b in zip([blocked.g_r, blocked.g_i, *blocked.fg_r, *blocked.fg_i,
                     blocked.final_loss],
                    [one.g_r, one.g_i, *one.fg_r, *one.fg_i, one.final_loss]):
        assert torch.equal(a, b)
    for a, b in zip(blocked.opt_state.mu["fg_r"] + blocked.opt_state.nu["fg_r"],
                    one.opt_state.mu["fg_r"] + one.opt_state.nu["fg_r"]):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("wgts_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("comps_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 5, 37, 3), (3, 7, 129, 130), (9, 6, 40, 119),
                                   (8, 64, 256, 118)])
def test_cuda_batched_kernel_matches_plain(shape, comps_dtype, wgts_dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    n, g, f, v = shape
    rng = np.random.default_rng(sum(shape))
    dev = torch.device("cuda")

    def t(*s):
        return torch.as_tensor(rng.standard_normal(s), dtype=torch.float32, device=dev)

    comps = t(g + 4, f, v).to(comps_dtype)
    coeffs2 = t(2, n, g + 4, v)
    pr, pi = 1 + 0.1 * t(n, g + 4, f), 0.1 * t(n, g + 4, f)
    dr, di = t(n, g + 4, f), t(n, g + 4, f)
    w = t(n, g + 4, f).abs().to(wgts_dtype)
    # a group block [2, 2 + g) of resident cubes: data and weights as views
    sl = slice(2, 2 + g)
    args = (coeffs2[:, :, sl].contiguous(), pr[:, sl].contiguous(), pi[:, sl].contiguous(),
            dr[:, sl], di[:, sl], w[:, sl], comps[sl])
    before = LAUNCHES.get(fused.KERNEL_NAME)
    got = fused.loss_and_grads_kernel(*args)
    assert LAUNCHES.get(fused.KERNEL_NAME) == before + 1
    want = fused.loss_and_grads_plain(*args)
    torch.cuda.synchronize()
    assert rel_err(got[0], want[0]) <= 1e-5
    for g, p in zip(got[1:], want[1:]):  # dcoeffs, dpr, dpi at a unit cotangent
        assert rel_err(g, p) <= 1e-4

    def grads(fn):
        leaves = [a.detach().clone().requires_grad_(i < 3) for i, a in enumerate(args)]
        torch.sum(fn(*leaves) * torch.arange(1, n + 1, device=dev)).backward()
        return [leaves[i].grad for i in range(3)]

    for got, want in zip(grads(fused.fused_chunk_loss_batched),
                         grads(fused.fused_chunk_loss_batched_plain)):
        assert rel_err(got, want) <= 1e-4
