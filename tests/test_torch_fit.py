"""The port's descent loop against calamity_tpu's fit_gains_and_foregrounds
on the golden Golomb file: loss histories, step counts (with phase steps)
and final parameters, for the float32, bfloat16 and mixed schedules, the
tol stop, use_min, patience, freeze_model, the "sum" prior and the stop on
a non-finite loss. Both packages start from the same state (the JAX warm
start carried over through calamity_tpu_torch.convert).

Tolerances: float64 runs agree to rel 1e-9 over every recorded step (only
summation order differs); float32 and bf16-comps runs to rel 1e-4 in loss
history and final parameters (rounding differences compound over the
steps of a descent; a few dozen steps here). Gains and coefficients are
compared as complex numbers, relative to their largest amplitude.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import zero_plateau_fit_args
from torch_parity import DPSS_DLY, GOLDEN_GOLOMB, rel_err, to_np

from calamity_tpu import models
from calamity_tpu.io import CalData, VisData
from calamity_tpu.solver.fit import fit_gains_and_foregrounds as jax_fit
from calamity_tpu.solver.tensorize import FitSpec
from calamity_tpu_torch.convert import chunks_from_jax, to_tensor
from calamity_tpu_torch.ops.fused import explain_fused_loss_inapplicable
from calamity_tpu_torch.solver.fit import fit_gains_and_foregrounds as torch_fit


@pytest.fixture(scope="module")
def golden_problem():
    uvd = VisData.from_uvh5(GOLDEN_GOLOMB)
    comps = models.yield_pbl_dpss_model_comps(uvd, min_dly=DPSS_DLY, offset=DPSS_DLY)
    gains = CalData.blank_from_visdata(uvd)
    rng = np.random.default_rng(11)
    gains.gain_array = gains.gain_array * (
        1 + 0.02 * rng.standard_normal(gains.gain_array.shape)
        + 0.02j * rng.standard_normal(gains.gain_array.shape)
    )
    out = {}
    for name, dtype in (("float32", np.float32), ("float64", np.float64)):
        spec = FitSpec(uvd, comps, {int(a): i for i, a in enumerate(gains.ant_array)},
                       dtype=dtype)
        t = spec.times[0]
        rms = np.sqrt(np.mean(np.abs(uvd.data_array) ** 2))
        data_r, data_i, wgts = spec.pack_data(uvd, "xx", t, data_scale_factor=rms)
        g_r, g_i = spec.pack_gains(gains, "xx", t)
        out[name] = dict(
            g_r=g_r, g_i=g_i, fg_r=spec.init_coeffs(data_r, wgts),
            fg_i=spec.init_coeffs(data_i, wgts), data_r=data_r, data_i=data_i, wgts=wgts,
            chunks=spec.device_chunks(),
        )
    return out


def _run_both(p, **kw):
    # the "sum" prior's sky model is the data itself (identity-gains alias)
    sky = {"sky_model_r": p["data_r"], "sky_model_i": p["data_i"]}
    if kw.get("model_regularization") != "sum":
        sky = {}
    jres = jax_fit(p["g_r"], p["g_i"], p["fg_r"], p["fg_i"], p["data_r"], p["data_i"],
                   p["wgts"], p["chunks"], **sky, **kw)

    def conv(xs):
        return [to_tensor(x, "cpu") for x in xs]

    kw.update({k: conv(v) for k, v in sky.items()})
    tres = torch_fit(to_tensor(p["g_r"], "cpu"), to_tensor(p["g_i"], "cpu"), conv(p["fg_r"]),
                     conv(p["fg_i"]), conv(p["data_r"]), conv(p["data_i"]), conv(p["wgts"]),
                     chunks_from_jax(p["chunks"], "cpu"), **kw)
    return jres, tres


def _compare(jres, tres, tol):
    jh, th = jres[4], tres[4]
    assert len(th["loss"]) == len(jh["loss"])
    assert th.get("phase_steps") == jh.get("phase_steps")
    assert rel_err(np.asarray(th["loss"]), np.asarray(jh["loss"])) <= tol
    # complex gains and coefficients, relative to their largest amplitude
    assert _complex_rel(tres[0], tres[1], jres[0], jres[1]) <= tol
    for parts in zip(tres[2], tres[3], jres[2], jres[3]):
        assert _complex_rel(*parts) <= tol


def _complex_rel(got_r, got_i, want_r, want_i):
    got = to_np(got_r).astype(np.float64) + 1j * to_np(got_i)
    want = to_np(want_r).astype(np.float64) + 1j * to_np(want_i)
    scale = np.max(np.abs(want))
    diff = np.max(np.abs(got - want))
    return diff / scale if scale > 0 else diff


@pytest.mark.parametrize("comps_precision", ["float32", "bfloat16", "mixed"])
def test_precision_schedules(golden_problem, comps_precision):
    jres, tres = _run_both(golden_problem["float32"], maxsteps=25, tol=0.0,
                           learning_rate=1e-2, comps_precision=comps_precision,
                           model_regularization="post_hoc")
    expect = 50 if comps_precision == "mixed" else 25
    assert len(tres[4]["loss"]) == expect
    _compare(jres, tres, 1e-4)


@pytest.mark.parametrize("case", ["tol_stop", "use_min", "patience", "freeze_model",
                                  "sum_prior"])
def test_stop_rules_and_modes_float64(golden_problem, case):
    p = golden_problem["float64"]
    kw = dict(maxsteps=400, tol=1e-10, learning_rate=1e-2, comps_precision="float32")
    if case == "use_min":
        kw.update(use_min=True, learning_rate=5e-2, maxsteps=60, tol=0.0)
    elif case == "patience":
        # a step size large enough to oscillate: no new minimum for 5 steps
        kw.update(patience=5, use_min=True, learning_rate=0.3, maxsteps=200, tol=0.0)
    elif case == "freeze_model":
        kw.update(freeze_model=True, maxsteps=60)
    elif case == "sum_prior":
        kw.update(model_regularization="sum", maxsteps=60)
    jres, tres = _run_both(p, **kw)
    if case in ("tol_stop", "patience"):
        assert len(jres[4]["loss"]) < kw["maxsteps"]  # the stop fired
    _compare(jres, tres, 1e-9)


@pytest.mark.parametrize("patience", [1, 7])
def test_patience_on_zero_plateau(patience):
    # loss exactly 0 every step: the first recorded step is the only new
    # minimum, so patience stops the fit after patience + 1 steps
    chunks, data_r, data_i, wgts, g_r, g_i, fg = zero_plateau_fit_args()
    kw = dict(maxsteps=50, patience=patience, use_min=True, tol=0.0, learning_rate=1e-2,
              comps_precision="float32")
    jres = jax_fit(g_r, g_i, fg, fg, data_r, data_i, wgts, chunks, **kw)

    def conv(xs):
        return [to_tensor(x, "cpu") for x in xs]

    tres = torch_fit(to_tensor(g_r, "cpu"), to_tensor(g_i, "cpu"), conv(fg), conv(fg),
                     conv(data_r), conv(data_i), conv(wgts), chunks_from_jax(chunks, "cpu"),
                     **kw)
    assert len(tres[4]["loss"]) == len(jres[4]["loss"]) == patience + 1
    assert all(x == 0.0 for x in tres[4]["loss"])
    _compare(jres, tres, 1e-12)


def test_bfloat16_weights(golden_problem):
    """bfloat16 weight cubes, which the port's kernel widens on load (the
    JAX package accepts them on this path)."""
    p = dict(golden_problem["float32"])
    p["wgts"] = [jnp.asarray(w).astype(jnp.bfloat16) for w in p["wgts"]]
    jres, tres = _run_both(p, maxsteps=25, tol=0.0, learning_rate=1e-2,
                           comps_precision="float32", model_regularization="post_hoc")
    assert len(tres[4]["loss"]) == 25
    _compare(jres, tres, 1e-4)


def test_non_finite_loss_stops(golden_problem):
    p = dict(golden_problem["float32"])
    w = np.array(p["wgts"][0])
    w[0, 0, 0] = np.nan
    p["wgts"] = [jnp.asarray(w)] + list(p["wgts"][1:])
    jres, tres = _run_both(p, maxsteps=20, tol=0.0, comps_precision="float32")
    assert len(tres[4]["loss"]) == len(jres[4]["loss"]) == 1
    assert np.isnan(tres[4]["loss"][0]) and np.isnan(jres[4]["loss"][0])


def _torch_args(p):
    return [to_tensor(p["g_r"], "cpu"), to_tensor(p["g_i"], "cpu"),
            [to_tensor(x, "cpu") for x in p["fg_r"]], [to_tensor(x, "cpu") for x in p["fg_i"]],
            [to_tensor(x, "cpu") for x in p["data_r"]], [to_tensor(x, "cpu") for x in p["data_i"]],
            [to_tensor(x, "cpu") for x in p["wgts"]], chunks_from_jax(p["chunks"], "cpu")]


def test_not_ported_options_raise(golden_problem):
    # every option of the reference's fit is ported: what is left raises
    # for a wrong value only
    args = _torch_args(golden_problem["float32"])
    with pytest.raises(ValueError, match="comps_precision"):
        torch_fit(*args, comps_precision="float16")
    with pytest.raises(KeyError, match="unknown optimizer 'Adamw'"):
        torch_fit(*args, optimizer="Adamw")


@pytest.mark.parametrize("comps_precision", ["float32", "bfloat16"])
def test_profile_steps_write_a_trace_and_leave_the_fit_unchanged(golden_problem, tmp_path,
                                                                  comps_precision):
    args = _torch_args(golden_problem["float32"])
    kw = dict(maxsteps=15, tol=0.0, learning_rate=1e-2, comps_precision=comps_precision)
    plain = torch_fit(*args, **kw)
    logdir = tmp_path / "prof"
    traced = torch_fit(*args, n_profile_steps=3, profile_log_dir=str(logdir), **kw)
    assert traced[4]["loss"] == plain[4]["loss"]
    for got, want in zip([traced[0], *traced[2]], [plain[0], *plain[2]]):
        assert torch.equal(got, want)
    traces = sorted(logdir.glob("trace_*.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    # the traced descent: a warm-up and n_profile_steps recorded steps, each
    # through one kernel chunk term (the gains, their products and the loss
    # kernel) of every chunk the fused kernel's gate accepts
    fused = sum(explain_fused_loss_inapplicable(c, f, d, w) is None
                for (c, _, _), f, d, w in zip(args[7], args[2], args[4], args[6]))
    assert fused > 0
    assert sum(e.get("name") == "ChunkTerm" for e in events) == 4 * fused


@pytest.mark.parametrize("optimizer, opt_kwargs", [
    ("Adam", {}), ("Nadam", {}), ("SGD", {"momentum": 0.9}),
    ("RMSprop", {"momentum": 0.5, "centered": True}), ("Adagrad", {}), ("Adadelta", {}),
    ("LAMB", {"weight_decay": 1e-3}), ("Ftrl", {"l1_regularization_strength": 1e-6}),
])
def test_optimizers_through_the_mixed_schedule(golden_problem, optimizer, opt_kwargs):
    """Each optimizer of the registry on the serial path with the mixed
    schedule: its state carried from the bf16 phase into the float32
    polish, as in the JAX package."""
    jres, tres = _run_both(golden_problem["float32"], maxsteps=12, tol=0.0,
                           learning_rate=1e-2, comps_precision="mixed",
                           model_regularization="post_hoc", optimizer=optimizer, **opt_kwargs)
    assert len(tres[4]["loss"]) == 24
    _compare(jres, tres, 1e-4)
