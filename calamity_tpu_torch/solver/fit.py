"""The descent loop: a first-order optimizer on the chunked chi-square, one slice.

Port of calamity_tpu/solver/fit.py:37-572, with the same semantics: an
unrecorded warm-up step, a per-step loss history, the |delta loss| < tol
stop (with the ``big`` sentinel so the first recorded step cannot trigger
it), optional patience gated on a finite loss, a stop on a non-finite
loss, ``use_min`` argmin tracking, ``freeze_model`` and the "sum" prior,
the float32 / bfloat16 / mixed basis-precision schedules, and the
segmented descent checkpointed under ``checkpoint_dir`` (``solver.checkpoint``),
and ``n_profile_steps``: a short descent traced by ``torch.profiler``.

The reference runs each descent as one ``lax.while_loop`` on the device.
Here the loop's carry lives on the device too (:class:`_Descent`): one step
function evaluates the reference's ``cond`` on the device, takes the step,
keeps it only where ``cond`` held (``where(live, new, old)`` on parameters,
optimizer state and step count) and writes the history, |delta loss|, the
best loss and its parameters and the steps since it; with Adamax, the
default, the update and that bookkeeping are two kernels on the card
(``ops.adamax``: one launch for every leaf, one for the carry). On CUDA
that step is captured once into a CUDA graph and replayed
(``solver.graph``); the host reads the stop test once per ``POLL_EVERY``
steps and the trajectory does not depend on that interval, since a step
after the stop changes nothing.
"""

from __future__ import annotations

import datetime
import os
import time
from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .._device import SPANS
from ..ops import adamax as adamax_ops
from ..ops.fused import warn_fused_fallbacks
from ..ops.loss import chunked_loss, chunked_loss_sum_regularized
from ..utils import echo
from .graph import POLL_EVERY, StepGraph
from .optimizers import get_optimizer, tree_leaves, tree_map


class FitConfig(NamedTuple):
    """Static configuration of one fit."""

    optimizer: str = "Adamax"
    opt_kwargs: Tuple[Tuple[str, Any], ...] = ()
    maxsteps: int = 10000
    tol: float = 1e-14
    use_min: bool = False
    freeze_model: bool = False
    regularization: Optional[str] = None
    remat: bool = False
    # stop when the loss has not reached a new minimum for this many
    # recorded steps; 0 disables
    patience: int = 0
    # time-parallel paths: evaluate each chunk's loss over blocks of this
    # many groups (None: whole chunks)
    loss_block: Optional[int] = None


def _big(np_dtype):
    return np_dtype.type(9e99 if np_dtype == np.float64 else 3e38)


def convert_chunks_dtype(chunks, dtype):
    """Chunk triples with comps cast to ``dtype`` (antenna indices
    untouched), as the span ``comps.convert``."""
    with SPANS.span("comps.convert"):
        return tuple((comps.to(dtype), a0, a1) for comps, a0, a1 in chunks)


def make_loss_fn(cfg, chunks, data_r, data_i, wgts, fg_r_const, fg_i_const,
                 prior_r_sum, prior_i_sum):
    """The fit's loss as a function of its parameter tree (``init_params``):
    the chunked chi-square, or with ``cfg.regularization == "sum"`` the
    chi-square plus the flux-scale prior."""

    def loss_fn(p):
        fr = fg_r_const if cfg.freeze_model else p["fg_r"]
        fi = fg_i_const if cfg.freeze_model else p["fg_i"]
        if cfg.regularization == "sum":
            return chunked_loss_sum_regularized(
                p["g_r"], p["g_i"], fr, fi, chunks, data_r, data_i, wgts,
                prior_r_sum, prior_i_sum,
            )
        return chunked_loss(p["g_r"], p["g_i"], fr, fi, chunks, data_r, data_i, wgts,
                            remat=cfg.remat)

    return loss_fn


def value_and_grad(loss_fn, params):
    """(loss, grads) of ``loss_fn`` at a parameter tree; both detached."""
    with torch.enable_grad():
        p = tree_map(lambda x: x.detach().requires_grad_(True), params)
        loss = loss_fn(p)
        grads = iter(torch.autograd.grad(loss, tree_leaves(p)))
    return loss.detach(), tree_map(lambda _: next(grads), p)


def _buffers(tree, device):
    """Fresh device buffers holding a tree's values (a Python-int step
    count becomes a 0-d int64 tensor), for a descent to update in place."""
    return tree_map(lambda x: x.detach().clone() if isinstance(x, torch.Tensor)
                    else torch.tensor(x, dtype=torch.int64, device=device), tree)


def _assign(dst, src):
    """Copy a tree's values into a tree of buffers of one structure."""
    tree_map(lambda d, v: d.copy_(v), dst, src)


class _Descent:
    """One slice's descent carry on the device, advanced in place by one
    step: the reference's ``_fit_segment`` ``while_loop``
    (calamity_tpu/solver/fit.py:128-207). The carry is the step and the
    segment's end, the parameters, the optimizer state, the last loss,
    |delta loss| (``big`` until a second loss), the best loss and its
    parameters, the steps since it and a history buffer of ``capacity``
    losses in the fit dtype. The step is one CUDA-graph replay on CUDA
    (``solver.graph.StepGraph``); :meth:`close` releases the graph. The carry's
    set-up is the span ``phase.entry``."""

    def __init__(self, cfg, loss_fn, opt, params, opt_state, capacity, name="serial descent",
                 verbose=False):
        with SPANS.span("phase.entry"):
            g = params["g_r"]
            dev = g.device
            self.cfg, self.loss_fn, self.opt = cfg, loss_fn, opt
            self.dtype = g.dtype
            self.np_dtype = np.dtype(_np_dtype(g))
            self.big = float(_big(self.np_dtype))
            self.params = _buffers(params, dev)
            self.opt_state = _buffers(opt_state, dev)
            self.best_params = _buffers(params, dev)

            def scalar(value, dtype):
                return torch.full((), value, dtype=dtype, device=dev)

            self.step, self.end, self.since = (scalar(0, torch.int64) for _ in range(3))
            self.prev, self.delta, self.best_loss = (scalar(self.big, g.dtype) for _ in range(3))
            self.history = torch.full((max(int(capacity), 1),), float("nan"), dtype=g.dtype,
                                      device=dev)
            self.carry = adamax_ops.SerialCarry(self.step, self.end, self.delta, self.prev,
                                                self.best_loss, self.since, self.history, cfg.tol,
                                                cfg.patience, self.big)
            self.graph = StepGraph(self._step, dev, name, verbose=verbose)

    def _live(self):
        # the reference's cond (solver/fit.py:174-179)
        return adamax_ops.serial_live(self.carry)

    def _step(self):
        """The reference's body (solver/fit.py:181-193) where ``cond``
        holds, and nothing where it does not: no host value is read. With
        Adamax the update and the bookkeeping are two kernels on the card
        (``ops.adamax``); the other optimizers update their trees and gate
        them leaf by leaf."""
        loss, grads = value_and_grad(self.loss_fn, self.params)
        loss = loss.to(self.dtype)
        if getattr(self.opt, "hyper", None) is not None:
            adamax_ops.adamax_step(self.opt, self.params, grads, self.opt_state,
                                   self.best_params, self.carry, loss)
            adamax_ops.descent_carry(self.carry, loss, self.opt_state.count)
            return
        live, is_best = adamax_ops.serial_flags(self.carry, loss)
        new_params, new_opt = self.opt.update(grads, self.opt_state, self.params)
        adamax_ops.keep(is_best, new_params, self.best_params)
        adamax_ops.keep(live, new_params, self.params)
        adamax_ops.keep(live, new_opt, self.opt_state)
        adamax_ops.serial_bookkeeping(self.carry, loss, live, is_best)

    def segment(self, seg_len, prev, best_loss, since=0):
        """Up to ``seg_len`` steps from the last loss ``prev``, the best
        loss and the steps since it (the reference's ``_fit_segment`` from
        explicit state; parameters and optimizer state are the carry's).
        The host issues the steps in blocks of ``POLL_EVERY`` (each the
        span ``descent.steps``) and reads the stop test after each
        (``descent.poll``). Returns (history as a list, steps, converged,
        prev, best_loss, since), the scalars as the fit dtype's numpy
        scalars, read back as the span ``phase.readback``."""
        if seg_len > self.history.numel():
            raise ValueError(f"a segment of {seg_len} steps in a history of "
                             f"{self.history.numel()}")
        self.step.zero_()
        self.end.fill_(int(seg_len))
        self.prev.fill_(float(prev))
        self.delta.fill_(self.big)
        self.best_loss.fill_(float(best_loss))
        self.since.fill_(int(since))
        issued = 0
        with SPANS.span("descent.poll"):
            live = bool(self._live())
        while live and issued < seg_len:
            n = min(POLL_EVERY, seg_len - issued)
            with SPANS.span("descent.steps"):
                for _ in range(n):
                    self.graph()
                issued += n
                with SPANS.span("descent.poll"):
                    live = bool(self._live())  # the host's one read of a block
        with SPANS.span("phase.readback"):
            nsteps = int(self.step)
            prev, delta, best_loss, since = torch.stack(
                [x.to(torch.float64) for x in (self.prev, self.delta, self.best_loss, self.since)]
            ).tolist()
            history = self.history[:nsteps].tolist()
        dt = self.np_dtype.type
        prev, delta, best_loss, since = dt(prev), dt(delta), dt(best_loss), int(since)
        converged = bool(delta < dt(self.cfg.tol))
        if self.cfg.patience > 0:
            # since_best also grows on a NaN/inf step, so a divergence that
            # lands on the patience boundary surfaces as a divergence
            converged = converged or (since >= self.cfg.patience and bool(np.isfinite(prev)))
        return history, nsteps, converged, prev, best_loss, since

    def close(self):
        self.graph.close()


def init_params(cfg, g_r, g_i, fg_r, fg_i):
    """The parameter tree the optimizer updates: gains, plus the per-chunk
    coefficients unless ``cfg.freeze_model``."""
    if cfg.freeze_model:
        return {"g_r": g_r, "g_i": g_i}
    return {"g_r": g_r, "g_i": g_i, "fg_r": list(fg_r), "fg_i": list(fg_i)}


def _outputs(cfg, params, fg_r, fg_i):
    if cfg.freeze_model:
        return params["g_r"], params["g_i"], tuple(fg_r), tuple(fg_i)
    return params["g_r"], params["g_i"], tuple(params["fg_r"]), tuple(params["fg_i"])


def _fit_core(cfg, loss_fn, params, opt, opt_state, verbose=False):
    """A warm-up step followed by one maxsteps segment. Returns (the
    :class:`_Descent`, whose carry holds the parameters, optimizer state
    and best parameters, prev, best_loss, history, nsteps)."""
    d = _Descent(cfg, loss_fn, opt, params, opt_state, cfg.maxsteps, verbose=verbose)
    # the warm-up step is not recorded (reference calibration.py:693)
    d.segment(1, d.big, d.big)
    _assign(d.best_params, d.params)
    history, nsteps, _, prev, best_loss, _ = d.segment(cfg.maxsteps, d.big, d.big)
    return d, prev, best_loss, history, nsteps


def _polish(cfg, loss_fn, opt, d0, verbose=False):
    """The float32 phase of the mixed schedule from the bfloat16 phase's
    descent ``d0`` (whose graph is released first): its parameters and
    Adamax state carried over, no second warm-up step. Returns as
    :func:`_fit_core`."""
    d0.close()
    d = _Descent(cfg, loss_fn, opt, d0.params, d0.opt_state, cfg.maxsteps,
                 name="serial descent (float32 phase)", verbose=verbose)
    history, nsteps, _, prev, best_loss, _ = d.segment(cfg.maxsteps, d.big, d.big)
    return d, prev, best_loss, history, nsteps


def profile_trace(log_dir, fn):
    """Run ``fn()`` under ``torch.profiler`` (host activity, and the card's
    where CUDA is present) and write the trace under ``log_dir`` as a
    Chrome trace file (``trace_<time>_<pid>.json``, readable by TensorBoard
    and Perfetto). Returns (fn's result, the trace's path)."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        out = fn()
        if cuda:
            torch.cuda.synchronize()
    path = os.path.join(log_dir, f"trace_{time.strftime('%Y%m%d_%H%M%S')}_{os.getpid()}_"
                                 f"{time.perf_counter_ns()}.json")
    prof.export_chrome_trace(path)
    return out, path


def _np_dtype(t):
    return {torch.float32: np.float32, torch.float64: np.float64}[t.dtype]


def _fit_checkpointed(cfg, loss_fn, params, opt, checkpoint_dir, checkpoint_every, resume,
                      verbose):
    """Segmented descent with a checkpoint after every segment of
    ``checkpoint_every`` steps (reference solver/fit.py:210-327). Same
    trajectory as :func:`_fit_core`, one :class:`_Descent` (one captured
    step) for every segment; a resumed run continues from the latest
    checkpoint under ``checkpoint_dir``. Returns as :func:`_fit_core`."""
    from .checkpoint import FitCheckpoint, latest_checkpoint, load_checkpoint, save_checkpoint

    seg = max(1, min(int(checkpoint_every), cfg.maxsteps))
    d = _Descent(cfg, loss_fn, opt, params, opt.init(params), seg, verbose=verbose)
    dt = d.np_dtype.type
    prev = best_loss = dt(d.big)
    history_all = np.zeros((0,), dtype=np.float64)
    step_total = 0
    ckpt_path = latest_checkpoint(checkpoint_dir)
    if resume and ckpt_path is not None:
        echo(f"{datetime.datetime.now()} Resuming from {ckpt_path}", verbose=verbose)
        like = FitCheckpoint(d.params, d.opt_state, 0, d.big, d.big, d.best_params,
                             history_all)
        ck = load_checkpoint(ckpt_path, like)
        _assign(d.params, ck.params)
        _assign(d.opt_state, ck.opt_state)
        _assign(d.best_params, ck.best_params)
        prev, best_loss = dt(ck.prev_loss), dt(ck.best_loss)
        history_all = ck.history
        step_total = ck.step
        # steps since the best loss, from the stored history (the first
        # occurrence of its minimum), so patience resumes exactly
        since = (len(history_all) - 1 - int(np.argmin(history_all))
                 if len(history_all) else 0)
    else:
        # the unrecorded warm-up step (reference calibration.py:693)
        d.segment(1, d.big, d.big)
        _assign(d.best_params, d.params)
        since = 0

    converged = False
    while step_total < cfg.maxsteps and not converged:
        seg_len = min(seg, cfg.maxsteps - step_total)
        hist, nseg, converged, prev, best_loss, since = d.segment(seg_len, prev, best_loss,
                                                                  since)
        if nseg == 0:
            # the stop condition held on entry (a resume past patience), or
            # the loss is non-finite: nothing to record or to save again
            break
        history_all = np.concatenate([history_all, np.asarray(hist, dtype=np.float64)])
        step_total += nseg
        save_checkpoint(
            os.path.join(checkpoint_dir, f"step_{step_total}"),
            FitCheckpoint(d.params, d.opt_state, step_total, float(prev), float(best_loss),
                          d.best_params, history_all),
        )
        echo(f"{datetime.datetime.now()} checkpointed at step {step_total} "
             f"(loss {float(prev):.3e})", verbose=verbose)
    return d, prev, best_loss, history_all.tolist(), step_total


def fit_gains_and_foregrounds(
    g_r,
    g_i,
    fg_r,
    fg_i,
    data_r,
    data_i,
    wgts,
    chunks,
    use_min=False,
    tol=1e-14,
    maxsteps=10000,
    optimizer="Adamax",
    freeze_model=False,
    verbose=False,
    sky_model_r=None,
    sky_model_i=None,
    model_regularization=None,
    n_profile_steps=0,
    profile_log_dir="./logdir",
    checkpoint_dir=None,
    checkpoint_every=1000,
    resume=True,
    use_pallas=False,
    remat=False,
    comps_precision="float32",
    patience=0,
    **opt_kwargs,
):
    """Run the gradient-descent fit for one (time, pol) slice.

    Reference-compatible entry point (calamity_tpu/solver/fit.py:330).
    Inputs are tensors on one device as produced by FitSpec; returns
    (g_r, g_i, fg_r, fg_i, fit_history) with fit_history = {"loss": list,
    "phase_seconds": list} (+ "phase_steps" for the mixed schedule).
    ``phase_seconds`` holds the seconds of each descent phase's span
    ``phase`` (ending with the device drained). The fit is the span ``fit``
    (``_device.SPANS``), its phases the spans ``phase``.

    comps_precision: storage precision of the basis tensors during the
    descent ("float32", "bfloat16", or "mixed": bf16 until the tol stop,
    then float32 with the Adamax state carried across). ``use_pallas`` is
    accepted for signature parity and ignored: on CUDA the fused kernel
    runs wherever its gate accepts a chunk."""
    del use_pallas
    if comps_precision not in ("float32", "bfloat16", "mixed"):
        raise ValueError(
            f"comps_precision must be 'float32', 'bfloat16' or 'mixed', "
            f"got {comps_precision!r}"
        )
    with SPANS.fit(g_r.device):
        if model_regularization == "sum":
            # the prior is an accumulated scalar: sum in the sky model's dtype
            wgts_f = [w.to(sky_model_r[0].dtype) for w in wgts]
            prior_r_sum = sum(torch.sum(smr * w) for smr, w in zip(sky_model_r, wgts_f))
            prior_i_sum = sum(torch.sum(smi * w) for smi, w in zip(sky_model_i, wgts_f))
            regularization = "sum"
        else:
            prior_r_sum = torch.zeros((), dtype=g_r.dtype, device=g_r.device)
            prior_i_sum = torch.zeros((), dtype=g_r.dtype, device=g_r.device)
            regularization = None
        warn_fused_fallbacks(chunks, fg_r, data_r, wgts)

        cfg = FitConfig(
            optimizer=optimizer,
            opt_kwargs=tuple(sorted(opt_kwargs.items())),
            maxsteps=int(maxsteps),
            tol=float(tol),
            use_min=bool(use_min),
            freeze_model=bool(freeze_model),
            regularization=regularization,
            remat=bool(remat),
            patience=int(patience),
        )
        opt = get_optimizer(cfg.optimizer, **dict(cfg.opt_kwargs))
        phases = [chunks]
        if comps_precision != "float32":
            # one bf16 copy of the chunks per fit, made outside the loop
            chunks_lo = convert_chunks_dtype(chunks, torch.bfloat16)
            phases = [chunks_lo] if comps_precision == "bfloat16" else [chunks_lo, chunks]
        echo(
            f"{datetime.datetime.now()} Starting fit ({cfg.optimizer}, "
            f"maxsteps={cfg.maxsteps}, comps_precision={comps_precision})...",
            verbose=verbose,
        )
        params = init_params(cfg, g_r, g_i, fg_r, fg_i)
        histories, seconds = [], []

        def loss_of(chs):
            return make_loss_fn(cfg, chs, data_r, data_i, wgts, fg_r, fg_i, prior_r_sum,
                                prior_i_sum)

        def phase(fn, *args):
            # one descent phase, drained at its end: its seconds are the device's
            with SPANS.span("phase") as span:
                out = fn(*args)
                SPANS.sync(g_r.device)
            seconds.append(span.seconds)
            return out

        if n_profile_steps > 0:
            # a short descent traced by the profiler before the fit (reference
            # solver/fit.py:444-458): every step runs, no stop, nothing returned
            prof_cfg = cfg._replace(maxsteps=int(n_profile_steps), tol=0.0, patience=0)
            prof_loss = loss_of(phases[0] if comps_precision == "bfloat16" else chunks)
            prof, _ = profile_trace(profile_log_dir, lambda: _fit_core(
                prof_cfg, prof_loss, params, opt, opt.init(params)))
            prof[0].close()

        if checkpoint_dir is not None:
            from .checkpoint import latest_checkpoint, load_phase_meta, save_phase_meta

            def run_checkpointed(chs, p, ckdir):
                d, prev, best_loss, hist, _ = _fit_checkpointed(
                    cfg, loss_of(chs), p, opt, ckdir, checkpoint_every, resume, verbose)
                d.close()
                return (d.best_params, best_loss, hist) if cfg.use_min else (d.params, prev, hist)

            if comps_precision == "mixed":
                # each phase is its own checkpointed descent (fresh optimizer
                # state and warm-up step, as the reference's checkpointed mixed
                # schedule), in phase subdirectories
                ck1 = os.path.join(checkpoint_dir, "phase_bf16")
                ck2 = os.path.join(checkpoint_dir, "phase_f32")
                if resume and latest_checkpoint(ck2) is not None:
                    # phase 2 under way: restore phase 1's recorded diagnostics
                    meta = load_phase_meta(checkpoint_dir)
                    hist1 = [] if meta is None else meta["history"].tolist()
                    p1 = params
                    seconds.append(0.0)
                else:
                    p1, _, hist1 = phase(run_checkpointed, phases[0], params, ck1)
                    save_phase_meta(checkpoint_dir, nsteps=len(hist1),
                                    history=np.asarray(hist1, dtype=np.float64))
                out_params, final_loss, hist2 = phase(run_checkpointed, phases[1], p1, ck2)
                histories = [hist1, hist2]
            else:
                out_params, final_loss, hist = phase(run_checkpointed, phases[0], params,
                                                     checkpoint_dir)
                histories = [hist]
        else:
            for pnum, chs in enumerate(phases):
                if pnum == 0:
                    d, prev, best_loss, hist, n = phase(_fit_core, cfg, loss_of(chs), params, opt,
                                                        opt.init(params), verbose)
                else:
                    # float32 polish of the mixed schedule: Adamax state carried
                    # over from the bf16 phase, no second warm-up step
                    d, prev, best_loss, hist, n = phase(_polish, cfg, loss_of(chs), opt, d, verbose)
                histories.append(hist)
                if pnum == 0 and len(phases) > 1:
                    echo(
                        f"{datetime.datetime.now()} bf16 phase converged after {n} "
                        f"steps; polishing in float32...",
                        verbose=verbose,
                    )
            d.close()
            out_params = d.best_params if cfg.use_min else d.params
            final_loss = best_loss if cfg.use_min else prev
        g_r_o, g_i_o, fg_r_o, fg_i_o = _outputs(cfg, out_params, fg_r, fg_i)
        history = [x for h in histories for x in h]
        fit_history = {"loss": history, "phase_seconds": seconds}
        if comps_precision == "mixed":
            fit_history["phase_steps"] = [len(h) for h in histories]
        echo(
            f"{datetime.datetime.now()} Finished gradient descent: "
            f"{len(history)} steps, final loss {float(final_loss):.2e}",
            verbose=verbose,
        )
    return g_r_o, g_i_o, fg_r_o, fg_i_o, fit_history
