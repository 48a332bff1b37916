"""Batched multi-(time, pol) fitting, on one device or on a device mesh.

Port of calamity_tpu/parallel/batched.py. Fits of different (time, pol)
slices are independent, so the time-parallel path stacks them on a leading
slice axis and runs one descent for the whole batch:

    g_r/g_i             : (nbatch, nants, nfreqs)
    fg_r/fg_i per chunk : (nbatch, ngrps, nvecs)
    data/wgts per chunk : (nbatch, ngrps, nbls, nfreqs)  (wgts may be
                          (..., 1): a frequency-invariant weights plane)

The loss is the sum over the batch of independent per-slice chi-squares,
so the summed gradient updates every slice as its own descent would
(Adam-family updates are elementwise). Convergence is tracked per slice: a
slice whose |delta loss| drops below tol, whose loss goes non-finite or
that runs out of patience is frozen (its parameters and optimizer moments
stop moving) while the others keep stepping; the optimizer's scalar step
count advances while any slice runs. The loss is ``ops.loss``'s
(:func:`batched_chunk_losses`, under the "sum" prior
:func:`batched_chunk_losses_sum_regularized`), each chunk on the route
``ops.loss.chunk_route`` chose for it.

The reference's jit-compiled ``while_loop`` keeps its carry on the device,
and so does :class:`_BatchedDescent`: one step function updates the
parameters, the optimizer state, the freeze mask and the per-slice
bookkeeping in place and writes a (steps, nbatch) history, a step taken
after the last slice froze (or past the segment) changing nothing, the
optimizer's step count included; with Adamax, the default, the update
and that bookkeeping are two kernels on the card (``ops.adamax``). On CUDA
the step is captured once into a CUDA graph and replayed
(``solver.graph``); the host reads the freeze mask once per
``poll_every`` steps, and the trajectory does not depend on that interval.
Under a mesh the same step runs eagerly (gloo's collectives cannot be
captured), the kernels taking the ranks' live flag.

Under a ('data', 'bl') mesh (``parallel.mesh``; one process per device)
each rank runs these functions on its blocks, with a ``MeshShard``
(``shard=``) that sums the per-slice losses and the gain gradients over
'bl', forms the "sum" prior from the whole flux sums, and makes the stop
global: a step is live while any slice of the batch runs, so every rank
takes the same steps. The step-0 guard sums its host partials the same way.

Left out on purpose: the reference's AOT auto-layout segment executables
(``BatchedSegmentPlan``, ``make_segment_plan``, ``_put_format``,
``_apply_required_layouts``, the plan cache, ``auto_layouts_enabled``) and
the layout self-heal (``:769-1085``). They exist to control XLA's entry
layouts on TPUs reached through a relay; PyTorch on one card has no such
layouts to plan. The step-0 loss guard does not depend on them and is
ported, armed on every fresh descent and on every resume.
"""

from __future__ import annotations

import datetime
import os
import sys
from functools import partial, wraps
from typing import Any, NamedTuple

import numpy as np
import torch

from .._device import SPANS
from ..ops import adamax as adamax_ops
from ..ops.loss import (
    _chunk_terms,
    batched_chunk_losses,
    batched_chunk_losses_sum_regularized,
    fg_model_host,
)
from ..solver.fit import _big, _buffers, _np_dtype, init_params
from ..solver.graph import StepGraph
from ..solver.optimizers import get_optimizer, tree_leaves, tree_map
from ..utils import echo, host_map


# ---------------------------------------------------------------------- #
# the batched descent
# ---------------------------------------------------------------------- #
class BatchedFitResult(NamedTuple):
    g_r: Any
    g_i: Any
    fg_r: Any
    fg_i: Any
    loss_history: Any  # (max(maxsteps, recorded), nbatch) float32 numpy, NaN-padded
    nsteps: Any  # recorded steps of the whole batch
    final_loss: Any  # (nbatch,)
    nsteps_slice: Any = None  # (nbatch,) numpy: per-slice steps until its freeze
    opt_state: Any = None  # final optimizer state (carried by the mixed schedule)


def _optimizer(cfg, shard):
    return get_optimizer(cfg.optimizer, **dict(cfg.opt_kwargs),
                         **({} if shard is None else {"norm_psum": shard.lamb_norm_psum}))


def _batched_step_fn(cfg, chunks, data_r, data_i, wgts, fg_r, fg_i, prior_r, prior_i,
                     shard=None):
    """(opt, one_step): ``one_step(params, opt_state) -> (losses, params,
    opt_state)`` over the batch, with the summed loss's gradient.

    Under a mesh (``shard``, a ``parallel.mesh.MeshShard``) the tensors are
    this rank's blocks: the per-slice losses are summed over 'bl' before
    anything reads them, and so are the gain gradients, so every 'bl' rank
    applies the same update to its replicated gains; coefficient gradients
    stay local. The "sum" prior is a function of the whole flux sums: it is
    formed from their 'bl' sum, and each rank differentiates its own sums
    against the prior's (constant) derivative there, which gives every
    coefficient its gradient once and the gains theirs once after the sum."""
    opt = _optimizer(cfg, shard)

    def losses_fn(p):
        fr = fg_r if cfg.freeze_model else p["fg_r"]
        fi = fg_i if cfg.freeze_model else p["fg_i"]
        if cfg.regularization == "sum":
            if shard is not None:
                return _sum_terms_sharded(p, fr, fi)
            return batched_chunk_losses_sum_regularized(
                p["g_r"], p["g_i"], fr, fi, chunks, data_r, data_i, wgts, prior_r, prior_i,
                loss_block=cfg.loss_block)
        return batched_chunk_losses(p["g_r"], p["g_i"], fr, fi, chunks, data_r, data_i,
                                    wgts, remat=cfg.remat, loss_block=cfg.loss_block)

    def _sum_terms_sharded(p, fr, fi):
        total, mr_sum, mi_sum = _chunk_terms(True, p["g_r"], p["g_i"], fr, fi, chunks, data_r,
                                             data_i, wgts, loss_block=cfg.loss_block)
        whole = shard.sum_bl(torch.stack([total, mr_sum, mi_sum]))
        dr, di = whole[1] - prior_r, whole[2] - prior_i
        losses = whole[0] + torch.square(dr) + torch.square(di)
        objective = torch.sum(total + 2 * dr * mr_sum + 2 * di * mi_sum)
        return losses, objective

    def losses_and_grads(params):
        with torch.enable_grad():
            p = tree_map(lambda x: x.detach().requires_grad_(True), params)
            out = losses_fn(p)
            # the "sum" prior's losses are whole already; the chi-square's
            # travel with the gain gradients, in one all-reduce
            losses, objective = out if isinstance(out, tuple) else (out, torch.sum(out))
            grads = iter(torch.autograd.grad(objective, tree_leaves(p)))
        grads = tree_map(lambda _: next(grads), p)
        losses = losses.detach()
        if shard is not None:
            g_r, g_i = grads["g_r"], grads["g_i"]
            parts = [g_r, g_i] if isinstance(out, tuple) else [g_r, g_i, losses]
            whole = shard.sum_bl(torch.cat([x.reshape(-1).to(g_r.dtype) for x in parts]))
            g_r, g_i, rest = whole.split([g_r.numel(), g_i.numel(), whole.numel()
                                          - g_r.numel() - g_i.numel()])
            grads = dict(grads, g_r=g_r.view_as(grads["g_r"]), g_i=g_i.view_as(grads["g_i"]))
            if not isinstance(out, tuple):
                losses = rest.to(losses.dtype)
        return losses, grads

    return opt, _BatchedStep(opt, losses_and_grads)


class _BatchedStep(NamedTuple):
    """One batched step's function: ``one_step(params, opt_state) ->
    (losses, params, opt_state)``, the optimizer's update of the summed
    loss's gradient; ``losses_and_grads(params) -> (losses, grads)`` alone,
    for a descent that updates in place (``ops.adamax``)."""

    opt: Any
    losses_and_grads: Any

    def __call__(self, params, opt_state):
        losses, grads = self.losses_and_grads(params)
        new_params, opt_state = self.opt.update(grads, opt_state, params)
        return losses, new_params, opt_state


class _Carry(NamedTuple):
    """Per-slice bookkeeping carried between steps and segments."""

    prev: Any  # (nbatch,) last recorded loss
    frozen: Any  # (nbatch,) bool
    nsteps_slice: Any  # (nbatch,) int64: global step of the freeze, maxsteps if none
    best_loss: Any  # (nbatch,) or None (tracked for use_min or patience)
    best_params: Any  # params tree or None (use_min)
    since_best: Any  # (nbatch,) int64 or None (patience)


def _fresh_carry(cfg, nbatch, dtype, device, best_params, shard=None):
    """The bookkeeping of a fresh descent. Under a mesh the dummy rows that
    pad the batch to the 'data' axis are frozen from the start."""
    big = float(_big(np.dtype(dtype)))
    tdt = torch.float64 if np.dtype(dtype) == np.float64 else torch.float32
    full = torch.full((nbatch,), big, dtype=tdt, device=device)
    frozen = torch.zeros((nbatch,), dtype=torch.bool, device=device)
    nsteps_slice = torch.full((nbatch,), cfg.maxsteps, dtype=torch.int64, device=device)
    valid = None if shard is None else shard.valid_rows()
    if valid is not None:
        frozen = ~valid
        nsteps_slice = torch.where(valid, nsteps_slice, 0)
    return _Carry(
        prev=full.clone(),
        frozen=frozen,
        nsteps_slice=nsteps_slice,
        best_loss=full.clone() if (cfg.use_min or cfg.patience > 0) else None,
        best_params=best_params if cfg.use_min else None,
        since_best=(torch.zeros((nbatch,), dtype=torch.int64, device=device)
                    if cfg.patience > 0 else None),
    )


def _all_frozen(frozen, shard):
    return bool(frozen.all()) if shard is None else shard.all_frozen(frozen)


class _BatchedDescent:
    """The batched descent's carry on the device, advanced in place by one
    step: the reference's ``_batched_segment_impl`` ``while_loop``
    (parallel/batched.py:443-559). The carry is the parameters, the
    optimizer state, the :class:`_Carry` bookkeeping, the segment's
    counters (live steps taken, their limit, the unrecorded warm-up steps
    at its start, the global recorded steps before it) and a (``capacity``,
    nbatch) float32 history. A step is live while it is within the segment
    and some slice runs (under a mesh: some slice of the whole batch, so
    every rank takes the same steps); a slice's parameters and moments move
    only while it runs, the step count only on a live step. On CUDA the
    step is one CUDA-graph replay (``solver.graph.StepGraph``), eager under
    a mesh; :meth:`close` releases the graph. The carry's set-up is the
    span ``phase.entry``."""

    def __init__(self, cfg, one_step, params, opt_state, carry, capacity, shard=None,
                 name="batched descent", verbose=False):
        with SPANS.span("phase.entry"):
            dev = carry.prev.device
            self.cfg, self.one_step, self.shard = cfg, one_step, shard
            self.params = _buffers(params, dev)
            self.opt_state = _buffers(opt_state, dev)
            self.prev, self.frozen, self.nsteps_slice = (
                x.clone() for x in (carry.prev, carry.frozen, carry.nsteps_slice))
            self.best_loss = None if carry.best_loss is None else carry.best_loss.clone()
            self.best_params = None if carry.best_params is None else _buffers(carry.best_params,
                                                                                dev)
            self.since = None if carry.since_best is None else carry.since_best.clone()
            self.it, self.total, self.warmup, self.step0 = (
                torch.zeros((), dtype=torch.int64, device=dev) for _ in range(4))
            self.history = torch.full((max(int(capacity), 1), self.prev.shape[0]), float("nan"),
                                      dtype=torch.float32, device=dev)
            self.gate = adamax_ops.BatchedCarry(
                self.it, self.total, self.warmup, self.step0, self.frozen, self.prev,
                self.best_loss, self.since, self.nsteps_slice, self.history, cfg.tol,
                cfg.patience)
            self.graph = StepGraph(self._step, dev, name, capture=shard is None, verbose=verbose)

    def carry(self):
        return _Carry(self.prev, self.frozen, self.nsteps_slice, self.best_loss,
                      self.best_params, self.since)

    def _step(self):
        """The reference's body (parallel/batched.py:505-552) for the slices
        that run, and nothing for the others. With Adamax the update and
        the bookkeeping are two kernels on the card (``ops.adamax``); the
        other optimizers update their trees and gate them leaf by leaf."""
        gate = self.gate
        if self.shard is not None:
            # the ranks' flag: every rank takes the same steps
            gate = gate._replace(live=self.shard.any_rows(adamax_ops.batched_live(gate)))
        opt = getattr(self.one_step, "opt", None)
        if getattr(opt, "hyper", None) is not None:
            losses, grads = self.one_step.losses_and_grads(self.params)
            adamax_ops.adamax_step(opt, self.params, grads, self.opt_state, self.best_params,
                                   gate, losses)
            adamax_ops.descent_carry(gate, losses, self.opt_state.count)
            return
        losses, new_params, new_opt = self.one_step(self.params, self.opt_state)
        flags = adamax_ops.batched_flags(gate, losses)
        live, active, _, _, is_best = flags
        adamax_ops.keep_rows(active, new_params, self.params)
        adamax_ops.keep_rows(active, new_opt, self.opt_state, live)
        if self.best_params is not None:
            adamax_ops.keep_rows(is_best, self.params, self.best_params)
        adamax_ops.batched_bookkeeping(gate, losses, *flags)

    def segment(self, step0, seg_len, warmup=0, poll_every=1):
        """Up to ``seg_len`` recorded steps after ``warmup`` unrecorded
        ones, ``step0`` global recorded steps already taken (so a resumed
        segment records global step numbers). The host issues the steps in
        blocks of ``poll_every`` and reads the freeze mask after each; the
        segment ends when every slice is frozen. A block is the span
        ``descent.steps``, its read ``descent.poll``. Returns (history
        (recorded, nbatch) float32 numpy of this rank's rows, recorded), read
        back as the span ``phase.readback``."""
        nbatch = self.prev.shape[0]
        total = seg_len + warmup
        if total <= 0:
            return np.zeros((0, nbatch), np.float32), 0
        with SPANS.span("descent.poll"):
            done = _all_frozen(self.frozen, self.shard)
        if done:
            return np.zeros((0, nbatch), np.float32), 0
        if seg_len > self.history.shape[0]:
            raise ValueError(f"a segment of {seg_len} steps in a history of "
                             f"{self.history.shape[0]}")
        self.it.zero_()
        self.total.fill_(total)
        self.warmup.fill_(warmup)
        self.step0.fill_(step0)
        self.history.fill_(float("nan"))
        issued = 0
        while issued < total:
            n = min(poll_every, total - issued)
            with SPANS.span("descent.steps"):
                for _ in range(n):
                    self.graph()
                issued += n
                with SPANS.span("descent.poll"):  # the host's one read of a block
                    done = _all_frozen(self.frozen, self.shard)
            if done:
                break
        with SPANS.span("phase.readback"):
            recorded = max(int(self.it) - warmup, 0)
            return self.history[:recorded].cpu().numpy(), recorded

    def close(self):
        self.graph.close()


def _batched_segment(cfg, one_step, params, opt_state, carry, step0, seg_len, warmup=0,
                     poll_every=1, shard=None):
    """Up to ``seg_len`` recorded steps (after ``warmup`` unrecorded ones)
    of the batched descent from explicit state (reference
    ``_batched_segment_impl``, parallel/batched.py:443-559), through a
    :class:`_BatchedDescent` of its own. Returns (params, opt_state, carry,
    history (recorded, nbatch) float32 numpy of this rank's rows,
    recorded)."""
    d = _BatchedDescent(cfg, one_step, params, opt_state, carry, seg_len, shard)
    history, recorded = d.segment(step0, seg_len, warmup, poll_every)
    d.close()
    return d.params, d.opt_state, d.carry(), history, recorded


def batched_fit_segment(cfg, chunks, data_r, data_i, wgts, fg_r_const, fg_i_const,
                        prior_r, prior_i, params, opt_state, carry, step0, seg_len,
                        warmup=0, poll_every=1, shard=None):
    """A checkpointable batched descent segment: carried state in and out,
    so the host can persist it between segments (the batched counterpart
    of ``solver.fit._Descent.segment``; reference parallel/batched.py:578-606).
    ``fg_r_const``/``fg_i_const`` are read only under ``cfg.freeze_model``."""
    _, one_step = _batched_step_fn(cfg, chunks, data_r, data_i, wgts, fg_r_const,
                                   fg_i_const, prior_r, prior_i, shard)
    return _batched_segment(cfg, one_step, params, opt_state, carry, step0, seg_len,
                            warmup=warmup, poll_every=poll_every, shard=shard)


def _result(cfg, params, carry, history, recorded, opt_state, fg_r, fg_i, shard=None):
    """The result; under a mesh ``history`` is the whole batch's, and so are
    the per-slice steps and final losses, while the parameters and the
    optimizer state are this rank's blocks."""
    nsteps_slice, final = carry.nsteps_slice, carry.best_loss if cfg.use_min else carry.prev
    with SPANS.span("phase.readback"):
        if shard is not None:
            nsteps_slice, final = shard.gather_rows(nsteps_slice), shard.gather_rows(final)
        nsteps_slice = np.minimum(nsteps_slice.cpu().numpy(), recorded)
    out = carry.best_params if cfg.use_min else params
    if cfg.freeze_model:
        fr, fi = tuple(fg_r), tuple(fg_i)
    else:
        fr, fi = tuple(out["fg_r"]), tuple(out["fg_i"])
    nbatch = history.shape[1]
    full = np.full((max(cfg.maxsteps, len(history)), nbatch), np.nan, dtype=np.float32)
    full[: len(history)] = history
    return BatchedFitResult(out["g_r"], out["g_i"], fr, fi, full, len(history), final,
                            nsteps_slice, opt_state)


def _one_phase(entry):
    """A batched entry point as one phase of a fit: the spans ``fit`` and
    ``phase`` around it, each joining one its caller has open (the
    calibration's phases of one fit)."""
    @wraps(entry)
    def run(cfg, chunks, data_r, data_i, wgts, g_r, *args, **kwargs):
        with SPANS.fit(g_r.device), SPANS.span("phase", join=True):
            return entry(cfg, chunks, data_r, data_i, wgts, g_r, *args, **kwargs)

    return run


@_one_phase
def batched_fit_core(cfg, chunks, data_r, data_i, wgts, g_r, g_i, fg_r, fg_i,
                     prior_r=None, prior_i=None, opt_state0=None, poll_every=1, shard=None):
    """Whole-batch descent: an unrecorded warm-up step, then up to
    ``cfg.maxsteps`` recorded steps with per-slice freeze (reference
    parallel/batched.py:1453-1501). ``opt_state0`` carries an optimizer
    state in (the float32 polish of the mixed schedule). Under a mesh
    (``shard``) the inputs are this rank's blocks (``parallel.mesh``)."""
    with SPANS.span("phase.entry"):
        opt, one_step = _batched_step_fn(cfg, chunks, data_r, data_i, wgts, fg_r, fg_i,
                                         prior_r, prior_i, shard)
        params = init_params(cfg, g_r, g_i, fg_r, fg_i)
        opt_state = opt.init(params) if opt_state0 is None else opt_state0
        _, params, opt_state = one_step(params, opt_state)  # the warm-up step
        carry = _fresh_carry(cfg, g_r.shape[0], _np_dtype(g_r), g_r.device, params, shard)
    params, opt_state, carry, history, recorded = _batched_segment(
        cfg, one_step, params, opt_state, carry, 0, cfg.maxsteps, poll_every=poll_every,
        shard=shard)
    if shard is not None:
        history = shard.gather_rows_host(history, axis=1)
    return _result(cfg, params, carry, history, recorded, opt_state, fg_r, fg_i, shard)


# ---------------------------------------------------------------------- #
# the step-0 loss guard
# ---------------------------------------------------------------------- #
def loss_guard_factor():
    """Tolerance factor of the step-0 loss cross-check, or None when the
    guard is off (``CALAMITY_LOSS_GUARD=off``); default 4
    (``CALAMITY_LOSS_GUARD_FACTOR``). The two evaluations are at the same
    parameters; the factor absorbs the bfloat16 basis quantization of the
    device loss. Corrupted data moves the loss by orders of magnitude."""
    if os.environ.get("CALAMITY_LOSS_GUARD", "on").lower() in ("off", "0", "false", "no"):
        return None
    return float(os.environ.get("CALAMITY_LOSS_GUARD_FACTOR", "4.0"))


def loss_guard_floor():
    """Absolute floor (rms-normalized chi-square units) below which the
    guard never aborts (``CALAMITY_LOSS_GUARD_FLOOR``, default 1e-4): a
    near-perfect warm start sits at rounding noise, where one warm-up step
    legitimately raises the loss by orders of magnitude."""
    return float(os.environ.get("CALAMITY_LOSS_GUARD_FLOOR", "1e-4"))


def host_batched_losses(g_r, g_i, fg_r, fg_i, host_chunks, data_r, data_i, wgts,
                        prior_r=None, prior_i=None, regularization=None, reduce=None):
    """numpy float64 mirror of :func:`batched_chunk_losses` (reference
    parallel/batched.py:665-706): the guard's independent value, computed
    from the host stacks without the device, the kernel or the plain torch
    loss. ``host_chunks``: (comps, a0, a1) numpy triples. All arrays carry
    the slice axis; returns (nbatch,) float64.

    ``reduce``: under a mesh, where the arrays are a rank's blocks of the
    groups, a function that sums the (3, nbatch) partial terms (the
    chi-square and the model flux sums, additive over groups) over the 'bl'
    ranks before the prior is formed."""
    terms = _host_terms(g_r, g_i, fg_r, fg_i, host_chunks, data_r, data_i, wgts,
                        regularization)
    total, mr_sum, mi_sum = terms if reduce is None else reduce(terms)
    if regularization == "sum":
        total = total + (np.square(mr_sum - np.asarray(prior_r, dtype=np.float64))
                         + np.square(mi_sum - np.asarray(prior_i, dtype=np.float64)))
    return total


_HOST_BLOCK = 2048  # groups a float64 block of the host terms


def _host_terms(g_r, g_i, fg_r, fg_i, host_chunks, data_r, data_i, wgts, regularization):
    """(3, nbatch) float64: each slice's chi-square and model flux sums.
    Each (chunk, slice) is one task of ``utils.host_map``, its float64
    arithmetic taken over blocks of :data:`_HOST_BLOCK` groups; the tasks'
    sums are added in a fixed order, so the value does not depend on the
    threads."""
    g_r = np.asarray(g_r, dtype=np.float64)
    g_i = np.asarray(g_i, dtype=np.float64)
    nbatch = g_r.shape[0]
    with_sums = regularization == "sum"

    def task(cnum, b):
        comps, a0, a1 = host_chunks[cnum]
        a0 = np.asarray(a0)
        a1 = np.asarray(a1)
        vr_c, vi_c = fg_model_host(fg_r[cnum][b], fg_i[cnum][b], comps)
        gr, gi = g_r[b], g_i[b]
        out = np.zeros((3,), dtype=np.float64)
        for g0 in range(0, a0.shape[0], _HOST_BLOCK):
            sl = slice(g0, g0 + _HOST_BLOCK)
            r0, r1 = a0[sl], a1[sl]
            vr, vi = vr_c[sl], vi_c[sl]
            pr = gr[r0] * gr[r1] + gi[r0] * gi[r1]
            pi = gr[r0] * gi[r1] - gi[r0] * gr[r1]
            mr = pr * vr + pi * vi
            mi = -pi * vr + pr * vi
            dr = np.asarray(data_r[cnum][b][sl], dtype=np.float64)
            di = np.asarray(data_i[cnum][b][sl], dtype=np.float64)
            w = np.asarray(wgts[cnum][b][sl], dtype=np.float64)
            out[0] += np.sum(w * (np.square(dr - mr) + np.square(di - mi)))
            if with_sums:
                out[1] += np.sum(mr * w)
                out[2] += np.sum(mi * w)
        return out

    keys = [(c, b) for c in range(len(host_chunks)) for b in range(nbatch)]
    terms = np.zeros((3, nbatch), dtype=np.float64)
    for (_, b), part in zip(keys, host_map(lambda k: task(*k), keys)):
        terms[:, b] += part
    return terms


def check_initial_loss(recorded0, expected0, factor, context=""):
    """Raise when the first recorded per-slice loss exceeds ``factor`` x
    the independently computed loss (and the absolute floor); warn when it
    is below it by the same factor (reference parallel/batched.py:723-766).
    Slices with a zero or non-finite expected loss, or a non-finite
    recorded one (frozen slices record nothing), are skipped."""
    recorded0 = np.asarray(recorded0, dtype=np.float64)
    expected0 = np.asarray(expected0, dtype=np.float64)
    valid = np.isfinite(expected0) & (expected0 > 0) & np.isfinite(recorded0)
    if not valid.any():
        return
    ratio = np.where(valid, recorded0 / np.where(valid, expected0, 1.0), 1.0)
    ratio = np.where(recorded0 > loss_guard_floor(), ratio, 1.0)
    if (ratio > factor).any():
        bad = int(np.argmax(ratio))
        raise RuntimeError(
            f"step-0 loss cross-check failed{context}: slice {bad} first recorded loss "
            f"{recorded0[bad]:.6e} is {ratio[bad]:.1f}x the independently computed loss "
            f"{expected0[bad]:.6e} (tolerance factor {factor:g}). A data or weight cube "
            "on the device does not hold what the host packed; the descent would fit "
            "corrupted data. Set CALAMITY_LOSS_GUARD=off to bypass, "
            "CALAMITY_LOSS_GUARD_FACTOR to widen."
        )
    if (valid & (ratio < 1.0 / factor)).any():
        bad = int(np.argmin(np.where(valid, ratio, 1.0)))
        print(
            f"calamity_tpu_torch: step-0 loss cross-check{context}: slice {bad} first "
            f"recorded loss {recorded0[bad]:.6e} is {1.0 / max(ratio[bad], 1e-300):.1f}x "
            f"below the expected {expected0[bad]:.6e}; plausible for a fast-converging "
            "warm-up step, but verify the run's convergence.",
            file=sys.stderr, flush=True,
        )


# ---------------------------------------------------------------------- #
# segmented, checkpointed descent
# ---------------------------------------------------------------------- #
def _saved_tree(cfg, params, opt_state, carry):
    """The checkpoint's tree: its structure depends on use_min only (the
    patience state is rebuilt from the stored history on resume)."""
    return {
        "params": params,
        "opt_state": opt_state,
        "best_params": carry.best_params if cfg.use_min else (),
        "prev": carry.prev,
        "frozen": carry.frozen,
        "nsteps_slice": carry.nsteps_slice,
        "best_loss": carry.best_loss if cfg.use_min else (),
    }


def _whole_saved(tree, shard, local=False):
    """A :func:`_saved_tree` gathered whole from this rank's blocks (the
    format an unsharded run of the padded batch writes), or with
    ``local``, this rank's blocks of a whole one."""
    if shard is None:
        return tree
    params_fn = shard.local_params if local else shard.gather_params
    rows_fn = shard.local_rows if local else shard.gather_rows
    out = {k: params_fn(tree[k]) for k in ("params", "opt_state", "best_params")}
    for k in ("prev", "frozen", "nsteps_slice", "best_loss"):
        out[k] = rows_fn(tree[k]) if isinstance(tree[k], torch.Tensor) else tree[k]
    return out


@_one_phase
def batched_fit_checkpointed(cfg, chunks, data_r, data_i, wgts, g_r, g_i, fg_r, fg_i,
                             prior_r, prior_i, checkpoint_dir, checkpoint_every, resume,
                             verbose, opt_state0=None, steps_per_execution=None,
                             expected_loss_fn=None, tail_save=True, poll_every=1,
                             shard=None):
    """Segmented batched descent with the carried state persisted under
    ``checkpoint_dir`` every ``checkpoint_every`` steps (reference
    parallel/batched.py:1087-1450, without the segment plans).

    Same trajectory as :func:`batched_fit_core` however it is cut: the
    warm-up step runs inside the first segment, and
    ``steps_per_execution`` bounds the steps of one segment call without
    changing the save cadence. A resumed run restores params, optimizer
    state and the per-slice bookkeeping from the latest checkpoint and
    reproduces the uninterrupted trajectory bit for bit. A checkpoint saved
    with the other ``use_min`` setting is adapted; patience state is
    rebuilt from the stored history; ``tail_save`` persists a partial final
    segment. ``checkpoint_dir=None`` runs the same segmented descent
    without persistence.

    ``expected_loss_fn(params) -> (nbatch,)``: the step-0 guard's
    independent loss (e.g. :func:`host_batched_losses` on the host
    stacks), taken at the parameters the first recorded step of this run
    evaluates: after the warm-up step of a fresh run, at the restored
    parameters of a resumed one. The first recorded loss is checked
    against it (:func:`check_initial_loss`).

    Under a mesh (``shard``) the inputs are this rank's blocks and
    ``expected_loss_fn`` returns the whole batch's losses. Rank 0 writes
    each checkpoint, gathered whole (the padded batch, in the unsharded
    format), and every rank waits for it; a resume restores each rank's
    blocks from it.

    Unlike the reference, ``use_min`` tracking starts from the entry
    parameters: a slice that never records a finite loss, or a fit with
    maxsteps=0, returns its entry parameters, not zeros."""
    from ..solver.checkpoint import latest_checkpoint, load_state, save_state
    from .mesh import is_writer

    opt = _optimizer(cfg, shard)
    dtype = _np_dtype(g_r)
    nbatch = g_r.shape[0]
    nbatch_all = shard.nbatch if shard is not None and shard.shards_rows else nbatch
    big = float(_big(np.dtype(dtype)))
    params = init_params(cfg, g_r, g_i, fg_r, fg_i)
    opt_state = opt.init(params) if opt_state0 is None else opt_state0
    carry = _fresh_carry(cfg, nbatch, dtype, g_r.device, params, shard)
    _, one_step = _batched_step_fn(cfg, chunks, data_r, data_i, wgts, fg_r, fg_i, prior_r,
                                   prior_i, shard)
    ckpt_path = latest_checkpoint(checkpoint_dir) if checkpoint_dir is not None else None
    resuming = bool(resume) and ckpt_path is not None
    history_all = np.zeros((0, nbatch_all), dtype=np.float32)
    step_total = 0
    warmup_pending = not resuming
    if resuming:
        echo(f"{datetime.datetime.now()} Resuming batched fit from {ckpt_path}",
             verbose=verbose)
        like = _whole_saved(_saved_tree(cfg, params, opt_state, carry), shard)
        stored_use_min = cfg.use_min
        try:
            tree, scal = load_state(ckpt_path, like, ("step", "history"))
        except ValueError as direct_err:
            # saved with the other use_min setting: retry with its structure
            # and adapt below; a checkpoint matching neither raises the
            # direct attempt's error
            stored_use_min = not cfg.use_min
            full = torch.full((nbatch_all,), big, dtype=carry.prev.dtype, device=g_r.device)
            like = dict(like, best_params=like["params"] if stored_use_min else (),
                        best_loss=full if stored_use_min else ())
            try:
                tree, scal = load_state(ckpt_path, like, ("step", "history"))
            except ValueError as flip_err:
                raise direct_err from flip_err
        tree = _whole_saved(tree, shard, local=True)
        params, opt_state = tree["params"], tree["opt_state"]
        frozen = tree["frozen"]
        # the not-frozen sentinel is the saving run's maxsteps: re-sentinel
        # unfrozen slices for this run's budget
        nsteps_slice = torch.where(frozen, tree["nsteps_slice"], cfg.maxsteps)
        best_params = carry.best_params
        best_loss = carry.best_loss
        if cfg.use_min:
            # saved without argmin tracking: restart it at the resume point
            best_params = tree["best_params"] if stored_use_min else params
            if stored_use_min:
                best_loss = tree["best_loss"]
        history_all = np.asarray(scal["history"], dtype=np.float32).reshape(-1, nbatch_all)
        step_total = int(scal["step"])
        since = carry.since_best
        if cfg.patience > 0 and history_all.shape[0]:
            # a slice's last strict improvement is the first occurrence of
            # its column minimum; unfrozen slices record every step
            h = np.where(np.isfinite(history_all), history_all, np.inf)
            if shard is not None:
                h = h[:, shard.rows(nbatch_all)]
            first_min = np.argmin(h, axis=0)
            col_min = h[first_min, np.arange(nbatch)]
            improved = np.isfinite(col_min)
            since = torch.as_tensor(np.where(improved, h.shape[0] - 1 - first_min, 0),
                                    dtype=torch.int64, device=g_r.device)
            if not cfg.use_min:
                best_loss = torch.as_tensor(np.where(improved, col_min, big),
                                            dtype=carry.prev.dtype, device=g_r.device)
        carry = _Carry(tree["prev"], frozen, nsteps_slice, best_loss, best_params, since)

    seg = max(1, min(int(checkpoint_every), cfg.maxsteps))
    cap = seg if steps_per_execution is None else max(1, min(int(steps_per_execution), seg))
    # one carry on the device (one captured step) for every segment
    d = _BatchedDescent(cfg, one_step, params, opt_state, carry, cap, shard, verbose=verbose)

    def segment(*args, **kwargs):
        hist, recorded = d.segment(*args, **kwargs)
        return hist if shard is None else shard.gather_rows_host(hist, axis=1), recorded

    guard = None
    factor = loss_guard_factor()
    if expected_loss_fn is not None and factor is not None and cfg.maxsteps > 0:
        if warmup_pending:
            # the warm-up step alone first (the trajectory does not depend
            # on how the steps are cut), so the independent value is taken
            # at the parameters the first recorded step evaluates
            segment(0, 0, warmup=1)
            warmup_pending = False
        guard = np.asarray(expected_loss_fn(d.params), dtype=np.float64)

    since_save = 0

    def save(step_total):
        whole = _whole_saved(_saved_tree(cfg, d.params, d.opt_state, d.carry()), shard)
        if is_writer():
            save_state(os.path.join(checkpoint_dir, f"step_{step_total}"), whole,
                       {"step": step_total, "history": history_all})
        if shard is not None:
            shard.barrier()
        echo(f"{datetime.datetime.now()} checkpointed batched fit at step {step_total} "
             f"({int(d.frozen.sum())}/{nbatch} slices frozen)", verbose=verbose)

    while step_total < cfg.maxsteps and not _all_frozen(d.frozen, shard):
        seg_len = min(cap, seg - since_save, cfg.maxsteps - step_total)
        if warmup_pending and steps_per_execution is not None:
            # the warm-up is a real step: keep the per-call bound honest
            seg_len = max(0, seg_len - 1)
        hist, nseg = segment(step_total, seg_len, warmup=1 if warmup_pending else 0,
                             poll_every=poll_every)
        was_warmup, warmup_pending = warmup_pending, False
        if nseg == 0:
            if was_warmup:
                continue  # a warm-up-only first call (steps_per_execution == 1)
            break
        history_all = np.concatenate([history_all, hist])
        if guard is not None:
            # the first recorded loss of this run (fresh or resumed) against
            # the independently computed one
            check_initial_loss(history_all[step_total], guard, factor,
                               context=" (resumed)" if resuming else "")
            guard = None
        step_total += nseg
        since_save += nseg
        if since_save >= seg:
            will_continue = (step_total < cfg.maxsteps
                             and not _all_frozen(d.frozen, shard))
            if checkpoint_dir is not None and (tail_save or will_continue):
                save(step_total)
            since_save = 0
    if checkpoint_dir is not None and since_save > 0 and tail_save:
        save(step_total)  # a partial tail: resume re-enters at the true end state
    d.close()
    return _result(cfg, d.params, d.carry(), history_all, step_total, d.opt_state, fg_r, fg_i,
                   shard)


# ---------------------------------------------------------------------- #
# the warm-started time scan
# ---------------------------------------------------------------------- #
def upload_time_slice(stack, t, device):
    """Time ``t`` of a per-chunk host stack (numpy array or CPU tensor of
    shape (ntimes, ...)) as a (1, ...) tensor on ``device``: the scan keeps
    its stacks on the host and moves one time to the device when that
    time's fit starts."""
    return torch.as_tensor(stack[t:t + 1]).to(device)


def scan_time_fit(cfg, chunks, data_r, data_i, wgts, carry, prior_r, prior_i,
                  checkpoint_dir=None, checkpoint_every=None, resume=False, verbose=False,
                  opt_state0=None, steps_per_execution=None, expected_loss_fn=None,
                  poll_every=1, shard=None):
    """One time of the warm-started scan: the segmented batched descent at
    nbatch=1 (:func:`batched_fit_checkpointed`, no tail save: the scan's
    per-time marker supersedes it) from ``carry = (g_r, g_i, fg_r, fg_i)``,
    each with a leading axis of 1.

    ``expected_loss_fn(g_r, g_i, fg_r, fg_i) -> (1,)`` is the step-0
    guard's independent loss, taken at the parameters the first recorded
    step evaluates (the entry carry after the warm-up step, or a resumed
    descent's restored state); under ``cfg.freeze_model`` it receives the
    carry's coefficients. Under a mesh (``shard``, 'data' unused) the
    coefficients and cubes are this rank's blocks of the groups. Returns
    (result, recorded loss row (float32 numpy), recorded steps, seconds
    spent in the guard, whose evaluation is the span ``loss_guard``)."""
    guards = []
    fn = None
    if expected_loss_fn is not None:
        def fn(params, fr_const=carry[2], fi_const=carry[3]):
            with SPANS.span("loss_guard") as span:
                guards.append(span)
                fr = fr_const if cfg.freeze_model else params["fg_r"]
                fi = fi_const if cfg.freeze_model else params["fg_i"]
                return expected_loss_fn(params["g_r"], params["g_i"], fr, fi)
    res = batched_fit_checkpointed(
        cfg, chunks, data_r, data_i, wgts, *carry, prior_r, prior_i, checkpoint_dir,
        cfg.maxsteps if checkpoint_every is None else checkpoint_every, resume, verbose,
        opt_state0, steps_per_execution=steps_per_execution, expected_loss_fn=fn,
        tail_save=False, poll_every=poll_every, shard=shard)
    nst = min(int(res.nsteps), int(res.nsteps_slice[0]))
    return (res, np.asarray(res.loss_history[:nst, 0], dtype=np.float32), nst,
            sum(g.seconds for g in guards))


def scan_carry(res):
    """The carry a finished time hands the next: its fitted parameters."""
    return (res.g_r, res.g_i, list(res.fg_r), list(res.fg_i))


def scanned_warmstart_fit_core(cfg, chunks, data_r, data_i, wgts, g_r0, g_i0, fg_r0, fg_i0,
                               prior_r, prior_i, expected_loss_fn=None, poll_every=1,
                               shard=None):
    """Sequential warm-started fits over times (reference
    parallel/batched.py:275-384): each time's fit starts from the previous
    time's solution, with a fresh optimizer state, one unrecorded warm-up
    step, and the serial descent's stops (|delta loss| < tol after the
    first recorded step, patience, a non-finite loss), ``use_min``,
    ``freeze_model`` and the "sum" prior of that time.

    The reference compiles the sequence as one lax.scan; here the times
    loop on the host, and each time runs :func:`scan_time_fit` (the
    batched descent at nbatch=1, freeze mask polled every ``poll_every``
    steps, so the trajectory is the per-step one). The parameters stay on
    the device between times.

    data_r/data_i/wgts: per chunk, (ntimes, ngrps, nbls, nfreqs) stacks
    (weights may be (..., 1) planes), numpy arrays or tensors; time t moves
    to ``g_r0``'s device when its fit starts (:func:`upload_time_slice`),
    so the device holds one time. g/fg: the time-0 start, without a time
    axis; prior_r/prior_i: (ntimes,). ``expected_loss_fn(t, g_r, g_i,
    fg_r, fg_i) -> (1,)`` arms the step-0 guard on every time (see
    :func:`scan_time_fit`). Under a mesh (``shard``) every stack and
    coefficient is this rank's block of the groups, and so are the
    returned coefficients.

    Returns (params: (g_r, g_i, fg_r, fg_i) stacked on a leading time
    axis, loss history (ntimes, maxsteps) float32 padded with NaN, recorded
    steps per time (ntimes,), final losses (ntimes,))."""
    dev = g_r0.device
    ntimes = int(data_r[0].shape[0])
    carry = (g_r0[None], g_i0[None], [f[None] for f in fg_r0], [f[None] for f in fg_i0])
    outs, rows, nsteps, finals = [], [], [], []
    for t in range(ntimes):
        dr, di, w = ([upload_time_slice(x, t, dev) for x in stack]
                     for stack in (data_r, data_i, wgts))
        pr = upload_time_slice(prior_r, t, dev)
        pi = upload_time_slice(prior_i, t, dev)
        guard = None if expected_loss_fn is None else partial(expected_loss_fn, t)
        res, row, nst, _ = scan_time_fit(cfg, chunks, dr, di, w, carry, pr, pi,
                                         expected_loss_fn=guard, poll_every=poll_every,
                                         shard=shard)
        carry = scan_carry(res)
        outs.append(carry)
        full = np.full((cfg.maxsteps,), np.nan, dtype=np.float32)
        full[:nst] = row[:cfg.maxsteps]
        rows.append(full)
        nsteps.append(nst)
        finals.append(res.final_loss)
    params = (torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs]),
              tuple(torch.cat([o[2][c] for o in outs]) for c in range(len(chunks))),
              tuple(torch.cat([o[3][c] for o in outs]) for c in range(len(chunks))))
    return params, np.stack(rows), np.asarray(nsteps), torch.cat(finals)
