"""Faults planted in the port under a run, each of which the comparison has to see.

A fault replaces one function of ``calamity_tpu_torch`` through a
``setattr(obj, name, value)`` (pytest's ``monkeypatch.setattr``, or
:class:`Patches` in a process of its own) and breaks the timed path
underneath the harness, which runs unchanged:

- ``unchanged_state``: every Adamax update leaves the parameters and the
  moments as they were;
- ``half_batch``: half of the batch left out, the mean of the rest standing
  for it (serial: half of a slice's chunks; batched: half of the slices);
- ``altered_answer``: the returned gains scaled by 1.001 where the fit
  returns them;
- ``phase2_frozen``: the float32 phase of the mixed schedule runs its
  steps at a learning rate of 0, so it returns the bfloat16 phase's
  parameters with a flat history that agrees with them;
- ``carry_dropped``: the float32 phase starts from a fresh Adamax state
  instead of the one the bfloat16 phase carries over.

``control.py --faults`` reads them on the card at a cell's own size; the
CPU tests plant them at cut width.
"""

from __future__ import annotations

import torch

from calamity_tpu_torch.ops import adamax as adamax_ops
from calamity_tpu_torch.parallel import batched
from calamity_tpu_torch.solver import fit as fitmod
from calamity_tpu_torch.solver import optimizers


class Patches:
    """``setattr`` that remembers what it replaced, and :meth:`undo`."""

    def __init__(self):
        self._undo = []

    def setattr(self, obj, name, value):
        self._undo.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def undo(self):
        while self._undo:
            obj, name, value = self._undo.pop()
            setattr(obj, name, value)


def unchanged_state(setattr):
    setattr(adamax_ops, "adamax_step", lambda *args, **kwargs: None)


def half_batch(setattr):
    serial, losses = fitmod.chunked_loss, batched.batched_chunk_losses

    def serial_half(g_r, g_i, fg_r, fg_i, chunks, data_r, data_i, wgts, remat=False):
        h = max(1, len(chunks) // 2)
        part = serial(g_r, g_i, fg_r[:h], fg_i[:h], chunks[:h], data_r[:h], data_i[:h],
                      wgts[:h], remat=remat)
        rest = serial(g_r, g_i, fg_r[h:], fg_i[h:], chunks[h:], data_r[h:], data_i[h:],
                      wgts[h:], remat=remat)
        return part * len(chunks) / h + 0 * rest  # the rest's leaves get no gradient

    def batched_half(*args, **kwargs):
        out = losses(*args, **kwargs)
        h = max(1, out.shape[0] // 2)
        return torch.cat([out[:h], out[:h].mean().expand(out.shape[0] - h)])

    setattr(fitmod, "chunked_loss", serial_half)
    setattr(batched, "batched_chunk_losses", batched_half)


def altered_answer(setattr):
    serial, core = fitmod.fit_gains_and_foregrounds, batched.batched_fit_core

    def serial_altered(*args, **kwargs):
        g_r, g_i, fr, fi, hist = serial(*args, **kwargs)
        return g_r * 1.001, g_i, fr, fi, hist

    def core_altered(*args, **kwargs):
        res = core(*args, **kwargs)
        if kwargs.get("opt_state0") is None:
            return res
        return res._replace(g_r=res.g_r * 1.001)

    setattr(fitmod, "fit_gains_and_foregrounds", serial_altered)
    setattr(batched, "batched_fit_core", core_altered)


def _second_phase(setattr, serial_fn, batched_cfg, batched_kwargs):
    # the float32 phase: the serial fit's _polish, the batched fit's second
    # batched_fit_core (the one given the bfloat16 phase's Adamax state)
    polish, core = fitmod._polish, batched.batched_fit_core

    def serial_phase(cfg, loss_fn, opt, d0, verbose=False):
        return polish(*serial_fn(cfg, loss_fn, opt, d0), verbose)

    def batched_phase(cfg, *args, **kwargs):
        if kwargs.get("opt_state0") is not None:
            cfg, kwargs = batched_cfg(cfg), batched_kwargs(kwargs)
        return core(cfg, *args, **kwargs)

    setattr(fitmod, "_polish", serial_phase)
    setattr(batched, "batched_fit_core", batched_phase)


def phase2_frozen(setattr):
    def serial_fn(cfg, loss_fn, opt, d0):
        return cfg, loss_fn, optimizers.get_optimizer(cfg.optimizer, learning_rate=0.0), d0

    def batched_cfg(cfg):
        return cfg._replace(opt_kwargs=(("learning_rate", 0.0),))

    _second_phase(setattr, serial_fn, batched_cfg, dict)


def carry_dropped(setattr):
    def serial_fn(cfg, loss_fn, opt, d0):
        d0.opt_state = opt.init(d0.params)
        return cfg, loss_fn, opt, d0

    def batched_kwargs(kwargs):
        return {**kwargs, "opt_state0": None}

    _second_phase(setattr, serial_fn, lambda cfg: cfg, batched_kwargs)


FAULTS = {"unchanged_state": unchanged_state, "half_batch": half_batch,
          "altered_answer": altered_answer, "phase2_frozen": phase2_frozen,
          "carry_dropped": carry_dropped}
