"""The Adamax update and the descent's carry, as two hand-written kernels.

The reference runs the optimizer (``optax.adamax``) and its loop's
bookkeeping inside one jitted ``lax.while_loop`` body
(calamity_tpu/solver/fit.py:172-193, with ``_tree_where`` at :79;
calamity_tpu/parallel/batched.py:505-552, with ``keep_frozen``), which XLA
fuses into a few loops. The descents here (``solver.fit._Descent``,
``parallel.batched._BatchedDescent``) keep that carry on the device; with
Adamax, the driver's default, each step runs it as two kernels of
``csrc/adamax_step.cu`` on a CUDA tensor:

- ``adamax_step``: the update of every leaf of the parameter tree in one
  launch (48 leaves a launch, more launches past that), gated as the
  descent gates it: the parameters and both moments move where the step
  is live (the batched descent: where the slice's row is ``~frozen &
  live``), the best parameters take the new ones where the loss improved.
  The kernel computes ``live`` and ``is_best`` from the carry itself;
  under a mesh ``live`` is the ranks' any-rows flag (``BatchedCarry.live``).
- ``descent_carry``: the bookkeeping after it, in one block: the history,
  |delta loss|, the best loss, the steps since it, the freeze mask and the
  slices' step counts, the last loss, the step and the optimizer's count.

Beside each wrapper its plain version, the torch ops the descents ran
before: ``opt.update`` and the ``where`` of each leaf
(:func:`adamax_step_plain`), and the carry's scalar ops
(:func:`descent_carry_plain`). A wrapper takes the plain version for a CPU
tensor, and on CUDA launches its kernel or raises; inside
:func:`plain_versions`, the private switch that holds a kernel fit against
a plain one, it takes the plain version on CUDA too. The two are equal to
the bit. The other optimizers keep their tree updates and the plain
gating, from the pieces below.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Any, NamedTuple

import torch

from .._device import LAUNCHES
from ..solver.optimizers import tree_leaves, tree_map

KERNEL_NAME = "adamax_step"
CARRY_KERNEL_NAME = "descent_carry"
LEAVES_PER_LAUNCH = 48  # kMaxLeaves of csrc/adamax_step.cu
_DTYPES = {torch.float32: 0, torch.float64: 1}


class SerialCarry(NamedTuple):
    """``solver.fit._Descent``'s carry: 0-d tensors of the step and the
    segment's end (int64), |delta loss|, the last loss and the best loss
    (the fit dtype), the steps since it (int64), and a (capacity,) history
    in the fit dtype; the stop's constants."""

    step: Any
    end: Any
    delta: Any
    prev: Any
    best_loss: Any
    since: Any
    history: Any
    tol: float
    patience: int
    big: float


class BatchedCarry(NamedTuple):
    """``parallel.batched._BatchedDescent``'s carry: 0-d int64 tensors of
    the segment's live steps taken, their limit, the unrecorded warm-up
    steps at its start and the global steps before it; per slice the freeze
    mask (bool), the last loss and the best loss (the fit dtype; None unless
    tracked), the steps since it (int64; None without patience) and the
    step of the freeze (int64); a (capacity, nbatch) float32 history; the
    stop's constants; and under a mesh ``live``, the ranks' 0-d any-rows
    flag of the step."""

    it: Any
    total: Any
    warmup: Any
    step0: Any
    frozen: Any
    prev: Any
    best_loss: Any
    since: Any
    nsteps_slice: Any
    history: Any
    tol: float
    patience: int
    live: Any = None


# ---------------------------------------------------------------------- #
# the plain versions, in pieces the other optimizers' steps share
# ---------------------------------------------------------------------- #
def keep(cond, new, old):
    """``old`` takes ``new``'s values where ``cond`` holds, in place (one
    ``where`` a leaf, written into ``old``)."""
    tree_map(lambda n, o: torch.where(cond, n, o, out=o), new, old)


def keep_rows(mask, new, old, live=None):
    """``old`` takes ``new``'s values where ``mask`` holds along the leading
    slice axis, in place; leaves without one (the optimizer's step count)
    where ``live`` (a 0-d bool)."""
    nbatch = mask.shape[0]

    def sel(n, o):
        if n.dim() == 0 or n.shape[0] != nbatch:
            torch.where(live, n, o, out=o)
        else:
            torch.where(mask.reshape((nbatch,) + (1,) * (n.dim() - 1)), n, o, out=o)

    tree_map(sel, new, old)


def serial_live(c):
    """The reference's cond (solver/fit.py:174-179), a 0-d bool."""
    live = (c.step < c.end) & (c.delta >= c.tol) & torch.isfinite(c.prev)
    if c.patience > 0:
        live = live & (c.since < c.patience)
    return live


def serial_flags(c, loss):
    """(live, is_best) of a serial step whose loss is ``loss``."""
    live = serial_live(c)
    return live, live & (loss < c.best_loss)


def serial_bookkeeping(c, loss, live, is_best):
    """The serial carry's scalar ops of a step (the reference's body,
    solver/fit.py:181-193), where ``live``: the history slot, |delta loss|,
    the best loss, the steps since it, the last loss and the step."""
    slot = torch.clamp(c.step, max=c.history.numel() - 1).reshape(1)
    c.history.index_copy_(0, slot, torch.where(live, loss, c.history.index_select(0, slot)))
    delta = torch.where(c.prev < c.big, torch.abs(loss - c.prev), c.big)
    torch.where(live, delta, c.delta, out=c.delta)
    # torch.minimum propagates NaN, as jnp.minimum does
    torch.where(live, torch.minimum(loss, c.best_loss), c.best_loss, out=c.best_loss)
    torch.where(live, torch.where(is_best, 0, c.since + 1), c.since, out=c.since)
    torch.where(live, loss, c.prev, out=c.prev)
    c.step.add_(live.to(torch.int64))


def batched_live(c):
    """The batched step's live flag: within the segment and some slice runs
    (under a mesh, the ranks' flag the carry holds)."""
    if c.live is not None:
        return c.live
    return (c.it < c.total) & ~c.frozen.all()


def batched_flags(c, losses):
    """(live, active, rec, recorded_live, is_best) of a batched step whose
    per-slice losses are ``losses``: ``active`` the rows that move,
    ``is_best`` None unless the best loss is tracked."""
    live = batched_live(c)
    active = ~c.frozen & live
    rec = (c.it - c.warmup) >= 0  # False on the warm-up step
    recorded_live = live & rec
    is_best = None if c.best_loss is None else recorded_live & (losses < c.best_loss)
    return live, active, rec, recorded_live, is_best


def batched_bookkeeping(c, losses, live, active, rec, recorded_live, is_best):
    """The batched carry's ops of a step (the reference's body,
    parallel/batched.py:515-552): the history row, the stop tests, the best
    loss, the steps since it, the freeze step and mask, the last loss and
    the step."""
    idx = c.it - c.warmup  # -1 on the warm-up step
    gstep = c.step0 + idx
    # frozen slices re-evaluate to their converged loss: not recorded
    slot = torch.clamp(idx, 0, c.history.shape[0] - 1).reshape(1)
    recording = active & rec
    c.history.index_copy_(0, slot, torch.where(
        recording, losses.to(torch.float32), c.history.index_select(0, slot)[0])[None])
    stop = ~torch.isfinite(losses)
    # the first recorded global step cannot trigger the tol stop
    stop = stop | ((gstep >= 1) & (torch.abs(losses - c.prev) < c.tol))
    newly = recording & stop
    if c.best_loss is not None:
        torch.where(is_best, losses, c.best_loss, out=c.best_loss)
    if c.since is not None:
        torch.where(recording, torch.where(is_best, 0, c.since + 1), c.since, out=c.since)
        newly = newly | (recording & (c.since >= c.patience))
    torch.where(newly, gstep + 1, c.nsteps_slice, out=c.nsteps_slice)
    c.frozen.logical_or_(newly)
    torch.where(recorded_live, losses, c.prev, out=c.prev)
    c.it.add_(live.to(torch.int64))


def adamax_step_plain(opt, params, grads, state, best, carry, loss):
    """Plain torch version of the update kernel: ``opt.update`` (the
    optimizer's tree update), then the gated writes, in place: the
    parameters and both moments where live (per slice where the row is
    active), the best parameters (``best``, or None) where the loss
    improved. The step count is the carry's (:func:`descent_carry_plain`)."""
    new_params, new_state = opt.update(grads, state, params)
    moments, new_moments = (state.mu, state.nu), (new_state.mu, new_state.nu)
    if isinstance(carry, SerialCarry):
        live, is_best = serial_flags(carry, loss)
        if best is not None:
            keep(is_best, new_params, best)
        keep(live, new_params, params)
        keep(live, new_moments, moments)
        return
    _, active, _, _, is_best = batched_flags(carry, loss)
    keep_rows(active, new_params, params)
    keep_rows(active, new_moments, moments)
    if best is not None:
        keep_rows(is_best, params, best)


def descent_carry_plain(carry, loss, count):
    """Plain torch version of the carry kernel: the bookkeeping of a step
    whose loss (per slice, batched) is ``loss``, and the optimizer's step
    count ``count`` (0-d int64) advanced where the step is live."""
    if isinstance(carry, SerialCarry):
        live, is_best = serial_flags(carry, loss)
        serial_bookkeeping(carry, loss, live, is_best)
    else:
        flags = batched_flags(carry, loss)
        batched_bookkeeping(carry, loss, *flags)
        live = flags[0]
    torch.where(live, count + 1, count, out=count)


# ---------------------------------------------------------------------- #
# the kernels
# ---------------------------------------------------------------------- #
class _Switch:
    """Whether a CUDA tensor takes the plain versions (:func:`plain_versions`)."""

    plain = False


_SWITCH = _Switch()


@contextlib.contextmanager
def plain_versions():
    """Within the block, :func:`adamax_step` and :func:`descent_carry` take
    their plain versions on CUDA tensors too: the counterpart of a kernel
    fit, to hold the two against each other (``chip_smoke.py``, the ``gpu``
    tests). Nothing on the main path enters it."""
    saved, _SWITCH.plain = _SWITCH.plain, True
    try:
        yield
    finally:
        _SWITCH.plain = saved


def _on_kernel(t):
    """Whether tensor ``t`` takes the kernel (CUDA, outside the switch) or
    the plain version (CPU, or inside it); raises on other devices."""
    if t.device.type == "cuda":
        return not _SWITCH.plain
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")


class _Leaf(ctypes.Structure):
    _fields_ = [(k, ctypes.c_void_p) for k in ("p", "g", "mu", "nu", "best")] + [
        ("n", ctypes.c_longlong), ("row", ctypes.c_longlong)]


_CARRY_PTRS = ("step", "end", "warmup", "step0", "delta", "prev", "best_loss", "since", "loss",
               "history", "frozen", "live", "nsteps_slice", "count")


class _Carry(ctypes.Structure):
    _fields_ = ([("batched", ctypes.c_int), ("nbatch", ctypes.c_int)]
                + [(k, ctypes.c_void_p) for k in _CARRY_PTRS]
                + [("capacity", ctypes.c_longlong), ("patience", ctypes.c_longlong),
                   ("tol", ctypes.c_double), ("big", ctypes.c_double)])


def _want(t, name, dtype, shape, device):
    if not isinstance(t, torch.Tensor) or t.dtype != dtype or tuple(t.shape) != shape \
            or t.device != device or not t.is_contiguous():
        got = (f"{t.dtype} {tuple(t.shape)} on {t.device}" if isinstance(t, torch.Tensor)
               else type(t).__name__)
        raise ValueError(f"the carry's {name}: {got}; the kernels take a contiguous {dtype} "
                         f"{shape} on {device}")


def _carry_struct(carry, loss, count, dtype, device):
    """The C carry of ``carry``, its tensors checked (types, shapes, device,
    contiguity)."""
    i64 = torch.int64
    ptr = {"loss": loss, "count": count}
    _want(count, "optimizer step count", i64, (), device)
    if isinstance(carry, SerialCarry):
        _want(loss, "loss", dtype, (), device)
        for name in ("step", "end", "since"):
            _want(getattr(carry, name), name, i64, (), device)
        for name in ("delta", "prev", "best_loss"):
            _want(getattr(carry, name), name, dtype, (), device)
        _want(carry.history, "history", dtype, (carry.history.numel(),), device)
        ptr.update({k: getattr(carry, k) for k in ("step", "end", "delta", "prev", "best_loss",
                                                   "since", "history")})
        out = _Carry(batched=0, nbatch=0, capacity=carry.history.numel(), big=carry.big)
    else:
        nbatch = carry.frozen.shape[0] if carry.frozen.dim() == 1 else -1
        _want(carry.frozen, "freeze mask", torch.bool, (nbatch,), device)
        _want(loss, "losses", dtype, (nbatch,), device)
        for name in ("it", "total", "warmup", "step0"):
            _want(getattr(carry, name), name, i64, (), device)
        _want(carry.prev, "prev", dtype, (nbatch,), device)
        _want(carry.nsteps_slice, "nsteps_slice", i64, (nbatch,), device)
        if carry.best_loss is not None:
            _want(carry.best_loss, "best_loss", dtype, (nbatch,), device)
        if carry.since is not None:
            if carry.best_loss is None:
                raise ValueError("the carry counts steps since a best loss it does not keep")
            _want(carry.since, "since", i64, (nbatch,), device)
        _want(carry.history, "history", torch.float32, (carry.history.shape[0], nbatch), device)
        if carry.live is not None:
            _want(carry.live, "live flag", torch.bool, (), device)
        ptr.update(step=carry.it, end=carry.total, warmup=carry.warmup, step0=carry.step0,
                   prev=carry.prev, best_loss=carry.best_loss, since=carry.since,
                   history=carry.history, frozen=carry.frozen, live=carry.live,
                   nsteps_slice=carry.nsteps_slice)
        out = _Carry(batched=1, nbatch=nbatch, capacity=carry.history.shape[0])
    out.patience, out.tol = int(carry.patience), float(carry.tol)
    for k, t in ptr.items():
        setattr(out, k, None if t is None else t.data_ptr())
    return out


def _step_leaves(params, grads, state, best, carry):
    """The leaves (p, g, mu, nu, best or None) of the trees, checked: one
    structure, one floating dtype and device, and in the batched descent a
    leading slice axis on every leaf. Raises on what the kernel does not
    take."""
    ps, gs = tree_leaves(params), tree_leaves(grads)
    ms, ns = tree_leaves(state.mu), tree_leaves(state.nu)
    bs = [None] * len(ps) if best is None else tree_leaves(best)
    if not len(ps) == len(gs) == len(ms) == len(ns) == len(bs) or not ps:
        raise ValueError(f"parameter, gradient, moment and best-parameter trees of "
                         f"{len(ps)}, {len(gs)}, {len(ms)}, {len(ns)} and {len(bs)} leaves")
    dtype, device = ps[0].dtype, ps[0].device
    if dtype not in _DTYPES:
        raise TypeError(f"parameters of {dtype} (float32 or float64)")
    nbatch = None if isinstance(carry, SerialCarry) else carry.frozen.shape[0]
    leaves = list(zip(ps, gs, ms, ns, bs))
    for k, leaf in enumerate(leaves):
        shape = leaf[0].shape
        for t in leaf:
            if t is not None and (t.shape != shape or t.dtype != dtype or t.device != device):
                got = [None if x is None else (tuple(x.shape), x.dtype, str(x.device))
                       for x in leaf]
                raise ValueError(f"leaf {k}: {got}; the parameter, gradient, moments and best "
                                 "parameter must agree in shape, dtype and device")
        if nbatch is not None and (len(shape) == 0 or shape[0] != nbatch):
            raise ValueError(f"leaf {k} {tuple(shape)} has no leading axis of the "
                             f"{nbatch} slices")
    return leaves, dtype, device


def adamax_step(opt, params, grads, state, best, carry, loss):
    """The Adamax update of a descent step, gated as the step gates it, in
    place: ``params``, ``state.mu``, ``state.nu`` and ``best`` (the best
    parameters, or None) from ``grads``; ``carry`` a :class:`SerialCarry`
    or :class:`BatchedCarry` and ``loss`` the step's loss (per slice,
    batched), both read only; ``opt`` the :func:`adamax` optimizer (its
    ``hyper``). The kernel on a CUDA tensor (raises on operands it does
    not take and on a failed launch), :func:`adamax_step_plain` on a CPU
    tensor and inside :func:`plain_versions`."""
    leaves, dtype, device = _step_leaves(params, grads, state, best, carry)
    if not _on_kernel(leaves[0][0]):
        adamax_step_plain(opt, params, grads, state, best, carry, loss)
        return
    from ._build import load_kernels
    from .gains import _launch, _raise_on

    h = opt.hyper
    bias = h.bias1.table(leaves[0][0])
    c = _carry_struct(carry, loss, state.count, dtype, device)
    table = (_Leaf * len(leaves))()
    keepalive = []
    for k, (p, g, m, n, b) in enumerate(leaves):
        for name, t in (("parameter", p), ("first moment", m), ("second moment", n),
                        ("best parameter", b)):
            if t is not None and not t.is_contiguous():
                raise ValueError(f"leaf {k}'s {name} {tuple(t.shape)} is not contiguous: the "
                                 "kernel updates it in place")
        # a gradient is read only: a strided one is copied, and the copy held
        # until the launch is queued (its memory is not handed out again)
        g = g.contiguous()
        keepalive.append(g)
        row = 0 if isinstance(carry, SerialCarry) else p.numel() // p.shape[0]
        table[k] = _Leaf(p.data_ptr(), g.data_ptr(), m.data_ptr(), n.data_ptr(),
                         None if b is None else b.data_ptr(), p.numel(), row)
    lib = load_kernels()
    launched = ctypes.c_int(0)
    dev = device.index if device.index is not None else torch.cuda.current_device()
    err = _launch(dev, lib.adamax_step, table, len(leaves), ctypes.byref(c), bias.data_ptr(),
                  bias.numel(), 1 - h.beta_1, h.beta_1, h.beta_2, h.epsilon, -h.learning_rate,
                  _DTYPES[dtype], ctypes.byref(launched))
    _raise_on(lib, err, KERNEL_NAME)
    for _ in range(launched.value):
        LAUNCHES.add(KERNEL_NAME)


def descent_carry(carry, loss, count):
    """The descent's bookkeeping after :func:`adamax_step`, in place:
    ``carry`` (a :class:`SerialCarry` or :class:`BatchedCarry`) from the
    step's ``loss`` (per slice, batched), and the optimizer's step count
    ``count`` (0-d int64) advanced where the step is live. The kernel on a
    CUDA tensor (raises on operands it does not take and on a failed
    launch), :func:`descent_carry_plain` on a CPU tensor and inside
    :func:`plain_versions`."""
    if not _on_kernel(carry.prev):
        descent_carry_plain(carry, loss, count)
        return
    from ._build import load_kernels
    from .gains import _launch, _raise_on

    device, dtype = carry.prev.device, carry.prev.dtype
    if dtype not in _DTYPES:
        raise TypeError(f"a carry of {dtype} (float32 or float64)")
    c = _carry_struct(carry, loss, count, dtype, device)
    lib = load_kernels()
    dev = device.index if device.index is not None else torch.cuda.current_device()
    err = _launch(dev, lib.descent_carry, ctypes.byref(c), _DTYPES[dtype])
    _raise_on(lib, err, CARRY_KERNEL_NAME)
    LAUNCHES.add(CARRY_KERNEL_NAME)
