"""Float policy, device resolution, kernel launch counters and the span recorder.

The port never chooses a device on its own: every entry point takes an
explicit ``device`` and passes it down to the tensors it makes. Asking for
CUDA where there is none raises; nothing moves to the CPU unless the caller
asked for the CPU.

What the port counts and times of itself lives here: :data:`LAUNCHES`, the
hand-written kernels' launches, and :data:`SPANS`, named host spans with a
parent and the fit they belong to, stamped with ``time.time_ns()``, the
clock ``torch.profiler`` stamps its host events with. Spans are coarse (a
fit, a phase, a block of steps, a capture, a stage of a calibration) and
always recorded; while the profiler records, each also opens a
``record_function`` range named ``calamity.<name>``, so that it shows in
the profiler's own timeline beside the device's work.
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch


def set_float_policy():
    """Full float32 in every matmul and convolution.

    The reference computes its float32 contractions at
    ``Precision.HIGHEST`` (calamity_tpu/ops/loss.py:40-43). TF32 keeps about
    three decimal digits and would move the chi-square floor of the fit."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(device):
    """``torch.device`` for a device name, checked against this machine.

    ``device`` is required (no default): "cpu", "cuda", "cuda:N" or a
    ``torch.device``. A CUDA device that is not present raises."""
    if device is None:
        raise ValueError("device is required: pass 'cuda' or 'cpu' explicitly")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but CUDA is not available "
                "(pass device='cpu' to run on the CPU)"
            )
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {str(device)!r} requested but only "
                f"{torch.cuda.device_count()} CUDA device(s) are present"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r} (cpu or cuda)")
    return dev


class LaunchCounter:
    """Counts of hand-written kernel launches, by kernel name.

    A wrapper adds one where it launches its kernel and nowhere else, so a
    run can show that its main path went through the kernels. A CUDA graph
    launches what its capture recorded each time it is replayed: the
    wrappers' counts during a capture launched nothing, so
    :meth:`recording` takes them back out and returns them, and
    :meth:`replayed` adds them once per replay."""

    def __init__(self):
        self._counts = {}

    def add(self, name):
        self._counts[name] = self._counts.get(name, 0) + 1

    def get(self, name):
        return self._counts.get(name, 0)

    def reset(self):
        self._counts.clear()

    def counts(self):
        """Every count, by name (a copy)."""
        return dict(self._counts)

    @contextlib.contextmanager
    def recording(self):
        """Within the block, counts go to the dict this yields (the launches
        of one replay of the graph being captured), not to the totals."""
        totals, self._counts = self._counts, {}
        try:
            yield self._counts
        finally:
            self._counts = totals

    def replayed(self, counts, times=1):
        """``times`` replays of a graph whose capture recorded ``counts``."""
        for name, n in counts.items():
            self._counts[name] = self._counts.get(name, 0) + n * times


LAUNCHES = LaunchCounter()


# spans the recorder keeps; the oldest are dropped first
SPAN_CAPACITY = 1 << 16
FIT = "fit"  # the root span of one fit: its index is the fit's id


class Span:
    """One span: its ``name``, ``start_ns`` and ``end_ns`` (``time.time_ns()``;
    ``end_ns`` is None while it is open), the ``index`` of its parent
    (``parent``, -1 for none) and of the fit it belongs to (``fit``, -1
    outside a fit), the ``thread`` that opened it and its ``notes``."""

    __slots__ = ("index", "name", "start_ns", "end_ns", "parent", "fit", "thread", "notes")

    def __init__(self, index, name, parent, fit, thread):
        self.index, self.name, self.parent, self.fit, self.thread = (index, name, parent,
                                                                      fit, thread)
        self.start_ns = self.end_ns = None
        self.notes = {}

    @property
    def seconds(self):
        """The closed span's duration."""
        return (self.end_ns - self.start_ns) * 1e-9

    def __repr__(self):
        return (f"Span({self.index}, {self.name!r}, parent={self.parent}, fit={self.fit}, "
                f"{self.start_ns}..{self.end_ns})")


def _allocator_calls(device):
    stats = torch.cuda.memory_stats(device)
    return stats.get("num_device_alloc", 0), stats.get("num_device_free", 0)


class _Open:
    """The context of one span (:meth:`SpanRecorder.span`)."""

    __slots__ = ("rec", "name", "join", "device", "span", "range")

    def __init__(self, rec, name, join, device):
        self.rec, self.name, self.join, self.device = rec, name, join, device
        self.span = self.range = None

    def __enter__(self):
        stack = self.rec._stack()
        if self.join:
            for sp in reversed(stack):
                if sp.name == self.name:
                    return sp  # joined: the open span is not closed here
        sp = self.span = self.rec._new(self.name, stack[-1] if stack else None)
        profiling = torch.autograd._profiler_enabled()
        if self.name == FIT:
            sp.fit = sp.index
            sp.notes["profiled"] = profiling
            if self.device is not None and self.device.type == "cuda":
                sp.notes["allocator_calls"] = [_allocator_calls(self.device)]
        stack.append(sp)
        sp.start_ns = time.time_ns()
        if profiling:
            self.range = torch.profiler.record_function("calamity." + self.name)
            self.range.__enter__()
        return sp

    def __exit__(self, *exc):
        sp = self.span
        if sp is None:
            return
        if self.range is not None:
            self.range.__exit__(*exc)
        if "allocator_calls" in sp.notes:
            sp.notes["allocator_calls"].append(_allocator_calls(self.device))
        sp.end_ns = time.time_ns()
        self.rec._stack().pop()


class SpanRecorder:
    """Named host spans in a ring of ``capacity``, the oldest dropped first
    (:attr:`dropped` counts them). Each thread has its own stack of open
    spans: a span's parent is the innermost span open on its thread, and
    its fit that parent's fit."""

    def __init__(self, capacity=SPAN_CAPACITY):
        self.capacity = int(capacity)
        self._ring = [None] * self.capacity
        self._count = 0
        self._lock = threading.Lock()
        self._local = threading.local()

    def _stack(self):
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def _new(self, name, top):
        with self._lock:
            index = self._count
            self._count += 1
            sp = Span(index, name, -1 if top is None else top.index,
                      -1 if top is None else top.fit, threading.get_ident())
            self._ring[index % self.capacity] = sp
        return sp

    def span(self, name, join=False):
        """A context that records a span named ``name`` and yields its
        :class:`Span`. With ``join``, a span of that name already open on
        this thread is yielded instead, and no new one is recorded."""
        return _Open(self, name, join, None)

    def fit(self, device):
        """The root span of one fit on ``device`` (:data:`FIT`; joins a fit
        open on this thread). Its notes say whether the profiler recorded
        it (``profiled``) and, on CUDA, the allocator's device
        (allocations, frees) at its start and at its end
        (``allocator_calls``)."""
        return _Open(self, FIT, True, torch.device(device))

    def sync(self, device):
        """``torch.cuda.synchronize`` on a CUDA ``device``, as a span named
        ``device.sync``; nothing elsewhere."""
        device = torch.device(device)
        if device.type == "cuda":
            with self.span("device.sync"):
                torch.cuda.synchronize(device)

    def records(self):
        """The spans kept, oldest first (open ones with ``end_ns`` None)."""
        with self._lock:
            n, cap = self._count, self.capacity
            return [self._ring[i % cap] for i in range(max(0, n - cap), n)]

    @property
    def dropped(self):
        """Spans dropped from the ring so far."""
        return max(0, self._count - self.capacity)

    def reset(self):
        """Forget every span recorded (spans still open close as usual)."""
        with self._lock:
            self._ring = [None] * self.capacity
            self._count = 0


SPANS = SpanRecorder()
