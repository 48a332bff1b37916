"""One descent step captured as a CUDA graph and replayed.

The reference runs each descent as one compiled program: a
``lax.while_loop`` whose stop test, loss history and argmin live on the
device, so that the host syncs once, after convergence
(calamity_tpu/solver/fit.py:9-14). The port keeps the same carry on the
device (``solver.fit._Descent``, ``parallel.batched._BatchedDescent``) and
advances it in place with one step function that reads no host value. On
CUDA, :class:`StepGraph` runs that function eagerly on a side stream for
its first :data:`EAGER_STEPS` calls (the lazy builds of the kernel library,
the gain kernels' row lists and the blocked path's index views happen
there, as does the caching allocator's warm-up), then captures it once
into a ``torch.cuda.CUDAGraph`` with its own memory pool and replays it:
a step is one launch from the host instead of the ~200 that PyTorch would
issue one by one. The host reads the stop state once per
:data:`POLL_EVERY` steps; a step after the stop changes nothing, so the
trajectory does not depend on that interval. On the CPU the function is
called as it is: the tests run the code the graph replays.

A failed capture raises, naming the operation that broke it; nothing falls
back to the eager step on CUDA. Under a device mesh the step runs eagerly
(gloo's collectives cannot be captured), as it does inside
:func:`eager_steps`, the private switch that runs a fit uncaptured to hold
it against the graphed one.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import traceback

import torch

from .._device import LAUNCHES, SPANS
from ..utils import echo

# steps between the host's reads of the stop state
POLL_EVERY = 16
# eager calls before the capture: the fit's first steps
EAGER_STEPS = 2

# a failed capture's site is named relative to the checkout
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_LIBRARIES = (os.path.dirname(torch.__file__), os.path.dirname(contextlib.__file__))


class _Switch:
    """Whether steps are captured on CUDA (see :func:`eager_steps`)."""

    capture = True


_SWITCH = _Switch()
# one record per capture: {"name", "seconds", "pool_bytes", "replays"}
CAPTURES = []


@contextlib.contextmanager
def eager_steps():
    """Within the block, :class:`StepGraph` runs every step eagerly: the
    uncaptured counterpart of a graphed fit, for comparisons."""
    saved, _SWITCH.capture = _SWITCH.capture, False
    try:
        yield
    finally:
        _SWITCH.capture = saved


def _failing_site(exc):
    """The innermost frame outside torch, contextlib and this module in the
    tracebacks of ``exc`` and the exceptions it was raised during: the
    operation a capture could not take, with its source line."""
    seen = exc
    while seen is not None:
        frames = [f for f in traceback.extract_tb(seen.__traceback__)
                  if not f.filename.startswith(_LIBRARIES) and f.filename != __file__]
        if frames:
            f = frames[-1]
            where = f.filename
            if where.startswith(_ROOT):
                where = os.path.relpath(where, _ROOT)
            return f"{where}:{f.lineno} in {f.name} ({f.line}): {type(seen).__name__}: {seen}"
        seen = seen.__context__
    return f"{type(exc).__name__}: {exc}"


class StepGraph:
    """Calls of ``step`` (a function of no arguments that updates device
    state in place): on a CUDA ``device`` its first :data:`EAGER_STEPS`
    calls run eagerly on a side stream, the next captures it and every call
    from then on replays the graph; elsewhere, or with ``capture=False``,
    or inside :func:`eager_steps`, each call runs ``step``. ``name`` labels
    the capture's record and log line. :meth:`close` releases the graph and
    its memory pool."""

    def __init__(self, step, device, name, capture=True, verbose=False):
        self._step = step
        self.device = torch.device(device)
        self.name = name
        self.capture = capture and _SWITCH.capture and self.device.type == "cuda"
        self.verbose = verbose
        self.calls = 0
        self.graph = None
        self.record = None
        self._counts = None
        self._side = None

    def __call__(self):
        if not self.capture:
            self._step()
        elif self.graph is not None:
            self.graph.replay()
            LAUNCHES.replayed(self._counts)
            self.record["replays"] += 1
        elif self.calls < EAGER_STEPS:
            self._on_side_stream()
        else:
            self._capture()
            self.graph.replay()
            LAUNCHES.replayed(self._counts)
            self.record["replays"] += 1
        self.calls += 1

    def _on_side_stream(self):
        with SPANS.span("graph.eager"):
            if self._side is None:
                self._side = torch.cuda.Stream(self.device)
            current = torch.cuda.current_stream(self.device)
            self._side.wait_stream(current)
            with torch.cuda.stream(self._side):
                self._step()
            current.wait_stream(self._side)

    def _capture(self):
        """The span ``graph.capture``: the device drained, the allocator's
        cache emptied, the step captured and the device drained again; its
        seconds are the capture record's."""
        with SPANS.span("graph.capture") as span:
            SPANS.sync(self.device)
            # the capture empties the allocator's cache first; so does this,
            # so that what it reserves after is the graph's pool
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(self.device)
            graph = torch.cuda.CUDAGraph()
            try:
                with LAUNCHES.recording() as counts, torch.cuda.graph(graph):
                    self._step()
            except RuntimeError as exc:
                raise RuntimeError(f"the CUDA graph capture of {self.name}'s step failed at "
                                   f"{_failing_site(exc)}") from exc
            SPANS.sync(self.device)
            pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        self.graph, self._counts = graph, dict(counts)
        self.record = {"name": self.name, "seconds": span.seconds, "pool_bytes": pool_bytes,
                       "replays": 0}
        CAPTURES.append(self.record)
        echo(f"{datetime.datetime.now()} captured {self.name}'s step in "
             f"{self.record['seconds']:.3f} s; its pool holds {self.record['pool_bytes']} bytes",
             verbose=self.verbose)

    def close(self):
        """Release the graph and its memory pool (the mixed schedule's
        float32 phase captures its own after the bfloat16 one's is gone),
        as the span ``graph.release``."""
        with SPANS.span("graph.release"):
            if self.graph is not None:
                SPANS.sync(self.device)  # no replay in flight
                self.graph.reset()
                self.graph = None
                torch.cuda.empty_cache()  # the pool's memory back to the device
