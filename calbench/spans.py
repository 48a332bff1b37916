"""The port's own spans, read for the per-layer metrics of a run on a card.

The port records named host spans in memory (``calamity_tpu_torch._device.SPANS``:
name, start and end from ``time.time_ns()``, the index of the parent span
and of the fit each belongs to, and notes); this module reads them, and it
is the only module of the benchmark's readers that imports the port. A
checkout whose port records no spans gives None, and so does every reader.

"The profiled fit" is the ``fit`` spans the profiler was recording (the
note ``profiled``): the fit every device-trace metric reads, one span for
a serial fit and one a phase for a batched one (``batched_fit_core`` is
called once a phase); their seconds and counts are summed.
"""

from __future__ import annotations

FIT = "fit"


def records():
    """The port's spans, oldest first, or None where its port records none."""
    try:
        from calamity_tpu_torch._device import SPANS
    except ImportError:
        return None
    return SPANS.records()


def seconds(span):
    return (span.end_ns - span.start_ns) * 1e-9


def profiled_fit(run):
    """(the profiled fit's ``fit`` spans, every closed span of those fits),
    or None: in a run with no device trace (no card), or where the spans
    hold no profiled fit."""
    if run.trace is None:
        return None
    recs = records()
    if not recs:
        return None
    fits = [r for r in recs if r.name == FIT and r.notes.get("profiled") and r.end_ns is not None]
    if not fits:
        return None
    ids = {f.index for f in fits}
    return fits, [r for r in recs if r.fit in ids and r.end_ns is not None]


def self_seconds(fit, name):
    """The summed self time of the fit's spans named ``name``: each one's
    seconds less those of its children."""
    _, members = fit
    spans = {r.index: r for r in members if r.name == name}
    total = sum(seconds(r) for r in spans.values())
    return total - sum(seconds(r) for r in members if r.parent in spans)


def covered_seconds(fit, names):
    """The summed seconds of the fit's spans named in ``names`` (spans that
    nest in none of the others)."""
    return sum(seconds(r) for r in fit[1] if r.name in names)


def setup_spans(run, name):
    """The closed spans named ``name`` in a run on a card (the set-up's), or
    None."""
    if run.trace is None:
        return None
    recs = records()
    found = [r for r in recs or () if r.name == name and r.end_ns is not None]
    return found or None
