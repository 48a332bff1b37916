"""The readers of the port's spans (``calbench/spans.py``, ``metrics/*.py``).

Each reads a hand-made ring of spans as its docstring says: the profiled
fit's (``fit`` spans noted ``profiled``, two of them as a batched fit's
two phases), a fit the profiler did not see, and the set-up's packing.
Each returns None in a run with no device trace, where the ring holds no
profiled fit or no such span, and where the port records no spans. The
new cell, ``hera_core.campaign8``, rehearsed at cut width on the CPU."""

import importlib.util
import os
import time
from types import SimpleNamespace

import pytest
from calbench_cuts import CUT_LIMITS, ROOT, SEED

from calbench import harness, spans

NEW = ("capture_s", "release_s", "phase_host_s", "alloc_calls_per_fit", "fitspec_s",
       "pack_slice_s")
MS = 1_000_000  # ns


def metric(name):
    path = os.path.join(ROOT, "calbench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"calbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Ring:
    """Spans as the port records them: index, name, start and end (ns),
    parent and fit indices, notes."""

    def __init__(self):
        self.spans = []

    def add(self, name, start_ms, end_ms, parent=None, **notes):
        index = len(self.spans)
        fit = index if name == "fit" else (-1 if parent is None else parent.fit)
        span = SimpleNamespace(index=index, name=name, start_ns=start_ms * MS,
                               end_ns=None if end_ms is None else end_ms * MS,
                               parent=-1 if parent is None else parent.index, fit=fit,
                               notes=notes)
        self.spans.append(span)
        return span


def phase_of(ring, fit, t0, allocs=None):
    """One phase of a fit from ``t0`` ms: 5 ms of entry, two blocks of
    steps (the first with a capture of 30 ms, 8 of them waiting on the
    device), a readback, a release of 7 ms (2 waiting)."""
    ph = ring.add("phase", t0, t0 + 100, fit)
    ring.add("phase.entry", t0, t0 + 5, ph)
    b1 = ring.add("descent.steps", t0 + 5, t0 + 45, ph)
    cap = ring.add("graph.capture", t0 + 6, t0 + 36, b1)
    ring.add("device.sync", t0 + 6, t0 + 10, cap)
    ring.add("device.sync", t0 + 30, t0 + 34, cap)
    ring.add("descent.poll", t0 + 40, t0 + 45, b1)
    b2 = ring.add("descent.steps", t0 + 45, t0 + 85, ph)
    ring.add("descent.poll", t0 + 80, t0 + 85, b2)
    ring.add("phase.readback", t0 + 85, t0 + 90, ph)
    rel = ring.add("graph.release", t0 + 90, t0 + 97, ph)
    ring.add("device.sync", t0 + 90, t0 + 92, rel)


def batched_ring(profiled=True):
    """The set-up's packing (one FitSpec, three slices on threads), a
    warm-up fit the profiler did not see, and a fit of two phases (two
    ``fit`` spans of 110 ms) under the profiler."""
    ring = Ring()
    ring.add("pack.fitspec", 0, 1000)
    for k in range(3):
        ring.add("pack.slice", 1000, 1000 + 200 * (k + 1))
    warm = ring.add("fit", 2000, 2500, profiled=False, allocator_calls=[(0, 0), (90, 80)])
    phase_of(ring, warm, 2000)
    for p in range(2):
        t0 = 3000 + 200 * p
        f = ring.add("fit", t0, t0 + 110, profiled=profiled,
                     allocator_calls=[(100 + 10 * p, 50), (104 + 10 * p, 53)])
        ring.add("comps.convert", t0 + 100, t0 + 110, f)
        phase_of(ring, f, t0)
    ring.add("fit", 4000, None, profiled=profiled)  # still open: not read
    return ring


CARD = SimpleNamespace(trace=object())  # a run on a card: it has a device trace
EXPECTED = {
    # per phase: 30 ms of capture less 8 of waits; 7 of release less 2
    "capture_s": 2 * 0.022,
    "release_s": 2 * 0.005,
    # per fit span: 110 ms less the 80 of blocks and 7 of the release
    "phase_host_s": 2 * 0.023,
    # (4 allocations + 3 frees) in each of the two spans
    "alloc_calls_per_fit": 14,
    "fitspec_s": 1.0,
    "pack_slice_s": (0.2 + 0.4 + 0.6) / 3,
}


@pytest.mark.parametrize("name", NEW)
def test_each_reader_reads_a_hand_made_ring(name, monkeypatch):
    ring = batched_ring()
    monkeypatch.setattr(spans, "records", lambda: ring.spans)
    assert metric(name)(CARD) == pytest.approx(EXPECTED[name], rel=1e-9)


@pytest.mark.parametrize("name", NEW)
def test_each_reader_reads_nothing_where_there_is_nothing(name, monkeypatch):
    read = metric(name)
    monkeypatch.setattr(spans, "records", lambda: batched_ring().spans)
    assert read(SimpleNamespace(trace=None)) is None  # no device trace: a CPU run
    monkeypatch.setattr(spans, "records", lambda: None)  # a port without spans
    assert read(CARD) is None
    monkeypatch.setattr(spans, "records", lambda: [])
    assert read(CARD) is None
    if name not in ("fitspec_s", "pack_slice_s"):
        # the fits the profiler did not see are no profiled fit
        monkeypatch.setattr(spans, "records", lambda: batched_ring(profiled=False).spans)
        assert read(CARD) is None


def test_allocator_calls_need_both_edges(monkeypatch):
    ring = batched_ring()
    ring.spans[[s.name for s in ring.spans].index("fit", 5)].notes.pop("allocator_calls")
    monkeypatch.setattr(spans, "records", lambda: ring.spans)
    assert metric("alloc_calls_per_fit")(CARD) is None


def test_records_of_a_port_without_the_recorder(monkeypatch):
    import calamity_tpu_torch._device as device

    monkeypatch.delattr(device, "SPANS")
    assert spans.records() is None


def test_the_port_records_what_the_readers_read():
    """The spans a CPU fit through the benchmark's own entry records, as the
    readers find them (the device-trace gate aside)."""
    from calamity_tpu_torch._device import SPANS

    SPANS.reset()
    cell = harness.Cell("hera_core.campaign8")
    ctx = harness.setup(cell, SEED, "cpu", CUT, log=lambda *a: None)
    try:
        from calbench import trace

        out, prof = trace.profiled(lambda: ctx.fits.fit(0, steps=20))
    finally:
        harness.release_collector()
    prof = None  # noqa: F841
    values = {name: metric(name)(CARD) for name in NEW}
    assert values["alloc_calls_per_fit"] is None  # the allocator is counted on CUDA only
    assert values["capture_s"] == 0.0  # no capture on the CPU
    assert values["fitspec_s"] > 0 and values["pack_slice_s"] > 0
    assert 0 < values["phase_host_s"] and values["release_s"] >= 0
    fits = [r for r in SPANS.records() if r.name == "fit" and r.notes["profiled"]]
    assert len(fits) == 2  # one batched_fit_core a phase
    assert len([r for r in SPANS.records() if r.name == "pack.slice"]) == cell.traffic["slices"]


CUT = dict(array={"nside": 5}, nfreqs=64, steps=300, warmup_steps=3,
           limits={**CUT_LIMITS, "resid_ratio": 4e-3})


def test_new_cell_rehearses_at_cut_width():
    code, res = harness.run("hera_core.campaign8", SEED, 0.0, False, time.perf_counter(),
                            device="cpu", overrides=CUT)
    assert code == 0 and res["correct"] is True and res["attempted"] == 8
    assert set(res["metrics"]) == {"slice_s", "peak_gib", "resid_ratio", "setup_s"}
