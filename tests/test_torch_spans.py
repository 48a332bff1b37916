"""The port's span recorder (``calamity_tpu_torch._device``: ``SpanRecorder``, ``SPANS``).

- A span's parent, fit id and self time; ``join``; the ring's bound and
  its drop counter; one stack of open spans for each thread.
- A CPU fit through each entry point (the serial fit, the batched core,
  its checkpointed form, the warm-started scan, and the calibration's
  serial and time-parallel paths) records the span tree the port
  documents: ``fit`` > ``phase`` > ``phase.entry`` / ``descent.steps`` >
  ``descent.poll``, ``phase.readback``, ``graph.release``.
- The timers folded into spans keep their keys: ``timings``, the fit's
  ``phase_seconds`` and ``phase_steps``, the scan's ``scan_descent_s`` and
  ``scan_guard_s``.
- Under ``torch.profiler`` a span opens a range ``calamity.<name>`` whose
  start lies within 1 ms of the span's own ``time_ns`` stamp.
- ``gpu``: a replay's kernels in the device trace fall inside the
  enclosing ``descent.steps`` span, and a capture's record takes its
  seconds from its ``graph.capture`` span.

No JAX here: the tests on the card run this file as it is.
"""

import sys
import threading
import time
from collections import Counter

import numpy as np
import pytest
import torch

from calamity_tpu_torch import calibration as tcal
from calamity_tpu_torch import simulate
from calamity_tpu_torch._device import SPANS, SpanRecorder
from calamity_tpu_torch.parallel import batched as tb
from calamity_tpu_torch.solver import fit as tfit
from calamity_tpu_torch.solver import graph

NANTS, NFREQS, NGRPS, NVECS = 4, 16, 6, 3


def _problem(nbatch=None, device="cpu", seed=0):
    """A tiny dense chunk: (chunks, data_r, data_i, wgts, g_r, g_i, fg_r,
    fg_i), with a leading slice axis of ``nbatch`` where given."""
    gen = torch.Generator().manual_seed(seed)
    lead = () if nbatch is None else (nbatch,)
    comps = torch.randn(NGRPS, 1, NFREQS, NVECS, generator=gen)
    a0 = torch.tensor([[0], [0], [0], [1], [1], [2]], dtype=torch.int32)
    a1 = torch.tensor([[1], [2], [3], [2], [3], [3]], dtype=torch.int32)
    chunks = ((comps.to(device), a0.to(device), a1.to(device)),)

    def rand(*shape):
        return torch.randn(*lead, *shape, generator=gen).to(device)

    data_r, data_i = [rand(NGRPS, 1, NFREQS)], [rand(NGRPS, 1, NFREQS)]
    wgts = [torch.ones(*lead, NGRPS, 1, NFREQS, device=device) / (NGRPS * NFREQS)]
    g_r = torch.ones(*lead, NANTS, NFREQS, device=device)
    g_i = torch.zeros(*lead, NANTS, NFREQS, device=device)
    fg_r = [torch.zeros(*lead, NGRPS, NVECS, device=device)]
    fg_i = [torch.zeros(*lead, NGRPS, NVECS, device=device)]
    return chunks, data_r, data_i, wgts, g_r, g_i, fg_r, fg_i


def _tree():
    """The recorded spans: {index: span}, and Counter of (name, parent's
    name) pairs."""
    recs = {r.index: r for r in SPANS.records()}
    pairs = Counter((r.name, recs[r.parent].name if r.parent in recs else None)
                    for r in recs.values())
    return recs, pairs


def _check_fits(recs, nfits, nphases):
    """Every span of a fit carries the fit's id, every span is closed, and
    the fits hold ``nphases`` phases between them."""
    fits = [r for r in recs.values() if r.name == "fit"]
    assert len(fits) == nfits
    for f in fits:
        assert f.fit == f.index and f.notes["profiled"] is False
        assert "allocator_calls" not in f.notes  # counted on CUDA only
    ids = {f.index for f in fits}
    for r in recs.values():
        assert r.end_ns is not None and r.end_ns >= r.start_ns
        if r.parent in recs:
            assert r.fit == (r.index if r.name == "fit" else recs[r.parent].fit)
            assert recs[r.parent].start_ns <= r.start_ns <= r.end_ns <= recs[r.parent].end_ns
    assert sum(r.name == "phase" and r.fit in ids for r in recs.values()) == nphases


# ---------------------------------------------------------------------- #
# the recorder
# ---------------------------------------------------------------------- #
def test_span_parents_fit_ids_joins_and_self_time():
    rec = SpanRecorder()
    with rec.span("outside") as out:
        with rec.fit("cpu") as fit:
            with rec.span("phase") as phase:
                with rec.span("phase", join=True) as joined:
                    assert joined is phase
                with rec.fit("cpu") as inner:
                    assert inner is fit  # a fit inside a fit joins it
                with rec.span("child") as child:
                    time.sleep(0.002)
            with rec.span("other") as other:
                pass
    spans = rec.records()
    assert [s.name for s in spans] == ["outside", "fit", "phase", "child", "other"]
    assert [s.index for s in spans] == [0, 1, 2, 3, 4]
    assert (out.parent, fit.parent, phase.parent, child.parent, other.parent) == (-1, 0, 1, 2, 1)
    assert out.fit == -1 and fit.fit == fit.index == 1
    assert phase.fit == child.fit == other.fit == 1
    assert fit.notes == {"profiled": False}
    self_phase = phase.seconds - child.seconds
    assert 0 <= self_phase < phase.seconds and child.seconds >= 0.002
    assert phase.seconds == (phase.end_ns - phase.start_ns) * 1e-9
    assert rec.dropped == 0


def test_span_closes_on_an_exception():
    rec = SpanRecorder()
    with pytest.raises(ValueError):
        with rec.span("failing"):
            raise ValueError("inside")
    (s,) = rec.records()
    assert s.end_ns is not None
    with rec.span("next") as nxt:
        pass
    assert nxt.parent == -1  # the failed span left the stack


def test_ring_keeps_the_newest_and_counts_the_dropped():
    rec = SpanRecorder(capacity=8)
    with rec.span("open") as first:
        for i in range(20):
            with rec.span(f"s{i}"):
                pass
    spans = rec.records()
    assert len(spans) == 8 and rec.dropped == 13
    assert [s.name for s in spans] == [f"s{i}" for i in range(12, 20)]
    assert all(s.parent == first.index for s in spans)  # its parent is gone from the ring
    assert first.end_ns is not None  # an open span dropped from the ring still closes
    rec.reset()
    assert rec.records() == [] and rec.dropped == 0


def test_each_thread_keeps_its_own_stack():
    rec = SpanRecorder()
    nthreads, depth = 8, 50
    errors = []
    start = threading.Barrier(nthreads + 1)

    def work(k):
        try:
            start.wait(timeout=10)
            for _ in range(depth):
                with rec.span(f"t{k}") as outer:
                    with rec.span(f"t{k}.inner") as inner:
                        assert inner.parent == outer.index and inner.thread == outer.thread
                    assert outer.parent == -1
        except Exception as exc:  # noqa: BLE001 (reported below)
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with rec.span("main") as main:
            threads = [threading.Thread(target=work, args=(k,)) for k in range(nthreads)]
            for t in threads:
                t.start()
            start.wait(timeout=10)
            for t in threads:
                t.join(timeout=30)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not errors
    spans = rec.records()
    assert len(spans) == 1 + 2 * nthreads * depth
    assert sorted(s.index for s in spans) == list(range(len(spans)))  # no index lost or shared
    assert all(s.parent != main.index for s in spans[1:])


# ---------------------------------------------------------------------- #
# the entry points on the CPU
# ---------------------------------------------------------------------- #
def test_serial_fit_records_its_span_tree_and_phase_seconds():
    chunks, dr, di, w, g_r, g_i, fr, fi = _problem()
    SPANS.reset()
    out = tfit.fit_gains_and_foregrounds(g_r, g_i, tuple(fr), tuple(fi), dr, di, w, chunks,
                                         maxsteps=40, tol=0.0, comps_precision="mixed",
                                         learning_rate=1e-2)
    recs, pairs = _tree()
    _check_fits(recs, nfits=1, nphases=2)
    assert pairs[("comps.convert", "fit")] == 1
    assert pairs[("phase", "fit")] == 2
    assert pairs[("phase.entry", "phase")] == 2
    # 1 warm-up step and 40 recorded steps, then 40: blocks of up to 16
    assert pairs[("descent.steps", "phase")] == 1 + 3 + 3
    assert pairs[("descent.poll", "descent.steps")] == 7
    assert pairs[("phase.readback", "phase")] == 3
    # the bfloat16 phase's graph goes as the float32 phase starts; the last with the fit
    assert pairs[("graph.release", "phase")] == 1 and pairs[("graph.release", "fit")] == 1
    hist = out[4]
    phases = sorted((r for r in recs.values() if r.name == "phase"), key=lambda r: r.index)
    assert hist["phase_seconds"] == [p.seconds for p in phases]
    assert hist["phase_steps"] == [40, 40] and len(hist["loss"]) == 80


@pytest.mark.parametrize("entry", ["core", "checkpointed", "scan"])
def test_batched_entry_points_record_their_span_trees(entry, tmp_path):
    chunks, dr, di, w, g_r, g_i, fr, fi = _problem(nbatch=2)
    cfg = tfit.FitConfig(maxsteps=20, tol=0.0, opt_kwargs=(("learning_rate", 1e-2),))
    prior = torch.zeros(2)
    SPANS.reset()
    if entry == "core":
        res = tb.batched_fit_core(cfg, chunks, dr, di, w, g_r, g_i, fr, fi, prior, prior,
                                  poll_every=graph.POLL_EVERY)
        assert int(res.nsteps) == 20
        nfits = 1
    elif entry == "checkpointed":
        res = tb.batched_fit_checkpointed(cfg, chunks, dr, di, w, g_r, g_i, fr, fi, prior, prior,
                                          str(tmp_path), 10, False, False,
                                          poll_every=graph.POLL_EVERY,
                                          expected_loss_fn=lambda p: np.full(2, np.nan))
        assert int(res.nsteps) == 20
        nfits = 1
    else:
        params, hist, nsteps, _ = tb.scanned_warmstart_fit_core(
            cfg, chunks, dr, di, w, g_r[0], g_i[0], [f[0] for f in fr], [f[0] for f in fi],
            prior, prior, expected_loss_fn=lambda t, *a: np.full(1, np.nan),
            poll_every=graph.POLL_EVERY)
        assert list(nsteps) == [20, 20]
        nfits = 2  # one a time
    recs, pairs = _tree()
    _check_fits(recs, nfits=nfits, nphases=nfits)
    assert pairs[("phase", "fit")] == nfits
    assert pairs[("phase.entry", "phase")] >= nfits
    assert pairs[("descent.steps", "phase")] >= 2 * nfits
    assert pairs[("descent.poll", "descent.steps")] == pairs[("descent.steps", "phase")]
    assert pairs[("phase.readback", "phase")] >= nfits
    assert pairs[("graph.release", "phase")] == nfits
    # the scan's guard is the span loss_guard; a guard passed in is the caller's to name
    assert pairs[("loss_guard", "phase")] == (nfits if entry == "scan" else 0)


def test_calibration_stages_are_spans_with_todays_timings_keys():
    uvd = simulate.make_golomb_array(nants=4, nfreqs=32, ntimes=2, seed=3)
    kw = dict(min_dly=2.0 / 0.3, offset=2.0 / 0.3, maxsteps=20, tol=0.0, learning_rate=1e-2,
              model_regularization="post_hoc", device="cpu")
    SPANS.reset()
    timings = {}
    _, _, _, hist = tcal.calibrate_and_model_dpss(uvdata=uvd, timings=timings, **kw)
    keys = {"basis_s", "packing_s", "pack_data_s", "warm_start_s", "fit_s", "writeback_s",
            "finalize_s"}
    assert keys <= set(timings) and all(isinstance(timings[k], float) for k in keys)
    recs, pairs = _tree()
    stages = Counter(r.name for r in recs.values() if r.name.startswith("calibration."))
    assert stages == {"calibration.basis_s": 1, "calibration.packing_s": 1,
                      "calibration.pack_data_s": 2, "calibration.warm_start_s": 2,
                      "calibration.fit_s": 2, "calibration.writeback_s": 2,
                      "calibration.finalize_s": 1}
    for key in keys:
        spans = [r for r in recs.values() if r.name == f"calibration.{key}"]
        assert timings[key] == pytest.approx(sum(s.seconds for s in spans), rel=1e-12)
    assert pairs[("fit", "calibration.fit_s")] == 2
    assert pairs[("pack.fitspec", "calibration.packing_s")] == 1
    assert pairs[("pack.slice", "calibration.pack_data_s")] == 2
    assert pairs[("pack.warm_start", "calibration.warm_start_s")] == 4  # real and imaginary
    entry = hist[0][0]
    assert len(entry["phase_seconds"]) == 2 and entry["phase_steps"] == [20, 20]

    SPANS.reset()
    timings = {}
    tcal.calibrate_and_model_dpss(uvdata=uvd, timings=timings, time_parallel=True, **kw)
    assert {"extract_s", "upload_s", "warmstart_s", "descent_s", "writeback_s",
            "loss_guard_s"} <= set(timings)
    assert timings["phase_steps"] == [20, 20] and len(timings["phase_seconds"]) == 2
    recs, pairs = _tree()
    _check_fits(recs, nfits=1, nphases=2)  # both phases of the mixed schedule: one fit
    assert pairs[("fit", "calibration.descent_s")] == 1
    assert pairs[("comps.convert", "fit")] == 1
    assert pairs[("loss_guard", "phase")] == 2
    guards = [r for r in recs.values() if r.name == "loss_guard"]
    assert timings["loss_guard_s"] == pytest.approx(sum(g.seconds for g in guards), rel=1e-12)
    assert sum(r.name == "pack.slice" for r in recs.values()) == 2  # one a slice

    timings = {}
    tcal.calibrate_and_model_dpss(uvdata=uvd, timings=timings, time_parallel=True,
                                  init_guesses_from_previous_time_step=True, **kw)
    assert {"scan_upload_s", "scan_descent_s", "scan_guard_s", "scan_fetch_s",
            "writeback_s"} <= set(timings)


def test_spans_show_in_the_profilers_timeline_on_its_clock():
    rec = SpanRecorder()
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with rec.fit("cpu") as fit:
            for _ in range(3):
                with rec.span("descent.steps"):
                    torch.ones(8).sum()
    assert fit.notes["profiled"] is True
    events = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("calamity.")}
    spans = rec.records()
    assert set(events) == {"calamity.fit", "calamity.descent.steps"}
    starts = sorted(e.start_ns() for e in prof.profiler.kineto_results.events()
                    if e.name() == "calamity.descent.steps")
    for span, start in zip([s for s in spans if s.name == "descent.steps"], starts):
        assert abs(start - span.start_ns) < 1_000_000
    assert abs(events["calamity.fit"].start_ns() - fit.start_ns) < 1_000_000


# ---------------------------------------------------------------------- #
# on a card
# ---------------------------------------------------------------------- #
def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs and the device trace have no CPU mode")


@pytest.mark.gpu
def test_cuda_replays_fall_inside_their_descent_steps_spans():
    _need_cuda()
    chunks, dr, di, w, g_r, g_i, fr, fi = _problem(device="cuda")
    args = (g_r, g_i, tuple(fr), tuple(fi), dr, di, w, chunks)
    kw = dict(maxsteps=64, tol=0.0, comps_precision="float32", learning_rate=1e-2)
    tfit.fit_gains_and_foregrounds(*args, **kw)  # builds and warms every kernel
    ncap = len(graph.CAPTURES)
    SPANS.reset()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        tfit.fit_gains_and_foregrounds(*args, **kw)
        torch.cuda.synchronize()
    recs = SPANS.records()
    (cap,) = [r for r in recs if r.name == "graph.capture"]
    assert graph.CAPTURES[ncap]["seconds"] == cap.seconds
    assert set(graph.CAPTURES[ncap]) == {"name", "seconds", "pool_bytes", "replays"}
    (fit,) = [r for r in recs if r.name == "fit"]
    assert fit.notes["profiled"] is True and len(fit.notes["allocator_calls"]) == 2
    blocks = [r for r in recs if r.name == "descent.steps"]
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in prof.profiler.kineto_results.events()
               if e.device_type() == cuda and not e.is_user_annotation()]
    assert kernels
    # a block's replays run on the device before its poll reads their
    # result: every kernel of the fit lies inside the fit's span, and every
    # kernel that starts inside a block's span ends inside it too
    for e in kernels:
        assert fit.start_ns <= e.start_ns() and e.start_ns() + e.duration_ns() <= fit.end_ns
    inside = 0
    for b in blocks:
        for e in kernels:
            if b.start_ns <= e.start_ns() <= b.end_ns:
                assert e.start_ns() + e.duration_ns() <= b.end_ns
                inside += 1
    assert inside >= len(blocks)
