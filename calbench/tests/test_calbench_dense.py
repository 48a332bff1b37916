"""The cell ``hera_core.dense`` and what it adds: the configuration with
per-baseline bases, the dense loss kernel's frozen count
(``dense_layout.py``) and the readers of ``dense_loss_ms``,
``dense_loss_roofline`` and ``dense_pack_s``."""

import importlib.util
import json
import os
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from calbench_cuts import CUT_LIMITS, ROOT, SEED

from calbench import arrays, dense_layout, dpss, harness, layout, spans, trace

NAME = "hera_core.dense"
# the core's cut, as hera_core.fit1's: the grid at 5 x 5, 64 channels,
# 300 steps a phase (sound: start_rel 5.1e-7, end_rel 8.5e-6, resid_ratio
# 1.66e-4)
CUT = dict(array={"nside": 5}, nfreqs=64, steps=300, warmup_steps=3,
           limits={**CUT_LIMITS, "resid_ratio": 4e-4})
NEW = ("dense_loss_ms", "dense_loss_roofline", "dense_pack_s")


def metric(name):
    path = os.path.join(ROOT, "calbench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"calbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def load(*parts):
    return json.load(open(os.path.join(ROOT, *parts)))


def test_configuration_is_the_core_with_per_baseline_bases():
    core, dense = load("calbench", "configs", "hera_core.json"), \
        load("calbench", "configs", "hera_core_dense.json")
    differ = {k for k in core if core[k] != dense[k]}
    assert differ == {"name", "source", "deployment", "basis"}
    assert {k: v for k, v in core["basis"].items() if dense["basis"][k] != v} == \
        {"shared_basis": True}
    assert dense["basis"]["shared_basis"] is False
    cell = harness.Cell(NAME)
    assert cell.entry["chips"] == 1 and cell.traffic == load("calbench", "traffic", "fit1.json")
    fit1 = load("calbench", "cells", "hera_core.fit1.json")
    for key in ("steps_per_phase", "warmup_steps", "checked_steps"):
        assert cell.cell[key] == fit1[key]
    assert {m["name"] for m in cell.per_layer} >= set(NEW)
    # the shared packing's kernels and counts are not this cell's
    assert not {m["name"] for m in cell.per_layer} & {
        "shared_loss_ms", "shared_loss_roofline", "gain_kernels_roofline", "adamax_roofline",
        "other_kernels_ms"}


@pytest.mark.parametrize("traced", [False, True])
def test_rehearsal_prints_the_contracts_line(traced):
    code, res = harness.run(NAME, SEED, 0.0, traced, time.perf_counter(), device="cpu",
                            overrides=CUT)
    assert code == 0
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "compared"]
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] == 1
    if traced:
        # on the CPU only the host's clock reads: the device's and the spans' readers
        # find nothing
        assert set(res["metrics"]) == {"pack_s"}
    else:
        assert set(res["metrics"]) == {"slice_s", "peak_gib", "resid_ratio", "setup_s"}
    for v in res["compared"].values():
        assert v["value"] <= v["limit"]
    json.dumps(res)


@pytest.fixture(scope="module")
def core_chunks():
    """The full core's frozen layout, as the harness builds it, and its dense chunks."""
    cfg = load("calbench", "configs", "hera_core_dense.json")
    dep = arrays.build(cfg)
    nvecs = [a.shape[1] for a in dpss.operators(dep.freqs, dep.op_dly_ns)]
    sizes = np.bincount(dep.op_of_bl)
    return layout.chunks(nvecs, sizes), dense_layout.chunks(nvecs, sizes), dep


def test_dense_count_gives_each_baseline_its_operators_modes(core_chunks):
    _, dense, dep = core_chunks
    assert dense == [(684, 29), (648, 35), (646, 45), (1224, 49), (578, 58), (304, 61),
                     (304, 61)]
    assert sum(c.groups for c in dense) == dep.nbls == 4388
    # the same operators as the configuration's own, read as the reader reads them
    nvecs, sizes = dense_layout.operators(dense_layout.CONFIG)
    assert dense_layout.chunks(nvecs, sizes) == dense


def meta_args(chunk, nbatch, nfreqs, comps_dtype, wgts_dtype):
    """The dense kernel's operands at a chunk's shapes, as the smoke test lays them out."""
    def t(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    g, v = chunk.groups, chunk.nvecs
    planes = [t(nbatch, g, nfreqs) for _ in range(4)]
    return [t(2, nbatch, g, v), *planes, t(nbatch, g, nfreqs, dtype=wgts_dtype),
            t(g, nfreqs, v, dtype=comps_dtype)]


@pytest.mark.parametrize("nbatch", [1, 8])
@pytest.mark.parametrize("comps_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("wgts_dtype", [torch.float32, torch.bfloat16])
def test_dense_count_reproduces_the_smoke_tests_bound(core_chunks, nbatch, comps_dtype,
                                                      wgts_dtype):
    import chip_smoke

    _, dense, dep = core_chunks
    for c in dense:
        want = chip_smoke.bound(meta_args(c, nbatch, dep.nfreqs, comps_dtype, wgts_dtype), True)
        got = dense_layout.loss_ms(c, nbatch, dep.nfreqs, comps_dtype.itemsize,
                                   wgts_dtype.itemsize)
        assert got == pytest.approx(want[0], rel=1e-12)


def test_dense_step_bound_of_the_core(core_chunks):
    _, dense, dep = core_chunks
    ms = [sum(dense_layout.loss_ms(c, 1, dep.nfreqs, size, 4) for c in dense)
          for size in (4, 2)]
    assert [round(x, 4) for x in ms] == [0.4281, 0.2427]
    # the port's packed bases (684 x 29 and 3704 x 61 modes) against the least
    cols = sum(c.groups * c.nvecs for c in dense)
    assert cols == 202174
    assert (684 * 29 + 3704 * 61) / cols == pytest.approx(1.216, abs=5e-4)


def traced_run(frozen, seconds, count=8):
    """A run of the cell as the readers see it: the loss kernel's time in
    the trace, 1000 recorded steps a phase, the first phase's comps in
    bfloat16 and a warm-up step."""
    by_name = {"void_fused_chunk_loss_kernel<float>": (seconds, count),
               "gain_grad_segments": (0.5, count)}
    tr = trace.Trace(window_s=4.0, busy_s=3.0, ops=100, by_name=by_name, idle_by_host={})
    phases = [dict(comps_itemsize=2, recorded=1000, loss_steps=1001),
              dict(comps_itemsize=4, recorded=1000, loss_steps=1000)]
    return SimpleNamespace(trace=tr, steps=2000, phases=phases, chunks=frozen, nbatch=1,
                           nfreqs=1536, wgts_itemsize=4)


def test_loss_readers_read_the_kernel(core_chunks):
    frozen, _, _ = core_chunks
    run = traced_run(frozen, 1.0)
    assert metric("dense_loss_ms")(run) == pytest.approx(0.5)
    bound = 1001 * 0.24269625194 + 1000 * 0.42809282746  # ms
    assert metric("dense_loss_roofline")(run) == pytest.approx(100 * bound / 1000, rel=1e-9)


def test_loss_readers_read_nothing_where_the_kernel_is_not(core_chunks):
    frozen, _, _ = core_chunks
    run = traced_run(frozen, 1.0)
    run.trace.by_name.pop("void_fused_chunk_loss_kernel<float>")
    for name in ("dense_loss_ms", "dense_loss_roofline"):
        assert metric(name)(run) is None
        assert metric(name)(SimpleNamespace(trace=None)) is None


def cut_layout(nside, nfreqs):
    cfg = load("calbench", "configs", "hera_core_dense.json")
    cfg["array"]["nside"] = nside
    dep = arrays.build(cfg, nfreqs)
    nvecs = [a.shape[1] for a in dpss.operators(dep.freqs, dep.op_dly_ns)]
    return layout.chunks(nvecs, np.bincount(dep.op_of_bl))


def test_roofline_reads_nothing_where_the_layout_is_not_the_configurations(core_chunks):
    frozen, _, _ = core_chunks
    # the core's CPU cut (5 x 5 antennas), or a layout of other operators: the count
    # is not frozen for either
    run = traced_run(cut_layout(5, 64), 1.0)
    run.nfreqs = 64
    assert metric("dense_loss_roofline")(run) is None
    assert metric("dense_loss_ms")(run) == pytest.approx(0.5)
    run = traced_run(frozen[1:], 1.0)
    assert metric("dense_loss_roofline")(run) is None
    # the whole core at fewer channels is the configuration's deployment: counted
    run = traced_run(cut_layout(19, 64), 1.0)
    run.nfreqs = 64
    assert 0 < metric("dense_loss_roofline")(run) < 100


def span(name, start_ms, end_ms, **notes):
    return SimpleNamespace(name=name, start_ns=start_ms * 1_000_000,
                           end_ns=None if end_ms is None else end_ms * 1_000_000, notes=notes)


def test_dense_pack_reader(monkeypatch):
    read, card = metric("dense_pack_s"), SimpleNamespace(trace=object())
    ring = [span("pack.fitspec", 0, 3000), span("pack.dense", 10, 410, groups=684),
            span("pack.dense", 410, 2410, groups=3704), span("pack.slice", 3000, 3400),
            span("pack.dense", 5000, None)]  # still open: not read
    monkeypatch.setattr(spans, "records", lambda: ring)
    assert read(card) == pytest.approx(2.4)
    assert read(SimpleNamespace(trace=None)) is None  # a run with no device trace
    # a port that packs no dense chunk (every shared cell), or records no spans
    monkeypatch.setattr(spans, "records", lambda: [r for r in ring if r.name != "pack.dense"])
    assert read(card) is None
    monkeypatch.setattr(spans, "records", lambda: None)
    assert read(card) is None


@pytest.mark.gpu
def test_cell_runs_correct_on_the_card_at_its_cut():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    code, res = harness.run(NAME, SEED, 1.0, False, time.perf_counter(), overrides=CUT)
    assert code == 0 and res["correct"] and res["device"]["platform"] == "gpu"
