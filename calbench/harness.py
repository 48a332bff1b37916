"""One run of a calbench cell: set-up, the measured window, the comparison, the result.

A cell (``BENCHMARK.json``'s ``workloads`` entry and ``cells/<name>.json``)
names a configuration (``configs/<config>.json``: the deployment) and a
traffic mix (``traffic/<traffic>.json``: which slices a fit takes, flags,
weights); its end-to-end and per-layer metrics are the entries of
``BENCHMARK.json`` that apply to it, each per-layer metric read by
``metrics/<name>.py``. A run:

1. builds the deployment and its DPSS bases, the configuration's sky, the
   mix's flags and, from ``--seed``, every slice's gains (:mod:`sky`), and
   hands them to the port as its ``VisData`` and component dict;
2. sets the port up as its calibration entry points do (:mod:`program`: ``FitSpec``, the
   packing and warm start of every slice; ``pack_s``), and runs one short
   fit of every kind of step the window runs, so that nothing builds,
   loads or warms up inside the window; ``setup_s`` is the process's
   seconds until then;
3. runs fits back to back until a fit ends at or after ``--seconds``
   (``slice_s``: the window's seconds over the slices its fits finished;
   ``peak_gib``: the allocator's peak since the port's set-up began); with
   ``--trace 1`` the window's first fit runs under ``torch.profiler``
   (:mod:`trace`);
4. frees the port's state and judges the last fit of each slice with the
   plain reference (:mod:`reference`): the first recorded losses of the
   bfloat16 phase against the reference's own steps from its own warm
   start (``start_rel``, the mean over the slices, and ``start_rel_max``,
   the largest), the best loss of the float32 phase against the
   reference's chi-square at the returned parameters (``end_rel``), and
   the fit's quality by that chi-square's residual over the data
   (``resid_ratio``, the largest over the slices), which a float32 phase
   that moves nothing cannot reach; every fit must take exactly the cell's
   steps a phase (``steps_off``);
5. prints the numbers compared beside their limits on standard error, then
   one JSON line on standard output.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from calbench import arrays, dpss, layout, program, reference, sky, trace

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "calamity_tpu")  # top-level module names
T_FIRST = 2459122.25  # Julian date of the first slice
DT_DAYS = 10.7 / 86400.0  # between slices
GIB = 2.0 ** 30
SMI_CLOCKS = "clocks.sm,clocks.mem,temperature.gpu,power.draw"


def load_json(path):
    with open(path) as fh:
        return json.load(fh)


class Cell:
    """A workload of ``BENCHMARK.json`` with its files."""

    def __init__(self, name, root=ROOT):
        bench = load_json(os.path.join(root, "BENCHMARK.json"))
        entries = [w for w in bench["workloads"] if w["name"] == name]
        if not entries:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        self.name, self.entry = name, entries[0]
        self.cell = load_json(os.path.join(HERE, "cells", f"{name}.json"))
        for key in ("config", "traffic"):
            if self.cell[key] != self.entry[key]:
                raise SystemExit(f"cells/{name}.json: {key} {self.cell[key]!r} is not "
                                 f"BENCHMARK.json's {self.entry[key]!r}")
        conf = [c for c in bench["configs"] if c["name"] == self.entry["config"]][0]
        self.config = load_json(os.path.join(root, conf["file"]))
        self.traffic = load_json(os.path.join(HERE, "traffic", f"{self.entry['traffic']}.json"))
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        names = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name] if m["moves"] in names else [])]


# ---------------------------------------------------------------------- #
# set-up
# ---------------------------------------------------------------------- #
def setup(cell, seed, device, overrides=None, log=print):
    """Inputs from ``seed``, handed to the port and packed. ``overrides``
    (CPU rehearsals only) replaces config ``array`` keys, ``nfreqs``,
    ``steps`` and ``warmup_steps`` (and, in :func:`run`, the cell's
    ``limits``). Returns the run's context."""
    ov = dict(overrides or {})
    cfg = json.loads(json.dumps(cell.config))
    cfg["array"].update(ov.get("array", {}))
    tr = cell.traffic
    steps = int(ov.get("steps", cell.cell["steps_per_phase"]))
    dev = torch.device(device)
    dep = arrays.build(cfg, ov.get("nfreqs"))
    ops_host = dpss.operators(dep.freqs, dep.op_dly_ns, cutoff=cfg["basis"]["eigenval_cutoff"])
    ops = [torch.as_tensor(a, device=dev) for a in ops_host]
    nslices = int(tr["slices"])
    flags = (sky.rfi_channels(tr["rfi_seed"], dep.nfreqs, tr["rfi_flag_frac"])
             if tr["rfi_flag_frac"] else np.zeros(dep.nfreqs, dtype=bool))
    vis = sky.unique_vis(dep, sky.draw_sky(cfg["sky"]["seed"], cfg["sky"]["nsrc"]), ops, dev)
    gains = sky.draw_gains(seed, nslices, dep.nants, dep.nfreqs, cfg["sky"]["gain_sigma"], dev)
    data = np.empty((nslices * dep.nbls, dep.nfreqs), dtype=np.dtype(cfg["data_dtype"]))
    for t in range(nslices):
        sky.slice_into(dep, vis, gains[t], data[t * dep.nbls:(t + 1) * dep.nbls])
    del vis, gains
    times = T_FIRST + DT_DAYS * np.arange(nslices)
    ctx = SimpleNamespace(cell=cell, seed=seed, device=dev, dep=dep, ops=ops,
                          nvecs=[a.shape[1] for a in ops_host], flags=flags, steps=steps,
                          data_ref=data.copy(), nslices=nslices, mode=tr["mode"],
                          wgts_precision=tr["wgts_precision"],
                          learning_rate=float(cfg["fit"]["learning_rate"]))
    uvd = program.visdata(dep, data, flags, cfg["site"], times)
    comps = program.comps_dict(dep, ops_host)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    ctx.fits = program.Fits(uvd, comps, times, tr["mode"], steps, tr["wgts_precision"], dev,
                            cfg["fit"], cfg["basis"])
    ctx.pack_s = time.perf_counter() - t0
    ctx.layout = ctx.fits.layout()
    ctx.chunks = layout.chunks(ctx.nvecs, np.bincount(dep.op_of_bl, minlength=len(ops)))
    log(f"calbench: {cell.name}: {dep.nants} antennas, {dep.nbls} baselines, "
        f"{len(ops)} operators, {dep.nfreqs} channels, {nslices} slices, "
        f"{int(flags.sum())} channels flagged; {len(ctx.chunks)} chunks; packed in "
        f"{ctx.pack_s:.3f} s")
    hold_collector()
    return ctx


def hold_collector():
    """Python's cycle collector held off from here and run between fits
    only (:func:`window`): a fit's descents hold their graphs in reference
    cycles, so when the collector frees them otherwise follows the
    interpreter's allocation counts, and with it the card's peak memory
    and the allocator's work in the next fit. The set-up's objects are
    frozen out of the collections."""
    gc.collect()
    gc.freeze()
    gc.disable()


def release_collector():
    gc.unfreeze()
    gc.enable()
    gc.collect()


def warm_up(ctx, overrides=None):
    """One short fit of the cell's kind: every kernel and graph of the
    window's step built and run once, off the window."""
    steps = int((overrides or {}).get("warmup_steps", ctx.cell.cell["warmup_steps"]))
    gc.collect()
    ctx.fits.fit(0, steps=steps)


# ---------------------------------------------------------------------- #
# the window
# ---------------------------------------------------------------------- #
def window(ctx, seconds, traced=False, min_fits=1):
    """Fits back to back until one ends at or after ``seconds``, at least
    ``min_fits`` of them. Returns
    (window seconds, each fit's seconds, the last output of each slice as
    {slice: (FitOut, row)}, fits whose steps were not the cap, the
    profiled fit's (FitOut, profiler) or None). The cycle collector runs
    before each fit (:func:`hold_collector`)."""
    last, off, prof, fit_s = {}, [], None, []
    t0 = time.perf_counter()
    k = 0
    while True:
        t1 = time.perf_counter()
        # a slice's last output goes before its next fit, so that the
        # card holds as many outputs in every fit after the first
        for s in ctx.fits.slices_of(k):
            last.pop(s, None)
        gc.collect()
        if traced and k == 0:
            out, p = trace.profiled(lambda: ctx.fits.fit(0))
            prof = (out, p)
        else:
            out = ctx.fits.fit(k)
        fit_s.append(time.perf_counter() - t1)
        k += 1
        for row, s in enumerate(out.slices):
            last[s] = (out, row)
            if any(int(n[row]) != ctx.steps for n in out.steps):
                off.append(s)
        if k >= min_fits and time.perf_counter() - t0 >= seconds:
            break
    return time.perf_counter() - t0, fit_s, last, off, prof


# ---------------------------------------------------------------------- #
# the comparison
# ---------------------------------------------------------------------- #
def claimed_loss(hist):
    """The loss that the last phase's history claims for the parameters a
    fit returns, and whether the history holds it: those are the
    parameters after the best step's update, whose loss the next step
    records. Where the best step is the last, the history's own next
    decrease, extrapolated from its last two (a geometric step, the loss
    still falling smoothly), is taken off its last loss."""
    best = int(np.argmin(hist))
    if best + 1 < len(hist):
        return float(hist[best + 1]), True
    if len(hist) >= 3:
        d1, d0 = hist[-2] - hist[-1], hist[-3] - hist[-2]
        if d1 > 0 and d0 > 0:
            return float(hist[-1] - d1 * d1 / d0), False
    return float(hist[-1]), False


def compare(ctx, last, control=False, log=print):
    """Per slice (start_rel, end_rel, resid_ratio) of its last fit; with
    ``control`` the control's readings at the same points."""
    k = int(ctx.cell.cell["checked_steps"])
    rows = {}
    for s in sorted(last):
        out, row = last[s]
        sl = reference.make_slice(ctx.dep, ctx.data_ref[s * ctx.dep.nbls:(s + 1) * ctx.dep.nbls],
                                  ctx.flags, ctx.wgts_precision, ctx.device)
        h_ref = reference.follow(sl, ctx.ops, k, lr=ctx.learning_rate)
        c_r, c_i = reference.gather(ctx.dep, ctx.nvecs, ctx.layout, out.fg_r, out.fg_i, row)
        loss, resid = reference.judge(sl, ctx.ops, out.g_r[row], out.g_i[row], c_r, c_i)
        if control:
            h_got = reference.follow(sl, ctx.ops, k, control=True, lr=ctx.learning_rate)
            claimed = reference.judge(sl, ctx.ops, out.g_r[row], out.g_i[row], c_r, c_i,
                                      control=True)[0]
            exact = True
        else:
            h_got = out.hist[0][:k, row]
            claimed, exact = claimed_loss(out.hist[1][:, row])
        start = (float(np.max(np.abs(h_got - h_ref) / h_ref)) if len(h_got) == k
                 else float("inf"))
        end = abs(claimed - loss) / loss
        rows[s] = (start, end, resid)
        log(f"calbench: slice {s}: first losses {[float(x) for x in h_got]} against "
            f"{[float(x) for x in h_ref]}; claimed loss {claimed!r} "
            f"({'recorded' if exact else 'extrapolated one step'}) against {loss!r}; "
            f"resid/data {resid!r}; the last phase's last losses "
            f"{[float(x) for x in out.hist[-1][-3:, row]]}")
        del sl
    return rows


NUMBERS = ("start_rel", "start_rel_max", "end_rel", "resid_ratio")


def numbers(rows):
    """The run's numbers compared (:data:`NUMBERS`), from :func:`compare`'s
    rows: ``start_rel``, the mean over the slices of each slice's largest
    relative gap over the first recorded losses (a slice alone can read its
    rounding's two effects, the floor it adds and the step it moves,
    cancelling), ``start_rel_max``, the largest of those gaps (a fault in
    one slice of many), and ``end_rel`` and ``resid_ratio``, the largest
    over the slices."""
    start = [r[0] for r in rows.values()]
    return {"start_rel": float(np.mean(start)), "start_rel_max": max(start),
            "end_rel": max(r[1] for r in rows.values()),
            "resid_ratio": max(r[2] for r in rows.values())}


def failed_slices(rows, limits):
    """The slices whose own numbers pass a limit; every slice where the
    mean ``start_rel`` does."""
    bad = {s for s, (start, end, resid) in rows.items()
           if not (start <= limits["start_rel_max"] and end <= limits["end_rel"]
                   and resid <= limits["resid_ratio"])}
    if not numbers(rows)["start_rel"] <= limits["start_rel"]:
        bad |= set(rows)
    return bad


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


# ---------------------------------------------------------------------- #
# the metrics
# ---------------------------------------------------------------------- #
def schedule(ctx, out):
    """The profiled fit's phases: per phase its comps itemsize, recorded
    steps, the steps that ran the loss and the gain kernels (the batched
    descent takes a warm-up step each phase, the serial one in its first),
    the steps that ran the Adamax update (the batched warm-up steps run the
    optimizer's torch ops) and the (row, step) updates whose loss improved
    on the phase's best."""
    serial = ctx.mode == "serial"
    phases = []
    for p, h in enumerate(out.hist):
        rec = h.shape[0]
        best = np.minimum.accumulate(np.vstack([np.full((1, h.shape[1]), np.inf), h]), axis=0)
        improved = int(np.sum(h < best[:-1]))
        warm = 1 if (not serial or p == 0) else 0
        adamax_warm = 1 if (serial and p == 0) else 0
        phases.append(dict(comps_itemsize=2 if p == 0 else 4, recorded=rec,
                           loss_steps=rec + warm, adamax_steps=rec + adamax_warm,
                           improved=improved + adamax_warm * h.shape[1]))
    return phases


def per_layer_metrics(ctx, cell, prof):
    out, p = prof
    tr = trace.reduce(p) if ctx.device.type == "cuda" else None
    run = SimpleNamespace(
        mode=ctx.mode, trace=tr, nbatch=len(out.slices), nants=ctx.dep.nants,
        nfreqs=ctx.dep.nfreqs, chunks=ctx.chunks, phases=schedule(ctx, out),
        steps=sum(h.shape[0] for h in out.hist),
        wgts_itemsize=2 if (ctx.wgts_precision == "bfloat16" and ctx.flags.any()) else 4,
        pack_s=ctx.pack_s)
    metrics = {}
    for m in cell.per_layer:
        path = os.path.join(HERE, "metrics", f"{m['name']}.py")
        spec = importlib.util.spec_from_file_location(f"calbench_metric_{len(metrics)}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        value = mod.read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return metrics, tr


def nvidia_smi(query="name,power.limit"):
    try:
        res = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return res.stdout.strip().splitlines()[0] if res.returncode == 0 else "nvidia-smi failed"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "nvidia-smi unavailable"


def rss_gib():
    with open("/proc/self/status") as fh:
        for line in fh:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 2 ** 20
    return float("nan")


# ---------------------------------------------------------------------- #
def run(name, seed, seconds, traced, t_process, device="cuda", overrides=None, root=ROOT):
    """One run; returns (exit code, the result dict or None)."""
    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    cell = Cell(name, root)
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.entry["chips"]:
            log(f"calbench: {name} needs {cell.entry['chips']} CUDA card(s); this machine has "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            return 2, None
        log(f"calbench: {nvidia_smi()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    ctx = setup(cell, seed, dev, overrides, log)
    warm_up(ctx, overrides)
    setup_s = time.perf_counter() - t_process
    n_cap0, s_cap0 = program.captures()
    launches0 = program.launches()
    window_s, fit_s, last, off, prof = window(ctx, seconds, traced)
    nfits = len(fit_s)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    n_cap, s_cap = program.captures()
    launches = {k: v - launches0.get(k, 0) for k, v in program.launches().items()}
    per_fit = len(next(iter(last.values()))[0].slices)
    attempted = nfits * per_fit
    log(f"calbench: window {window_s:.3f} s, {nfits} fits of {ctx.steps} steps a phase, "
        f"{attempted} slices; captures {n_cap - n_cap0} in {s_cap - s_cap0:.3f} s; launches "
        f"{launches}; host RSS {rss_gib():.2f} GiB; setup {setup_s:.3f} s; fits "
        f"{[round(x, 4) for x in fit_s]} s")
    if dev.type == "cuda":
        log(f"calbench: after the window: {nvidia_smi(SMI_CLOCKS)} ({SMI_CLOCKS})")
    metrics = {}
    tr = None
    if traced:
        metrics, tr = per_layer_metrics(ctx, cell, prof)
        prof = None
    ctx.fits.close()
    ctx.fits = None
    release_collector()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    rows = compare(ctx, last, log=log)
    limits = (overrides or {}).get("limits", cell.cell["limits"])
    got = numbers(rows)
    failed = len(set(off) | failed_slices(rows, limits))
    found = forbidden_modules()
    if found:
        log(f"calbench: modules loaded that the run must not load: {found}")
        return 3, None
    if not traced:
        values = {"slice_s": window_s / attempted, "peak_gib": peak / GIB,
                  "resid_ratio": got["resid_ratio"], "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}
    compared = {k: {"value": got[k], "limit": limits[k]} for k in NUMBERS}
    compared["steps_off"] = {"value": len(off), "limit": 0}
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type,
              "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": failed == 0 and all(np.isfinite(v["value"]) for v in compared.values()),
              "attempted": attempted, "failed": failed, "metrics": metrics, "device": device}
    if traced and tr is not None:
        device.update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = trace.breakdown(tr)
    result["compared"] = compared
    for key, v in compared.items():
        log(f"calbench: compared {key} {v['value']!r} limit {v['limit']!r}")
    return 0, result

