"""What ``torch.profiler`` saw of one fit: device time by kernel, busy and idle.

:func:`profiled` runs a function under the profiler (host and CUDA
activity) inside a ``calbench.fit`` annotation; :func:`reduce` reads the
raw events: every device operation (kernels, copies and sets, the kernels
of CUDA-graph replays included) with its name, start and length, and the
host's operations. The window is the annotation's span. Busy time is the
union of the device operations' spans within it; an idle gap is a span
with none, named by the innermost host operation under its middle.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

ANNOTATION = "calbench.fit"
NAME_CHARS = 160  # a breakdown entry's name is cut to this


class Trace(NamedTuple):
    window_s: float
    busy_s: float
    ops: int  # device operations
    by_name: dict  # name -> (seconds, count)
    idle_by_host: dict  # host operation -> idle seconds under it (the longest gaps)


def profiled(fn):
    """(fn's result, the profiler) of ``fn()`` run under the profiler, the
    device synchronised inside the annotation."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(ANNOTATION):
            out = fn()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    return out, prof


def _union(starts, ends):
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    merged = []
    cur_s, cur_e = s[0], e[0]
    for a, b in zip(s[1:], e[1:]):
        if a > cur_e:
            merged.append((cur_s, cur_e))
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    merged.append((cur_s, cur_e))
    return np.asarray(merged, dtype=np.int64)


def reduce(prof, max_gaps=400):
    """A :class:`Trace` of the profiled fit, or None where the trace holds no
    device operation."""
    events = prof.profiler.kineto_results.events()
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    win = [e for e in events if e.name() == ANNOTATION and e.device_type() == cpu]
    # the annotation's mirror on the device's timeline is no operation
    dev = [e for e in events if e.device_type() == cuda and e.name() != ANNOTATION
           and not e.is_user_annotation()]
    if not win or not dev:
        return None
    w0, w1 = win[0].start_ns(), win[0].start_ns() + win[0].duration_ns()
    names = [e.name() for e in dev]
    starts = np.array([e.start_ns() for e in dev], dtype=np.int64)
    ends = starts + np.array([e.duration_ns() for e in dev], dtype=np.int64)
    by_name = {}
    for n, a, b in zip(names, starts, ends):
        sec, cnt = by_name.get(n, (0.0, 0))
        by_name[n] = (sec + (b - a) * 1e-9, cnt + 1)
    spans = _union(np.clip(starts, w0, w1), np.clip(ends, w0, w1))
    busy = float(np.sum(spans[:, 1] - spans[:, 0])) * 1e-9
    # idle gaps: before the first operation, between spans, after the last
    edges = np.concatenate([[w0], spans.reshape(-1), [w1]]).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    gaps = gaps[np.argsort(gaps[:, 0] - gaps[:, 1])[:max_gaps]]
    host = [e for e in events if e.device_type() == cpu and e.name() != ANNOTATION]
    idle_by_host = {}
    if len(gaps):
        hs = np.array([e.start_ns() for e in host], dtype=np.int64)
        he = hs + np.array([e.duration_ns() for e in host], dtype=np.int64)
        hn = [e.name() for e in host]
        for a, b in gaps:
            mid = (a + b) // 2
            under = np.nonzero((hs <= mid) & (he >= mid))[0]
            name = hn[under[np.argmin(he[under] - hs[under])]] if len(under) else "(no host op)"
            idle_by_host[name] = idle_by_host.get(name, 0.0) + (b - a) * 1e-9
    rest = (w1 - w0) * 1e-9 - busy - sum(idle_by_host.values())
    if rest > 0:
        idle_by_host[f"(gaps shorter than the {max_gaps} longest)"] = rest
    return Trace((w1 - w0) * 1e-9, busy, len(dev), by_name, idle_by_host)


def breakdown(tr, top=10):
    """The contract's ``breakdown``: the costliest device operations and the
    idle time by what the host was doing, [name, seconds] each."""
    ops = sorted(tr.by_name.items(), key=lambda kv: -kv[1][0])[:top]
    gaps = sorted(tr.idle_by_host.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:NAME_CHARS], s] for n, (s, _) in ops],
            "idle_gaps": [[n[:NAME_CHARS], s] for n, s in gaps]}


def group(tr, pattern):
    """(seconds, count) of the device operations whose name holds any of
    the substrings in ``pattern``."""
    sec = cnt = 0
    for n, (s, c) in tr.by_name.items():
        if any(p in n for p in pattern):
            sec += s
            cnt += c
    return sec, cnt
