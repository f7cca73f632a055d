"""Spans from outside the program, and the reduction of a profiler trace to
the numbers the per-layer metrics read.

``wrap`` puts a ``record_function`` span around a function of the program
(a method or a module-level name that its callers look up at call time),
as the benchmark wraps the layers' entry points from its own files.
``Trace`` reads the Chrome trace that ``torch.profiler`` exports: host
spans (``user_annotation``), device operations (kernels, copies, sets)
and the runtime or driver calls that launched them, matched by their
correlation ids, and the host's kernel-launch calls."""
from __future__ import annotations

import collections
import json
import os
import re
import tempfile

import torch

WINDOW = "window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
# the runtime and driver calls that put kernels on the device (a graph's
# launch is one call, however many kernels it replays)
LAUNCH_CALLS = frozenset((
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchCooperativeKernel",
    "cuLaunchKernel", "cuLaunchKernelEx", "cuLaunchCooperativeKernel",
    "cudaGraphLaunch", "cuGraphLaunch"))
TOP = 10


def wrap(owner, name: str, label: str):
    """Put a span named ``label`` around ``owner.name``; returns the undo."""
    fn = getattr(owner, name)

    def spanned(*args, **kwargs):
        with torch.profiler.record_function(label):
            return fn(*args, **kwargs)

    setattr(owner, name, spanned)
    return lambda: setattr(owner, name, fn)


def _union(intervals) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class Trace:
    """One traced window; times in seconds."""

    def __init__(self, events: list[dict]):
        spans, device, launch, calls = [], [], {}, []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, ts = e.get("cat"), float(e["ts"]) * 1e-6
            end = ts + float(e.get("dur", 0.0)) * 1e-6
            if cat == "user_annotation":
                spans.append((ts, end, e["name"], e.get("tid")))
            elif cat in DEVICE_CATS:
                device.append((ts, end, e["name"], cat,
                               e.get("args", {}).get("correlation")))
            elif cat in LAUNCH_CATS:
                if re.sub(r"_v\d+$", "", e["name"]) in LAUNCH_CALLS:
                    calls.append(ts)
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    launch[corr] = (ts, e.get("tid"))
        windows = [s for s in spans if s[2] == WINDOW]
        if len(windows) != 1:
            raise RuntimeError(f"the trace holds {len(windows)} "
                               f"{WINDOW!r} spans, not one")
        self.w0, self.w1, _, self.tid = windows[0]
        self.window_s = self.w1 - self.w0
        self.device = [d for d in device if d[1] > self.w0 and d[0] < self.w1]
        self.kernels = [d for d in self.device if d[3] == "kernel"]
        self.launch_calls = sum(self.w0 <= t <= self.w1 for t in calls)
        self.busy = _union((max(a, self.w0), min(b, self.w1))
                           for a, b, *_ in self.device)
        self.busy_s = sum(b - a for a, b in self.busy)
        self._by_tid = collections.defaultdict(list)
        for s in spans:
            if s[2] != WINDOW and s[0] >= self.w0 and s[1] <= self.w1:
                self._by_tid[s[3]].append(s)
        self.self_s: dict[str, float] = collections.defaultdict(float)
        self.total_s: dict[str, float] = collections.defaultdict(float)
        self.count: dict[str, int] = collections.defaultdict(int)
        for group in self._by_tid.values():
            group.sort(key=lambda s: (s[0], -s[1]))
            self._self_times(group)
        # each device operation's launch: the innermost span around it
        self.launched_in: dict[str, float] = collections.defaultdict(float)
        self.unmatched = 0
        queries = collections.defaultdict(list)
        for d in self.device:
            where = launch.get(d[4])
            if where is None:
                self.unmatched += 1
                continue
            queries[where[1]].append((where[0], d))
        for tid, qs in queries.items():
            for (t, d), name in zip(sorted(qs, key=lambda q: q[0]),
                                    self._innermost(tid, sorted(
                                        q[0] for q in qs))):
                self.launched_in[name] += d[1] - d[0]

    def _self_times(self, group) -> None:
        """Each span's total and self time (less its direct children's)."""
        children: dict[int, float] = collections.defaultdict(float)
        stack: list[int] = []
        for k, (a, b, name, _) in enumerate(group):
            while stack and group[stack[-1]][1] <= a:
                stack.pop()
            if stack:
                children[stack[-1]] += b - a
            stack.append(k)
            self.total_s[name] += b - a
            self.count[name] += 1
        for k, (a, b, name, _) in enumerate(group):
            self.self_s[name] += (b - a) - children[k]

    def _innermost(self, tid, times) -> list[str]:
        """The innermost span on ``tid`` around each of ``times`` (sorted),
        or ``"(harness)"``."""
        group = self._by_tid.get(tid, [])
        out, stack, k = [], [], 0
        for t in times:
            while k < len(group) and group[k][0] <= t:
                stack.append(group[k])
                k += 1
            while stack and stack[-1][1] < t:
                stack.pop()
            inner = [s for s in stack if s[0] <= t <= s[1]]
            out.append(inner[-1][2] if inner else "(harness)")
        return out

    def idle_gaps(self) -> list[tuple[str, float]]:
        """Idle seconds of the window by the harness thread's innermost
        span at each gap's start, longest first."""
        edges = [self.w0] + [t for ab in self.busy for t in ab] + [self.w1]
        gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
        names = self._innermost(self.tid, [a for a, _ in gaps])
        by = collections.defaultdict(float)
        for (a, b), name in zip(gaps, names):
            by[name] += b - a
        return sorted(by.items(), key=lambda kv: -kv[1])[:TOP]

    def device_ops(self) -> list[tuple[str, float]]:
        by = collections.defaultdict(float)
        for a, b, name, *_ in self.device:
            by[name] += min(b, self.w1) - max(a, self.w0)
        return sorted(by.items(), key=lambda kv: -kv[1])[:TOP]


def read(prof) -> Trace:
    """The ``Trace`` of a finished ``torch.profiler.profile``, through a
    Chrome trace written to the run's temporary directory and removed."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return Trace(events)

