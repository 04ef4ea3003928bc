"""Reduction of a torch.profiler trace (its Chrome-trace JSON) to what
the per-layer metrics read: device busy time as the union of kernel,
memcpy and memset intervals, launch calls, the device time of kernels
launched inside a named host range, the top device ops and the longest
idle gaps labelled by what the host was doing.

Everything here works on plain dicts, so the tests feed it small
synthetic traces.
"""
from __future__ import annotations

import bisect
import json
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
            "cudaMemsetAsync")
HOST_CATS = ("cpu_op", "user_annotation")


def load(path) -> List[Dict]:
    with open(path) as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def _span(e) -> Tuple[float, float]:
    t0 = float(e["ts"])
    return t0, t0 + float(e.get("dur", 0.0))


def union_length(spans: Iterable[Tuple[float, float]]) -> float:
    """Total length covered by a set of intervals."""
    total, cur0, cur1 = 0.0, None, None
    for a, b in sorted(spans):
        if cur1 is None or a > cur1:
            if cur1 is not None:
                total += cur1 - cur0
            cur0, cur1 = a, b
        else:
            cur1 = max(cur1, b)
    if cur1 is not None:
        total += cur1 - cur0
    return total


def merged(spans: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _clip(spans, lo, hi):
    return [(max(a, lo), min(b, hi)) for a, b in spans if b > lo and a < hi]


class Trace:
    """One profiled slice.  `window` names the host range (a
    record_function) that bounds it; times are microseconds."""

    def __init__(self, events: List[Dict], window: str):
        self.events = [e for e in events if e.get("ph") == "X"]
        win = [e for e in self.events if e.get("name") == window
               and e.get("cat") in HOST_CATS]
        if not win:
            raise ValueError(f"no host range {window!r} in the trace")
        self.t0, self.t1 = _span(win[0])
        self.device = [e for e in self.events
                       if e.get("cat") in DEVICE_CATS]
        self.runtime = [e for e in self.events
                        if e.get("cat") in ("cuda_runtime", "cuda_driver")]
        self.host = [e for e in self.events if e.get("cat") in HOST_CATS]
        self.by_corr = {}
        for e in self.device:
            c = (e.get("args") or {}).get("correlation")
            if c is not None:
                self.by_corr.setdefault(c, []).append(e)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def device_spans(self):
        return _clip([_span(e) for e in self.device], self.t0, self.t1)

    @property
    def busy_s(self) -> float:
        return union_length(self.device_spans()) * 1e-6

    def launches(self) -> int:
        return sum(1 for e in self.runtime if e.get("name") in LAUNCHES
                   and self.t0 <= float(e["ts"]) <= self.t1)

    def ranges(self, name: str, exclude: Optional[str] = None):
        """Host ranges called `name` in the window (those inside a range
        called `exclude` on the same thread left out)."""
        got = [e for e in self.host if e.get("name") == name
               and self.t0 <= float(e["ts"]) <= self.t1]
        if exclude is None:
            return got
        outer = [e for e in self.host if e.get("name") == exclude]

        def inside(e):
            a, b = _span(e)
            return any(o.get("tid") == e.get("tid") and _span(o)[0] <= a
                       and b <= _span(o)[1] for o in outer)
        return [e for e in got if not inside(e)]

    def launched_in(self, ranges) -> List[Dict]:
        """Device events launched by a runtime call made inside one of
        the given host ranges, on that range's thread."""
        by_tid = defaultdict(list)
        for r in ranges:
            by_tid[(r.get("pid"), r.get("tid"))].append(_span(r))
        out = []
        for key, spans in by_tid.items():
            spans.sort()
            starts = [a for a, _ in spans]
            for e in self.runtime:
                if (e.get("pid"), e.get("tid")) != key:
                    continue
                t = float(e["ts"])
                i = bisect.bisect_right(starts, t) - 1
                if i >= 0 and t <= spans[i][1]:
                    c = (e.get("args") or {}).get("correlation")
                    out.extend(self.by_corr.get(c, []))
        return out

    def device_seconds(self, events) -> float:
        return union_length(_span(e) for e in events) * 1e-6

    def top_ops(self, n: int = 10):
        tot = defaultdict(float)
        for e in self.device:
            a, b = _span(e)
            a, b = max(a, self.t0), min(b, self.t1)
            if b > a:
                tot[e.get("name", "?")] += (b - a) * 1e-6
        return sorted(([k, v] for k, v in tot.items()),
                      key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10):
        """The n longest gaps between device work in the window, each
        named by the innermost host range running at its middle."""
        busy = merged(self.device_spans())
        edges = [self.t0] + [x for s in busy for x in s] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:n]:
            mid = 0.5 * (a + b)
            cover = [e for e in self.host
                     if _span(e)[0] <= mid <= _span(e)[1]]
            name = (min(cover, key=lambda e: float(e.get("dur", 0)))["name"]
                    if cover else "host outside any traced op")
            out.append([name, (b - a) * 1e-6])
        return out
