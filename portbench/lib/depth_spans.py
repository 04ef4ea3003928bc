"""The depth priors' spans in a traced slice: each `depth.*` span of the
port (google_nerf_tpu_torch/utils/logging.span) with its device seconds,
its calls and the device-idle seconds spent in it, and the share of the
slice's busy time that the layer spans (every span but the root
`depth.priors.frame`) cover.

The priors run forward only, on one thread.  A device event belongs to
the innermost `depth.*` span that holds, on the same thread, the runtime
call that launched it; a call on a thread without spans, to the
innermost span on the main thread (the one that holds the slice's
window range) at its time.  Each gap between device work in the slice
goes to the innermost span on the main thread at the gap's midpoint.
What no span holds is reported as outside.  Device seconds are unions of
the events' intervals within the slice, as `Trace.busy_s` counts them.
The nesting helpers are `lib/program_spans.py`'s.
"""
from __future__ import annotations

from collections import Counter, defaultdict
from typing import Dict

from portbench.lib.program_spans import (OUTSIDE, _main_thread, _Nest,
                                         _thread)
from portbench.lib.trace import Trace, _clip, _span, merged, union_length

PREFIX = "depth."
ROOT = "depth.priors.frame"


def reduce(t: Trace) -> Dict:
    """The slice's span table: {"spans": {name: {calls, fwd_s, idle_s,
    total_s}}, "outside_s", "outside_idle_s", "busy_s", "layer_s",
    "coverage"}.  fwd_s and idle_s are the span's own (innermost);
    total_s holds everything nested in it too.  coverage is layer_s /
    busy_s, or None where the slice has no layer span or no device
    time."""
    by_thread = defaultdict(list)
    for e in t.host:
        if e.get("name", "").startswith(PREFIX):
            by_thread[_thread(e)].append(e)
    spans = {k: _Nest(v) for k, v in by_thread.items()}
    main = _main_thread(t)

    def chain_at(th, ts):
        n = spans.get(th)
        return n.chain(n.innermost(ts)) if n else ()

    owned = defaultdict(list)    # span -> intervals of its own
    holds = defaultdict(list)    # span -> intervals, nested work included
    for e in t.runtime:
        dev = t.by_corr.get((e.get("args") or {}).get("correlation"))
        if not dev:
            continue
        ts = float(e["ts"])
        chain = chain_at(_thread(e), ts) or chain_at(main, ts)
        iv = _clip([_span(d) for d in dev], t.t0, t.t1)
        owned[chain[0] if chain else OUTSIDE].extend(iv)
        for name in set(chain):
            holds[name].extend(iv)

    idle = defaultdict(float)
    busy = merged(t.device_spans())
    edges = [t.t0] + [x for s in busy for x in s] + [t.t1]
    for k in range(0, len(edges), 2):
        a, b = edges[k], edges[k + 1]
        if b > a:
            chain = chain_at(main, 0.5 * (a + b))
            idle[chain[0] if chain else OUTSIDE] += (b - a) * 1e-6

    calls = Counter(e["name"] for n in spans.values() for e in n.events
                    if t.t0 <= float(e["ts"]) <= t.t1)
    names = sorted((set(calls) | set(owned) | set(idle)) - {OUTSIDE})
    table = {n: dict(calls=calls.get(n, 0),
                     fwd_s=union_length(owned[n]) * 1e-6,
                     idle_s=idle.get(n, 0.0),
                     total_s=union_length(holds[n]) * 1e-6) for n in names}
    layers = [n for n in names if n != ROOT]
    layer_s = union_length([iv for n in layers for iv in owned[n]]) * 1e-6
    busy_s = t.busy_s
    return dict(spans=table, outside_s=union_length(owned[OUTSIDE]) * 1e-6,
                outside_idle_s=idle.get(OUTSIDE, 0.0), busy_s=busy_s,
                layer_s=layer_s,
                coverage=layer_s / busy_s if layers and busy_s > 0 else None)
