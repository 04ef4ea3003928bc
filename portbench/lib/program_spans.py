"""The program's spans in a traced slice: each `ngp.*` span of the port
(google_nerf_tpu_torch/utils/logging.span) with its forward and
backward device seconds, its calls and the device-idle seconds spent in
it, and the share of the slice's busy time that the layer spans (every
span but the roots) cover.

- **Forward.**  A device event belongs to the innermost `ngp.*` span
  that holds, on the same thread, the runtime call that launched it.
  Everything inside `ngp.grid_update` is `ngp.grid_update`'s.
- **Backward.**  A runtime call made inside an
  `autograd::engine::evaluate_function: ...` range belongs to the
  forward op with the range's autograd sequence number (`Sequence
  number`), and so to that op's innermost span.  Ops that make no
  autograd node record the number the next node will take, so the op
  that made the node is the last on its thread to start with it.  The
  range's `Fwd thread id` is the profiler's own number of the forward
  thread, not its tid (forward ops carry 0 there), so it is resolved to
  the tid whose forward ops hold the most of its sequence numbers.
- **The rest.**  A call that neither rule places (the autograd engine's
  own work, such as AccumulateGrad, or a call on a thread without
  spans) belongs to the innermost span on the main thread at its time,
  the main thread being the one that holds the slice's window range.
- **Device idle.**  Each gap between device work in the slice goes to
  the innermost span on the main thread at the gap's midpoint.

What no span holds is reported as outside.  Device seconds are unions
of the events' intervals within the slice, as `Trace.busy_s` counts
them.  Everything works on `lib/trace.Trace`, so the tests feed it
synthetic traces.
"""
from __future__ import annotations

import bisect
from collections import Counter, defaultdict
from typing import Dict, List, Tuple

from portbench.lib.trace import Trace, _clip, _span, merged, union_length

PREFIX = "ngp."
ROOTS = ("ngp.train.step", "ngp.serve.view")
FOLD = "ngp.grid_update"
BACKWARD = "autograd::engine::evaluate_function: "
OUTSIDE = "outside"


class _Nest:
    """The properly nested ranges of one thread, for innermost
    lookups."""

    def __init__(self, events: List[Dict]):
        self.events = sorted(events, key=lambda e: (float(e["ts"]),
                                                    -float(e.get("dur", 0))))
        self.starts = [float(e["ts"]) for e in self.events]
        self.ends = [_span(e)[1] for e in self.events]
        self.parent = []
        stack: List[int] = []
        for i, a in enumerate(self.starts):
            while stack and self.ends[stack[-1]] < a:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def innermost(self, t: float) -> int:
        """Index of the innermost range holding t, or -1."""
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.ends[i] < t:
            i = self.parent[i]
        return i

    def chain(self, i: int) -> Tuple[str, ...]:
        """Names from range i out to its outermost ancestor."""
        out = []
        while i >= 0:
            out.append(self.events[i]["name"])
            i = self.parent[i]
        return tuple(out)


def _owner(chain: Tuple[str, ...]) -> Tuple[str, Tuple[str, ...]]:
    """The span a chain's work belongs to, and every span that holds it
    (innermost first), with what lies inside ngp.grid_update folded."""
    if FOLD in chain:
        chain = chain[chain.index(FOLD):]
    return (chain[0], chain) if chain else (OUTSIDE, ())


def _thread(e) -> Tuple:
    return (e.get("pid"), e.get("tid"))


def _main_thread(t: Trace) -> Tuple:
    """The thread of the slice's window range."""
    return next(_thread(e) for e in t.host if _span(e) == (t.t0, t.t1))


def reduce(t: Trace) -> Dict:
    """The slice's span table: {"spans": {name: {calls, fwd_s, bwd_s,
    idle_s, total_s}}, "outside_s", "outside_idle_s", "busy_s",
    "layer_s", "coverage"}.  fwd_s, bwd_s and idle_s are the span's own
    (innermost); total_s holds everything nested in it too.  coverage is
    layer_s / busy_s: the busy time owned by a span other than a root,
    or None where the slice has no layer span or no device time."""
    by_thread = defaultdict(list)
    backward = defaultdict(list)
    forward = {}
    for e in t.host:
        name = e.get("name", "")
        if name.startswith(PREFIX):
            by_thread[_thread(e)].append(e)
        elif name.startswith(BACKWARD):
            backward[_thread(e)].append(e)
        else:
            seq = (e.get("args") or {}).get("Sequence number")
            if seq is not None and not (e.get("args") or {}).get(
                    "Fwd thread id"):
                # ops that make no node record the number the next node
                # will take, so the op that made node `seq` is the last
                # to start with it
                key = (_thread(e), seq)
                forward[key] = max(forward.get(key, -1.0), float(e["ts"]))
    spans = {k: _Nest(v) for k, v in by_thread.items()}
    bwd = {k: _Nest(v) for k, v in backward.items()}
    main = _main_thread(t)
    fwd_thread = _resolve_forward_threads(bwd, forward)

    def chain_at(th, ts):
        n = spans.get(th)
        return n.chain(n.innermost(ts)) if n else ()

    owned = defaultdict(list)    # (span, "fwd" | "bwd") -> intervals
    holds = defaultdict(list)    # span -> intervals, nested work included
    for e in t.runtime:
        c = (e.get("args") or {}).get("correlation")
        dev = t.by_corr.get(c)
        if not dev:
            continue
        th, ts = _thread(e), float(e["ts"])
        kind, chain = "fwd", ()
        nb = bwd.get(th)
        i = nb.innermost(ts) if nb else -1
        if i >= 0:
            kind = "bwd"
            args = nb.events[i].get("args") or {}
            key = (fwd_thread.get(args.get("Fwd thread id")),
                   args.get("Sequence number"))
            if key in forward:
                chain = chain_at(key[0], forward[key])
        if not chain:
            chain = chain_at(th, ts) or chain_at(main, ts)
        owner, held = _owner(chain)
        iv = _clip([_span(d) for d in dev], t.t0, t.t1)
        owned[(owner, kind)].extend(iv)
        for name in set(held):
            holds[name].extend(iv)

    idle = defaultdict(float)
    busy = merged(t.device_spans())
    edges = [t.t0] + [x for s in busy for x in s] + [t.t1]
    for k in range(0, len(edges), 2):
        a, b = edges[k], edges[k + 1]
        if b > a:
            idle[_owner(chain_at(main, 0.5 * (a + b)))[0]] += (b - a) * 1e-6

    calls = Counter(e["name"] for n in spans.values() for e in n.events
                    if t.t0 <= float(e["ts"]) <= t.t1)
    names = sorted((set(calls) | {n for n, _ in owned} | set(idle))
                   - {OUTSIDE})
    table = {n: dict(
        calls=calls.get(n, 0),
        fwd_s=union_length(owned[(n, "fwd")]) * 1e-6,
        bwd_s=union_length(owned[(n, "bwd")]) * 1e-6,
        idle_s=idle.get(n, 0.0),
        total_s=union_length(holds[n]) * 1e-6) for n in names}
    layers = [n for n in names if n not in ROOTS]
    layer_s = union_length([iv for (n, _), ivs in owned.items()
                            if n in layers for iv in ivs]) * 1e-6
    busy_s = t.busy_s
    return dict(
        spans=table,
        outside_s=union_length(owned[(OUTSIDE, "fwd")]
                               + owned[(OUTSIDE, "bwd")]) * 1e-6,
        outside_idle_s=idle.get(OUTSIDE, 0.0), busy_s=busy_s,
        layer_s=layer_s,
        coverage=layer_s / busy_s if layers and busy_s > 0 else None)


def _resolve_forward_threads(bwd, forward) -> Dict:
    """{Fwd thread id: the forward ops' thread} by the most sequence
    numbers matched."""
    by_seq = defaultdict(set)
    for th, seq in forward:
        by_seq[seq].add(th)
    votes = defaultdict(Counter)
    for n in bwd.values():
        for e in n.events:
            args = e.get("args") or {}
            fid, seq = args.get("Fwd thread id"), args.get("Sequence number")
            for th in by_seq.get(seq, ()):
                votes[fid][th] += 1
    return {fid: c.most_common(1)[0][0] for fid, c in votes.items()}
