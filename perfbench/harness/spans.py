"""The program's own spans (avrecode_tpu_torch.trace) in a traced run.

A traced run loads its per-layer readers before its set-up (harness/spec.py
loads them when it finds the cell), so a reader that calls `enable()` when
it is imported switches the program's recorder on from the warm-up calls
to the read. `load(ctx)` drains the recorder once a run, keeps the spans of
the window's calls, puts them on the profiler's timeline and adds them to
the trace's host events, where the idle gaps find them: harness/trace.py
names a gap by the shortest host event around its middle. The readers run
before the run reads its idle gaps (run.py), so the gaps are named by the
program's phases.

The two clocks. The program's spans read CLOCK_MONOTONIC in ns; the
profile's events are in µs on the profiler's own clock. The program mirrors
each root it opens on a thread with no open root (`call` of device.compress,
`corpus.pool` of the corpus pool) by a record_function of the same name,
entered right after the root's first reading: the profiler stamps the
event's start within a few µs of that reading (the first on a thread can
be late by 0.1-1 ms). Nothing of the program runs after the window, so the
window's roots of a name are the last ones drained: they pair in order with
that name's events in the profile, and the median of the pairs' start
differences is the one offset. The window's calls are those roots' calls
and the corpus files that start inside a window's pool call.

Where the program has no recorder (a checkout older than it), nothing is
recorded, `load` returns None, and every reader of these spans returns
None.
"""
from __future__ import annotations

import statistics
from dataclasses import dataclass

from harness import trace as tr

ROOTS = ("call", "corpus.pool")
WAITS = ("native.ready_wait", "native.rendezvous")


def enable() -> None:
    """Switches the program's recorder on, where the program has one."""
    try:
        from avrecode_tpu_torch import trace
    except ImportError:
        return
    trace.enable()


def _drain() -> list:
    try:
        from avrecode_tpu_torch import trace
    except ImportError:
        return []
    return trace.drain()


@dataclass
class Window:
    spans: list          # the window's program spans (avrecode_tpu_torch.trace.Span)
    offset_us: float     # profile µs = span ns / 1e3 + offset_us

    def us(self, sp) -> tuple[float, float]:
        """A span's start and end on the profile's timeline."""
        return sp.start_ns / 1e3 + self.offset_us, sp.end_ns / 1e3 + self.offset_us

    def named(self, *names: str) -> list:
        return [s for s in self.spans if s.name in names]

    def s_per_mb(self, ctx, *names: str) -> float | None:
        """Seconds of the window's spans with these names over the input MB
        of the files whose container came; None where no such span is."""
        found = self.named(*names)
        mb = sum(r.nbytes for r in ctx.done) / 1e6
        if not found or not mb:
            return None
        return sum(s.end_ns - s.start_ns for s in found) / 1e9 / mb


def window(drained: list, host: list) -> Window | None:
    """The window's spans of `drained` and their offset onto the profile
    whose host events are `host` ((name, start_us, end_us)); None without a
    pair of a mirrored root and its event."""
    pairs, kept_roots = [], []
    for name in ROOTS:
        events = sorted(s for n, s, _ in host if n == name)
        roots = sorted((s for s in drained if s.name == name and s.parent_id is None),
                       key=lambda s: s.start_ns)
        if not events or len(events) > len(roots):
            continue
        roots = roots[len(roots) - len(events):]
        pairs += [e - r.start_ns / 1e3 for e, r in zip(events, roots)]
        kept_roots += roots
    if not pairs:
        return None
    calls = {r.call_id for r in kept_roots}
    pools = [(r.start_ns, r.end_ns) for r in kept_roots if r.name == "corpus.pool"]
    calls |= {s.call_id for s in drained if s.name == "corpus.file" and s.parent_id is None
              and any(a <= s.start_ns <= b for a, b in pools)}
    return Window([s for s in drained if s.call_id in calls], statistics.median(pairs))


def load(ctx) -> Window | None:
    """The run's Window, made once (the first reader drains the recorder and
    adds the spans to ctx.trace.host; the later ones read what it kept)."""
    if "_program_window" not in ctx.__dict__:
        w = None
        if ctx.trace is not None:
            w = window(_drain(), ctx.trace.host)
        if w is not None:
            profiled = {n for n, _, _ in ctx.trace.host}
            ctx.trace.host += [(s.name, *w.us(s)) for s in w.spans
                               if s.parent_id is not None or s.name not in profiled]
        ctx.__dict__["_program_window"] = w
    return ctx.__dict__["_program_window"]


def idle_walk_share(trace, w: Window) -> float | None:
    """Of the window's device-idle time, the share (%) during which at least
    one call is open and every open call's thread waits for the walk
    (native.ready_wait or native.rendezvous); None without idle time or
    calls."""
    idle = tr.gaps(trace.merged, *trace.span_us())
    calls = w.named("call")
    if not calls or not idle:
        return None
    # A sweep over every boundary: +1/-1 of idle time, of open calls and of
    # waits (a call's waits lie inside it, one at a time on its thread).
    edges = []
    for s, e in idle:
        edges += [(s, 0, 1), (e, 0, -1)]
    for sp in calls:
        s, e = w.us(sp)
        edges += [(s, 1, 1), (e, 1, -1)]
    for sp in w.named(*WAITS):
        s, e = w.us(sp)
        edges += [(s, 2, 1), (e, 2, -1)]
    edges.sort()
    level = [0, 0, 0]
    both = 0.0
    t = edges[0][0]
    for at, kind, step in edges:
        if level[0] > 0 and level[1] > 0 and level[2] >= level[1]:
            both += at - t
        t = at
        level[kind] += step
    idle_us = sum(e - s for s, e in idle)
    return 100.0 * both / idle_us if idle_us > 0 else None
