"""The port's spans and counters, on one clock, from the corpus pool and
device.compress down into the native engine's walk threads.

The recorder is off by default. `enable()` switches it on, for this process
and for every native session opened from then on; `drain()` hands over the
spans recorded since the last drain (call it once the calls have
returned); `disable()` switches it off. While it is off, a call that wants
no readings opens no span: `root()` is one test of a module-level bool and
returns the null scope, whose spans allocate nothing and read no clock.

A span (`Span`) holds its name, two CLOCK_MONOTONIC readings in ns
(Python's time.monotonic_ns(); the native engine's std::chrono::steady_clock,
the same clock under libstdc++ on Linux), the OS thread id, its id and its
parent's, the call id that every span of one call shares, a chunk index or
None, and two counts whose meaning its name fixes: `count` holds the input
bytes of `call` and `corpus.file`, the files of `corpus.pool`, the wire
bytes of `chunk.stage`, the slices of `native.pass1` (`count2`: its
threads), the bins of `native.trace_walk` and `native.dense_walk`, the
bins of `chunk.model` (`count2`: the bytes its model pass moves between
host and device, both ways; on profile 0's card route the chunk's narrow
blob), the lanes of `chunk.lanes` (`count2`: the bytes of its uploaded
lane planes; on the card route the lane counts and the download), the
host-input bytes of `mesh.pack`
(`count2`: its chunks), the lanes K of `mesh.step`, the bytes downloaded
by `mesh.fetch`, and the bytes of `native.export`,
`native.dense_export`, `native.v2_tables`, `native.copyout` and
`native.pack`; 0 elsewhere. Spans go
at phase and chunk granularity only.

The spans, by where they are opened:
  parallel.distributed.corpus_compress: `corpus.pool` on the calling thread
      (one list); per file, on its worker thread, a root `corpus.file` with
      `corpus.queued` (submit to worker start), `corpus.read`, the file's
      `call` tree, `corpus.verify` (the host decode) and `corpus.write`;
  device.compress: a root `call` (or a child of the thread's open
      `corpus.file`), with `call.open`, then under profile 2 `call.begin`,
      `call.header`, per chunk `chunk.fetch`, `chunk.take`, `chunk.parse`,
      `chunk.stage`, `chunk.launch`, `chunk.compact`, then `call.emit` (the
      downloads) and per chunk `chunk.emit` (its blob's assembly); under
      profile 0 `call.begin`, `call.header`, then per chunk `chunk.fetch`
      (the wait for the chunk's export and its hand-over), `call.parse`
      (its parse), `chunk.model` (uploads, model pass, probs download; on
      the card route the pack, the one upload, the expand and the pass) and
      `chunk.lanes` (lane planes' upload and encode; on the card route the
      planes written there and the encode); then `call.pack`;
  device.compress_mesh: a root `call` with `call.open`, `call.begin`,
      `call.header`, per chunk `chunk.fetch`, `chunk.take`, `chunk.parse`
      (the walk of every chunk), then `mesh.pack` (every chunk packed for
      the step), `mesh.step` (the step built and every cell's launches
      issued), `mesh.fetch` (the one download and its wait),
      `mesh.assemble` (every chunk's blob) and `call.pack`;
  the native engine (host.session_trace), drained at the call's end and
      joined to its tree: `native.pass1` (the opener), `native.nz_probe`
      (the pipe), per chunk `native.trace_walk` and `native.export` (the pipe
      for chunk 0, the analyze workers), and on the calling thread
      `native.ready_wait`, per chunk `native.rendezvous` and
      `native.copyout`, and `native.pack`; under profile 0, on the dense
      analysis's walker threads, per chunk `native.dense_walk` and
      `native.dense_export` (which holds the chunk's `native.v2_tables`),
      and on the calling thread per chunk `native.rendezvous` and
      `native.copyout` (the hand-over of the chunk's export, no copy: the
      walker writes the block it hands over). A native span on the
      calling thread takes the innermost Python span around it as its
      parent; one on another thread takes the call's root.

A root opened while torch.profiler runs is mirrored by a record_function of
its name, entered right after the root's first clock reading and left after
its last, so a reader of a profile can put this clock on the profile's: the
profiler stamps a record_function's start as it is entered, within a few
µs of the reading before it.
"""
from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass

from torch.autograd.profiler import record_function

_on = False
_records: list = []
_span_ids = itertools.count(1)
_call_ids = itertools.count(1)
_local = threading.local()  # .scope: the thread's open publishing scope


def enable() -> None:
    """Records from now on: this process's spans, and the native spans of
    every session opened from now on."""
    global _on
    from . import host
    host.lib().artc_trace_enable(1)
    _on = True


def disable() -> None:
    global _on
    _on = False
    from . import host
    host.lib().artc_trace_enable(0)


def drain() -> list:
    """Every span published since the last drain (none while the recorder
    was off), in no particular order."""
    global _records
    out, _records = _records, []
    return out


@dataclass(slots=True, eq=False)
class Span:
    name: str
    start_ns: int
    end_ns: int
    thread: int
    span_id: int
    parent_id: int | None
    call_id: int
    chunk: int | None = None
    count: int = 0
    count2: int = 0
    _scope: object = None  # the scope while the span is open

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def __enter__(self) -> "Span":
        sc = self._scope
        self.parent_id = sc._stack[-1].span_id
        sc._stack.append(self)
        self.start_ns = time.monotonic_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.monotonic_ns()
        sc, self._scope = self._scope, None
        sc._stack.pop()
        sc.spans.append(self)
        return False


class Scope:
    """The spans of one call, opened on one thread: its root and the root's
    descendants. With `publish` the spans go to the recorder when the root
    closes; without, they are the call's own readings (the caller's `info`
    or ARTC_TIMING lines) and go nowhere else."""

    def __init__(self, name: str, count: int, publish: bool):
        self.recording = publish
        self.thread = threading.get_native_id()
        self._outer = getattr(_local, "scope", None) if publish else None
        outer = self._outer
        self.call_id = outer.call_id if outer is not None else next(_call_ids)
        parent = outer._stack[-1].span_id if outer is not None else None
        self.root = Span(name, 0, 0, self.thread, next(_span_ids), parent, self.call_id,
                         count=count)
        self.spans: list[Span] = []
        self._stack = [self.root]
        self._mirror = None

    def __enter__(self) -> "Scope":
        self.root.start_ns = time.monotonic_ns()
        if self.recording:
            if self._outer is None:
                self._mirror = record_function(self.root.name)
                self._mirror.__enter__()
            _local.scope = self
        return self

    def __exit__(self, *exc) -> bool:
        self.root.end_ns = time.monotonic_ns()
        self.spans.append(self.root)
        if self.recording:
            _local.scope = self._outer
            if self._mirror is not None:
                self._mirror.__exit__(None, None, None)
            _records.extend(self.spans)
        return False

    def span(self, name: str, chunk: int | None = None, count: int = 0,
             count2: int = 0) -> Span:
        """A child of the innermost open span, to be entered with `with`."""
        return Span(name, 0, 0, self.thread, next(_span_ids), None, self.call_id, chunk,
                    count, count2, self)

    def add(self, name: str, start_ns: int, end_ns: int, thread: int | None = None,
            parent: Span | None = None, chunk: int | None = None, count: int = 0,
            count2: int = 0) -> Span:
        """A closed span from readings taken elsewhere (default: on this
        thread, under the innermost open span)."""
        sp = Span(name, start_ns, end_ns, self.thread if thread is None else thread,
                  next(_span_ids), (parent or self._stack[-1]).span_id, self.call_id, chunk,
                  count, count2)
        self.spans.append(sp)
        return sp

    def join_native(self, records) -> None:
        """Adds the native spans of the call's session (host.session_trace
        tuples): on this thread under the innermost span around each, on
        any other under the root."""
        mine = [s for s in self.spans if s.thread == self.thread]
        for name, t0, t1, tid, chunk, count, count2 in records:
            parent = self.root
            if tid == self.thread:
                around = [s for s in mine if s.start_ns <= t0 and t1 <= s.end_ns]
                if around:
                    parent = min(around, key=lambda s: s.end_ns - s.start_ns)
            self.add(name, t0, t1, tid, parent, None if chunk < 0 else chunk, count, count2)

    def first(self, name: str) -> Span | None:
        return next((s for s in self.spans if s.name == name), None)

    def seconds(self, *names: str) -> float:
        """The summed seconds of the closed spans with these names."""
        return sum(s.end_ns - s.start_ns for s in self.spans if s.name in names) / 1e9


class _Null:
    """The scope of a call that records nothing: every span is this object,
    and a count set on it goes nowhere."""
    __slots__ = ()
    recording = False
    count = count2 = property(lambda self: 0, lambda self, value: None)
    root = property(lambda self: self)

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def span(self, name, chunk=None, count=0, count2=0):
        return self


NULL = _Null()


def root(name: str, count: int = 0, keep: bool = False):
    """The scope of one call (enter it with `with`): recorded while the
    recorder is on, kept for the caller alone with `keep`, else the null
    scope. Opened on a thread whose recorded scope is open, it joins that
    scope's call as a child of its innermost open span."""
    if not _on:
        return Scope(name, count, False) if keep else NULL
    return Scope(name, count, True)
