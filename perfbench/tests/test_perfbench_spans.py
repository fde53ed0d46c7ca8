"""The program's spans in a traced run (harness/spans.py): the one offset
onto the profile's timeline, the readers of the seven span metrics on a
synthetic window with known answers, and the idle gaps named by program
spans."""
import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import run
from harness import spans
from harness import trace as tr
from harness.record import Record
from spec_helpers import metric

from avrecode_tpu_torch import device as td
from avrecode_tpu_torch import trace

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(os.path.dirname(BENCH), "avrecode_tpu_torch", "testdata", "corpus")
MARK = [7, 11, 13]  # the shape of the test's own marker copies
READERS = ("walk.pass1_s_per_mb", "walk.trace_s_per_mb", "walk.export_s_per_mb",
           "walk.wait_s_per_mb", "walk.copyout_s_per_mb", "corpus.verify_s_per_mb",
           "device.idle_walk_share")


def _mark():
    torch.zeros(MARK).copy_(torch.ones(MARK))


def test_the_offset_puts_the_staging_spans_around_their_copies(monkeypatch):
    """Three CPU compress calls under torch.profiler: the copies issued at
    the start and the end of each chunk's staging lie inside its converted
    `chunk.stage` span, to within 50 µs."""
    real = td.to_torch_staged

    def staged(*args, **kw):
        _mark()
        st = real(*args, **kw)
        _mark()
        return st

    monkeypatch.setattr(td, "to_torch_staged", staged)
    with open(os.path.join(CORPUS, "i_main.264"), "rb") as f:
        data = f.read()
    td.compress(data, batch_size=512, device="cpu")  # before the window
    trace.drain()
    trace.enable()
    try:
        with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
            for _ in range(3):
                td.compress(data, batch_size=512, device="cpu")
    finally:
        trace.disable()
    t = tr.read(prof, 1.0)
    w = spans.window(trace.drain(), t.host)
    assert w is not None and len({s.call_id for s in w.spans}) == 3
    marks = [float(e.time_range.start) for e in prof.events()
             if e.name == "aten::copy_" and e.input_shapes and e.input_shapes[0] == MARK]
    stages = [w.us(s) for s in w.named("chunk.stage")]
    assert len(stages) == 3 and len(marks) == 2 * len(stages)
    for m in marks:
        assert any(a - 50 <= m <= b + 50 for a, b in stages), m


def _span(name, t0_us, t1_us, call, span_id, parent=None, thread=1):
    return trace.Span(name, int(t0_us * 1e3), int(t1_us * 1e3), thread, span_id, parent,
                      call)


def _synthetic():
    """A window of two calls of 1 MB each on one thread, its warm-up call
    before it, and their mirrors 100 µs off the spans' clock. Call 2 (from
    0 to 1000 µs): begin's ready wait 0-100, walks on another thread,
    chunk 0 fetched at 100-300 (rendezvous 100-250, copy-out 250-260, take
    300-310); call 3 (2000-3000 µs): rendezvous 2000-2400."""
    off = 100.0
    s = [_span("call", -5000, -4000, 1, 1),  # warm-up, before the profile
         _span("native.pass1", -4990, -4500, 1, 2, 1, thread=2),
         _span("call", 0, 1000, 2, 10),
         _span("call.begin", 0, 100, 2, 11, 10),
         _span("native.ready_wait", 0, 100, 2, 12, 11),
         _span("native.pass1", 0, 80, 2, 13, 10, thread=2),
         _span("native.trace_walk", 80, 240, 2, 14, 10, thread=3),
         _span("native.export", 240, 250, 2, 15, 10, thread=3),
         _span("chunk.fetch", 100, 300, 2, 16, 10),
         _span("native.rendezvous", 100, 250, 2, 17, 16),
         _span("native.copyout", 250, 260, 2, 18, 16),
         _span("chunk.take", 300, 310, 2, 19, 10),
         _span("call", 2000, 3000, 3, 20),
         _span("native.rendezvous", 2000, 2400, 3, 21, 20),
         _span("native.trace_walk", 2000, 2400, 3, 22, 20, thread=3)]
    host = [("compress a", -10 + off, 1010 + off), ("call", -1 + off, 1001 + off),
            ("compress b", 1990 + off, 3010 + off), ("call", 1999 + off, 3001 + off)]
    # the card: busy 500-1000 and 2600-3090 on the profile's clock, in the
    # window 90-3090 (from the first host event)
    kernels = [("k", 400 + off, 900 + off), ("k", 2500 + off, 2990 + off)]
    t = tr.Trace(window_s=3000e-6, kernels=kernels, host=host)
    recs = [Record("a", 1_000_000, 0.0, 1.0, True), Record("b", 1_000_000, 2.0, 3.0, True)]
    return s, t, recs


def _ctx(monkeypatch, drained, t, recs):
    monkeypatch.setattr(spans, "_drain", lambda: list(drained))
    return run.Context(records=recs, window_s=t.window_s, setup_s=1.0, config={}, trace=t)


def test_the_window_keeps_the_last_roots_and_one_offset():
    s, t, _ = _synthetic()
    w = spans.window(s, t.host)
    assert w.offset_us == pytest.approx(99.0)
    assert {sp.call_id for sp in w.spans} == {2, 3}
    assert spans.window(s, [("compress a", 0, 1)]) is None  # no mirrored root


def test_the_span_readers_give_the_known_answers(monkeypatch):
    s, t, recs = _synthetic()
    ctx = _ctx(monkeypatch, s, t, recs)
    got = {name: metric(name).read(ctx) for name in READERS}
    mb = 2.0
    assert got["walk.pass1_s_per_mb"] == pytest.approx(80e-6 / mb)
    assert got["walk.trace_s_per_mb"] == pytest.approx((160e-6 + 400e-6) / mb)
    assert got["walk.export_s_per_mb"] == pytest.approx(10e-6 / mb)
    assert got["walk.wait_s_per_mb"] == pytest.approx((100e-6 + 150e-6 + 400e-6) / mb)
    assert got["walk.copyout_s_per_mb"] == pytest.approx((10e-6 + 10e-6) / mb)
    assert got["corpus.verify_s_per_mb"] is None  # no pool in this window
    # On the profile's clock (the spans' + 99 µs): idle 90-500 and
    # 1000-2600 (2010 µs); every open call waits 99-349 and 2099-2499.
    idle = tr.gaps(t.merged, *t.span_us())
    assert idle == [(90, 500), (1000, 2600)]
    assert got["device.idle_walk_share"] == pytest.approx(100 * (250 + 400) / 2010)


def test_a_corpus_window_reads_its_verify_decodes(monkeypatch):
    s = [_span("corpus.pool", 0, 1000, 1, 1),
         _span("corpus.file", 10, 900, 2, 2), _span("corpus.verify", 700, 850, 2, 3, 2),
         _span("corpus.file", 20, 950, 3, 4, thread=2),
         _span("corpus.verify", 800, 900, 3, 5, 4, thread=2),
         _span("corpus.file", 2000, 2100, 4, 6)]  # after the pool: not the window's
    t = tr.Trace(window_s=1e-3, kernels=[("k", 5, 6)], host=[("corpus.pool", 0.5, 1001)])
    recs = [Record("a", 500_000, 0.0, 0.9, True), Record("b", 500_000, 0.0, 0.95, True)]
    ctx = _ctx(monkeypatch, s, t, recs)
    assert metric("corpus.verify_s_per_mb").read(ctx) == pytest.approx(250e-6)
    assert metric("walk.pass1_s_per_mb").read(ctx) is None  # no such span


def test_without_a_recorder_every_span_reader_reads_nothing(monkeypatch):
    _, t, recs = _synthetic()
    ctx = _ctx(monkeypatch, [], t, recs)
    assert all(metric(name).read(ctx) is None for name in READERS)


def test_the_idle_gaps_are_named_by_the_program(monkeypatch):
    s, t, recs = _synthetic()
    ctx = _ctx(monkeypatch, s, t, recs)
    before = t.idle_gaps()
    assert {name for name, _ in before} <= {"call", "compress a", "compress b",
                                            "no host event"}
    metric("walk.wait_s_per_mb").read(ctx)  # the first reader adds the spans
    names = [name for name, _ in t.idle_gaps()]
    # 1000-2600 (middle 1800): between the calls, no event; 90-500 (middle
    # 295): chunk 0's rendezvous (199-349), the shortest around it
    assert names[0] == "no host event" and names[1] == "native.rendezvous"
    assert len([h for h in t.host if h[0] == "call"]) == 2  # mirrored roots not repeated
