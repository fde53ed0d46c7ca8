"""The port's span recorder (avrecode_tpu_torch.trace) on the CPU: one traced
compress of benchdata/multigop720.mp4 (profile 2, two chunks) gives one
`call` tree whose native spans nest inside their Python parents on the
shared clock, `info` agrees with the spans, the container does not change
with the recorder on, nothing is recorded with it off, and a traced
two-worker corpus gives each file its own call. A traced profile-0
compress of benchdata/multigop.mp4 (eight chunks) gives the dense path's
tree: per chunk one walk and one export holding its v2 tables on a
walker thread, and on the calling thread one wait and hand-over, one
parse, one model pass and one lane encode, each with its counts."""
import os
import struct

import pytest

from avrecode_tpu_torch import device as td
from avrecode_tpu_torch import host, trace
from avrecode_tpu_torch.ops import model_pass as mp
from avrecode_tpu_torch.parallel import distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHUNK_SPANS = ("chunk.fetch", "chunk.take", "chunk.parse", "chunk.stage", "chunk.launch",
               "chunk.compact", "chunk.emit")
NATIVE_ON_CALLER = {"native.ready_wait": ("call.begin", "call.pack"),
                    "native.rendezvous": ("chunk.fetch",), "native.copyout": ("chunk.fetch",),
                    "native.pack": ("call.pack",)}


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _traced(fn):
    """fn()'s result and the spans it published, with the recorder on."""
    trace.drain()
    trace.enable()
    try:
        out = fn()
    finally:
        trace.disable()
    return out, trace.drain()


@pytest.fixture(scope="module")
def multigop():
    """(container and info with the recorder off, the same with it on, the
    traced call's spans)."""
    data = _read(os.path.join(REPO, "benchdata", "multigop720.mp4"))
    off_info, on_info = {}, {}
    off, _ = td.compress(data, device="cpu", info=off_info)
    (on, _), spans = _traced(lambda: td.compress(data, device="cpu", info=on_info))
    return off, off_info, on, on_info, spans


def test_one_call_root_and_every_child_carries_its_id(multigop):
    _, _, _, info, spans = multigop
    roots = [s for s in spans if s.parent_id is None]
    assert [r.name for r in roots] == ["call"] and roots[0].count > 0
    call = roots[0]
    ids = {s.span_id for s in spans}
    assert len(ids) == len(spans)
    assert all(s.call_id == call.call_id for s in spans)
    assert all(s.parent_id in ids for s in spans if s is not call)
    n = info["n_chunks"]
    assert n == 2
    for name in CHUNK_SPANS:
        assert sorted(s.chunk for s in spans if s.name == name) == list(range(n)), name
    for name in ("call.open", "call.begin", "call.header", "call.emit", "call.pack"):
        assert [s.parent_id for s in spans if s.name == name] == [call.span_id], name


def test_native_spans_nest_in_their_python_parents_on_one_clock(multigop):
    *_, spans = multigop
    by_id = {s.span_id: s for s in spans}
    call = next(s for s in spans if s.parent_id is None)
    native = [s for s in spans if s.name.startswith("native.")]
    assert {s.name for s in native} >= {"native.pass1", "native.nz_probe",
                                         "native.trace_walk", "native.export",
                                         *NATIVE_ON_CALLER}
    for s in native:
        parent = by_id[s.parent_id]
        assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns, s
        assert call.start_ns <= s.start_ns and s.end_ns <= call.end_ns, s
        if s.name in NATIVE_ON_CALLER:
            assert s.thread == call.thread and parent.name in NATIVE_ON_CALLER[s.name], s
            if parent.name == "chunk.fetch":
                assert parent.chunk == s.chunk
        else:
            assert parent is call
    pass1 = next(s for s in native if s.name == "native.pass1")
    assert pass1.thread != call.thread and pass1.count > 0 and pass1.count2 >= 1


def test_walk_and_export_once_per_chunk_with_bins_and_bytes(multigop):
    *_, spans = multigop
    for name in ("native.trace_walk", "native.export", "native.rendezvous", "native.copyout"):
        got = sorted((s.chunk, s) for s in spans if s.name == name)
        assert [c for c, _ in got] == [0, 1], name
        if name != "native.rendezvous":
            assert all(s.count > 0 for _, s in got), name
    exports = {s.chunk: s.count for s in spans if s.name == "native.export"}
    copies = {s.chunk: s.count for s in spans if s.name == "native.copyout"}
    assert exports == copies  # the copy-out hands over the export whole


def test_info_agrees_with_the_spans(multigop):
    _, off_info, _, info, spans = multigop
    assert set(info) == set(off_info)
    assert {"open_s", "fetch_s", "fetch_wait_s", "parse_s", "stage_s", "launch_s",
            "compact_s", "dispatch_s", "emit_s", "pack_s", "wire_bytes",
            "n_chunks"} <= set(info)

    def sec(*names):
        return sum(s.seconds for s in spans if s.name in names)

    def first(name):
        return next(s for s in spans if s.name == name)

    want = {"fetch_wait_s": sec("chunk.fetch", "chunk.take"), "parse_s": sec("chunk.parse"),
            "stage_s": sec("chunk.stage"), "launch_s": sec("chunk.launch"),
            "compact_s": sec("chunk.compact"), "emit_s": sec("call.emit", "chunk.emit"),
            "pack_s": sec("call.pack"),
            "open_s": (first("call.header").end_ns - first("call.open").start_ns) / 1e9,
            "dispatch_s": (first("call.emit").start_ns - first("call.header").end_ns) / 1e9}
    for key, value in want.items():
        assert info[key] == pytest.approx(value, abs=1e-3), key
    assert info["fetch_s"] == pytest.approx(info["fetch_wait_s"] + info["parse_s"])
    assert info["wire_bytes"] == sum(s.count for s in spans if s.name == "chunk.stage")
    # the native waits lie inside the phases that hold them
    assert sec("native.rendezvous", "native.copyout") <= sec("chunk.fetch") + 1e-3
    assert info["open_s"] >= sec("native.ready_wait") - 1e-3


def test_the_container_is_the_same_with_the_recorder_on(multigop):
    off, off_info, on, on_info, _ = multigop
    assert on == off
    assert on_info["blobs"] == off_info["blobs"]


def _session_spans(data) -> list:
    """Opens a profile-2 session, fetches every chunk, and returns what
    artc_session_trace hands over before the close."""
    with host.Session(data, 16, 0, 1024, 2) as session:
        n = session.begin(mp.default_sup(), 0)
        assert n > 0
        for i in range(n):
            session.chunk(i).take()
        return session.trace()


def test_off_records_nothing_and_reads_no_clock(corpus_dir, monkeypatch):
    data = _read(os.path.join(corpus_dir, "i_main.264"))
    assert trace.root("call") is trace.NULL  # the recorder is off
    trace.drain()
    assert _session_spans(data) == []

    class NoClock:
        @staticmethod
        def monotonic_ns():
            raise AssertionError("a span read the clock with the recorder off")

    with monkeypatch.context() as m:
        m.setattr(trace, "time", NoClock)
        m.delenv("ARTC_TIMING", raising=False)
        td.compress(data, batch_size=1024, device="cpu")
    assert trace.drain() == []
    # the same session records once the recorder is on
    recs, _ = _traced(lambda: _session_spans(data))
    assert {r[0] for r in recs} >= {"native.pass1", "native.trace_walk", "native.export",
                                     "native.rendezvous", "native.copyout"}


def test_a_traced_two_worker_corpus_gives_each_file_its_own_call(corpus_dir, tmp_path):
    names = ["i_main.264", "cavlc.mp4", "mbaff.264"]
    paths = [os.path.join(corpus_dir, n) for n in names]
    rep, spans = _traced(lambda: dist.corpus_compress(
        paths, str(tmp_path / "out"), use_device=True, device="cpu", batch_size=512,
        verify=True, host_workers=2))
    assert rep.failures == 0 and rep.files == 3
    by_id = {s.span_id: s for s in spans}
    files = [s for s in spans if s.name == "corpus.file"]
    pools = [s for s in spans if s.name == "corpus.pool"]
    assert len(files) == 3 and len(pools) == 1
    assert all(s.parent_id is None for s in files + pools)
    assert len({s.call_id for s in files + pools}) == 4
    assert sorted(s.count for s in files) == sorted(os.path.getsize(p) for p in paths)
    for f in files:
        mine = [s for s in spans if s.call_id == f.call_id]
        kids = {s.name: s for s in mine if s.parent_id == f.span_id}
        assert set(kids) == {"corpus.queued", "corpus.read", "call", "corpus.verify",
                             "corpus.write"}
        assert pools[0].start_ns <= kids["corpus.queued"].start_ns <= f.start_ns
        for s in mine:
            if s is not f:
                p = by_id[s.parent_id]
                assert p.call_id == f.call_id
        assert any(s.name == "native.trace_walk" for s in mine)


@pytest.fixture(scope="module")
def profile0():
    """As `multigop`, for a profile-0 compress (the v2 pass) of
    benchdata/multigop.mp4 at chunk mode 1 and batch 1024: eight chunks."""
    data = _read(os.path.join(REPO, "benchdata", "multigop.mp4"))
    args = (data, 16, 1, 1024, 0)
    off_info, on_info = {}, {}
    with pytest.MonkeyPatch.context() as m:
        m.delenv("ARTC_MODEL_IMPL", raising=False)
        off, _ = td.compress(*args, device="cpu", info=off_info)
        (on, _), spans = _traced(lambda: td.compress(*args, device="cpu", info=on_info))
    return off, off_info, on, on_info, spans


def _one(spans, name, chunk=None):
    got = [s for s in spans if s.name == name and s.chunk == chunk]
    assert len(got) == 1, (name, chunk, len(got))
    return got[0]


def test_profile0_gives_each_chunk_its_walk_export_model_and_lanes(profile0):
    """The producer's walker threads (at most three) walk and export chunks,
    none more than three ahead of the chunks taken; the calling thread, per
    chunk, waits for the chunk and takes it (`chunk.fetch`, holding the
    native rendezvous and hand-over), parses it, runs its model pass and its
    lane encode."""
    *_, info, spans = profile0
    by_id = {s.span_id: s for s in spans}
    call = _one(spans, "call")
    n_chunks = info["n_chunks"]
    assert n_chunks == 8 and len(info["blobs"]) == n_chunks
    assert not {"native.trace_walk", "native.export"} & {s.name for s in spans}
    walks, prev = [], None
    for i, blob in enumerate(info["blobs"]):
        K, n = struct.unpack_from("<II", blob)
        walk = _one(spans, "native.dense_walk", i)
        xport = _one(spans, "native.dense_export", i)
        v2 = _one(spans, "native.v2_tables", i)
        assert walk.count == n > 0
        assert walk.end_ns <= xport.start_ns
        assert xport.start_ns <= v2.start_ns <= v2.end_ns <= xport.end_ns
        assert 0 < v2.count < xport.count
        for s in (walk, xport, v2):
            assert by_id[s.parent_id] is call and s.thread != call.thread
        walks.append(walk)
        fetch = _one(spans, "chunk.fetch", i)
        wait = _one(spans, "native.rendezvous", i)
        copy = _one(spans, "native.copyout", i)
        parse = _one(spans, "call.parse", i)
        model = _one(spans, "chunk.model", i)
        lanes = _one(spans, "chunk.lanes", i)
        for s in (wait, copy):
            assert by_id[s.parent_id] is fetch and s.thread == call.thread
        for s in (fetch, parse, model, lanes):
            assert by_id[s.parent_id] is call and s.thread == call.thread
        assert copy.count == xport.count  # the chunk's export, handed over whole
        assert xport.end_ns <= copy.start_ns
        assert fetch.end_ns <= parse.start_ns and parse.end_ns <= model.start_ns
        assert model.end_ns <= lanes.start_ns
        if prev is not None:
            assert prev.end_ns <= fetch.start_ns
        if i >= 3:  # claimed once chunk i - 3 was taken
            assert _one(spans, "native.copyout", i - 3).start_ns <= walk.start_ns
        prev = lanes
        assert model.count == n and lanes.count == K
        # the pass's five bin planes (int32, padded) and the probs download
        assert model.count2 >= 6 * 4 * n
        # bits and probs as int32, the mask as bool, over T x K steps
        T = 1 << max(0, (-(-n // K) - 1).bit_length())
        assert lanes.count2 == 9 * T * K
    assert 1 <= len({w.thread for w in walks}) <= 3


def test_profile0_info_agrees_with_the_spans(profile0):
    _, off_info, _, info, spans = profile0
    assert set(info) == set(off_info) >= {"analyze_s", "model_s", "lanes_s", "pack_s"}

    def sec(*names):
        return sum(s.seconds for s in spans if s.name in names)

    assert info["analyze_s"] == pytest.approx(
        sec("call.open", "call.begin", "call.header", "chunk.fetch", "call.parse"), abs=1e-6)
    assert info["model_s"] == pytest.approx(sec("chunk.model"), abs=1e-6)
    assert info["lanes_s"] == pytest.approx(sec("chunk.lanes"), abs=1e-6)
    assert sec("native.rendezvous", "native.copyout") <= sec("chunk.fetch") + 1e-3


def test_profile0_container_is_the_same_with_the_recorder_on(profile0):
    off, off_info, on, on_info, _ = profile0
    assert on == off
    assert on_info["blobs"] == off_info["blobs"]


def test_profile0_off_records_nothing_and_reads_no_clock(corpus_dir, monkeypatch):
    data = _read(os.path.join(corpus_dir, "i_main.264"))
    trace.drain()

    class NoClock:
        @staticmethod
        def monotonic_ns():
            raise AssertionError("a span read the clock with the recorder off")

    monkeypatch.setattr(trace, "time", NoClock)
    monkeypatch.delenv("ARTC_TIMING", raising=False)
    td.compress(data, 16, 0, 1024, 0, device="cpu")
    assert trace.drain() == []
