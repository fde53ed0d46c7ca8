"""The mesh path's spans and bytes (device.compress_mesh; plain versions on
a 1x1 grid of the CPU) over ipb_high.mp4 of the frozen corpus at chunk
mode 1 (two GOP chunks, each picking 16 lanes): the container is the same
with the recorder on and off and equals the single-device compress's; a
traced call is one `call` tree with the walk of every chunk, the mesh's
pack, step, fetch and assembly, the container pack and the joined native
spans, each with its counts; `info` is read from those spans; with the
recorder off nothing is recorded and no clock is read."""
import pytest

from avrecode_tpu_torch import _native
from avrecode_tpu_torch import device as td
from avrecode_tpu_torch import host, trace
from avrecode_tpu_torch import testcorpus as tc
from avrecode_tpu_torch.analysis import read_slim
from avrecode_tpu_torch.parallel import mesh as tmesh

_native.ensure_host_lib()

KW = dict(lanes=16, chunk_mode=1, batch_size=512, sup=4)
MESH_SPANS = ("mesh.pack", "mesh.step", "mesh.fetch", "mesh.assemble", "call.pack")
WALK_SPANS = ("call.open", "call.begin", "call.header", "chunk.fetch", "chunk.take",
              "chunk.parse")


def _mesh():
    return tmesh.make_mesh(1, 1, ["cpu"])


def _traced(fn):
    trace.drain()
    trace.enable()
    try:
        out = fn()
    finally:
        trace.disable()
    return out, trace.drain()


@pytest.fixture(scope="module")
def mesh_call():
    """(the clip, the container with the recorder off, the container and
    info of a traced call, its spans)."""
    data = tc.clip_bytes("ipb_high.mp4")
    off, _ = td.compress_mesh(data, _mesh(), **KW)
    info: dict = {}
    (on, _), spans = _traced(lambda: td.compress_mesh(data, _mesh(), **KW, info=info))
    return data, off, on, info, spans


def test_the_mesh_container_is_the_same_with_the_recorder_on(mesh_call):
    _, off, on, _, _ = mesh_call
    assert on == off


def test_the_mesh_container_equals_the_single_device_compress(mesh_call):
    data, off, _, info, _ = mesh_call
    assert info["n_chunks"] == 2
    single, _ = td.compress(data, KW["lanes"], KW["chunk_mode"], KW["batch_size"],
                            device="cpu")
    assert off == single
    assert host.decompress(off)[0] == data


def test_a_traced_mesh_call_is_one_tree_with_its_phases(mesh_call):
    data, _, _, info, spans = mesh_call
    roots = [s for s in spans if s.parent_id is None]
    assert [r.name for r in roots] == ["call"] and roots[0].count == len(data)
    call = roots[0]
    ids = {s.span_id for s in spans}
    assert all(s.call_id == call.call_id for s in spans)
    assert all(s.parent_id in ids for s in spans if s is not call)
    for name in ("call.open", "call.begin", "call.header") + MESH_SPANS:
        assert [s.parent_id for s in spans if s.name == name] == [call.span_id], name
    for name in ("chunk.fetch", "chunk.take", "chunk.parse"):
        assert sorted(s.chunk for s in spans if s.name == name) == [0, 1], name
    # in order: the walk of every chunk, then the pack, step, fetch, assembly, pack
    order = [next(s for s in spans if s.name == n).start_ns for n in MESH_SPANS]
    assert order == sorted(order)
    last_parse = max(s.end_ns for s in spans if s.name == "chunk.parse")
    assert last_parse <= order[0]

    with host.Session(data, KW["lanes"], KW["chunk_mode"], KW["batch_size"], 2) as session:
        an, stream = read_slim(session, KW["sup"], trace.NULL)
        inputs = td.mesh_inputs(an, [c for _, c in stream], 1, KW["sup"])
    pack = next(s for s in spans if s.name == "mesh.pack")
    assert pack.count == sum(t.nbytes for t in inputs.tensors()) and pack.count2 == 2
    K = inputs.statics["K_total"]
    assert K == 16 and next(s for s in spans if s.name == "mesh.step").count == K
    M = inputs.statics["ns"] * KW["sup"] * KW["batch_size"]
    # x_final int32[G, K], words int16[G, T, K], emits bool[G, T, K], the total int32
    assert next(s for s in spans if s.name == "mesh.fetch").count == 2 * (4 * K + 3 * M) + 4


def test_the_native_walk_joins_the_mesh_call(mesh_call):
    *_, spans = mesh_call
    by_id = {s.span_id: s for s in spans}
    call = next(s for s in spans if s.parent_id is None)
    native = [s for s in spans if s.name.startswith("native.")]
    assert {s.name for s in native} >= {"native.pass1", "native.nz_probe",
                                         "native.trace_walk", "native.export"}
    for s in native:
        parent = by_id[s.parent_id]
        assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns, s
        assert call.start_ns <= s.start_ns and s.end_ns <= call.end_ns, s
    assert sorted(s.chunk for s in native if s.name == "native.trace_walk") == [0, 1]


def test_mesh_info_is_read_from_the_spans(mesh_call):
    *_, info, spans = mesh_call

    def sec(*names):
        return sum(s.seconds for s in spans if s.name in names)

    assert set(info) == {"walk_s", "pack_s", "step_s", "emit_s", "upload_bytes", "n_chunks"}
    assert info["walk_s"] == pytest.approx(sec(*WALK_SPANS))
    assert info["pack_s"] == pytest.approx(sec("mesh.pack"))
    assert info["step_s"] == pytest.approx(sec("mesh.step", "mesh.fetch"))
    assert info["emit_s"] == pytest.approx(sec("mesh.assemble", "call.pack"))
    assert info["upload_bytes"] == next(s for s in spans if s.name == "mesh.pack").count
    assert all(info[k] > 0 for k in info)


def test_a_mesh_call_with_info_and_the_recorder_off_publishes_nothing(mesh_call):
    data, off, *_ = mesh_call
    trace.drain()
    info: dict = {}
    out, _ = td.compress_mesh(data, _mesh(), **KW, info=info)
    assert out == off and info["n_chunks"] == 2
    assert trace.drain() == []


def test_mesh_off_records_nothing_and_reads_no_clock(mesh_call, monkeypatch):
    data, off, *_ = mesh_call
    trace.drain()

    class NoClock:
        @staticmethod
        def monotonic_ns():
            raise AssertionError("a span read the clock with the recorder off")

    monkeypatch.setattr(trace, "time", NoClock)
    out, _ = td.compress_mesh(data, _mesh(), **KW)
    assert out == off
    assert trace.drain() == []
