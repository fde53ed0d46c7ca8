"""The configuration p2_mesh (device.compress_mesh on a 1x1 grid) and its
cell p2_mesh.archive, on the CPU at sizes a test holds: the cell resolves
with its six per-layer metrics and its settings; whole runs with p2_mesh's
settings on multigop.mp4 whole (eight GOP chunks, each picking 16 lanes)
are correct and each planted fault makes them incorrect; the mesh's
container equals the reference's; a traced run reports the five span
metrics; the six readers give the known answers on a synthetic window;
the roofline's counts at camera1080.mp4's four GOP chunks are PERF.md's."""
import json
import os

import pytest

import run
from harness import check, clips, roofline, roofline_mesh, roofline_p0, spans, spec
from harness import trace as tr
from harness.record import Record
from reference import engine
from spec_helpers import metric
from test_perfbench_faults import _flip_last, _library_build_id  # noqa: F401
from test_perfbench_lookup import add_cell, copy_bench
from test_perfbench_spans import _span

from avrecode_tpu_torch import device as td
from avrecode_tpu_torch.parallel import mesh as tmesh

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
CELL = "p2_mesh.archive"
READERS = ("mesh.walk_s_per_mb", "mesh.pack_s_per_mb", "mesh.step_s_per_mb",
           "mesh.emit_s_per_mb", "mesh.upload_bytes_per_mb", "kernels.mesh_roofline")
SPAN_READERS = READERS[:5]
TRAFFIC = {"clips": ["multigop.mp4"], "cut": "whole"}
# camera1080.mp4's GOP chunks at p2_mesh's settings: bins, all at K = 128
CAMERA_CHUNKS = (11_215_741, 11_247_584, 11_216_365, 11_263_923)


def _config() -> dict:
    with open(os.path.join(BENCH, "configs", "p2_mesh.json")) as f:
        return json.load(f)


def test_the_cell_resolves_with_its_six_metrics():
    bench = os.path.join(ROOT, "BENCHMARK.json")
    traced = spec.cell(bench, CELL, trace=True)
    assert [m["name"] for m, _ in traced.metrics] == list(READERS)
    assert all(m["workloads"] == [CELL] and m["moves"] == "throughput_mb_s"
               for m, _ in traced.metrics)
    plain = spec.cell(bench, CELL, trace=False)
    assert [m["name"] for m, _ in plain.metrics] == ["throughput_mb_s", "setup_s"]
    conf = plain.config
    assert (conf["entry"], conf["model_profile"], conf["chunk_mode"], conf["batch_size"],
            conf["lanes"], conf["sup"], conf["mesh"], conf["prob_bits"], conf["processes"],
            conf["cards"], conf["reduced"]) == (
        "compress_mesh", 2, 1, 4096, 16, 128, [1, 1], 15, 1, 1, ["cards", "file_seconds"])
    assert plain.traffic["clips"] == ["camera1080.mp4"] and plain.traffic["cut"] == "whole"
    assert plain.chips == 1


def _plant_mesh(monkeypatch, fault):
    orig = td.compress_mesh

    def broken(data, *a, **k):
        out, st = orig(data, *a, **k)
        return {"altered": _flip_last(out), "half": out[:len(out) // 2],
                "unchanged": data}[fault], st
    monkeypatch.setattr(td, "compress_mesh", broken)


def _run(tmp_path, capsys, trace_on: int = 0) -> dict:
    """One run of a test cell with p2_mesh's settings over multigop.mp4
    whole; with trace_on the five span readers are listed for it too."""
    bench, base = copy_bench(tmp_path)
    name = add_cell(bench, base, config="tiny_p2_mesh", traffic=TRAFFIC, entry="compress_mesh",
                    config_over=_config())
    with open(bench) as f:
        b = json.load(f)
    for m in b["per_layer"]:
        if m["name"] in SPAN_READERS:
            m["workloads"].append(name)
    with open(bench, "w") as f:
        json.dump(b, f)
    capsys.readouterr()
    rc = run.main(["--workload", name, "--seed", "3000000053", "--seconds", "1.0",
                   "--trace", str(trace_on)], device="cpu", bench=bench, base=base)
    out = capsys.readouterr()
    assert rc == 0, out.err[-2000:]
    return json.loads(out.out.strip().splitlines()[-1])


def test_a_sound_p2_mesh_run_is_correct(tmp_path, capsys):
    result = _run(tmp_path, capsys)
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] >= 1
    assert set(result["metrics"]) == {"throughput_mb_s", "setup_s"}
    assert all(c["value"] == 0 for c in result["checks"].values())


def test_a_traced_p2_mesh_run_reports_the_mesh_span_metrics(tmp_path, capsys):
    result = _run(tmp_path, capsys, trace_on=1)
    assert result["correct"] is True
    # no card: the roofline finds no kernel to read and is left out
    assert set(result["metrics"]) == set(SPAN_READERS)
    assert all(m["value"] > 0 for m in result["metrics"].values())


@pytest.mark.parametrize("fault", ["altered", "half", "unchanged"])
def test_a_planted_fault_makes_a_p2_mesh_run_incorrect(tmp_path, capsys, monkeypatch, fault):
    _plant_mesh(monkeypatch, fault)
    result = _run(tmp_path, capsys)
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


def test_the_mesh_container_equals_the_reference_at_chunk_mode_1():
    c = _config()
    data = clips.load(["multigop.mp4"])["multigop.mp4"]
    out, st = td.compress_mesh(data, tmesh.make_mesh(1, 1, ["cpu"]), lanes=c["lanes"],
                               chunk_mode=c["chunk_mode"], batch_size=c["batch_size"],
                               sup=c["sup"])
    assert st.n_chunks == 8
    build_id = out[6:6 + out[5]]
    want = engine.Engine().compress(data, c["chunk_mode"], c["batch_size"], build_id,
                                    c["model_profile"], c["lanes"])
    assert check.bytes_differing(out, want) == 0


def _synthetic():
    """A window of one mesh call of 2 MB on one thread (0-10,000 µs), its
    mirror 100 µs off the spans' clock; two chunks walked, then packed,
    stepped, fetched, assembled and packed."""
    off = 100.0
    s = [_span("call", 0, 10000, 2, 1),
         _span("call.open", 0, 300, 2, 2, 1),
         _span("native.pass1", 10, 250, 2, 3, 1, thread=7),
         _span("call.begin", 300, 400, 2, 4, 1),
         _span("call.header", 400, 420, 2, 5, 1),
         _span("chunk.fetch", 420, 1420, 2, 6, 1),
         _span("chunk.take", 1420, 1470, 2, 7, 1),
         _span("chunk.parse", 1470, 1670, 2, 8, 1),
         _span("chunk.fetch", 1670, 2670, 2, 9, 1),
         _span("chunk.take", 2670, 2720, 2, 10, 1),
         _span("chunk.parse", 2720, 2920, 2, 11, 1),
         _span("mesh.pack", 2920, 3920, 2, 12, 1),
         _span("mesh.step", 3920, 4120, 2, 13, 1),
         _span("mesh.fetch", 4120, 8120, 2, 14, 1),
         _span("mesh.assemble", 8120, 9120, 2, 15, 1),
         _span("call.pack", 9120, 9900, 2, 16, 1)]
    s[11].count, s[11].count2 = 5_000_000, 2
    host = [("compress_mesh a", -10 + off, 10010 + off), ("call", -1 + off, 10001 + off)]
    # the step's kernels: expand 500 µs, pass 1000, lane scan 2000, others 500
    kernels = [("(anonymous namespace)::wire_expand_kernel(Args)", 4200 + off, 4700 + off),
               ("void (anonymous namespace)::scan_kernel<unsigned int>(Scan)", 4700 + off,
                5700 + off),
               ("(anonymous namespace)::lane_scan_kernel((anonymous namespace)::ScanArgs)",
                5700 + off, 7700 + off),
               ("void at::native::vectorized_elementwise_kernel<4>(...)", 7700 + off,
                8200 + off)]
    t = tr.Trace(window_s=10000e-6, kernels=kernels, host=host)
    recs = [Record("a", 2_000_000, 0.0, 0.01, True, b"")]
    return s, t, recs


def _ctx(monkeypatch, drained, t, recs, chunks=tuple((128, n) for n in CAMERA_CHUNKS)):
    monkeypatch.setattr(spans, "_drain", lambda: list(drained))
    ctx = run.Context(records=recs, window_s=t.window_s, setup_s=1.0, config={}, trace=t)
    ctx.chunks = lambda r: list(chunks)
    return ctx


def test_the_mesh_readers_give_the_known_answers(monkeypatch):
    s, t, recs = _synthetic()
    ctx = _ctx(monkeypatch, s, t, recs)
    got = {name: metric(name).read(ctx) for name in READERS}
    mb = 2.0
    assert got["mesh.walk_s_per_mb"] == pytest.approx(
        (300e-6 + 100e-6 + 20e-6 + 2 * (1000e-6 + 50e-6 + 200e-6)) / mb)
    assert got["mesh.pack_s_per_mb"] == pytest.approx(1000e-6 / mb)
    assert got["mesh.step_s_per_mb"] == pytest.approx((200e-6 + 4000e-6) / mb)
    assert got["mesh.emit_s_per_mb"] == pytest.approx((1000e-6 + 780e-6) / mb)
    assert got["mesh.upload_bytes_per_mb"] == pytest.approx(5_000_000 / mb)
    least = sum(roofline_mesh.least_s(n, 128) for n in CAMERA_CHUNKS)
    assert got["kernels.mesh_roofline"] == pytest.approx(100 * least / 4000e-6)
    # the idle gaps inside the call are named by the mesh path's spans
    names = {name for name, _ in t.idle_gaps()}
    assert names <= {sp.name for sp in s} and "no host event" not in names


def test_without_a_recorder_the_mesh_span_readers_read_nothing(monkeypatch):
    _, t, recs = _synthetic()
    ctx = _ctx(monkeypatch, [], t, recs)
    assert all(metric(name).read(ctx) is None for name in SPAN_READERS)


def test_a_single_device_window_gives_the_mesh_readers_nothing(monkeypatch):
    """device.compress's spans (its walk, its `call.pack`) are not read as
    the mesh's."""
    s = [_span("call", 0, 1000, 2, 1), _span("call.open", 0, 100, 2, 2, 1),
         _span("chunk.fetch", 100, 300, 2, 3, 1), _span("chunk.stage", 300, 400, 2, 4, 1),
         _span("call.pack", 900, 1000, 2, 5, 1)]
    t = tr.Trace(window_s=1e-3, host=[("call", 0.5, 1001)])
    ctx = _ctx(monkeypatch, s, t, [Record("a", 1_000_000, 0.0, 0.001, True, b"")])
    assert all(metric(name).read(ctx) is None for name in READERS)


def test_the_mesh_roofline_depends_on_the_chunks_not_on_the_timing(monkeypatch):
    _, t, recs = _synthetic()
    slow = tr.Trace(window_s=t.window_s, host=t.host,
                    kernels=[(n, a, a + 2 * (b - a)) for n, a, b in t.kernels])
    a = metric("kernels.mesh_roofline").read(_ctx(monkeypatch, [], t, recs))
    b = metric("kernels.mesh_roofline").read(_ctx(monkeypatch, [], slow, recs))
    assert b == pytest.approx(a / 2)


def test_roofline_mesh_at_the_camera_chunks_gives_perf_md_counts():
    """camera1080.mp4's four GOP chunks at K = 128: the bytes and operations
    PERF.md states for one file, every kernel bound by its bytes; the
    constants are roofline.py's rows 1 and 3 and roofline_p0.py's row 7."""
    total: dict = {}
    for n in CAMERA_CHUNKS:
        for k, (b, o) in roofline_mesh.work(n, 128).items():
            tb, to = total.get(k, (0, 0))
            total[k] = (tb + b, to + o)
        assert set(roofline_mesh.bound_by(n, 128).values()) == {"bytes"}
    assert total["wire_expand4_blob"][0] == pytest.approx(1_475_593_069, abs=1)
    assert total["wire_expand4_blob"][1] == pytest.approx(963_184_139, abs=1)
    assert total["model_pass_v4"][0] == pytest.approx(1_346_525_102, abs=1)
    assert total["model_pass_v4"][1] == pytest.approx(3_721_393_264, abs=1)
    assert total["lane_scan"] == (539_329_024, 449_436_130)
    least = sum(roofline_mesh.least_s(n, 128) for n in CAMERA_CHUNKS)
    assert least * 1e3 == pytest.approx(1.0034, abs=1e-4)
    # where the live steps are a power of two, the scan's count is roofline_p0's row 7
    n = 128 * 65_536
    assert roofline_mesh.work(n, 128)["lane_scan"] == roofline_p0.work(n, 128)["lane_scan"]
    assert roofline_mesh.work(n, 128)["model_pass_v4"] == roofline.work(n, 128)["model_pass_v4"]
