"""The configuration p0_v2 (profile 0, the v2 model pass) and its cell
p0_v2.archive, on the CPU at sizes a test holds: the cell resolves with its
seven per-layer metrics; whole runs on multigop.mp4's single-GOP pieces are
correct and each planted fault makes them incorrect; the driver runs the
v2 pass whatever ARTC_MODEL_IMPL holds; the port's profile-0 containers
equal the reference's; the control fails at these settings; the seven
readers give the known answers on a synthetic window; the roofline's
counts at bench.mp4's profile-0 chunk 0 are the kernel table's."""
import json
import os

import pytest

import control
import run
from harness import check, clips, roofline_p0, spans, spec, traffic
from harness import trace as tr
from harness.record import Record
from reference import engine
from spec_helpers import metric
from test_perfbench_faults import TRAFFIC, _library_build_id, _plant_compress  # noqa: F401
from test_perfbench_lookup import add_cell, copy_bench
from test_perfbench_spans import _span

from avrecode_tpu_torch import device as td
from avrecode_tpu_torch.ops import model_pass as mp

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
CELL = "p0_v2.archive"
READERS = ("dense.walk_s_per_mb", "dense.export_s_per_mb", "dense.parse_s_per_mb",
           "dense.chunks_s_per_mb", "dense.upload_bytes_per_mb",
           "kernels.model_v2_roofline", "kernels.lane_scan_roofline")
SPAN_READERS = READERS[:5]


def _config() -> dict:
    with open(os.path.join(BENCH, "configs", "p0_v2.json")) as f:
        return json.load(f)


def test_the_cell_resolves_with_its_seven_metrics():
    bench = os.path.join(ROOT, "BENCHMARK.json")
    traced = spec.cell(bench, CELL, trace=True)
    assert [m["name"] for m, _ in traced.metrics] == list(READERS)
    assert all(m["workloads"] == [CELL] and m["moves"] == "throughput_mb_s"
               for m, _ in traced.metrics)
    plain = spec.cell(bench, CELL, trace=False)
    assert [m["name"] for m, _ in plain.metrics] == ["throughput_mb_s", "setup_s"]
    conf = plain.config
    assert (conf["entry"], conf["model_profile"], conf["model_impl"], conf["chunk_mode"],
            conf["batch_size"], conf["lanes"], conf["reduced"]) == (
        "compress_dense", 0, "v2", 0, 4096, 16, ["file_seconds"])
    assert plain.traffic["clips"] == ["camera1080.mp4"] and plain.chips == 1


def _run(tmp_path, capsys, trace_on: int = 0) -> dict:
    """One run of a test cell with p0_v2's settings over multigop.mp4's
    pieces; with trace_on the five span readers are listed for it too."""
    bench, base = copy_bench(tmp_path)
    name = add_cell(bench, base, config="tiny_p0_v2", traffic=TRAFFIC, entry="compress_dense",
                    config_over=_config())
    with open(bench) as f:
        b = json.load(f)
    for m in b["per_layer"]:
        if m["name"] in SPAN_READERS:
            m["workloads"].append(name)
    with open(bench, "w") as f:
        json.dump(b, f)
    capsys.readouterr()
    rc = run.main(["--workload", name, "--seed", "3000000037", "--seconds", "2.0",
                   "--trace", str(trace_on)], device="cpu", bench=bench, base=base)
    out = capsys.readouterr()
    assert rc == 0, out.err[-2000:]
    return json.loads(out.out.strip().splitlines()[-1])


def test_a_sound_p0_v2_run_is_correct(tmp_path, capsys):
    result = _run(tmp_path, capsys)
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] >= 2
    assert set(result["metrics"]) == {"throughput_mb_s", "setup_s"}
    assert all(c["value"] == 0 for c in result["checks"].values())


def test_a_traced_p0_v2_run_reports_the_dense_span_metrics(tmp_path, capsys):
    result = _run(tmp_path, capsys, trace_on=1)
    assert result["correct"] is True
    # no card: the kernels' shares find nothing to read and are left out
    assert set(result["metrics"]) == set(SPAN_READERS)
    assert all(m["value"] > 0 for m in result["metrics"].values())


@pytest.mark.parametrize("fault", ["altered", "half", "unchanged"])
def test_a_planted_fault_makes_a_p0_v2_run_incorrect(tmp_path, capsys, monkeypatch, fault):
    _plant_compress(monkeypatch, fault)
    result = _run(tmp_path, capsys)
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


def test_the_driver_runs_v2_whatever_the_environment_holds(monkeypatch, tmp_path):
    monkeypatch.setenv("ARTC_MODEL_IMPL", "dict")
    drv = spec.load_module(os.path.join(BENCH, "drivers", "compress_dense.py"),
                           "perfbench_driver_compress_dense").Driver(_config(), "cpu",
                                                                       str(tmp_path))
    used = []
    real = mp.run_chunk_v2_tables

    def v2(*a, **k):
        used.append(mp.default_impl())
        return real(*a, **k)

    def other(*a, **k):
        raise AssertionError("the dict, sort or mm pass ran")

    monkeypatch.setattr(mp, "run_chunk_v2_tables", v2)
    monkeypatch.setattr(mp, "run_chunk", other)
    piece = clips.gop_pieces(clips.load(["multigop.mp4"])["multigop.mp4"])[0]
    out = drv._call(piece)
    assert used == ["v2"] and out[:4] == b"ATRC"
    assert os.environ["ARTC_MODEL_IMPL"] == "dict"  # the environment's own value is back


def _pieces():
    out = []
    for name in ("multigop.mp4", "multigop720.mp4"):
        pieces = clips.gop_pieces(clips.load([name])[name])
        out += [(f"{name} g{i:02d}", pieces[i]) for i in (0, 1)]
    return out


@pytest.mark.parametrize("name,data", _pieces(), ids=lambda v: v if isinstance(v, str) else "")
def test_the_port_profile0_container_equals_the_reference(name, data, monkeypatch):
    monkeypatch.delenv("ARTC_MODEL_IMPL", raising=False)
    c = _config()
    out, _ = td.compress(data, c["lanes"], c["chunk_mode"], c["batch_size"], c["model_profile"],
                         device="cpu")
    build_id = out[6:6 + out[5]]
    want = engine.Engine().compress(data, c["chunk_mode"], c["batch_size"], build_id,
                                    c["model_profile"], c["lanes"])
    assert check.bytes_differing(out, want) == 0, name


@pytest.mark.parametrize("prob_bits,correct", [(14, False), (15, True)])
def test_control_fails_and_the_reference_passes_at_p0_v2(prob_bits, correct):
    conf = _config()
    ref = engine.Engine()
    stream = traffic.Stream({"clips": ["multigop.mp4"], "cut": "whole"}, 3000000041)
    eng = ref if prob_bits == 15 else engine.Engine(prob_bits)
    recs = control.control_records(eng, stream, conf, 0.5, b"nogit")
    numbers = check.judge(recs, {it.name: it.data for it in stream.items}, conf, ref, b"nogit")
    assert check.verdict(numbers, len(recs)) is correct
    if not correct:
        assert numbers["container_bytes_differing"] > 0


def _synthetic():
    """A window of one profile-0 call of 2 MB on one thread (0-10,000 µs),
    its mirror 100 µs off the spans' clock; two chunks."""
    off = 100.0
    s = [_span("call", 0, 10000, 2, 1),
         _span("call.open", 0, 100, 2, 2, 1),
         _span("call.analyze", 100, 6000, 2, 3, 1),
         _span("native.dense_walk", 110, 2000, 2, 4, 3),
         _span("native.dense_export", 2000, 2500, 2, 5, 3),
         _span("native.v2_tables", 2200, 2500, 2, 6, 3),
         _span("native.dense_walk", 2500, 4500, 2, 7, 3),
         _span("native.dense_export", 4500, 5000, 2, 8, 3),
         _span("native.v2_tables", 4700, 5000, 2, 9, 3),
         _span("native.copyout", 5000, 5200, 2, 10, 3),
         _span("call.parse", 5200, 6000, 2, 11, 3),
         _span("call.model", 6000, 8000, 2, 12, 1),
         _span("chunk.model", 6000, 7000, 2, 13, 12),
         _span("chunk.model", 7000, 8000, 2, 14, 12),
         _span("call.lanes", 8000, 9900, 2, 15, 1),
         _span("chunk.lanes", 8000, 9000, 2, 16, 15),
         _span("chunk.lanes", 9000, 9900, 2, 17, 15)]
    for sp, c2 in zip([x for x in s if x.name.startswith("chunk.")], (1000, 3000, 500, 700)):
        sp.count2 = c2
    host = [("compress a", -10 + off, 10010 + off), ("call", -1 + off, 10001 + off)]
    # model pass 600 µs, the profile-2 pass (not its row) 50, lane scan 300 and
    # compaction 100 + 100, another kernel 77
    kernels = [("void (anonymous namespace)::scan_kernel<int2>((anonymous namespace)::Scan)",
                6100 + off, 6700 + off),
               ("void (anonymous namespace)::scan_kernel<unsigned int>(Scan)", 6700 + off,
                6750 + off),
               ("(anonymous namespace)::lane_scan_kernel((anonymous namespace)::ScanArgs)",
                8100 + off, 8400 + off),
               ("(anonymous namespace)::compact_count_kernel(Compact)", 8400 + off, 8500 + off),
               ("(anonymous namespace)::compact_write_kernel(Compact)", 8500 + off, 8600 + off),
               ("(anonymous namespace)::lane_scan_dev_kernel(ScanArgs)", 8600 + off,
                8677 + off)]
    t = tr.Trace(window_s=10000e-6, kernels=kernels, host=host)
    recs = [Record("a", 2_000_000, 0.0, 0.01, True, b"")]
    return s, t, recs


def _ctx(monkeypatch, drained, t, recs, chunks=((128, 4_305_700),)):
    monkeypatch.setattr(spans, "_drain", lambda: list(drained))
    ctx = run.Context(records=recs, window_s=t.window_s, setup_s=1.0, config={}, trace=t)
    ctx.chunks = lambda r: list(chunks)
    return ctx


def test_the_dense_readers_give_the_known_answers(monkeypatch):
    s, t, recs = _synthetic()
    ctx = _ctx(monkeypatch, s, t, recs)
    got = {name: metric(name).read(ctx) for name in READERS}
    mb = 2.0
    assert got["dense.walk_s_per_mb"] == pytest.approx((1890e-6 + 2000e-6) / mb)
    assert got["dense.export_s_per_mb"] == pytest.approx((500e-6 + 500e-6) / mb)
    assert got["dense.parse_s_per_mb"] == pytest.approx((200e-6 + 800e-6) / mb)
    assert got["dense.chunks_s_per_mb"] == pytest.approx((2000e-6 + 1900e-6) / mb)
    assert got["dense.upload_bytes_per_mb"] == pytest.approx((1000 + 3000 + 500 + 700) / mb)
    assert got["kernels.model_v2_roofline"] == pytest.approx(
        100 * roofline_p0.least_s(4_305_700, 128, "model_v2") / 600e-6)
    assert got["kernels.lane_scan_roofline"] == pytest.approx(
        100 * roofline_p0.least_s(4_305_700, 128, "lane_scan") / 500e-6)
    # the idle gaps inside the call are named by the dense path's spans
    names = {name for name, _ in t.idle_gaps()}
    assert "native.dense_walk" in names and "no host event" not in names


def test_without_a_recorder_the_dense_span_readers_read_nothing(monkeypatch):
    _, t, recs = _synthetic()
    ctx = _ctx(monkeypatch, [], t, recs)
    assert all(metric(name).read(ctx) is None for name in SPAN_READERS)


def test_a_profile2_window_gives_the_dense_readers_nothing(monkeypatch):
    """The parent's and profile 2's spans (copy-outs included) are not read
    as the dense path's."""
    s = [_span("call", 0, 1000, 2, 1), _span("native.trace_walk", 0, 500, 2, 2, 1, thread=3),
         _span("native.export", 500, 600, 2, 3, 1, thread=3),
         _span("native.copyout", 600, 610, 2, 4, 1)]
    t = tr.Trace(window_s=1e-3, kernels=[("k", 5, 6)], host=[("call", 0.5, 1001)])
    ctx = _ctx(monkeypatch, s, t, [Record("a", 1_000_000, 0.0, 0.001, True, b"")])
    assert all(metric(name).read(ctx) is None for name in READERS)


def test_the_shares_depend_on_the_chunks_not_on_the_timing(monkeypatch):
    _, t, recs = _synthetic()
    slow = tr.Trace(window_s=t.window_s, host=t.host,
                    kernels=[(n, a, a + 2 * (b - a)) for n, a, b in t.kernels])
    for name in READERS[5:]:
        a = metric(name).read(_ctx(monkeypatch, [], t, recs))
        b = metric(name).read(_ctx(monkeypatch, [], slow, recs))
        assert b == pytest.approx(a / 2)


def test_roofline_p0_at_bench_chunk0_gives_the_kernel_table_bounds():
    """bench.mp4's chunk 0 under profile 0 at p0_v2's settings is the
    table's shape, and the counts there are rows 6, 7 and 5 of the kernel
    table (PERF.md)."""
    c = _config()
    data = clips.load(["bench.mp4"])["bench.mp4"]
    an = td.analyze(data, chunk_mode=c["chunk_mode"], batch_size=c["batch_size"],
                    model_profile=0)
    n0 = len(an.chunks[0].bit)
    assert (n0, td.pick_lanes(n0)) == (roofline_p0.N_TABLE, 128)
    w = roofline_p0.work(n0, 128)
    assert w["model_pass_v2"][0] == pytest.approx(214_032_384)
    assert w["model_pass_v2"][1] == pytest.approx(387_973_120)
    assert w["lane_scan"] == (100_664_320, 43_057_000)
    assert w["lane_compact"][0] == pytest.approx(25_690_112)
    assert set(roofline_p0.bound_by(n0, 128).values()) == {"bytes"}
    assert roofline_p0.least_s(n0, 128, "model_v2") * 1e3 == pytest.approx(0.0639, abs=1e-4)

