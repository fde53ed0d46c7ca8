"""A whole run on the CPU (the program's plain versions, so no look for a
card), at a size a test holds: multigop.mp4's eight single-GOP pieces of
about 8 KB. A sound run is correct; each fault the cell can have, planted in
the timed path, makes `correct` false:

    altered    one byte of a container changed where it is produced
    half       half of the work left out (half of each container; half of
               each list the pool is handed)
    unchanged  a call that hands back its input unchanged

The build id that the containers should carry is the one the program's
library was built with: in a git checkout whose HEAD has moved since, that
is older than the id the harness works out from HEAD, so these runs take
the library's (test_perfbench_build_id.py tests the harness's own).
"""
import json
import os

import pytest

import run
from harness import check, clips
from test_perfbench_lookup import add_cell, copy_bench

TRAFFIC = {"clips": ["multigop.mp4"], "cut": "gop", "list_len": 2}


def _flip_last(b: bytes) -> bytes:
    return b[:-1] + bytes([b[-1] ^ 1])


def _plant_compress(monkeypatch, fault):
    from avrecode_tpu_torch import device as td
    orig = td.compress

    def broken(data, *a, **k):
        out, st = orig(data, *a, **k)
        return {"altered": _flip_last(out), "half": out[:len(out) // 2],
                "unchanged": data}[fault], st
    monkeypatch.setattr(td, "compress", broken)


def _plant_corpus(monkeypatch, fault):
    from avrecode_tpu_torch.parallel import distributed as dist
    if fault == "half":
        orig_pool = dist.corpus_compress
        monkeypatch.setattr(dist, "corpus_compress",
                            lambda paths, *a, **k: orig_pool(paths[::2], *a, **k))
        return
    orig = dist._compress_one

    def broken(path, *a, **k):
        res = orig(path, *a, **k)
        with open(res[0], "rb") as f:
            out = f.read()
        with open(path, "rb") as f:
            data = f.read()
        with open(res[0], "wb") as f:
            f.write(_flip_last(out) if fault == "altered" else data)
        return res
    monkeypatch.setattr(dist, "_compress_one", broken)


@pytest.fixture(autouse=True)
def _library_build_id(monkeypatch):
    from avrecode_tpu_torch import host
    piece = clips.gop_pieces(clips.load(["multigop.mp4"])["multigop.mp4"])[0]
    out, _ = host.compress(piece, 16, 0, 4096, 2)
    monkeypatch.setattr(check, "expected_build_id", lambda root: out[6:6 + out[5]])


def _run(tmp_path, capsys, entry: str, seconds: float = 2.0, trace: int = 0) -> dict:
    bench, base = copy_bench(tmp_path)
    over = {"chunk_mode": 1, "host_workers": 2, "verify": True} if entry == "corpus" else {}
    name = add_cell(bench, base, config=f"tiny_{entry}", traffic=TRAFFIC, entry=entry,
                    config_over=over)
    capsys.readouterr()
    rc = run.main(["--workload", name, "--seed", "3000000019", "--seconds", str(seconds),
                   "--trace", str(trace)], device="cpu", bench=bench, base=base)
    out = capsys.readouterr()
    assert rc == 0, out.err[-2000:]
    result = json.loads(out.out.strip().splitlines()[-1])
    assert out.err.strip().splitlines()[-1].startswith("check ")
    assert list(result)[-1] == "checks"
    return result


@pytest.mark.parametrize("entry", ["compress", "corpus"])
def test_a_sound_run_is_correct(tmp_path, capsys, entry):
    result = _run(tmp_path, capsys, entry)
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] >= 2
    assert set(result["metrics"]) == {"throughput_mb_s", "setup_s"}
    assert all(c["value"] == 0 for c in result["checks"].values())


def test_a_traced_run_reports_the_per_layer_metrics(tmp_path, capsys):
    result = _run(tmp_path, capsys, "compress", trace=1)
    assert result["correct"] is True
    # no card: the device's metrics find nothing to read and are left out
    assert set(result["metrics"]) == set()  # the test cell is listed by none but kernels.*


@pytest.mark.parametrize("entry,fault", [
    ("compress", "altered"), ("compress", "half"), ("compress", "unchanged"),
    ("corpus", "altered"), ("corpus", "half"), ("corpus", "unchanged")])
def test_a_planted_fault_makes_the_run_incorrect(tmp_path, capsys, monkeypatch, entry, fault):
    (_plant_compress if entry == "compress" else _plant_corpus)(monkeypatch, fault)
    result = _run(tmp_path, capsys, entry)
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())
