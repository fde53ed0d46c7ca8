"""The port's bench and microbench (avrecode_tpu_torch.bench, .microbench)
on the CPU: they run the device path's plain versions on a corpus clip,
print every documented key, and fail with an `error` key on a forced
mismatch. The bench's device container must equal the JAX package's
device.compress on the same clip (exact bytes)."""
import contextlib
import io
import json
import os

import pytest
from test_torch_jaxlib import ensure_jax_lib

from avrecode_tpu import device as jd
from avrecode_tpu_torch import _native, bench, microbench
from avrecode_tpu_torch import device as td

# Both host libraries, each built here under its own lock, before any test
# of any module can reach the JAX package's unlocked build (see
# test_torch_jaxlib.py).
_native.ensure_host_lib()
ensure_jax_lib()

CLIP, GOP_CLIP = "i_main.264", "ipb_high.mp4"
BENCH_KEYS = {
    "metric", "unit", "value", "value_median", "vs_baseline", "roundtrip_bit_exact", "device",
    "card", "clip", "gop_clip", "batch_size", "reps", "host_reps", "input_mb",
    "compression_ratio", "bins", "device_bins", "device_e2e_s", "device_e2e_median_s",
    "device_e2e_runs_s", "device_e2e_spread", "host_phases_s", "wire_bytes",
    "device_phases_ms", "microbench", "host_best_s", "host_median_s", "host_run_spread_s",
    "host_path_mb_s",
    "host_path_mb_s_median", "vm_loaded", "host_decompress_mb_s", "gop_scaling_1cpu_s",
    "gop_scaling_parallel_s", "gop_scaling_x", "gop_scaling_cpus", "cpu_calib_s"}
MICRO_KEYS = {
    "chunk", "chunk_bins", "m", "lanes", "reps", "expand_ms", "expand_model_ms", "chain_ms",
    "dense_chain_ms", "dense_upload_ms", "wire_upload_ms", "chain_mbins_s",
    "dense_chain_mbins_s", "dense_mb", "wire_chunk_mb", "wire_mb"}
TIMES = ("expand_ms", "expand_model_ms", "chain_ms", "dense_chain_ms", "dense_upload_ms",
         "wire_upload_ms")


def _bench_argv(corpus_dir):
    return ["--device", "cpu", "--clip", os.path.join(corpus_dir, CLIP),
            "--gop-clip", os.path.join(corpus_dir, GOP_CLIP), "--batch-size", "512",
            "--reps", "1", "--host-reps", "1"]


def _micro_argv(corpus_dir):
    return [os.path.join(corpus_dir, CLIP), "--device", "cpu", "--batch-size", "512",
            "--reps", "1"]


def _main(main, argv):
    """(exit code, the last stdout line as JSON) of main(argv)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.fixture(scope="module")
def bench_run(corpus_dir):
    """One bench run on the CPU, with every container device.compress
    returned to it."""
    containers = []
    real = td.compress

    def spy(*args, **kw):
        comp, st = real(*args, **kw)
        containers.append(comp)
        return comp, st

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(td, "compress", spy)
        rc, rep = _main(bench.main, _bench_argv(corpus_dir))
    return rc, rep, containers


def test_bench_cpu_prints_every_key(bench_run):
    rc, rep, _ = bench_run
    assert rc == 0 and "error" not in rep
    assert set(rep) == BENCH_KEYS
    for key in BENCH_KEYS:  # documented, key by key
        assert key in bench.__doc__, key
    assert rep["value"] > 0 and rep["roundtrip_bit_exact"] is True
    assert rep["device"] == rep["card"] == "cpu"
    assert rep["value"] == rep["input_mb"] / rep["device_e2e_s"]
    # Unfloored: host best over device best as they are (the plain versions
    # on the CPU are far slower than the host engine).
    assert rep["vs_baseline"] == rep["host_best_s"] / rep["device_e2e_s"]
    assert len(rep["device_e2e_runs_s"]) == 1 and len(rep["host_run_spread_s"]) == 1
    assert set(rep["device_phases_ms"]) == set(bench.PHASES)
    assert all(0 <= p["best"] <= p["median"] for p in rep["device_phases_ms"].values())
    assert set(rep["host_phases_s"]) >= {"open_s", "dispatch_s", "emit_s", "pack_s"}
    assert MICRO_KEYS <= set(rep["microbench"])
    assert rep["device_bins"] > 0 and rep["bins"] > 0 and rep["wire_bytes"] > 0


def test_bench_device_container_matches_jax(corpus_dir, bench_run):
    rc, rep, containers = bench_run
    with open(os.path.join(corpus_dir, CLIP), "rb") as f:
        want, _ = jd.compress(f.read(), batch_size=512)
    assert rc == 0 and len(containers) == 1 + rep["reps"]
    assert all(c == want for c in containers)
    assert rep["compression_ratio"] == len(want) / (rep["input_mb"] * 1e6)


def _flip_container(monkeypatch):
    real = td.compress

    def flipped(*args, **kw):
        comp, st = real(*args, **kw)
        return comp[:-1] + bytes([comp[-1] ^ 1]), st
    monkeypatch.setattr(td, "compress", flipped)


def _corrupt_host_probs(monkeypatch):
    real = td.analyze

    def corrupted(*args, **kw):
        an = real(*args, **kw)
        c = an.chunks[0]
        p = c.host_probs.copy()
        p[7] = p[7] % 32767 + 1
        object.__setattr__(c, "host_probs", p)
        return an
    monkeypatch.setattr(td, "analyze", corrupted)


@pytest.mark.parametrize("force", [_flip_container, _corrupt_host_probs],
                         ids=["container_byte", "host_probs"])
def test_bench_fails_on_a_forced_mismatch(corpus_dir, monkeypatch, force):
    force(monkeypatch)
    rc, rep = _main(bench.main, _bench_argv(corpus_dir))
    assert rc != 0 and rep["error"] and rep["value"] == 0.0
    assert "vs_baseline" not in rep


def test_microbench_cpu_prints_every_key(corpus_dir):
    rc, rep = _main(microbench.main, _micro_argv(corpus_dir))
    assert rc == 0 and rep["differential_ok"] is True and "error" not in rep
    assert MICRO_KEYS | {"clip", "card", "batch_size", "differential_ok"} == \
        set(rep) - {k + "_median" for k in TIMES}
    for key in TIMES:
        assert 0 <= rep[key] <= rep[key + "_median"]
        assert key in microbench.__doc__
    assert rep["chain_mbins_s"] == rep["m"] / rep["chain_ms"] / 1e3
    assert rep["card"] == "cpu" and rep["clip"] == CLIP


def test_microbench_fails_on_a_forced_mismatch(corpus_dir, monkeypatch):
    _corrupt_host_probs(monkeypatch)
    rc, rep = _main(microbench.main, _micro_argv(corpus_dir))
    assert rc == 1 and rep["differential_ok"] is False
    assert "chunk 0" in rep["error"] and "chain_ms" not in rep


def test_probs_mismatch_names_the_first_bin(corpus_dir):
    """The differential reports the first differing bin of the first chunk
    that differs."""
    with open(os.path.join(corpus_dir, GOP_CLIP), "rb") as f:
        an = td.analyze(f.read(), chunk_mode=1, batch_size=512, model_profile=2)
    staged = microbench.stage_all(an, "cpu")
    assert len(an.chunks) > 1 and microbench.probs_mismatch(an, staged) is None
    c = an.chunks[1]
    p = c.host_probs.copy()
    p[11] = p[11] % 32767 + 1
    object.__setattr__(c, "host_probs", p)
    assert microbench.probs_mismatch(an, staged) == \
        "device/host probs mismatch on chunk 1 (first at bin 11)"
