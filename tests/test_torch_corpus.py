"""The port's corpus path (avrecode_tpu_torch.parallel.distributed and `cli
corpus`), as tests/test_parallel.py checks the JAX package's: one process,
resume, the CLI, and two processes over gloo that merge their stats with
one all-reduce. The device path runs the plain versions (--device cpu) with
a batch small enough for the test clips."""
import json
import os
import shutil
import socket
import subprocess
import sys
import textwrap
import time

import pytest
from test_torch_jaxlib import ensure_jax_lib

from avrecode_tpu import device as jd
from avrecode_tpu import host as jhost
from avrecode_tpu_torch import _native, cli, host
from avrecode_tpu_torch.parallel import distributed as dist

# Both host libraries, each built here under its own lock, before any test
# of any module can reach the JAX package's unlocked build (see
# test_torch_jaxlib.py).
_native.ensure_host_lib()
ensure_jax_lib()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLIPS = ["i_main.264", "cavlc.mp4", "mbaff.264"]
DEVICE_KW = dict(use_device=True, device="cpu", batch_size=512)


def _inputs(corpus_dir, tmp_path, names=CLIPS):
    """A directory holding copies of `names` (the corpus directory holds
    many more clips)."""
    d = tmp_path / "in"
    d.mkdir()
    for n in names:
        shutil.copy(os.path.join(corpus_dir, n), d / n)
    return d


def _outputs_roundtrip(in_dir, out_dir):
    names = sorted(os.listdir(out_dir))
    for n in names:
        with open(os.path.join(out_dir, n), "rb") as f:
            dec, _ = host.decompress(f.read())
        with open(os.path.join(in_dir, n[:-len(".atrc")]), "rb") as f:
            assert dec == f.read(), n
    return names


@pytest.mark.parametrize("use_device", [False, True])
def test_corpus_compress_single_process(corpus_dir, tmp_path, use_device):
    """One process: every file compressed, verified and reported; the
    containers equal the JAX package's (host engine, or its device path with
    the same parameters)."""
    in_dir = _inputs(corpus_dir, tmp_path)
    out_dir = tmp_path / "out"
    paths = [str(in_dir / n) for n in CLIPS]
    kw = DEVICE_KW if use_device else {}
    rep = dist.corpus_compress(paths, str(out_dir), verify=True, **kw)
    assert rep.failures == 0 and rep.files == 3
    assert rep.ratio < 1.0
    assert rep.input_bytes == sum(os.path.getsize(p) for p in paths)
    assert _outputs_roundtrip(in_dir, out_dir) == sorted(n + ".atrc" for n in CLIPS)
    for n in CLIPS:
        with open(in_dir / n, "rb") as f:
            data = f.read()
        if use_device:
            want, _ = jd.compress(data, chunk_mode=1, batch_size=512)
        else:
            want, _ = jhost.compress(data, chunk_mode=1, batch_size=4096)
        assert (out_dir / (n + ".atrc")).read_bytes() == want, n


def test_corpus_resume(corpus_dir, tmp_path):
    """A resumed run skips completed outputs (written atomically) and redoes
    the missing ones."""
    in_dir = _inputs(corpus_dir, tmp_path, CLIPS[:2])
    out_dir = str(tmp_path / "out")
    paths = [str(in_dir / n) for n in CLIPS[:2]]
    rep1 = dist.corpus_compress(paths, out_dir, verify=True, **DEVICE_KW)
    assert rep1.failures == 0 and rep1.files == 2
    victim = os.path.join(out_dir, "cavlc.mp4.atrc")
    kept = os.path.join(out_dir, "i_main.264.atrc")
    os.remove(victim)
    kept_mtime = os.path.getmtime(kept)
    time.sleep(0.01)
    rep2 = dist.corpus_compress(paths, out_dir, verify=True, resume=True, **DEVICE_KW)
    assert rep2.failures == 0 and rep2.files == 2
    assert os.path.exists(victim)
    assert os.path.getmtime(kept) == kept_mtime
    assert rep2.ratio == pytest.approx(rep1.ratio)
    assert sum(1 for r in rep2.per_file if r[3] == 0.0) == 1  # the skipped file


def test_corpus_resume_redoes_an_older_container(corpus_dir, tmp_path):
    """An output with another container version is redone, not skipped."""
    in_dir = _inputs(corpus_dir, tmp_path, CLIPS[:1])
    out_dir = tmp_path / "out"
    out_dir.mkdir()
    stale = out_dir / "i_main.264.atrc"
    stale.write_bytes(b"ATRC" + bytes([(host.container_version() - 1) & 0xFF]) + b"old")
    assert dist._resume_done(str(in_dir / "i_main.264"), str(out_dir)) is None
    rep = dist.corpus_compress([str(in_dir / "i_main.264")], str(out_dir), resume=True,
                               **DEVICE_KW)
    assert rep.files == 1 and rep.failures == 0
    assert dist._resume_done(str(in_dir / "i_main.264"), str(out_dir)) is not None


def test_corpus_counts_a_failed_file_and_goes_on(corpus_dir, tmp_path):
    """A file that cannot be read counts as a failure; the others finish.
    (Any byte string compresses: the engine passes what it cannot parse
    through as literal bytes.)"""
    in_dir = _inputs(corpus_dir, tmp_path, CLIPS[:1])
    gone = str(in_dir / "vanished.264")
    rep = dist.corpus_compress([str(in_dir / "i_main.264"), gone], str(tmp_path / "out"),
                               **DEVICE_KW)
    assert rep.files == 1 and rep.failures == 1
    assert [os.path.basename(r[0]) for r in rep.per_file] == ["i_main.264.atrc"]


@pytest.mark.parametrize("kind", ["dir", "glob"])
def test_corpus_cli(corpus_dir, tmp_path, capsys, kind):
    in_dir = _inputs(corpus_dir, tmp_path)
    src = str(in_dir) if kind == "dir" else str(in_dir / "*.264")
    out_dir = tmp_path / "out"
    rc = cli.main(["corpus", src, str(out_dir), "--device", "cpu", "--batch-size", "512"])
    assert rc == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    n = 3 if kind == "dir" else 2
    assert rep["files"] == n and rep["failures"] == 0 and rep["process"] == "0/1"
    assert rep["device"] == "cpu"
    assert len(_outputs_roundtrip(in_dir, out_dir)) == n


@pytest.mark.parametrize("chunk_mode", ["0", "1"])
def test_corpus_cli_host_matches_jax(corpus_dir, tmp_path, capsys, chunk_mode):
    """`corpus --host` runs the native host engine, as the JAX CLI's corpus
    does without --device: with the same --chunk-mode both write identical
    files, and their JSON reports agree in every field both have but the
    clock's (wall_s, mb_s)."""
    from avrecode_tpu import cli as jcli
    in_dir = _inputs(corpus_dir, tmp_path)
    reports, outs = [], []
    for name, run in (("port", cli.main), ("jax", jcli.main)):
        out_dir = tmp_path / name
        args = ["corpus", str(in_dir), str(out_dir), "--chunk-mode", chunk_mode]
        capsys.readouterr()
        assert run(args + (["--host"] if name == "port" else [])) == 0
        reports.append(json.loads(capsys.readouterr().out.strip().splitlines()[-1]))
        outs.append({n: (out_dir / n).read_bytes() for n in sorted(os.listdir(out_dir))})
    assert outs[0] == outs[1] and len(outs[0]) == len(CLIPS)
    shared = (set(reports[0]) & set(reports[1])) - {"wall_s", "mb_s"}
    assert shared == {"process", "files", "failures", "input_bytes", "output_bytes", "ratio"}
    assert {k: reports[0][k] for k in shared} == {k: reports[1][k] for k in shared}
    assert reports[0]["device"] == "host"
    assert _outputs_roundtrip(in_dir, tmp_path / "port") == sorted(n + ".atrc" for n in CLIPS)


def test_init_distributed_without_coordinator_is_noop(monkeypatch):
    for k in ("JAX_COORDINATOR", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    assert dist.init_distributed() == (0, 1)
    assert not (dist.dist.is_available() and dist.dist.is_initialized())


def test_corpus_two_processes(corpus_dir, tmp_path):
    """Two processes join one gloo group through the JAX launch variables,
    deal the corpus between them, and both report the merged stats of one
    all-reduce; every output roundtrips."""
    in_dir = _inputs(corpus_dir, tmp_path)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    out_dir = tmp_path / "out"
    script = textwrap.dedent(f"""
        import os, sys
        os.environ["JAX_COORDINATOR"] = "localhost:{port}"
        os.environ["JAX_NUM_PROCESSES"] = "2"
        os.environ["JAX_PROCESS_ID"] = sys.argv[1]
        from avrecode_tpu_torch import cli
        from avrecode_tpu_torch.parallel import distributed
        rc = cli.main(["corpus", {str(in_dir)!r}, {str(out_dir)!r}, "--device", "cpu",
                       "--batch-size", "512"])
        print(distributed.calls["_psum_across_processes"])
        sys.exit(rc)
    """)
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    procs = [subprocess.Popen([sys.executable, "-c", script, str(i)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env, cwd=REPO)
             for i in range(2)]
    reports = []
    try:
        for pr in procs:
            out, err = pr.communicate(timeout=300)
            assert pr.returncode == 0, err[-2000:]
            lines = out.strip().splitlines()
            assert lines[-1] == "1"  # one collective per process
            reports.append(json.loads(lines[-2]))
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
    assert [r["process"] for r in reports] == ["0/2", "1/2"]
    for key in ("files", "input_bytes", "output_bytes", "failures"):
        assert reports[0][key] == reports[1][key], key
    assert reports[0]["files"] == 3 and reports[0]["failures"] == 0
    assert len(_outputs_roundtrip(in_dir, out_dir)) == 3
