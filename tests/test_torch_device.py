"""The port's compress path (avrecode_tpu_torch.device, plain versions on the
CPU) against the JAX package's: byte-identical containers that the host
decoder reads back; the port never imports jax or the JAX package; a CUDA
request never runs on the CPU."""
import ast
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from test_torch_jaxlib import ensure_jax_lib

from avrecode_tpu import device as jd
from avrecode_tpu import pipeline
from avrecode_tpu_torch import _native, cli
from avrecode_tpu_torch import device as td
from avrecode_tpu_torch.ops import lanes as tl

# Both host libraries, each built here under its own lock, before any test
# of any module can reach the JAX package's unlocked build (see
# test_torch_jaxlib.py).
_native.ensure_host_lib()
ensure_jax_lib()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _read(corpus_dir, clip):
    with open(os.path.join(corpus_dir, clip), "rb") as f:
        return f.read()


# v16 warm-started sections on a small clip (as test_device_model.py's
# warm-section tests force them): later chunks alias earlier chunks' tables.
WARM = {"ARTC_SECTION_BINS": "150000", "ARTC_SEED_BINS": "100000",
        "ARTC_WARM_BINS": "120000"}


@pytest.mark.parametrize("clip,kw,env", [
    ("i_main.264", dict(batch_size=1024), {}),
    ("ipb_high.mp4", dict(batch_size=512, chunk_mode=1), {}),
    ("multislice.264", dict(batch_size=256), WARM),
])
def test_compress_container_identical_to_jax(corpus_dir, monkeypatch, clip, kw, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    data = _read(corpus_dir, clip)
    info = {}
    comp, st = td.compress(data, device="cpu", info=info, **kw)
    want, want_st = jd.compress(data, **kw)
    assert comp == want
    assert st.n_chunks == want_st.n_chunks == info["n_chunks"] == len(info["blobs"])
    dec, _ = pipeline.decompress(comp)
    assert dec == data


def test_device_probs_and_blob_slim_branches(corpus_dir):
    """device_probs equals the host model's probs and device_blob the JAX
    package's lane blob, chunk by chunk; staging copies the JAX staging's
    arrays exactly."""
    data = _read(corpus_dir, "ipb_high.mp4")
    an = jd.analyze(data, batch_size=512, chunk_mode=1, model_profile=2)
    assert len(an.chunks) > 1
    cache = {}
    for c in an.chunks:
        assert np.array_equal(td.device_probs(an, c, "cpu"), c.host_probs)
        assert td.device_blob(an, c, "cpu") == jd.device_blob(an, c)
        st = td.to_torch_staged(an, c, "cpu", cache)
        blob, sc = jd._build_blob4(an, c, jd._chunk_layout(c))
        assert np.array_equal(st.blob.numpy().view(np.uint32), blob)
        assert np.array_equal(st.sc.numpy(), sc)
        assert np.array_equal(st.dual0.numpy(), c.dual0.astype(np.int32))
        assert td.to_torch_staged(an, c, "cpu", cache).dual0 is st.dual0  # cache hit


def test_aliased_tables_staged_once(corpus_dir, monkeypatch):
    """Warm chunks that alias an earlier chunk's dual0/sig0 tables reuse the
    tensors staged for it instead of uploading them again."""
    for k, v in WARM.items():
        monkeypatch.setenv(k, v)
    an = jd.analyze(_read(corpus_dir, "multislice.264"), batch_size=256, model_profile=2)
    cache = {}
    staged = [td.to_torch_staged(an, c, "cpu", cache) for c in an.chunks]
    aliased = [i for i, c in enumerate(an.chunks) if not c.dual0_inline]
    assert aliased
    for i in aliased:
        assert staged[i].dual0 is staged[i - 1].dual0
        assert staged[i].s_idx is staged[i - 1].s_idx is not None
        assert staged[i].wire_nbytes == staged[i].blob.nbytes + staged[i].sc.nbytes


def test_cli_roundtrip(corpus_dir, tmp_path, capsys):
    path = os.path.join(corpus_dir, "i_main.264")
    out = str(tmp_path / "i_main.artc")
    assert cli.main(["roundtrip", path, out, "--device", "cpu"]) == 0
    assert '"roundtrip_ok": true' in capsys.readouterr().out
    with open(out, "rb") as f:
        dec, _ = pipeline.decompress(f.read())
    assert dec == _read(corpus_dir, "i_main.264")


def _same(a, b) -> bool:
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return a is not None and b is not None and a.dtype == b.dtype \
            and np.array_equal(a, b)
    return a == b


@pytest.mark.parametrize("clip,kw", [
    ("ipb_high.mp4", dict(batch_size=512, chunk_mode=1, model_profile=2)),
    ("multislice.264", dict(batch_size=256, model_profile=2)),
    ("ipb_high.mp4", dict(batch_size=512, model_profile=0, sup=4)),
])
def test_port_analysis_matches_jax(corpus_dir, monkeypatch, clip, kw):
    """The port's copy of the parsers (avrecode_tpu_torch.analysis) reads
    the native export into the JAX package's Analysis, field by field, and
    its layout buckets, warm sig0 forms and lane rule agree."""
    if clip == "multislice.264":
        for k, v in WARM.items():
            monkeypatch.setenv(k, v)
    data = _read(corpus_dir, clip)
    got, want = td.analyze(data, **kw), jd.analyze(data, **kw)
    head = ("lanes", "batch", "n_dual", "n_sig", "fast_w", "slow_w", "sig_w", "sig_alpha",
            "profile", "sup", "slim")
    assert [getattr(got, f) for f in head] == [getattr(want, f) for f in head]
    assert len(got.chunks) == len(want.chunks) > 0
    for g, w in zip(got.chunks, want.chunks):
        for f in dataclasses.fields(w):
            assert _same(getattr(g, f.name), getattr(w, f.name)), f.name
        if got.slim:
            assert td._chunk_layout(g) == jd._chunk_layout(w)
            for a, b in zip(td._sig0_sparse_padded(g, got.n_sig),
                            jd._sig0_sparse_padded(w, want.n_sig)):
                assert (a is None and b is None) or _same(a, b)
            assert np.array_equal(g.packed, w.packed) and np.array_equal(g.dual0, w.dual0)
        else:
            a, b = td._sig0_dense(g, got.n_sig), jd._sig0_dense(w, want.n_sig)
            assert (a is None and b is None) or _same(a, b)
    for n in (1, 16 * 32768, 16 * 32768 + 16, 1 << 24, 1 << 30):
        assert td.pick_lanes(n) == jd.pick_lanes(n)


def test_port_host_decoder_matches_jax_package(corpus_dir):
    """The port's own host bindings (avrecode_tpu_torch.host) load the
    port's own library, built under avrecode_tpu_torch/build and not the
    JAX package's file, and compress / decompress as the JAX package's
    bindings do."""
    from avrecode_tpu import host as jhost
    from avrecode_tpu_torch import host as thost
    data = _read(corpus_dir, "ipb_high.mp4")
    comp, st = thost.compress(data, chunk_mode=1, batch_size=512)
    want, want_st = jhost.compress(data, chunk_mode=1, batch_size=512)
    assert comp == want and vars(st) == vars(want_st)
    assert thost.decompress(comp)[0] == jhost.decompress(comp)[0] == data
    assert thost.container_version() == jhost.container_version() == comp[4]
    assert _native.HOST_LIB_PATH == os.path.join(REPO, "avrecode_tpu_torch", "build",
                                                 "libartc_host.so")
    assert not os.path.samefile(_native.HOST_LIB_PATH, jhost._LIB_PATH)


def test_port_never_imports_jax(corpus_dir, tmp_path):
    """Importing every module of the port and running every entry point on
    a clip (compress under profile 2 and under profile 0 with every model
    pass, compress_mesh on a CPU grid, corpus_compress through the port,
    pipeline.roundtrip, the CLI's info, the microbench on the CPU) leaves
    jax and every module of the JAX package (avrecode_tpu, avrecode_tpu.*)
    out of sys.modules, and no file under avrecode_tpu/ (the JAX package's
    host library) mapped. Checked in a subprocess: this test process has
    imported jax already (conftest)."""
    clip = os.path.join(corpus_dir, "i_main.264")
    container = str(tmp_path / "i_main.atrc")
    code = (
        "import sys\n"
        "import avrecode_tpu_torch, avrecode_tpu_torch._native, avrecode_tpu_torch.cli\n"
        "import avrecode_tpu_torch.ops.intmath, avrecode_tpu_torch.ops.lanes\n"
        "import avrecode_tpu_torch.ops.model_pass, avrecode_tpu_torch.analysis\n"
        "import avrecode_tpu_torch.host, avrecode_tpu_torch.parallel.mesh\n"
        "import avrecode_tpu_torch.parallel.pipeline, avrecode_tpu_torch.parallel.distributed\n"
        "import avrecode_tpu_torch.pipeline, avrecode_tpu_torch.bench\n"
        "import avrecode_tpu_torch.microbench, avrecode_tpu_torch.models.refprior\n"
        "import avrecode_tpu_torch.utils.billing\n"
        "import os\n"
        "from avrecode_tpu_torch import device\n"
        "from avrecode_tpu_torch.parallel import distributed, mesh\n"
        f"data = open({clip!r}, 'rb').read()\n"
        "device.compress(data, batch_size=1024, device='cpu')\n"
        "for impl in ('v2', 'dict', 'sort', 'mm'):\n"
        "    os.environ['ARTC_MODEL_IMPL'] = impl\n"
        "    device.compress(data, batch_size=1024, model_profile=0, device='cpu')\n"
        "device.compress_mesh(data, mesh.make_mesh(2, 2, ['cpu'] * 4), batch_size=512, sup=4,\n"
        "                     force_lanes=4)\n"
        f"rep = distributed.corpus_compress([{clip!r}], {str(tmp_path)!r}, use_device=True,\n"
        "                                  device='cpu', batch_size=512)\n"
        "assert rep.files == 1 and rep.failures == 0, rep\n"
        "from avrecode_tpu_torch import cli, microbench, pipeline\n"
        "assert pipeline.roundtrip(data).ok\n"
        f"open({container!r}, 'wb').write(pipeline.compress(data)[0])\n"
        f"assert cli.main(['info', {container!r}]) == 0\n"
        f"assert microbench.main([{clip!r}, '--device', 'cpu', '--batch-size', '512',\n"
        "                        '--reps', '1']) == 0\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
        "'avrecode_tpu'))\n"
        "assert not bad, bad\n"
        f"jax_dir = os.path.realpath({os.path.join(REPO, 'avrecode_tpu')!r}) + os.sep\n"
        "maps = [line.split(None, 5) for line in open('/proc/self/maps')]\n"
        "mapped = sorted({os.path.realpath(m[5].strip()) for m in maps if len(m) == 6})\n"
        "assert not [m for m in mapped if m.startswith(jax_dir)], mapped\n"
        "print('no-jax-ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "no-jax-ok" in res.stdout


def _port_sources():
    files = [os.path.join(REPO, "chip_smoke.py"),
             os.path.join(REPO, "tools", "profile_torch_compress.py"),
             os.path.join(REPO, "tools", "profile_model_scan.py")]
    for root, _dirs, names in os.walk(os.path.join(REPO, "avrecode_tpu_torch")):
        files += [os.path.join(root, n) for n in sorted(names) if n.endswith(".py")]
    return files


def _jax_side_imports(path):
    """(line, module) of every import of jax, jaxlib or the JAX package
    (avrecode_tpu, avrecode_tpu.*) in a source file, at any depth (inside
    functions too)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        found += [(node.lineno, n) for n in names
                  if n.split(".")[0] in ("jax", "jaxlib", "avrecode_tpu")]
    return found


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: os.path.relpath(p, REPO))
def test_port_sources_import_nothing_of_jax(path):
    """No module of the port, nor chip_smoke.py or the port's profiling
    tools, imports jax or anything of the JAX package, at any depth."""
    assert _jax_side_imports(path) == []


def test_import_guard_sees_nested_imports(tmp_path):
    """The AST guard finds the imports it must reject, also inside
    functions, and passes the port's own relative imports."""
    src = tmp_path / "m.py"
    src.write_text("import os\nfrom . import host\nfrom .ops import lanes\n"
                   "def f():\n    import jax.numpy as jnp\n"
                   "    from avrecode_tpu.device import analyze\n"
                   "    from avrecode_tpu import host\n    import avrecode_tpu\n")
    assert [m for _, m in _jax_side_imports(str(src))] == [
        "jax.numpy", "avrecode_tpu.device", "avrecode_tpu", "avrecode_tpu"]


def test_cuda_request_never_runs_on_cpu(corpus_dir):
    """device='cuda' without a usable card raises instead of running the
    plain versions on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the no-card case")
    data = _read(corpus_dir, "i_main.264")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        td.compress(data, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        td.compress(data, model_profile=0, device="cuda")
    for profile in (2, 0):
        an = jd.analyze(data, batch_size=1024, model_profile=profile)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            td.device_probs(an, an.chunks[0], "cuda")
    # encode_interleaved defaults to the card, as compress does
    with pytest.raises((RuntimeError, AssertionError)):
        tl.encode_interleaved(np.ones(8, np.uint8), np.full(8, 100, np.uint16), 4)


def test_multigop_chunk_mode_0_fails_as_in_jax():
    """benchdata/multigop.mp4 as one chunk (chunk mode 0) overflows the slim
    wire's 8192-slot dictionary: the JAX package and the port raise the same
    error class and message (or, should that change, write the same
    container)."""
    with open(os.path.join(REPO, "benchdata", "multigop.mp4"), "rb") as f:
        data = f.read()
    outcomes = []
    for compress in (jd.compress, lambda d, **kw: td.compress(d, device="cpu", **kw)):
        try:
            outcomes.append(("container", compress(data, chunk_mode=0)[0]))
        except Exception as e:  # noqa: BLE001 - the outcome itself is compared
            outcomes.append((type(e).__name__, str(e)))
    assert outcomes[0] == outcomes[1]
    assert outcomes[0][0] == "NativeError" and "dict width > 8192" in outcomes[0][1]
