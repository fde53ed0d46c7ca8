"""The port's compress path (avrecode_tpu_torch.device, plain versions on the
CPU) against the JAX package's: byte-identical containers that the host
decoder reads back; the port never imports jax; a CUDA request never runs
on the CPU."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from avrecode_tpu import device as jd
from avrecode_tpu import pipeline
from avrecode_tpu_torch import _native, cli
from avrecode_tpu_torch import device as td

# Built here, under the port's lock, before any test of any module can reach
# the host library's unlocked build (see _native.ensure_host_lib).
_native.ensure_host_lib()

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


def test_port_never_imports_jax(corpus_dir):
    """Importing every module of the port and compressing a clip with it,
    under profile 2 and under profile 0 with every model pass, leaves jax
    out of sys.modules. Checked in a subprocess: this test
    process has imported jax already (conftest)."""
    code = (
        "import sys\n"
        "import avrecode_tpu_torch, avrecode_tpu_torch._native, avrecode_tpu_torch.cli\n"
        "import avrecode_tpu_torch.ops.intmath, avrecode_tpu_torch.ops.lanes\n"
        "import avrecode_tpu_torch.ops.model_pass\n"
        "import os\n"
        "from avrecode_tpu_torch import device\n"
        f"data = open({os.path.join(corpus_dir, 'i_main.264')!r}, 'rb').read()\n"
        "device.compress(data, batch_size=1024, device='cpu')\n"
        "for impl in ('v2', 'dict', 'sort', 'mm'):\n"
        "    os.environ['ARTC_MODEL_IMPL'] = impl\n"
        "    device.compress(data, batch_size=1024, model_profile=0, device='cpu')\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib')))\n"
        "assert not bad, bad\n"
        "print('no-jax-ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "no-jax-ok" in res.stdout


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
