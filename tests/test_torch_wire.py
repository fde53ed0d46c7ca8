"""What the port's profile-2 path uploads and reports, against the JAX
package's: the staging ships every array at its wire width (the dual0
dictionary's u8 indices and u16 rows, the warm sig rows' u32 / u16) and
counts the same bytes, chunk by chunk and in `compress(info=...)`; with
ARTC_TIMING set, compress prints JAX's timing lines. Plain versions on the
CPU."""
import os
import re

import torch
from test_torch_jaxlib import ensure_jax_lib

from avrecode_tpu import device as jd
from avrecode_tpu_torch import _native
from avrecode_tpu_torch import device as td

# Both host libraries, each built here under its own lock, before any test
# of any module can reach the JAX package's unlocked build (see
# test_torch_jaxlib.py).
_native.ensure_host_lib()
ensure_jax_lib()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WARM = {"ARTC_SECTION_BINS": "150000", "ARTC_SEED_BINS": "100000",
        "ARTC_WARM_BINS": "120000"}


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_staged_wire_bytes_match_jax_on_every_clip(corpus_dir):
    """On every clip of the test corpus (batch 512): each chunk's
    StagedChunk.wire_nbytes equals JAX _stage_v4's with a cache shared
    across the chunks, the dual0 dictionary and the warm sig rows go up at
    their wire widths, and a chunk that aliases its predecessor's tables
    costs only its blob and scalars."""
    clips = sorted(os.listdir(corpus_dir))
    assert len(clips) > 30
    for clip in clips:
        data = _read(os.path.join(corpus_dir, clip))
        t_an = td.analyze(data, batch_size=512, model_profile=2)
        j_an = jd.analyze(data, batch_size=512, model_profile=2)
        t_cache, j_cache = {}, {}
        for tc, jc in zip(t_an.chunks, j_an.chunks, strict=True):
            st = td.to_torch_staged(t_an, tc, "cpu", t_cache)
            assert st.wire_nbytes == jd._stage_v4(j_an, jc, j_cache).wire_nbytes, clip
            if not tc.dual0_inline and not tc.sig0_inline:
                assert st.wire_nbytes == st.blob.nbytes + st.sc.nbytes, clip
            if st.s_val is not None:
                assert (st.s_idx.dtype, st.s_val.dtype) == (torch.int32, torch.int16)


def _masked(text: str) -> list[str]:
    """The [artc] lines with their seconds masked."""
    return [re.sub(r"\d+\.\d{3}s", "<s>", line) for line in text.splitlines()
            if line.startswith("[artc]")]


def _compress_both(data, capsys, **kw):
    """(port info, port lines, JAX info, JAX lines) of one compress each."""
    infos, lines = [], []
    for run in (lambda info: td.compress(data, device="cpu", info=info, **kw),
                lambda info: jd.compress(data, info=info, **kw)):
        info = {}
        capsys.readouterr()
        run(info)
        infos.append(info)
        lines.append(_masked(capsys.readouterr().out))
    return infos[0], lines[0], infos[1], lines[1]


def test_compress_wire_bytes_and_timing_match_jax_multigop720(capsys, monkeypatch):
    """benchdata/multigop720.mp4 under the defaults (profile 2, two chunks):
    the port's wire_bytes equal JAX's (the int32-widened uploads of the
    dual0 indices read 51,530,592 B against JAX's 50,427,622), and with
    ARTC_TIMING=1 the port prints JAX's lines, equal but for the seconds."""
    monkeypatch.setenv("ARTC_TIMING", "1")
    data = _read(os.path.join(REPO, "benchdata", "multigop720.mp4"))
    t_info, t_lines, j_info, j_lines = _compress_both(data, capsys)
    assert t_info["wire_bytes"] == j_info["wire_bytes"] == 50_427_622
    assert t_lines == j_lines
    assert len(t_lines) == 2 + 1 + 2 + 1  # dispatches, a compaction, emits, the total
    assert t_lines[-1] == f"[artc] device wire total {j_info['wire_bytes'] / 1e6:.1f} MB"


def test_timing_lines_match_jax_on_warm_chunks(corpus_dir, capsys, monkeypatch):
    """Warm sections (chunks >= 2 alias chunk 1's tables, so their wire is
    the blob alone): the lines equal JAX's, line for line, in JAX's order."""
    for k, v in {**WARM, "ARTC_TIMING": "1"}.items():
        monkeypatch.setenv(k, v)
    data = _read(os.path.join(corpus_dir, "multislice.264"))
    t_info, t_lines, j_info, j_lines = _compress_both(data, capsys, batch_size=256)
    assert t_info["wire_bytes"] == j_info["wire_bytes"]
    assert t_lines == j_lines
    n = t_info["n_chunks"]
    assert n > 2 and len(t_lines) == n + (n - 1) + n + 1
    kinds = [re.sub(r"chunk \d+", "chunk i", line).split(":")[1].split()[0]
             for line in t_lines[:-1]]
    assert kinds == ["fetch+dispatch"] + ["fetch+dispatch", "compact"] * (n - 1) + ["emit"] * n


def test_no_timing_lines_without_artc_timing(corpus_dir, capsys, monkeypatch):
    """ARTC_TIMING unset or "0": compress prints nothing."""
    data = _read(os.path.join(corpus_dir, "i_main.264"))
    for value in (None, "0"):
        if value is None:
            monkeypatch.delenv("ARTC_TIMING", raising=False)
        else:
            monkeypatch.setenv("ARTC_TIMING", value)
        capsys.readouterr()
        td.compress(data, batch_size=1024, device="cpu")
        assert capsys.readouterr().out == ""
