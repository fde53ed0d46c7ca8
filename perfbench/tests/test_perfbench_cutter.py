"""The GOP cutter and the clips' manifest."""
import pytest

from harness import clips

START = clips.START


def _nal_types(annexb: bytes) -> list[int]:
    parts = annexb.split(START)
    assert parts[0] == b""
    return [p[0] & 31 for p in parts[1:]]


@pytest.mark.parametrize("name", ["bench.mp4", "camera1080.mp4", "multigop720.mp4", "multigop.mp4"])
def test_pieces_start_with_sps_pps_idr(name):
    """SPS, PPS, then (after any SEI or delimiter) an IDR slice first."""
    for piece in clips.gop_pieces(clips.load([name])[name]):
        types = _nal_types(piece)
        assert types[:2] == [7, 8]
        assert next(t for t in types[2:] if 1 <= t <= 5) == 5


@pytest.mark.parametrize("name", ["bench.mp4", "camera1080.mp4", "multigop720.mp4", "multigop.mp4"])
def test_pieces_hold_every_access_unit_once(name):
    buf = clips.load([name])[name]
    d = clips.demux(buf)
    head = b"".join(START + p for p in d["sps"] + d["pps"])
    pieces = clips.gop_pieces(buf)
    assert len(pieces) == len(d["sync"]) and d["sync"][0] == 0
    body = b"".join(p[len(head):] for p in pieces)
    assert all(p.startswith(head) for p in pieces)
    assert body == b"".join(clips.annexb(s, d["nal_len"]) for s in d["samples"])


def test_manifest_refuses_a_changed_clip(tmp_path, monkeypatch):
    import json
    import shutil
    shutil.copy(f"{clips.CLIPS}/multigop.mp4", tmp_path / "multigop.mp4")
    with open(f"{clips.CLIPS}/manifest.json") as f:
        manifest = json.load(f)
    manifest["multigop.mp4"]["sha256"] = "0" * 64
    (tmp_path / "manifest.json").write_text(json.dumps(manifest))
    monkeypatch.setattr(clips, "CLIPS", str(tmp_path))
    with pytest.raises(ValueError, match="sha256"):
        clips.load(["multigop.mp4"])
