"""The benchmark's input files: the clips it owns, checked against their
manifest, and the single-GOP Annex-B pieces cut from them.

The cutter is a plain ISO-BMFF (MP4) demux of its own: the first video
track's avcC gives the SPS/PPS and the NAL length size, stsz/stco/co64/stsc
give every sample's bytes, stss the sync samples. A piece is one IDR GOP:
a start code before the SPS and the PPS, then every access unit of the GOP
with each NAL's length prefix turned into a four-byte start code.
"""
from __future__ import annotations

import hashlib
import json
import os
import struct

HERE = os.path.dirname(os.path.abspath(__file__))
CLIPS = os.path.join(os.path.dirname(HERE), "clips")
START = b"\x00\x00\x00\x01"


def load(names: list[str]) -> dict[str, bytes]:
    """{name: bytes} of the named clips, each checked against the SHA-256
    of clips/manifest.json; a clip that differs raises."""
    with open(os.path.join(CLIPS, "manifest.json")) as f:
        manifest = json.load(f)
    out = {}
    for name in names:
        with open(os.path.join(CLIPS, name), "rb") as f:
            data = f.read()
        digest = hashlib.sha256(data).hexdigest()
        if digest != manifest[name]["sha256"]:
            raise ValueError(f"clip {name}: sha256 {digest} is not the manifest's")
        out[name] = data
    return out


def _boxes(buf: bytes, start: int, end: int):
    """(type, payload start, payload end) of each box in buf[start:end]."""
    i = start
    while i + 8 <= end:
        size, typ = struct.unpack_from(">I4s", buf, i)
        head = 8
        if size == 1:
            size = struct.unpack_from(">Q", buf, i + 8)[0]
            head = 16
        elif size == 0:
            size = end - i
        if size < head or i + size > end:
            raise ValueError(f"mp4: box {typ!r} at {i} overruns its parent")
        yield typ, i + head, i + size
        i += size


def _find(buf: bytes, start: int, end: int, path: list[bytes]):
    """Payload bounds of the first box along `path`, descending through
    container boxes; None if there is none."""
    for typ, s, e in _boxes(buf, start, end):
        if typ == path[0]:
            if len(path) == 1:
                return s, e
            hit = _find(buf, s, e, path[1:])
            if hit is not None:
                return hit
    return None


def _video_stbl(buf: bytes) -> tuple[int, int]:
    moov = _find(buf, 0, len(buf), [b"moov"])
    if moov is None:
        raise ValueError("mp4: no moov box")
    for typ, s, e in _boxes(buf, *moov):
        if typ != b"trak":
            continue
        hdlr = _find(buf, s, e, [b"mdia", b"hdlr"])
        if hdlr is not None and buf[hdlr[0] + 8:hdlr[0] + 12] == b"vide":
            stbl = _find(buf, s, e, [b"mdia", b"minf", b"stbl"])
            if stbl is not None:
                return stbl
    raise ValueError("mp4: no video track")


def _full_box_u32s(buf: bytes, bounds, width: int = 4) -> list[int]:
    """The entries of a full box that holds a u32 count and then entries of
    `width` bytes' integers (stco, co64, stss)."""
    s, _ = bounds
    n = struct.unpack_from(">I", buf, s + 4)[0]
    fmt = ">Q" if width == 8 else ">I"
    return [struct.unpack_from(fmt, buf, s + 8 + width * k)[0] for k in range(n)]


def demux(buf: bytes) -> dict:
    """The first video track: {"sps": [bytes], "pps": [bytes],
    "nal_len": int, "samples": [bytes], "sync": [sample index]}."""
    s, e = _video_stbl(buf)
    stsd = _find(buf, s, e, [b"stsd"])
    entry = stsd[0] + 8  # version/flags, entry count
    avcc = _find(buf, entry + 8 + 78, stsd[1], [b"avcC"])
    if avcc is None:
        raise ValueError("mp4: no avcC in the video sample entry")
    a = avcc[0]
    nal_len = (buf[a + 4] & 3) + 1
    sps, pps = [], []
    i = a + 5
    for out in (sps, pps):
        count = buf[i] & (31 if out is sps else 255)
        i += 1
        for _ in range(count):
            n = struct.unpack_from(">H", buf, i)[0]
            out.append(buf[i + 2:i + 2 + n])
            i += 2 + n
    # sample sizes
    stsz = _find(buf, s, e, [b"stsz"])
    fixed, count = struct.unpack_from(">II", buf, stsz[0] + 4)
    sizes = [fixed] * count if fixed else [
        struct.unpack_from(">I", buf, stsz[0] + 12 + 4 * k)[0] for k in range(count)]
    # chunk offsets and the samples of each chunk
    co = _find(buf, s, e, [b"stco"])
    offsets = _full_box_u32s(buf, co) if co else _full_box_u32s(
        buf, _find(buf, s, e, [b"co64"]), 8)
    stsc = _find(buf, s, e, [b"stsc"])
    runs = [struct.unpack_from(">III", buf, stsc[0] + 8 + 12 * k)
            for k in range(struct.unpack_from(">I", buf, stsc[0] + 4)[0])]
    samples = []
    for r, (first, per_chunk, _desc) in enumerate(runs):
        last = runs[r + 1][0] - 1 if r + 1 < len(runs) else len(offsets)
        for c in range(first - 1, last):
            off = offsets[c]
            for _ in range(per_chunk):
                if len(samples) == count:
                    break
                size = sizes[len(samples)]
                samples.append(buf[off:off + size])
                off += size
    if len(samples) != count:
        raise ValueError(f"mp4: {len(samples)} samples placed of {count}")
    stss = _find(buf, s, e, [b"stss"])
    sync = [k - 1 for k in _full_box_u32s(buf, stss)] if stss else list(range(count))
    return {"sps": sps, "pps": pps, "nal_len": nal_len, "samples": samples, "sync": sync}


def annexb(sample: bytes, nal_len: int) -> bytes:
    """One access unit with each length-prefixed NAL behind a start code."""
    out = bytearray()
    i = 0
    while i < len(sample):
        n = int.from_bytes(sample[i:i + nal_len], "big")
        i += nal_len
        if n == 0 or i + n > len(sample):
            raise ValueError("mp4: NAL length overruns its sample")
        out += START + sample[i:i + n]
        i += n
    return bytes(out)


def gop_pieces(buf: bytes) -> list[bytes]:
    """One Annex-B file per IDR GOP of the clip: SPS, PPS, then the GOP's
    access units. The pieces hold every access unit of the clip once."""
    d = demux(buf)
    head = b"".join(START + p for p in d["sps"] + d["pps"])
    bounds = d["sync"] + [len(d["samples"])]
    return [head + b"".join(annexb(d["samples"][k], d["nal_len"])
                            for k in range(bounds[g], bounds[g + 1]))
            for g in range(len(d["sync"]))]
