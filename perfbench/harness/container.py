"""Reads the fields of an ATRC container that the benchmark needs: each
chunk's lane count K and coded-bin count n (the first two u32 of each
chunk's rANS blob). The layout is the format's
(pack_container in the engine's recode.cc): little-endian integers, LEB128
varints.
"""
from __future__ import annotations

import struct


class Reader:
    def __init__(self, buf: bytes):
        self.buf, self.pos = buf, 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise ValueError("container truncated")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def u16(self) -> int:
        return struct.unpack("<H", self.take(2))[0]

    def u32(self) -> int:
        return struct.unpack("<I", self.take(4))[0]

    def vu(self) -> int:
        v = shift = 0
        while True:
            b = self.u8()
            v |= (b & 0x7F) << shift
            if b < 0x80:
                return v
            shift += 7


def chunks(container: bytes) -> list[tuple[int, int]]:
    """[(K, n)] of each chunk's lane blob; [] for a stored (literal)
    container. Raises ValueError on bytes that do not parse."""
    r = Reader(container)
    if r.take(4) != b"ATRC":
        raise ValueError("no ATRC magic")
    r.u8()                     # version
    r.take(r.u8())             # build id
    r.u16(), r.u8(), r.u32(), r.u8()   # lanes, chunk mode, batch, profile
    if r.u8():                 # MPEG-TS transport: run map
        r.vu()
        for _ in range(2 * r.vu()):
            r.vu()
    r.u32()                    # CRC-32 of the input
    if r.u8():                 # coded side bytes
        r.vu()
        r.take(r.vu())
    else:
        r.take(r.vu())
    for _ in range(r.vu()):    # parameter sets
        r.u8(), r.vu()
    n_chunks = r.vu()
    for _ in range(n_chunks):  # nz modes
        r.vu()
    r.vu(), r.vu()             # warm slices, alpha
    for _ in range(r.vu()):    # segments
        if r.u8() == 0:
            r.vu()
        else:
            r.vu(), r.u8(), r.vu(), r.vu(), r.vu(), r.vu(), r.u8(), r.u8()
    out = []
    for _ in range(n_chunks):
        blob = r.take(r.vu())
        k, n = struct.unpack_from("<II", blob, 0)
        out.append((k, n))
    if r.pos != len(container):
        raise ValueError(f"{len(container) - r.pos} bytes after the last blob")
    return out
