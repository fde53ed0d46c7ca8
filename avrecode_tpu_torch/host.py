"""ctypes bindings to the port's native host library (libartc_host.so).

The C++ engine (the syntax walkers, the prior model, the CABAC engines, the
rANS codec and the container) is the port's own copy, under native/:
`_native.ensure_host_lib` compiles it into build/libartc_host.so, and this
module binds its C ABI. It is a copy of avrecode_tpu/host.py's bindings plus
the analysis-session entries of avrecode_tpu/device.py (`_session_lib`,
`_pack_session`), held by one type, `Session`, so the port imports nothing
of the JAX package and no other module of it calls a session entry.
Decompression runs here, on the host: every container the port writes is
read back by the independent C++ decoder.
"""
from __future__ import annotations

import ctypes
import threading
from dataclasses import dataclass, field

from . import _native

N_KLASSES = 11
KLASS_NAMES = ["other", "sig", "eob", "res", "bypass_other", "bypass_res", "terminate", "sign",
               "cbf", "skip", "mvd_sign"]


class ArtcStatsC(ctypes.Structure):
    _fields_ = [
        ("input_bytes", ctypes.c_uint64),
        ("output_bytes", ctypes.c_uint64),
        ("cabac_in_bytes", ctypes.c_uint64),
        ("recoded_bytes", ctypes.c_uint64),
        ("literal_bytes", ctypes.c_uint64),
        ("n_slices", ctypes.c_int32),
        ("n_fallback", ctypes.c_int32),
        ("n_chunks", ctypes.c_int32),
        ("total_bins", ctypes.c_uint64),
        ("klass_mbits", ctypes.c_uint64 * N_KLASSES),
        ("klass_count", ctypes.c_uint64 * N_KLASSES),
        ("klass_cabac_mbits", ctypes.c_uint64 * N_KLASSES),
        ("eob_cabac_mbits", ctypes.c_uint64),
        ("nz_mbits", ctypes.c_uint64),
        ("nz_count", ctypes.c_uint64),
        ("eob_count", ctypes.c_uint64),
        ("ref_mbits", ctypes.c_uint64),
    ]


@dataclass
class Stats:
    input_bytes: int = 0
    output_bytes: int = 0
    cabac_in_bytes: int = 0
    recoded_bytes: int = 0
    literal_bytes: int = 0
    n_slices: int = 0
    n_fallback: int = 0
    n_chunks: int = 0
    total_bins: int = 0
    bill: dict = field(default_factory=dict)
    # Bytes the reference's model would have spent on the same bins (0
    # unless ARTC_REFMODEL=1; native/refmodel.h).
    ref_model_bytes: float = 0.0

    @classmethod
    def from_c(cls, c: ArtcStatsC) -> "Stats":
        bill = {
            KLASS_NAMES[i]: {
                "count": int(c.klass_count[i]),
                "bytes": c.klass_mbits[i] / 8000.0,
                "cabac_bytes": c.klass_cabac_mbits[i] / 8000.0,
            }
            for i in range(N_KLASSES)
        }
        bill["nz"] = {"count": int(c.nz_count), "bytes": c.nz_mbits / 8000.0}
        bill["eob_free_bins"] = {
            "count": int(c.eob_count),
            "bytes": 0.0,
            "cabac_bytes": c.eob_cabac_mbits / 8000.0,
        }
        return cls(
            ref_model_bytes=c.ref_mbits / 8000.0,
            input_bytes=int(c.input_bytes),
            output_bytes=int(c.output_bytes),
            cabac_in_bytes=int(c.cabac_in_bytes),
            recoded_bytes=int(c.recoded_bytes),
            literal_bytes=int(c.literal_bytes),
            n_slices=int(c.n_slices),
            n_fallback=int(c.n_fallback),
            n_chunks=int(c.n_chunks),
            total_bins=int(c.total_bins),
            bill=bill,
        )


class ArtcTraceRecordC(ctypes.Structure):
    """One native span (recode.cc ArtcTraceRecord)."""
    _fields_ = [
        ("name", ctypes.c_char * 24),
        ("start_ns", ctypes.c_int64),
        ("end_ns", ctypes.c_int64),
        ("thread", ctypes.c_int64),
        ("chunk", ctypes.c_int64),
        ("count", ctypes.c_uint64),
        ("count2", ctypes.c_uint64),
    ]


class NativeError(RuntimeError):
    pass


_lib = None
_LIB_LOCK = threading.Lock()

_OUT = ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8))
_LEN = ctypes.POINTER(ctypes.c_size_t)

# Session.begin's flags: 2 adds the host probabilities to the slim export;
# DENSE starts the dense analysis in place of the slim one.
DENSE = 4


def _bind(lib: ctypes.CDLL) -> None:
    """argtypes/restype of every C entry the port calls."""
    c = ctypes
    sigs = {
        "artc_compress": (c.c_int, [c.c_char_p, c.c_size_t, c.c_int, c.c_int, c.c_uint32,
                                    c.c_int, _OUT, _LEN, c.POINTER(ArtcStatsC)]),
        "artc_decompress": (c.c_int, [c.c_char_p, c.c_size_t, _OUT, _LEN,
                                      c.POINTER(ArtcStatsC)]),
        "artc_free": (None, [c.POINTER(c.c_uint8)]),
        "artc_last_error": (c.c_char_p, []),
        "artc_container_version": (c.c_int, []),
        "artc_session_open": (c.c_void_p, [c.c_char_p, c.c_size_t, c.c_int, c.c_int,
                                           c.c_uint32, c.c_int]),
        "artc_session_analyze2": (c.c_int, [c.c_void_p, c.c_int, c.c_int, _OUT, _LEN]),
        "artc_session_analyze_begin": (c.c_int, [c.c_void_p, c.c_int, c.c_int]),
        "artc_session_analyze_header": (c.c_int, [c.c_void_p, _OUT, _LEN]),
        "artc_session_analyze_chunk": (c.c_int, [c.c_void_p, c.c_uint32, _OUT, _LEN]),
        "artc_session_pack": (c.c_int, [c.c_void_p, c.c_char_p, c.POINTER(c.c_uint64), c.c_int,
                                        _OUT, _LEN, c.POINTER(ArtcStatsC)]),
        "artc_session_close": (None, [c.c_void_p]),
        "artc_session_trace": (c.c_int, [c.c_void_p, _OUT, _LEN]),
        "artc_trace_enable": (None, [c.c_int]),
        "artc_rans_encode": (c.c_int, [c.POINTER(c.c_uint8), c.POINTER(c.c_uint16), c.c_uint64,
                                       c.c_int, _OUT, _LEN]),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes


def lib() -> ctypes.CDLL:
    """The host library, built if missing or stale (_native.ensure_host_lib)
    and bound on first use."""
    global _lib
    with _LIB_LOCK:
        if _lib is None:
            handle = ctypes.CDLL(_native.ensure_host_lib())
            _bind(handle)
            _lib = handle
    return _lib


def container_version() -> int:
    """The native library's ATRC container version (recode.h)."""
    return int(lib().artc_container_version())


def last_error() -> NativeError:
    return NativeError(lib().artc_last_error().decode())


class _Returned:
    """The buffer fn(*args, &out, &out_len[, &stats]) hands back (a nonzero rc
    raises the library's error), until take() copies it into bytes and frees
    it: at once, or under a span of the caller's."""
    __slots__ = ("out", "out_len")

    def __init__(self, fn, *args, stats: ArtcStatsC | None = None):
        self.out = ctypes.POINTER(ctypes.c_uint8)()
        self.out_len = ctypes.c_size_t()
        tail = () if stats is None else (ctypes.byref(stats),)
        if fn(*args, ctypes.byref(self.out), ctypes.byref(self.out_len), *tail) != 0:
            raise last_error()

    def take(self) -> bytes:
        try:
            return ctypes.string_at(self.out, self.out_len.value)
        finally:
            lib().artc_free(self.out)

    def read(self, fn):
        """fn(the buffer, read in place as a ctypes byte array), then the
        buffer freed; returns fn's result, which must hold no view of the
        buffer."""
        try:
            n = self.out_len.value
            raw = (ctypes.c_uint8 * n).from_address(ctypes.addressof(self.out.contents)) \
                if n else bytearray()
            return fn(raw)
        finally:
            lib().artc_free(self.out)


def _call(fn, data: bytes, *args) -> tuple[bytes, Stats]:
    st = ArtcStatsC()
    raw = _Returned(fn, data, len(data), *args, stats=st).take()
    return raw, Stats.from_c(st)


def compress(data: bytes, lanes: int = 16, chunk_mode: int = 0,
             batch_size: int = 1, model_profile: int = 0) -> tuple[bytes, Stats]:
    """Host-only compression (the C++ engine end to end)."""
    return _call(lib().artc_compress, data, lanes, chunk_mode, batch_size, model_profile)


def decompress(data: bytes) -> tuple[bytes, Stats]:
    """Host decompression of an ATRC container (the C++ serial decoder)."""
    return _call(lib().artc_decompress, data)


def rans_encode(bits, probs, lanes: int) -> bytes:
    """One chunk's K-lane rANS blob from the C++ encoder (native/rans.h):
    bits[n] (0/1) and probs[n] in [1, 32767]; what the device lane encode
    must write byte for byte."""
    import numpy as np
    bits = np.ascontiguousarray(bits, np.uint8)
    probs = np.ascontiguousarray(probs, np.uint16)
    return _Returned(lib().artc_rans_encode,
                     bits.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                     probs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
                     len(bits), lanes).take()


class Session:
    """One native analysis session of `data`: the syntax walk, its exports,
    and the container packed around the device's lane blobs. Opening raises
    NativeError with the library's message; `with` closes it once."""

    def __init__(self, data: bytes, lanes: int, chunk_mode: int, batch_size: int,
                 model_profile: int):
        self._lib = lib()
        self._h = self._lib.artc_session_open(data, len(data), lanes, chunk_mode, batch_size,
                                              model_profile)
        if not self._h:
            raise last_error()

    def __enter__(self) -> "Session":
        return self

    def __exit__(self, *exc) -> None:
        h, self._h = self._h, None
        if h:
            self._lib.artc_session_close(h)

    def begin(self, sup: int, flags: int) -> int:
        """Starts the slim analysis's workers or, with flags DENSE, the dense
        analysis's walkers; returns the chunk count."""
        n = self._lib.artc_session_analyze_begin(self._h, sup, flags)
        if n < 0:
            raise last_error()
        return n

    def header(self) -> bytes:
        return _Returned(self._lib.artc_session_analyze_header, self._h).take()

    def chunk(self, i: int) -> _Returned:
        """Chunk i's export, handed over once, when it is written (dense
        chunks in order)."""
        return _Returned(self._lib.artc_session_analyze_chunk, self._h, i)

    def analyze(self, sup: int, flags: int) -> _Returned:
        """The whole export (flags: 1 slim, 2 with the host probabilities)."""
        return _Returned(self._lib.artc_session_analyze2, self._h, sup, flags)

    def pack(self, blobs: list[bytes]) -> tuple[bytes, Stats]:
        lens = (ctypes.c_uint64 * len(blobs))(*[len(b) for b in blobs])
        st = ArtcStatsC()
        raw = _Returned(self._lib.artc_session_pack, self._h, b"".join(blobs), lens, len(blobs),
                        stats=st).take()
        return raw, Stats.from_c(st)

    def trace(self) -> list[tuple]:
        """The spans the session recorded since the last call, as (name,
        start_ns, end_ns, thread, chunk or -1, count, count2); none unless the
        recorder was on when it opened (trace.enable)."""
        buf = _Returned(self._lib.artc_session_trace, self._h)
        if not buf.out_len.value:
            return []
        raw = buf.take()
        n = len(raw) // ctypes.sizeof(ArtcTraceRecordC)
        recs = (ArtcTraceRecordC * n).from_buffer_copy(raw)
        return [(r.name.decode(), r.start_ns, r.end_ns, r.thread, r.chunk, r.count, r.count2)
                for r in recs]
