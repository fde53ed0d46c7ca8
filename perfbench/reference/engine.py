"""The reference: the serial CPU engine of the ATRC format, built from the
benchmark's own frozen copy of the format's original C++ sources (the
JAX package's native engine, whose containers the port's match byte for
byte) and bound through ctypes. It imports nothing of the program
and loads none of its libraries; it is built at -O2, where g++ unswitches
no loops.

The copy differs from its origin in three edits, all in recode.cc and each
between "perfbench edit begin" and "perfbench edit end" lines, where a line
that starts with "//- " keeps the origin's line that the edit replaced
(perfbench/tests/test_perfbench_reference_copy.py holds the rest to the origin): each
chunk's lane blob takes the device path's lane rule (16 lanes, doubled up
to 128 while a lane would hold more than 32,768 bins); artc_ref_set_build_id
sets the build id that containers carry; and with PERFBENCH_PROB_BITS
defined (the control's build) the rANS coder is given the model's
probabilities at that many bits instead of 15.

    compress(data, chunk_mode, batch_size, build_id) -> container bytes
    decompress(container) -> the original file's bytes
"""
from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading

HERE = os.path.dirname(os.path.abspath(__file__))
NATIVE = os.path.join(HERE, "native")
BUILD = os.path.join(HERE, "build")
CXXFLAGS = ["-std=c++17", "-O2", "-DNDEBUG", "-fPIC", "-shared", "-pthread"]
_N_KLASSES = 11


class _Stats(ctypes.Structure):
    _fields_ = [("input_bytes", ctypes.c_uint64), ("output_bytes", ctypes.c_uint64),
                ("cabac_in_bytes", ctypes.c_uint64), ("recoded_bytes", ctypes.c_uint64),
                ("literal_bytes", ctypes.c_uint64), ("n_slices", ctypes.c_int32),
                ("n_fallback", ctypes.c_int32), ("n_chunks", ctypes.c_int32),
                ("total_bins", ctypes.c_uint64),
                ("klass_mbits", ctypes.c_uint64 * _N_KLASSES),
                ("klass_count", ctypes.c_uint64 * _N_KLASSES),
                ("klass_cabac_mbits", ctypes.c_uint64 * _N_KLASSES),
                ("eob_cabac_mbits", ctypes.c_uint64), ("nz_mbits", ctypes.c_uint64),
                ("nz_count", ctypes.c_uint64), ("eob_count", ctypes.c_uint64),
                ("ref_mbits", ctypes.c_uint64)]


def _sources() -> list[str]:
    out = []
    for root, _dirs, files in os.walk(NATIVE):
        out += [os.path.join(root, f) for f in files if f.endswith((".h", ".cc"))]
    return out


def build(prob_bits: int = 15) -> str:
    """The library's path, compiled first if it is missing or older than a
    source (under an flock, through a temporary file renamed over it)."""
    name = "libref.so" if prob_bits == 15 else f"libref_p{prob_bits}.so"
    path = os.path.join(BUILD, name)
    os.makedirs(BUILD, exist_ok=True)
    newest = max(os.path.getmtime(s) for s in _sources())
    with open(os.path.join(BUILD, name + ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(path) and os.path.getmtime(path) >= newest:
            return path
        tmp = path + ".tmp"
        extra = [] if prob_bits == 15 else [f"-DPERFBENCH_PROB_BITS={prob_bits}"]
        subprocess.run(["g++", *CXXFLAGS, *extra, '-DARTC_BUILD_ID="perfbench-reference"',
                        "-I", NATIVE, "-o", tmp, os.path.join(NATIVE, "recode.cc")],
                       check=True)
        os.replace(tmp, path)
    return path


class Engine:
    """One loaded build of the reference (prob_bits 15, or the control's)."""

    def __init__(self, prob_bits: int = 15):
        self.lib = lib = ctypes.CDLL(build(prob_bits))
        self._lock = threading.Lock()
        out = [ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)), ctypes.POINTER(ctypes.c_size_t),
               ctypes.POINTER(_Stats)]
        lib.artc_compress.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_uint32, ctypes.c_int, *out]
        lib.artc_compress.restype = ctypes.c_int
        lib.artc_decompress.argtypes = [ctypes.c_char_p, ctypes.c_size_t, *out]
        lib.artc_decompress.restype = ctypes.c_int
        lib.artc_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
        lib.artc_free.restype = None
        lib.artc_last_error.argtypes = []
        lib.artc_last_error.restype = ctypes.c_char_p
        lib.artc_ref_set_build_id.argtypes = [ctypes.c_char_p]
        lib.artc_ref_set_build_id.restype = None

    def _call(self, fn, data: bytes, *args) -> bytes:
        out = ctypes.POINTER(ctypes.c_uint8)()
        n = ctypes.c_size_t()
        st = _Stats()
        if fn(data, len(data), *args, ctypes.byref(out), ctypes.byref(n), ctypes.byref(st)):
            raise RuntimeError(self.lib.artc_last_error().decode())
        try:
            return ctypes.string_at(out, n.value)
        finally:
            self.lib.artc_free(out)

    def compress(self, data: bytes, chunk_mode: int, batch_size: int, build_id: bytes,
                 model_profile: int = 2, lanes: int = 16) -> bytes:
        """The container of `data` whose header carries `build_id`."""
        with self._lock:  # the build id is the library's state
            self.lib.artc_ref_set_build_id(build_id)
            return self._call(self.lib.artc_compress, data, lanes, chunk_mode, batch_size,
                              model_profile)

    def decompress(self, container: bytes) -> bytes:
        return self._call(self.lib.artc_decompress, container)
