#!/usr/bin/env python3
"""Times the dense (ANLZ) export of one or more builds of the host library,
in turns, on one file.

    python3 tools/time_dense_export.py CLIP REPS NAME=LIB [NAME=LIB ...]

Each LIB is a built libartc_host.so (the port's, `_native.HOST_LIB_PATH`,
or one built from another checkout); each is loaded under its own handle in
this one process. Per rep the libraries run in turns (the order reversed on
odd reps), each one artc_session_analyze2 of CLIP at profile 0 (chunk mode
0, batch 4096, 16 lanes, sup 128: `p0_v2`'s settings) with its spans on.
One JSON line per library and rep: the spans native.dense_walk,
native.dense_export, native.v2_tables and native.copyout in seconds summed
over the chunks, the export's ns a bin, the call's wall time, the export's
bytes and the first 16 hex digits of its SHA-256 (equal builds write equal
digits), and the process's peak RSS so far. Host clock only: it says
nothing of a device.
"""
import ctypes
import hashlib
import json
import resource
import struct
import sys
import time

OUT = ctypes.POINTER(ctypes.c_uint8)
SPANS = ("native.dense_walk", "native.dense_export", "native.v2_tables", "native.copyout")
RECORD = 72  # sizeof(ArtcTraceRecord), native/trace.h
SUP = 128  # ops.model_pass.default_sup()


def bind(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    lib.artc_session_open.restype = ctypes.c_void_p
    lib.artc_session_open.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_uint32, ctypes.c_int]
    lib.artc_session_analyze2.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                          ctypes.POINTER(OUT), ctypes.POINTER(ctypes.c_size_t)]
    lib.artc_session_trace.argtypes = [ctypes.c_void_p, ctypes.POINTER(OUT),
                                       ctypes.POINTER(ctypes.c_size_t)]
    lib.artc_session_close.argtypes = [ctypes.c_void_p]
    lib.artc_last_error.restype = ctypes.c_char_p
    lib.artc_free.argtypes = [OUT]
    lib.artc_trace_enable.argtypes = [ctypes.c_int]
    lib.artc_trace_enable(1)
    return lib


def take(lib: ctypes.CDLL, out, n) -> bytes:
    try:
        return ctypes.string_at(out, n.value)
    finally:
        lib.artc_free(out)


def run(lib: ctypes.CDLL, data: bytes) -> dict:
    h = lib.artc_session_open(data, len(data), 16, 0, 4096, 0)
    if not h:
        raise RuntimeError(lib.artc_last_error().decode())
    try:
        out, n = OUT(), ctypes.c_size_t()
        t0 = time.perf_counter()
        if lib.artc_session_analyze2(h, SUP, 0, ctypes.byref(out), ctypes.byref(n)) != 0:
            raise RuntimeError(lib.artc_last_error().decode())
        wall = time.perf_counter() - t0
        export = take(lib, out, n)
        out, n = OUT(), ctypes.c_size_t()
        lib.artc_session_trace(h, ctypes.byref(out), ctypes.byref(n))
        raw = take(lib, out, n) if out else b""
    finally:
        lib.artc_session_close(h)
    sec = dict.fromkeys(SPANS, 0.0)
    bins = 0
    for off in range(0, len(raw), RECORD):
        name = raw[off:off + 24].split(b"\0")[0].decode()
        start, end, _thread, _chunk, count, _count2 = struct.unpack_from("<qqqqQQ", raw, off + 24)
        if name in sec:
            sec[name] += (end - start) * 1e-9
        if name == "native.dense_walk":
            bins += count
    return {"wall_s": wall, "bytes": len(export),
            "sha256": hashlib.sha256(export).hexdigest()[:16], "bins": bins,
            "export_ns_a_bin": sec["native.dense_export"] / max(bins, 1) * 1e9, **sec}


def main() -> None:
    clip, reps = sys.argv[1], int(sys.argv[2])
    libs = [(arg.split("=", 1)[0], bind(arg.split("=", 1)[1])) for arg in sys.argv[3:]]
    with open(clip, "rb") as f:
        data = f.read()
    for rep in range(reps):
        for name, lib in (libs if rep % 2 == 0 else libs[::-1]):
            res = run(lib, data)
            res["maxrss_mb"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss // 1024
            print(json.dumps({"lib": name, "rep": rep, **res}), flush=True)


if __name__ == "__main__":
    main()
