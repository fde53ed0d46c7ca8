"""The port's slim (ANL5) export, native/slim_export.h, against the
original's in the JAX package's library, both libraries loaded in one
process: artc_session_analyze2's slim export (the header and every chunk)
is the same byte for byte on clips of the test corpus (a 4:2:2, a 10-bit,
an MBAFF and a PAFF clip among them, and multislice.264's warm sections),
at both chunk modes, batch 256 and 4096, sup 16 and 128, with and without
the host probabilities, and at odd batch and sup sizes; the cases reach the
prior escapes, the (ones, total) escapes, the dual0 row escapes and the
tables a warm chunk shares, and both libraries refuse a dictionary wider
than 8192 with the same message."""
import ctypes
import itertools
import os

import pytest
from test_torch_jaxlib import ensure_jax_lib

from avrecode_tpu_torch import _native, analysis
from avrecode_tpu_torch import testcorpus as tc

# Both host libraries, each built here under its own lock (see
# test_torch_jaxlib.py).
_native.ensure_host_lib()
ensure_jax_lib()

_OUT = ctypes.POINTER(ctypes.c_uint8)
# multislice.264's v16 warm-started sections (as test_torch_device.py's).
WARM = {"ARTC_SECTION_BINS": "150000", "ARTC_SEED_BINS": "100000",
        "ARTC_WARM_BINS": "120000"}
CLIPS = ["ipb_high.mp4", "multislice.264", "c422.264", "hi10.264", "mbaff.264", "paff_ip.264"]
REFUSAL = "slim analysis: dict width > 8192 (use fat export)"


def _bind(path: str) -> ctypes.CDLL:
    """A handle of its own on the library at `path`, its session entries
    bound."""
    lib = ctypes.CDLL(path)
    lib.artc_session_open.restype = ctypes.c_void_p
    lib.artc_session_open.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_uint32, ctypes.c_int]
    lib.artc_session_analyze2.restype = ctypes.c_int
    lib.artc_session_analyze2.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                          ctypes.POINTER(_OUT), ctypes.POINTER(ctypes.c_size_t)]
    lib.artc_session_close.argtypes = [ctypes.c_void_p]
    lib.artc_last_error.restype = ctypes.c_char_p
    lib.artc_free.argtypes = [_OUT]
    return lib


PORT = _bind(_native.HOST_LIB_PATH)
JAX = _bind(ensure_jax_lib())


def _slim(lib: ctypes.CDLL, data: bytes, chunk_mode: int, batch: int, sup: int,
          probs: bool) -> bytes | str:
    """The library's slim export of `data` at profile 2, or its error."""
    h = lib.artc_session_open(data, len(data), 16, chunk_mode, batch, 2)
    assert h, lib.artc_last_error().decode()
    try:
        out, out_len = _OUT(), ctypes.c_size_t()
        if lib.artc_session_analyze2(h, sup, 1 | (2 if probs else 0), ctypes.byref(out),
                                     ctypes.byref(out_len)) != 0:
            return lib.artc_last_error().decode()
        try:
            return ctypes.string_at(out, out_len.value)
        finally:
            lib.artc_free(out)
    finally:
        lib.artc_session_close(h)


def _both(monkeypatch, clip: str, chunk_mode: int, batch: int, sup: int,
          probs: bool) -> tuple[bytes | str, bytes | str]:
    if clip == "multislice.264":
        for k, v in WARM.items():
            monkeypatch.setenv(k, v)
    data = tc.clip_bytes(clip)
    return (_slim(PORT, data, chunk_mode, batch, sup, probs),
            _slim(JAX, data, chunk_mode, batch, sup, probs))


@pytest.mark.parametrize("clip,chunk_mode,batch,sup,probs", [
    *itertools.product(CLIPS, (0, 1), (256, 4096), (16, 128), (False, True)),
    ("ipb_high.mp4", 1, 333, 16, True),
    ("ipb_high.mp4", 0, 1001, 7, False),
    ("mbaff.264", 0, 257, 3, True),
    ("paff_ip.264", 1, 1, 16, False),
])
def test_slim_export_equals_the_original(monkeypatch, clip, chunk_mode, batch, sup, probs):
    got, want = _both(monkeypatch, clip, chunk_mode, batch, sup, probs)
    assert type(got) is type(want)
    if isinstance(want, str):
        assert got == want == REFUSAL
    else:
        assert len(got) == len(want) and got == want


def _chunks(monkeypatch, clip, chunk_mode, batch, sup):
    got, want = _both(monkeypatch, clip, chunk_mode, batch, sup, False)
    assert isinstance(got, bytes) and got == want
    return analysis._parse_analysis(got).chunks


def test_cases_reach_every_escape_and_shared_table(monkeypatch):
    """The escape lists and shared tables the layout has are non-empty in
    the cases above, and a prior dictionary that holds every prior (no
    escape; its order is all ties broken) is among them."""
    chunks = _chunks(monkeypatch, "ipb_high.mp4", 1, 256, 16)
    assert all(len(c.esc_idx) and len(c.cesc_idx) for c in chunks)
    assert any(len(c.d0_esc_idx) for c in chunks)
    chunks = _chunks(monkeypatch, "multislice.264", 0, 256, 16)
    assert any(not c.dual0_inline for c in chunks) and any(len(c.d0_esc_idx) for c in chunks)
    chunks = _chunks(monkeypatch, "paff_ip.264", 0, 4096, 16)
    assert not any(len(c.esc_idx) for c in chunks)


def test_dict_width_refusal_is_the_same(monkeypatch):
    """Chunk mode 0 at batch 4096 and sup 128 gives ipb_high.mp4 a super-step
    with more keys than an 8192-wide dictionary holds: both libraries
    refuse it, with the same message."""
    assert _both(monkeypatch, "ipb_high.mp4", 0, 4096, 128, True) == (REFUSAL, REFUSAL)
