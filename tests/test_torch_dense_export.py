"""The port's dense (ANLZ) export, native/dense_export.h, against the
original's in the JAX package's library, both libraries loaded in one
process: artc_session_analyze2's dense export (the header and every chunk:
the bit, kind, key and prior planes, the within-batch prefix counts, the
probabilities, the dual0 rows, the sparse sig0 rows and the v2 tables) is
the same byte for byte on clips of the test corpus (a 4:2:2, a 10-bit, an
MBAFF and a PAFF clip among them, and multislice.264's warm sections, whose
sig0 rows are not empty), at both chunk modes, batch 256 and 4096, the
default sup, 16 and 128, flags 0 and 2, and at odd batch and sup sizes;
the cases reach super-step counts past 8, where bucket_steps rounds an odd
count up to an even one."""
import ctypes
import itertools

import pytest
from test_torch_slim_export import _OUT, JAX, PORT, WARM

from avrecode_tpu_torch import analysis
from avrecode_tpu_torch import testcorpus as tc

CLIPS = ["ipb_high.mp4", "multislice.264", "c422.264", "hi10.264", "mbaff.264", "paff_ip.264"]


def _dense(lib: ctypes.CDLL, data: bytes, chunk_mode: int, batch: int, sup: int,
           flags: int) -> bytes:
    """The library's dense export of `data` at profile 0."""
    h = lib.artc_session_open(data, len(data), 16, chunk_mode, batch, 0)
    assert h, lib.artc_last_error().decode()
    try:
        out, out_len = _OUT(), ctypes.c_size_t()
        rc = lib.artc_session_analyze2(h, sup, flags, ctypes.byref(out), ctypes.byref(out_len))
        assert rc == 0, lib.artc_last_error().decode()
        try:
            return ctypes.string_at(out, out_len.value)
        finally:
            lib.artc_free(out)
    finally:
        lib.artc_session_close(h)


def _both(monkeypatch, clip: str, chunk_mode: int, batch: int, sup: int,
          flags: int) -> tuple[bytes, bytes]:
    if clip == "multislice.264":
        for k, v in WARM.items():
            monkeypatch.setenv(k, v)
    data = tc.clip_bytes(clip)
    return (_dense(PORT, data, chunk_mode, batch, sup, flags),
            _dense(JAX, data, chunk_mode, batch, sup, flags))


@pytest.mark.parametrize("clip,chunk_mode,batch,sup,flags", [
    *itertools.product(CLIPS, (0, 1), (256, 4096), (0, 16, 128), (0, 2)),
    ("ipb_high.mp4", 1, 333, 16, 2),
    ("ipb_high.mp4", 0, 1, 7, 0),
    ("mbaff.264", 0, 333, 3, 2),
    ("paff_ip.264", 1, 1, 16, 0),
    ("hi10.264", 0, 1, 3, 0),
])
def test_dense_export_equals_the_original(monkeypatch, clip, chunk_mode, batch, sup, flags):
    got, want = _both(monkeypatch, clip, chunk_mode, batch, sup, flags)
    assert len(got) == len(want) and got == want


def test_cases_reach_sig0_rows_and_even_step_rounding(monkeypatch):
    """multislice.264's warm sections carry sig0 rows, and the odd cases
    hold chunks of more than 8 super-steps, among them one whose count of
    steps with bins is odd, so bucket_steps adds a step of padding only."""
    got, want = _both(monkeypatch, "multislice.264", 0, 256, 16, 0)
    assert got == want
    assert any(len(c.sig0_idx) for c in analysis._parse_analysis(got).chunks)
    got, want = _both(monkeypatch, "hi10.264", 0, 1, 3, 0)
    assert got == want
    an = analysis._parse_analysis(got)
    span = an.sup * an.batch
    steps = [(len(c.bit) + span - 1) // span for c in an.chunks]
    assert all(s > 8 for s in steps)
    assert any(s % 2 == 1 and c.v2_dk_d.shape[0] == s + 1 for s, c in zip(steps, an.chunks))
