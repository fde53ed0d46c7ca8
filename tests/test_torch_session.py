"""host.Session, the one owner of the native analysis session: its errors
carry the library's message, a body that raises closes the session once,
the streamed slim and dense exports equal the one-shot exports byte for
byte, and device.compress (both profiles) and compress_mesh make the same
native calls in the same order, through the chunk loops
analysis.read_slim and analysis.read_dense. The dense analysis's walker
threads: a profile-0 compress writes the host engine's container, an error
of a later chunk reaches the caller, dense chunks are taken in order, and a
caller that leaves the loop early closes the session without a hang and
without a thread left behind."""
import os
import threading
import time

import numpy as np
import pytest
from test_torch_dense_export import CLIPS
from test_torch_slim_export import WARM

from avrecode_tpu_torch import analysis, host, trace
from avrecode_tpu_torch import device as td
from avrecode_tpu_torch import testcorpus as tc
from avrecode_tpu_torch.parallel import mesh as tmesh

CLIP = "ipb_high.mp4"
SUP = 128
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Recording:
    """A stand-in for host._lib that records the name of every entry called
    and hands the call on to the real library (or to `fake`'s entries)."""

    def __init__(self, real, fake=None):
        self.real, self.fake, self.calls = real, fake or {}, []

    def __getattr__(self, name):
        fn = self.fake.get(name) or getattr(self.real, name)

        def call(*args):
            self.calls.append(name)
            return fn(*args)
        return call


@pytest.fixture
def recording(monkeypatch):
    rec = Recording(host.lib())
    monkeypatch.setattr(host, "_lib", rec)
    return rec


def test_a_null_handle_raises_the_library_message():
    with pytest.raises(host.NativeError,
                       match=r"^unsupported model profile \(0 = immediate, 2 = frozen-batch\)$"):
        host.Session(tc.clip_bytes(CLIP), 16, 1, 4096, 1)


def test_bytes_that_are_no_video_open_to_no_chunks_and_pack_back():
    """The open is asynchronous and accepts any bytes: they hold no slice,
    so the analysis has no chunk and the container stores them as they are."""
    data = b"no video here " * 50
    with host.Session(data, 16, 1, 4096, 2) as session:
        an, chunks = analysis.read_slim(session, SUP, trace.NULL)
        assert list(chunks) == [] and an.slim
        comp, _ = session.pack([])
    assert host.decompress(comp)[0] == data


@pytest.mark.parametrize("call, message", [
    (lambda s: s.chunk(0), "bad analyze chunk index"),
    (lambda s: s.header(), "artc_session_analyze_begin not called"),
])
def test_a_failing_call_raises_the_library_message(call, message):
    with host.Session(tc.clip_bytes(CLIP), 16, 1, 4096, 2) as session:
        with pytest.raises(host.NativeError, match=f"^{message}$"):
            call(session)


def test_begin_on_a_profile_0_session_raises_the_library_message():
    with host.Session(tc.clip_bytes(CLIP), 16, 1, 4096, 0) as session:
        with pytest.raises(host.NativeError, match="^slim analysis requires model_profile=2"):
            session.begin(SUP, 0)


def test_a_body_that_raises_closes_the_session_once(recording):
    with pytest.raises(ZeroDivisionError):
        with host.Session(tc.clip_bytes(CLIP), 16, 1, 4096, 2) as session:
            session.begin(SUP, 0)
            1 / 0
    session.__exit__(None, None, None)  # a second exit closes nothing
    assert recording.calls == ["artc_session_open", "artc_session_analyze_begin",
                               "artc_session_close"]


def test_a_failed_open_closes_nothing(monkeypatch):
    rec = Recording(host.lib(), {"artc_session_open": lambda *args: None})
    monkeypatch.setattr(host, "_lib", rec)
    with pytest.raises(host.NativeError):
        host.Session(b"", 16, 0, 4096, 2)
    assert rec.calls == ["artc_session_open", "artc_last_error"]


def test_streamed_slim_export_equals_the_one_shot():
    """At chunk mode 1 (two GOP chunks)."""
    data = tc.clip_bytes(CLIP)
    with host.Session(data, 16, 1, 4096, 2) as session:
        n = session.begin(SUP, 0)
        streamed = session.header() + b"".join(session.chunk(i).take() for i in range(n))
    with host.Session(data, 16, 1, 4096, 2) as session:
        one_shot = session.analyze(SUP, 1).take()
    assert n == 2
    assert streamed == one_shot
    # and the slim chunk loop parses what the one-shot parse does
    with host.Session(data, 16, 1, 4096, 2) as session:
        an, chunks = analysis.read_slim(session, SUP, trace.NULL)
        got = [c for _, c in chunks]
    want = analysis._parse_analysis(one_shot)
    assert (an.n_dual, an.sup, an.batch, len(got)) == (want.n_dual, want.sup, want.batch, n)
    for g, w in zip(got, want.chunks):
        assert g.n == w.n and np.array_equal(g.packed, w.packed)
        assert np.array_equal(g.dual0, w.dual0)


def _chunk_loop_calls(n: int) -> list[str]:
    chunks = [name for _ in range(n)
              for name in ("artc_session_analyze_chunk", "artc_free")]
    return ["artc_session_open", "artc_session_analyze_begin",
            "artc_session_analyze_header", "artc_free", *chunks,
            "artc_session_pack", "artc_free", "artc_session_close"]


def test_compress_makes_the_session_calls_in_order(recording):
    td.compress(tc.clip_bytes(CLIP), chunk_mode=1, batch_size=1024, device="cpu")
    assert recording.calls == _chunk_loop_calls(2)


def test_compress_mesh_makes_the_same_calls_in_order(recording):
    td.compress_mesh(tc.clip_bytes(CLIP), tmesh.make_mesh(1, 1, ["cpu"]), batch_size=1024)
    assert recording.calls == _chunk_loop_calls(2)


def test_compress_profile_0_makes_the_session_calls_in_order(recording):
    td.compress(tc.clip_bytes(CLIP), chunk_mode=1, batch_size=1024, model_profile=0,
                device="cpu")
    assert recording.calls == _chunk_loop_calls(2)


def _warm(monkeypatch, clip: str) -> bytes:
    """The clip's bytes, with multislice.264's warm sections switched on as
    test_torch_dense_export.py has them."""
    if clip == "multislice.264":
        for k, v in WARM.items():
            monkeypatch.setenv(k, v)
    return tc.clip_bytes(clip)


@pytest.mark.parametrize("clip,chunk_mode", [(c, m) for c in CLIPS for m in (0, 1)])
def test_streamed_dense_export_equals_the_one_shot(monkeypatch, clip, chunk_mode):
    """The header, then each chunk taken one by one, is the one-shot dense
    export byte for byte; read_dense parses what the one-shot parse does."""
    data = _warm(monkeypatch, clip)
    with host.Session(data, 16, chunk_mode, 4096, 0) as session:
        n = session.begin(SUP, host.DENSE)
        parts = [session.header()] + [session.chunk(i).take() for i in range(n)]
    with host.Session(data, 16, chunk_mode, 4096, 0) as session:
        one_shot = session.analyze(SUP, 0).take()
    assert n >= 1 and b"".join(parts) == one_shot
    want = analysis._parse_analysis(one_shot)
    with host.Session(data, 16, chunk_mode, 4096, 0) as session:
        an, chunks = analysis.read_dense(session, SUP, trace.NULL)
        got = list(chunks)
    assert (an.slim, an.n_dual, an.sup, an.batch, len(got)) == (
        False, want.n_dual, want.sup, want.batch, n)
    for g, w in zip(got, want.chunks):
        for name in ("bit", "kind", "key", "prior", "pre_ones", "pre_tot", "host_probs",
                     "dual0", "v2_bin_u", "v2_dk_d", "v2_dk_s", "v2_dd", "v2_ds", "sig0_idx",
                     "sig0_val"):
            a, b = getattr(g, name), getattr(w, name)
            assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), name
        assert g.v2_m == w.v2_m


@pytest.mark.parametrize("clip", CLIPS)
def test_compress_profile_0_writes_the_host_engines_container(monkeypatch, clip):
    """At chunk mode 1 and 16 lanes a chunk, the host engine's lane count."""
    data = _warm(monkeypatch, clip)
    got, _ = td.compress(data, 16, 1, 1024, 0, force_lanes=16, device="cpu")
    assert got == host.compress(data, 16, 1, 1024, 0)[0]


def _within(seconds: float, fn):
    """fn()'s result, run on a thread of its own; fails if fn has not
    returned within `seconds`."""
    out = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as e:  # handed to the caller
            out["error"] = e
    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(seconds)
    assert not t.is_alive(), f"no return within {seconds} s"
    if "error" in out:
        raise out["error"]
    return out.get("value")


def _threads() -> int:
    return len(os.listdir("/proc/self/task"))


def _multigop() -> bytes:
    with open(os.path.join(REPO, "benchdata", "multigop.mp4"), "rb") as f:
        return f.read()


def test_a_producer_error_on_a_later_chunk_reaches_the_caller(monkeypatch):
    monkeypatch.setenv("ARTC_DENSE_FAULT_CHUNK", "1")
    message = "^dense analysis: fault injected at chunk 1$"

    def fetch():
        with host.Session(tc.clip_bytes(CLIP), 16, 1, 4096, 0) as session:
            assert session.begin(SUP, host.DENSE) == 2
            session.chunk(0).take()
            with pytest.raises(host.NativeError, match=message):
                session.chunk(1)
    _within(60, fetch)
    with pytest.raises(host.NativeError, match=message):
        _within(60, lambda: td.compress(tc.clip_bytes(CLIP), 16, 1, 1024, 0, device="cpu"))
    with pytest.raises(host.NativeError, match=message):
        _within(60, lambda: analysis.analyze(tc.clip_bytes(CLIP), 16, 1, 1024, 0, slim=False))


def test_dense_chunks_are_taken_in_order():
    with host.Session(tc.clip_bytes(CLIP), 16, 1, 4096, 0) as session:
        session.begin(SUP, host.DENSE)
        with pytest.raises(host.NativeError,
                           match="^dense analysis chunks are taken once each, in order$"):
            session.chunk(1)
        session.chunk(0).take()
        session.chunk(1).take()


def test_leaving_the_chunk_loop_early_closes_without_a_hang_or_a_thread_left(monkeypatch):
    """multigop.mp4 at chunk mode 1 has eight chunks: when chunk.model raises
    at chunk 1, the walkers are waiting at their run-ahead, or walking."""
    data = _multigop()
    _within(120, lambda: td.compress(data, 16, 1, 1024, 0, device="cpu"))  # torch's threads
    before = _threads()
    real = td.device_probs
    seen = []

    def probs(an, c, *args, **kw):
        seen.append(len(c.bit))
        if len(seen) == 2:
            raise RuntimeError("injected at chunk 1")
        return real(an, c, *args, **kw)
    monkeypatch.setattr(td, "device_probs", probs)
    with pytest.raises(RuntimeError, match="^injected at chunk 1$"):
        _within(60, lambda: td.compress(data, 16, 1, 1024, 0, device="cpu"))
    assert len(seen) == 2
    deadline = time.monotonic() + 10
    while _threads() > before and time.monotonic() < deadline:
        time.sleep(0.05)
    assert _threads() <= before
