"""host.Session, the one owner of the native analysis session: its errors
carry the library's message, a body that raises closes the session once,
the streamed slim export equals the one-shot export byte for byte, and
device.compress and compress_mesh make the same native calls in the same
order, through the one slim chunk loop (analysis.read_slim)."""
import numpy as np
import pytest

from avrecode_tpu_torch import analysis, host, trace
from avrecode_tpu_torch import device as td
from avrecode_tpu_torch import testcorpus as tc
from avrecode_tpu_torch.parallel import mesh as tmesh

CLIP = "ipb_high.mp4"
SUP = 128


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


def _slim_calls(n: int) -> list[str]:
    chunks = [name for _ in range(n)
              for name in ("artc_session_analyze_chunk", "artc_free")]
    return ["artc_session_open", "artc_session_analyze_begin",
            "artc_session_analyze_header", "artc_free", *chunks,
            "artc_session_pack", "artc_free", "artc_session_close"]


def test_compress_makes_the_session_calls_in_order(recording):
    td.compress(tc.clip_bytes(CLIP), chunk_mode=1, batch_size=1024, device="cpu")
    assert recording.calls == _slim_calls(2)


def test_compress_mesh_makes_the_same_calls_in_order(recording):
    td.compress_mesh(tc.clip_bytes(CLIP), tmesh.make_mesh(1, 1, ["cpu"]), batch_size=1024)
    assert recording.calls == _slim_calls(2)


def test_compress_profile_0_makes_the_session_calls_in_order(recording):
    td.compress(tc.clip_bytes(CLIP), chunk_mode=1, batch_size=1024, model_profile=0,
                device="cpu")
    assert recording.calls == ["artc_session_open", "artc_session_analyze2", "artc_free",
                               "artc_session_pack", "artc_free", "artc_session_close"]
