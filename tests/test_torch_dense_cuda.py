"""Profile 0's card route on the card: ops/dense.py's two kernels against
their plain versions, and compress(model_profile=0) under v2 through them.

CUDA kernels have no CPU mode, so these tests skip where torch sees no CUDA
device. They import nothing of the JAX package. On a machine with the card:

    python -m pytest -m cuda tests/test_torch_dense_cuda.py -q
"""
import os
import struct

import numpy as np
import pytest
import torch

from avrecode_tpu_torch import _native, host, trace
from avrecode_tpu_torch import device as td
from avrecode_tpu_torch.ops import dense
from avrecode_tpu_torch.ops import lanes as lx
from avrecode_tpu_torch.ops import model_pass as mp

pytestmark = pytest.mark.cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLIP = os.path.join(REPO, "benchdata", "multigop720.mp4")
BENCH = os.path.join(REPO, "benchdata", "bench.mp4")
CAMERA = os.path.join(REPO, "perfbench", "clips", "camera1080.mp4")


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    _native.ensure_host_lib()
    _native.build()
    return torch.device("cuda")


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _equal(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    assert torch.equal(a, b)


@pytest.mark.parametrize("path", [CLIP, BENCH])
def test_dense_kernels_match_plain(cuda, path):
    """Both kernels on every profile-0 chunk of the clip, from the chunk's
    packed blob: kernel == plain, one launch each, and the pass on the
    expanded inputs gives the host model's probs."""
    an = td.analyze(_read(path), batch_size=4096, model_profile=0, sup=128)
    kw = dict(batch=an.batch, sup=an.sup, fast_w=an.fast_w, slow_w=an.slow_w, sig_w=an.sig_w,
              sig_alpha=an.sig_alpha)
    for c in an.chunks:
        n = len(c.bit)
        lay = dense.chunk_layout(an, c)
        buf = np.empty(lay.nbytes, np.uint8)
        dense.pack(c, lay, buf)
        host_blob = torch.from_numpy(buf)
        blob = host_blob.to(cuda)
        _native.reset_launches()
        got = dense.expand(blob, lay)
        assert _native.launches["dense_expand"] == 1
        for g, w in zip(got, dense.expand(host_blob, lay), strict=True):
            _equal(g.cpu(), w)
        probs = mp.model_pass_v2(*got, **kw)
        assert np.array_equal(probs[:n].cpu().numpy(), c.host_probs.astype(np.int32))
        for K in (td.pick_lanes(n), 7):
            T = lx._bucket(-(-n // K))
            planes = dense.lane_planes(blob, probs, lay, T, K)
            for g, w in zip(planes, dense.lane_planes(host_blob, probs.cpu(), lay, T, K),
                            strict=True):
                _equal(g.cpu(), w)
        assert _native.launches["dense_lanes"] == 2


def _narrow_bytes(an, blobs, keep_probs):
    """The bytes the card route moves for the chunks: each one's blob up,
    then its lane counts, its compacted words and final states (and its
    probs) down."""
    total = 0
    for c, blob in zip(an.chunks, blobs, strict=True):
        K, n = struct.unpack_from("<II", blob)
        words = np.frombuffer(blob, "<u4", K, 8).astype(np.int64) - 2
        maxW = lx._bucket(max(int(words.max()), 1))
        total += dense.chunk_layout(an, c).nbytes + 4 * K + 2 * maxW * K + 4 * K
        total += 4 * n if keep_probs else 0
    return total


@pytest.mark.parametrize("path", [BENCH, CAMERA])
def test_compress_profile0_card_route(cuda, path, monkeypatch):
    """compress(model_profile=0) under v2 takes the card route on every
    chunk: two new launches a chunk, spans that count the narrow bytes
    (chunk.model + chunk.lanes count2), kept probs equal to the host
    model's, and the container the host route writes (bench.mp4: the CPU
    route's), which decodes to the input. camera1080.mp4's CPU route runs
    the plain lane scan's Python loop over 131,072 steps a chunk, minutes,
    so its witness is the host engine, the serial C++ encoder independent
    of every card path, at its own 16 lanes a chunk."""
    data = _read(path)
    an = td.analyze(data, batch_size=4096, model_profile=0, sup=128)
    monkeypatch.setenv("ARTC_MODEL_IMPL", "v2")
    for keep in (False, True):
        trace.drain()
        trace.enable()
        _native.reset_launches()
        info = {}
        try:
            comp, _ = td.compress(data, model_profile=0, device=cuda, info=info,
                                  keep_probs=keep)
        finally:
            trace.disable()
        spans = trace.drain()
        assert _native.launches["dense_expand"] == _native.launches["dense_lanes"] \
            == len(an.chunks)
        moved = sum(s.count2 for s in spans if s.name in ("chunk.model", "chunk.lanes"))
        assert moved == _narrow_bytes(an, info["blobs"], keep)
        if keep:
            for c, probs in zip(an.chunks, info["probs"], strict=True):
                assert probs.dtype == np.uint16 and np.array_equal(probs, c.host_probs)
    if path == BENCH:
        assert comp == td.compress(data, model_profile=0, device="cpu")[0]
    else:
        got, _ = td.compress(data, model_profile=0, force_lanes=16, device=cuda)
        assert got == host.compress(data, 16, 0, 4096, 0)[0]
    assert host.decompress(comp)[0] == data


def test_dense_kernels_past_2_24_padded_bins(cuda):
    """A chunk of more than 2^24 padded bins (the JAX expand's bound, which
    the card route does not keep) and more than 2^24 lane slots: both
    kernels equal their plain versions on a random blob."""
    ns, sup, batch = 33, 128, 4096
    m = ns * sup * batch
    lay = dense.layout(m - 777, m, ns, sup, batch, 64, 64, 100, 50)
    gen = torch.Generator(device=cuda).manual_seed(2 ** 31 + 5)
    blob = torch.randint(0, 256, (lay.nbytes,), dtype=torch.uint8, device=cuda, generator=gen)
    probs = torch.randint(-2 ** 31, 2 ** 31 - 1, (m,), dtype=torch.int32, device=cuda,
                          generator=gen)
    host_blob = blob.cpu()
    for g, w in zip(dense.expand(blob, lay), dense.expand(host_blob, lay), strict=True):
        _equal(g.cpu(), w)
    K = 128
    T = lx._bucket(-(-lay.n // K))
    assert m > 1 << 24 and T * K > 1 << 24
    for g, w in zip(dense.lane_planes(blob, probs, lay, T, K),
                    dense.lane_planes(host_blob, probs.cpu(), lay, T, K), strict=True):
        _equal(g.cpu(), w)
