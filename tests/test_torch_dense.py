"""Profile 0's narrow blob (avrecode_tpu_torch/ops/dense.py) on the CPU:
the plain versions of the card route's two kernels, given a chunk's packed
blob, equal exactly what the host route builds on the host for the same
chunk: dense.expand equals model_pass_v2's arguments from
model_pass.v2_tables_inputs, and dense.lane_planes, given the pass's int32
probs, equals the lane scan's planes from lanes.interleaved_planes on the
uint16 probs. Every chunk of the frozen corpus under its profile-0 mode is a
case, as are multislice.264's warm-started chunks (a nonzero sig0) and
synthetic chunks at the padding edges.
"""
import dataclasses

import numpy as np
import pytest
import torch

from avrecode_tpu_torch import _native
from avrecode_tpu_torch import device as td
from avrecode_tpu_torch import testcorpus as tc
from avrecode_tpu_torch.analysis import ChunkAnalysis
from avrecode_tpu_torch.ops import dense
from avrecode_tpu_torch.ops import lanes as lx
from avrecode_tpu_torch.ops import model_pass as mp

_native.ensure_host_lib()

MODE = tc.CORPUS_MODES["p0_v2"]
CLIPS = [c for c, e in sorted(tc.manifest()["clips"].items())
         if "digest" in e["modes"].get("p0_v2", {})]
WARM = dataclasses.replace(MODE, env=tc.WARM_ENV)


def _blob(an, c) -> tuple[dense.Layout, torch.Tensor]:
    lay = dense.chunk_layout(an, c)
    buf = np.full(lay.nbytes, 0xA5, np.uint8)  # bytes pack does not write stay 0xA5
    dense.pack(c, lay, buf)
    return lay, torch.from_numpy(buf)


def _host_inputs(an, c):
    args, _ = mp.v2_tables_inputs(c.kind, c.prior, c.pre_ones, c.pre_tot, c.v2_m, c.v2_bin_u,
                                  c.v2_dk_d, c.v2_dk_s, c.v2_dd, c.v2_ds, c.dual0, an.batch,
                                  an.sup, an.fast_w, an.slow_w, an.sig_w, an.sig_alpha,
                                  an.n_sig, td._sig0_dense(c, an.n_sig), device="cpu")
    return args


def _equal(got, want, what):
    assert len(got) == len(want), what
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape, f"{what}: output {k}"
        assert torch.equal(g, w), f"{what}: output {k}"


def _check_chunk(an, c, what, K=None, rng=None):
    """The expand and the lane planes of one chunk against the host route;
    returns (n, m, T, K)."""
    n = len(c.bit)
    lay, blob = _blob(an, c)
    _equal(dense.expand(blob, lay), _host_inputs(an, c), f"{what}: expand")
    K = K or td.pick_lanes(n)
    T = lx._bucket(-(-n // K))
    rng = rng or np.random.default_rng(n)
    # The pass's int32 probs: the host model's below, anything above bit 15
    # and past n (the host route keeps their low 16 bits, up to n).
    probs = c.host_probs.astype(np.int64) | (rng.integers(0, 1 << 15, n) << 16)
    probs = np.concatenate([probs, rng.integers(-1 << 31, 1 << 31, c.v2_m - n)])
    got = dense.lane_planes(blob, torch.from_numpy(probs.astype(np.int32)), lay, T, K)
    _equal(got, lx.interleaved_planes(c.bit, c.host_probs, K, "cpu"), f"{what}: lane planes")
    return n, lay.m, T, K


def _analysis(clip, mode=MODE):
    an = tc.mode_analysis(tc.clip_bytes(clip), mode)
    assert not an.slim and an.chunks and all(c.v2_bin_u is not None for c in an.chunks)
    return an


@pytest.mark.parametrize("clip", CLIPS)
def test_dense_kernels_plain_match_host_route(clip):
    an = _analysis(clip)
    for i, c in enumerate(an.chunks):
        n, m, T, K = _check_chunk(an, c, f"{clip} chunk {i}")
        assert m > n and T * K >= n


def test_dense_kernels_plain_match_host_route_warm_chunks():
    """multislice.264 as warm-started sections: several chunks, the later
    ones with a nonzero sparse sig0, and lane counts forced to 4, 7 and 128
    (n not a multiple of K, T x K past n)."""
    an = _analysis("multislice.264", WARM)
    assert len(an.chunks) > 1
    assert any(c.sig0_idx is not None and len(c.sig0_idx) for c in an.chunks[1:])
    edges = set()
    for i, c in enumerate(an.chunks):
        for K in (4, 7, 128):
            n, m, T, K = _check_chunk(an, c, f"warm chunk {i}, K={K}", K=K)
            edges.add((n % K != 0, T * K > n, m > n))
    assert (True, True, True) in edges


def _synthetic(rng, n, m, ns, sup, batch, ud, us, n_dual, n_sig, warm):
    """A dense chunk of random arrays at the export's ranges (the expand
    and the planes read no meaning into them)."""
    def u(hi, *shape):
        return rng.integers(0, hi, shape)

    sig_idx = rng.choice(n_sig, 5, replace=False).astype(np.uint32) if warm else None
    return ChunkAnalysis(
        bit=u(2, n).astype(np.uint8), kind=u(4, n).astype(np.uint8),
        key=u(1 << 20, n).astype(np.uint32), prior=u(1 << 16, n).astype(np.uint16),
        pre_ones=u(1 << 16, n).astype(np.uint16), pre_tot=u(1 << 16, n).astype(np.uint16),
        host_probs=(1 + u(32767, n)).astype(np.uint16),
        dual0=u(1 << 16, n_dual, 4).astype(np.int32), v2_m=m,
        v2_bin_u=u(1 << 32, m).astype(np.uint32),
        v2_dk_d=u(1 << 32, ns, ud).astype(np.uint32).view(np.int32),
        v2_dk_s=u(1 << 32, ns, us).astype(np.uint32).view(np.int32),
        v2_dd=u(1 << 16, ns, sup, ud, 2).astype(np.int32),
        v2_ds=u(1 << 16, ns, sup, us, 2).astype(np.int32),
        sig0_idx=sig_idx, sig0_val=u(1 << 16, 5, 2).astype(np.int32) if warm else None)


# (n, ns, K): n = m (no padding), one bin short of m, one bin, and a stream
# that fills T x K exactly.
EDGES = {"n_is_m": (2 * 4 * 16, 2, 16), "m_less_one": (2 * 4 * 16 - 1, 2, 16),
         "one_bin": (1, 1, 16), "fills_t_by_k": (64, 2, 16)}


@pytest.mark.parametrize("edge", list(EDGES))
def test_dense_kernels_plain_match_host_route_at_the_edges(edge):
    n, ns, K = EDGES[edge]
    sup, batch, ud, us, n_dual, n_sig = 4, 16, 8, 4, 11, 6
    an = td.Analysis([], 16, batch, n_dual, n_sig, 1, 2, 3, 4, 0, sup)
    rng = np.random.default_rng(len(edge))
    c = _synthetic(rng, n, ns * sup * batch, ns, sup, batch, ud, us, n_dual, n_sig,
                   edge != "one_bin")
    got_n, m, T, got_k = _check_chunk(an, c, edge, K=K, rng=rng)
    assert (got_n == m) == (edge == "n_is_m")
    assert (T * got_k == n) == (edge in ("fills_t_by_k", "n_is_m"))


@pytest.mark.parametrize("clip", ["i_main.264", "pcm_mixed.mp4"])
def test_dense_blob_bytes_are_the_layout_formula(clip):
    """The bytes the card route counts (chunk.model's count2) are the
    layout's: each segment at its export width, rounded up to 256 bytes."""
    an = _analysis(clip)
    for c in an.chunks:
        lay, blob = _blob(an, c)
        n, m = len(c.bit), int(c.v2_m)
        ns, ud = c.v2_dk_d.shape
        us = c.v2_dk_s.shape[1]
        sizes = [n, n, 2 * n, 2 * n, 2 * n, 4 * m, 4 * ns * ud, 4 * ns * us,
                 2 * ns * an.sup * ud * 2, 2 * ns * an.sup * us * 2, 2 * an.n_dual * 4,
                 2 * an.n_sig * 2]
        assert blob.numel() == lay.nbytes == sum(-(-s // 256) * 256 for s in sizes)
        assert lay.offs == tuple(np.cumsum([0] + [-(-s // 256) * 256 for s in sizes])[:-1])


def test_dense_layout_keeps_the_expand_bound():
    """The layout keeps dense_expand_kernel's bound, 2^31 padded bins, and not
    the JAX expand's float one, 2^24: a chunk of 2^24 padded bins is laid
    out, one of 2^31 is refused."""
    lay = dense.layout(10, 1 << 24, 1 << 12, 1, 1 << 12, 8, 8, 4, 4)
    assert lay.counts[5] == 1 << 24 and lay.nbytes > 4 << 24
    with pytest.raises(ValueError, match="2\\^31"):
        dense.layout(10, 1 << 31, 1 << 19, 1, 1 << 12, 8, 8, 4, 4)
    with pytest.raises(ValueError):
        dense.layout(0, 64, 1, 4, 16, 8, 8, 4, 4)
