"""The port's CUDA kernels against their plain PyTorch versions, on the card.

CUDA kernels have no CPU mode, so these tests skip where torch sees no CUDA
device. On a machine with the card:

    python -m pytest -m cuda tests/test_torch_cuda.py -q
"""
import ctypes
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch
from test_coder import _c_encode, _random_biased_stream
from test_torch_batch_passes import KW as PASS_KW
from test_torch_batch_passes import N_DUAL, N_SIG, _dict_inputs, _stream, _tables
from test_torch_jaxlib import ensure_jax_lib

from avrecode_tpu import pipeline
from avrecode_tpu_torch import _native, host
from avrecode_tpu_torch import device as td
from avrecode_tpu_torch import testcorpus as tc
from avrecode_tpu_torch.ops import lanes as tl
from avrecode_tpu_torch.ops import model_pass as tmp
from avrecode_tpu_torch.testing import (DUAL0_CASES, EXPAND_CASES, dual0_case, expand_case,
                                        lane_planes)

pytestmark = pytest.mark.cuda

# Both host libraries, each built here under its own lock, before any test
# of any module can reach the JAX package's unlocked build (see
# test_torch_jaxlib.py).
_native.ensure_host_lib()
ensure_jax_lib()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
from host_flags import MODES as HOST_MODES  # noqa: E402

CLIP = os.path.join(REPO, "benchdata", "multigop720.mp4")
BENCH = os.path.join(REPO, "benchdata", "bench.mp4")


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    _native.build()
    return torch.device("cuda")


@pytest.fixture(scope="module")
def clip_analysis(cuda):
    with open(CLIP, "rb") as f:
        data = f.read()
    return data, td.analyze(data, batch_size=4096, model_profile=2, sup=128)


def _equal(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    assert torch.equal(a, b)


@pytest.mark.parametrize("lanes", [1, 16, 128])
def test_lane_kernels_match_plain_and_c(cuda, lanes):
    rng = np.random.default_rng(lanes)
    n = 20011
    bits, probs = _random_biased_stream(rng, n)
    b = torch.from_numpy(bits.astype(np.int32)).to(cuda)
    p = torch.from_numpy(probs.astype(np.int32)).to(cuda)
    T = tl._bucket(-(-n // lanes))
    got = tl.lane_scan_dev(b, p, n, T, lanes)
    for g, w in zip(got, tl._lane_scan_dev_plain(b, p, n, T, lanes)):
        _equal(g, w)
    maxW = tl._bucket(int(got[3].max()))
    _equal(tl.lane_compact(got[1], got[2], maxW), tl._lane_compact_plain(got[1], got[2], maxW))
    assert tl.encode_interleaved_dev(b, p, n, lanes) == _c_encode(bits, probs, lanes)


def test_expand_and_model_kernels_match_plain(cuda, clip_analysis):
    _, an = clip_analysis
    c = an.chunks[0]
    st = td.to_torch_staged(an, c, cuda)
    d0 = [td._wire(a).to(cuda) for a in td._dual0_dict(c)]
    _equal(tmp.dual0_expand(*d0), tmp._dual0_expand_plain(*d0))
    _equal(st.dual0, tmp._dual0_expand_plain(*d0))
    ex = st.statics["expand"]
    planes = tmp.wire_expand4_blob(st.blob, st.sc, **ex)
    plain = tmp._wire_expand_plain(st.blob, st.sc, *(ex[k] for k in (
        "m", "nsub", "U", "ud", "us", "ns", "batch", "layout")))
    for g, w in zip(planes, plain):
        _equal(g, w)
    bit, kind, slot, prior, deltas, dk_d, dk_s = planes
    mo = st.statics["model"]
    probs, _ = tmp.model_pass_v4(bit, kind, slot, prior, dk_d, dk_s, deltas, st.dual0,
                                 sig0_idx=st.s_idx, sig0_val=st.s_val, **mo)
    _equal(probs, tmp._v3_core_plain(kind, slot, prior, dk_d, dk_s, deltas, st.dual0,
                                     *(mo[k] for k in ("batch", "sup", "fast_w", "slow_w",
                                                       "sig_w", "sig_alpha", "ud", "us",
                                                       "n_sig")), st.s_idx, st.s_val))
    assert np.array_equal(probs[:c.n].cpu().numpy(), c.host_probs.astype(np.int32))


@pytest.mark.parametrize("case", list(DUAL0_CASES))
def test_dual0_expand_edge_cases_match_plain(cuda, case):
    """The one-launch dual0 expand on testing.py's dictionaries (no escapes,
    escapes at rows 0 and n_dual - 1, blocks with only padding escapes, a
    short dictionary, a block of escapes only, three search rounds, n_dual
    never a multiple of the block) and on an idx slice whose end is not on
    16 bytes: kernel == plain, one launch a call as the wrapper and the C
    entry count it; the launch floor (the same wrapper path, an empty
    kernel) counts nothing."""
    d0 = [td._wire(a).to(cuda) for a in dual0_case(case)]
    _native.reset_launches()
    got = tmp.dual0_expand(*d0)
    assert _native.launches["dual0_expand"] == 1
    assert _native.dual0_launches() == 1
    _equal(got, tmp._dual0_expand_plain(*d0))
    short = [d0[0], d0[1][:d0[1].shape[0] - 5], *d0[2:]]
    _equal(tmp.dual0_expand(*short), tmp._dual0_expand_plain(*short))
    tmp._dual0_expand_cuda(*d0, entry="artc_launch_floor")
    torch.cuda.synchronize()
    assert _native.launches["dual0_expand"] == 2


PROFILE2_KERNELS = ("wire_expand", "dual0_expand", "model_pass_v4", "lane_scan_dev",
                    "lane_compact")
PROFILE0_KERNELS = {"v2": "model_pass_v2", "dict": "model_pass_dict", "sort": "model_pass",
                    "mm": "model_pass"}


def test_compress_on_cuda_roundtrips_through_every_kernel(cuda, clip_analysis):
    data, an = clip_analysis
    _native.reset_launches()
    info = {}
    comp, _ = td.compress(data, device=cuda, info=info, keep_probs=True)
    assert all(_native.launches[k] > 0 for k in PROFILE2_KERNELS), _native.launches
    for c, probs in zip(an.chunks, info["probs"]):
        assert np.array_equal(probs, c.host_probs)
    dec, _ = pipeline.decompress(comp)
    assert dec == data


@pytest.mark.parametrize("K", [16, 128])
def test_masked_lane_scan_matches_plain(cuda, K):
    """lane_scan with a mask that is not a prefix (lane-sliced and ragged)
    and the probability extremes: kernel == plain."""
    rng = np.random.default_rng(K)
    T = 1024
    bits = rng.integers(0, 2, (T, K)).astype(np.int32)
    probs = np.where(rng.random((T, K)) < 0.3, np.where(bits == 1, 1, 32767),
                     rng.integers(1, 32768, (T, K))).astype(np.int32)
    valid = rng.random((T, K)) < 0.8
    valid[:, ::3] = False
    args = [torch.from_numpy(a).to(cuda) for a in (bits, probs, valid)]
    for g, w in zip(tl.lane_scan(*args), tl._lane_scan_plain(*args)):
        _equal(g, w)


@pytest.mark.parametrize("K", [1, 7, 33])
def test_lane_scans_on_ragged_lane_groups(cuda, K):
    """Lane counts that leave the kernels' 32-lane groups ragged: the dense
    scan with n not a multiple of K, and the masked scan over 3 chunks of a
    lane slice with a ragged mask and T not a multiple of the ring's tile;
    kernel == plain (on CPU copies)."""
    rng = np.random.default_rng(K)
    n = K * 1001 + K // 2
    T = tl._bucket(-(-n // K))
    b, p = (torch.from_numpy(a.astype(np.int32)) for a in _random_biased_stream(rng, n))
    for g, w in zip(tl.lane_scan_dev(b.to(cuda), p.to(cuda), n, T, K),
                    tl._lane_scan_dev_plain(b, p, n, T, K)):
        _equal(g.cpu(), w)
    G, T, wide = 3, 333, K + 5
    planes = [torch.from_numpy(a) for a in (
        rng.integers(0, 2, (G, T, wide)).astype(np.int32),
        rng.integers(1, 32768, (G, T, wide)).astype(np.int32),
        rng.random((G, T, wide)) < 0.7)]
    got = tl.lane_scan(*(x.to(cuda)[:, :, 2:2 + K] for x in planes))
    for g, w in zip(got, tl._lane_scan_plain(*(x[:, :, 2:2 + K] for x in planes))):
        _equal(g.cpu(), w)


@pytest.fixture(scope="module")
def profile0_analysis(cuda):
    with open(CLIP, "rb") as f:
        data = f.read()
    return data, td.analyze(data, batch_size=4096, model_profile=0, sup=128)


def test_model_pass_v2_kernel_matches_plain(cuda, profile0_analysis):
    """model_pass_v2 on chunk 0's full planes: kernel == plain == host."""
    _, an = profile0_analysis
    c = an.chunks[0]
    args = (c.kind, c.prior, c.pre_ones, c.pre_tot, c.v2_m, c.v2_bin_u, c.v2_dk_d, c.v2_dk_s,
            c.v2_dd, c.v2_ds, c.dual0, an.batch, an.sup, an.fast_w, an.slow_w, an.sig_w,
            an.sig_alpha, an.n_sig)
    _native.reset_launches()
    got = tmp.run_chunk_v2_tables(*args, device=cuda)
    assert _native.launches["model_pass_v2"] == 1
    assert _native.pass_launches() == 4  # two table copies, a barrier clear, one pass
    assert np.array_equal(got, c.host_probs)
    planes = [torch.from_numpy(np.concatenate([a.astype(np.int32), np.full(
        c.v2_m - len(c.bit), v, np.int32)])).to(cuda) for a, v in (
            (c.kind, 3), (c.prior, 1), (c.pre_ones, 0), (c.pre_tot, 0))]
    ns = c.v2_dk_d.shape[0]
    sh = (ns, an.sup, an.batch)
    ud, us = c.v2_dk_d.shape[1], c.v2_dk_s.shape[1]
    tables = [np.concatenate([c.dual0.astype(np.int32), np.ones((1 + ud, 4), np.int32)]),
              np.concatenate([np.zeros((an.n_sig, 2), np.int32), np.ones((us, 2), np.int32)])]
    rest = [torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(cuda) for a in (
        c.v2_bin_u.reshape(sh), c.v2_dk_d, c.v2_dk_s, c.v2_dd, c.v2_ds, *tables)]
    kw = dict(batch=an.batch, sup=an.sup, fast_w=an.fast_w, slow_w=an.slow_w, sig_w=an.sig_w,
              sig_alpha=an.sig_alpha)
    pl = [x.reshape(sh) for x in planes]
    _equal(tmp.model_pass_v2(*pl, *rest, **kw), tmp._model_pass_v2_plain(
        *pl, *rest, *(kw[k] for k in ("batch", "sup", "fast_w", "slow_w", "sig_w",
                                      "sig_alpha"))))


@pytest.mark.parametrize("impl", ["dict", "sort", "mm"])
def test_per_batch_kernels_match_plain(cuda, profile0_analysis, impl):
    """model_pass_dict / model_pass on the first 64 batches of chunk 0 (a
    prefix of a chunk's stream is a stream; its probs are the chunk's
    first ones): kernel == plain == host."""
    _, an = profile0_analysis
    c = an.chunks[0]
    n = 64 * an.batch
    args = (c.bit[:n], c.kind[:n], c.key[:n], c.prior[:n], c.dual0, an.batch, an.fast_w,
            an.slow_w, an.sig_w, an.sig_alpha, an.n_sig)
    _native.reset_launches()
    got = tmp.run_chunk(*args, impl=impl, device=cuda)
    assert _native.launches[PROFILE0_KERNELS[impl]] == 1
    assert np.array_equal(got, tmp.run_chunk(*args, impl=impl, device="cpu"))
    assert np.array_equal(got, c.host_probs[:n])


def _pass_case(case: str, wide: bool):
    """(bits, kinds, keys, priors, dual, sig, batch) of one of the inputs
    that have broken ports of the per-batch passes (the CPU tests of
    test_torch_batch_passes.py hold the same against JAX). `wide` gives the
    largest batch tables wide enough for about 10,000 distinct keys a batch."""
    rng = np.random.default_rng(len(case))
    n_dual, n_sig = (20000, 30000) if wide and case == "batch_12288" else (N_DUAL, N_SIG)
    nb, batch, over, far = {"over_window": (5, 256, True, (7, 50)),
                            "scratch_mix_nb1": (1, 512, False, ()),
                            "scratch_mix_nb3": (3, 512, False, ()),
                            "keys_past_tables": (3, 256, False, ()),
                            "batch_12288": (2, 12288, False, ()),
                            "many_batches": (70, 64, False, ())}[case]
    p = (0.3, 0.2, 0.2, 0.3) if case.startswith("scratch") else (0.45, 0.2, 0.3, 0.05)
    bits, kinds, keys, priors = _stream(rng, nb, batch, kinds_p=p, n_dual=n_dual, n_sig=n_sig)
    for r in far:  # rows with sums about 2^28 that no bin reads
        keys[(keys == r) & (kinds != 3)] = 3
    if case == "keys_past_tables":
        odd = rng.choice(np.flatnonzero(kinds != 3), 60, replace=False)
        keys[odd] = np.where(kinds[odd] == 2, N_SIG, N_DUAL) + rng.integers(0, 5, 60)
    dual, sig = _tables(rng, over, n_dual=n_dual, n_sig=n_sig, untouched=far)
    return bits, kinds, keys, priors, dual, sig, batch


PASS_CASES = ["over_window", "scratch_mix_nb1", "scratch_mix_nb3", "keys_past_tables",
              "batch_12288", "many_batches"]


# The dict pass takes its keys from the dictionary: no keys past the tables.
@pytest.mark.parametrize("impl,case", [(i, c) for i in ("dict", "sort") for c in PASS_CASES
                                       if (i, c) != ("dict", "keys_past_tables")])
def test_persistent_passes_match_plain(cuda, impl, case):
    """The persistent kernels on tables over their windows, the scratch-key
    mix, batch counts 1, 3 and past the staging ring, keys past the tables
    and the largest batch: kernel == plain (on CPU copies), with a launch
    count that does not depend on the number of batches."""
    bits, kinds, keys, priors, dual, sig, batch = _pass_case(case, impl == "sort")
    nb = len(bits) // batch
    if impl == "dict":
        bin_u, dict_keys, sig_ext = _dict_inputs(kinds, keys, sig, batch, len(dual))
        args = [torch.from_numpy(np.ascontiguousarray(a)) for a in (
            bits.reshape(nb, batch), kinds.reshape(nb, batch), priors.reshape(nb, batch), bin_u,
            dict_keys, dual, sig_ext)]
        fn, launches = tmp.model_pass_dict, 8
    else:
        args = [torch.from_numpy(a) for a in (bits, kinds, keys, priors, dual, sig)]
        fn, launches = tmp.model_pass, 7
    got = fn(*(a.to(cuda) for a in args), batch=batch, **PASS_KW)
    torch.cuda.synchronize()
    assert _native.pass_launches() == launches
    _equal(got.cpu(), fn(*args, batch=batch, **PASS_KW))


def test_model_pass_chunk_axis_matches_plain(cuda):
    """model_pass over a chunk axis of 3 with different tables per chunk:
    one call, one launch sequence, kernel == plain per chunk."""
    rng = np.random.default_rng(9)
    G, nb, batch = 3, 5, 512
    streams = [_stream(rng, nb, batch) for _ in range(G)]
    tables = [_tables(rng, g == 1) for g in range(G)]
    stacked = [torch.from_numpy(np.stack([s[i] for s in streams])) for i in range(4)] + [
        torch.from_numpy(np.stack([t[i] for t in tables])) for i in range(2)]
    _native.reset_launches()
    got = tmp.model_pass(*(a.to(cuda) for a in stacked), batch=batch, **PASS_KW)
    assert _native.launches["model_pass"] == 1 and _native.pass_launches() == 7
    _equal(got.cpu(), tmp.model_pass(*stacked, batch=batch, **PASS_KW))


@pytest.mark.parametrize("impl", ["v2", "dict", "sort", "mm"])
def test_compress_profile0_on_cuda(cuda, profile0_analysis, impl, monkeypatch):
    data, an = profile0_analysis
    monkeypatch.setenv("ARTC_MODEL_IMPL", impl)
    _native.reset_launches()
    info = {}
    comp, _ = td.compress(data, model_profile=0, device=cuda, info=info, keep_probs=True)
    assert _native.launches[PROFILE0_KERNELS[impl]] > 0 and _native.launches["lane_scan"] > 0
    for c, probs in zip(an.chunks, info["probs"]):
        assert np.array_equal(probs, c.host_probs)
    dec, _ = pipeline.decompress(comp)
    assert dec == data


@pytest.fixture(scope="module")
def mesh_inputs(cuda):
    with open(CLIP, "rb") as f:
        data = f.read()
    an = td.analyze(data, chunk_mode=1, batch_size=4096, model_profile=2, sup=128)
    return data, an, td.mesh_inputs(an, an.chunks, 2, 128, 16)


def test_mesh_expand_and_chunk_axis_kernels_match_plain(cuda, mesh_inputs):
    """The mesh-mode expand (every chunk) and the model pass over the chunk
    axis (all chunks in one launch sequence) at multigop720.mp4's
    mesh-uniform shapes: kernel == plain, and probs == host model."""
    _, an, inp = mesh_inputs
    st = inp.statics
    UD, US, NS = st["ud"], st["us"], st["ns"]
    M = NS * 128 * 4096
    blob, sc, dual0, si, sv, _ = (t.to(cuda) for t in inp.tensors())
    dual0 = dual0.to(torch.int32) & 0xFFFF  # mesh_inputs ships u16; the cells widen it so
    ex = dict(m=M, nsub=NS * 128, U=UD + US, ud=UD, us=US, ns=NS, batch=4096,
              layout=st["layout"], mesh=True)
    _native.reset_launches()
    planes = tmp.wire_expand4_blob(blob, sc, **ex)
    assert _native.launches["wire_expand"] == 1  # one call: every chunk's launches at once
    assert _native.expand_launches() == 3
    for g in range(blob.shape[0]):
        for got, want in zip(planes, tmp._wire_expand_plain(blob[g], sc[g], *ex.values())):
            _equal(got[g], want)
    bit, kind, slot, prior, deltas, dk_d, dk_s = planes
    mkw = dict(batch=4096, sup=128, fast_w=an.fast_w, slow_w=an.slow_w, sig_w=an.sig_w,
               sig_alpha=an.sig_alpha, ud=UD, us=US, n_sig=an.n_sig)
    probs = tmp.v3_core(bit, kind, slot, prior, dk_d, dk_s, deltas, dual0, sig0_idx=si,
                        sig0_val=sv, **mkw)
    assert _native.launches["model_pass_v4"] == 1
    assert _native.pass_launches() == 4  # a barrier clear, table init, sig0 scatter, one pass
    _equal(probs, tmp._v3_core_plain(kind, slot, prior, dk_d, dk_s, deltas, dual0,
                                     *mkw.values(), si, sv))
    for g, c in enumerate(an.chunks):
        assert np.array_equal(probs[g, :c.n].cpu().numpy(), c.host_probs.astype(np.int32))


def test_expand_launches_do_not_grow_with_the_chunks(cuda, mesh_inputs):
    """The expand of all of the mesh's chunks (pad chunks with 0-bit widths
    among them) and of one chunk alone make the same three launches; each
    chunk of the call equals the plain version."""
    _, an, inp = mesh_inputs
    st = inp.statics
    UD, US, NS = st["ud"], st["us"], st["ns"]
    blob, sc = inp.blob.to(cuda), inp.sc.to(cuda)
    ex = dict(m=NS * 128 * 4096, nsub=NS * 128, U=UD + US, ud=UD, us=US, ns=NS, batch=4096,
              layout=st["layout"], mesh=True)
    made = {}
    for G in (1, blob.shape[0]):
        planes = tmp.wire_expand4_blob(blob[:G], sc[:G], **ex)
        made[G] = _native.expand_launches()
        for g in range(G):
            for got, want in zip(planes, tmp._wire_expand_plain(blob[g], sc[g], *ex.values())):
                _equal(got[g], want)
    assert set(made.values()) == {3}, made


@pytest.mark.parametrize("case", [*EXPAND_CASES, "empty_coo_stream"])
def test_expand_kernel_edge_cases_match_plain(cuda, case):
    """The expand kernel on synthetic blobs: live COO entries past the sum
    of the runs (they belong to the last sub-batch), slots past their row,
    no prior or count escapes, m and U not multiples of 4, U = 16,384 (a
    64 KB row: the shared-memory opt-in), and no COO entry at all:
    kernel == plain, in three launches."""
    blob, sc, kw = expand_case(case)
    b, s = td._wire(blob), td._wire(sc)
    got = tmp.wire_expand4_blob(b.to(cuda), s.to(cuda), **kw)
    assert _native.expand_launches() <= 3
    for g, w in zip(got, tmp.wire_expand4_blob(b, s, **kw)):
        _equal(g.cpu(), w)


@pytest.mark.parametrize("K", [1, 7, 33, 128])
def test_compact_kernel_edge_cases_match_plain(cuda, K):
    """The compaction at K lanes: T not a multiple of the tile and under one
    tile, a silent lane, a lane that emits at every step, maxW at the
    bucket, at the largest count and below it: kernel == plain, in two
    launches."""
    rng = np.random.default_rng(K)
    for T in (tl._compact_rows(9000, K) * 3 + 17, 20):
        words, emits = (torch.from_numpy(a) for a in lane_planes(rng, T, K))
        top = max(int(emits.sum(0).max()), 1)
        for maxW in (tl._bucket(top), top, max(top // 3, 1)):
            got = tl.lane_compact(words.to(cuda), emits.to(cuda), maxW)
            assert _native.compact_launches() == 2
            _equal(got.cpu(), tl._lane_compact_plain(words, emits, maxW))


@pytest.mark.parametrize("G", [1, 3])
def test_lane_scan_on_lane_slices_matches_plain(cuda, G):
    """The masked scan reads a lane slice of wider [G, T, K] planes in place
    (row and chunk strides): kernel == plain, one launch for all chunks."""
    rng = np.random.default_rng(G)
    T, K = 512, 16
    bits = torch.from_numpy(rng.integers(0, 2, (G, T, K)).astype(np.int32)).to(cuda)
    probs = torch.from_numpy(rng.integers(1, 32768, (G, T, K)).astype(np.int32)).to(cuda)
    valid = (torch.arange(T * K, device=cuda) < T * K - 100).view(T, K).expand(G, T, K)
    valid = valid.contiguous()
    for cols in (slice(0, 8), slice(8, 16), slice(4, 7)):
        planes = [x[:, :, cols] for x in (bits, probs, valid)]
        _native.reset_launches()
        got = tl.lane_scan(*planes)
        assert _native.launches["lane_scan"] == 1
        for g, w in zip(got, tl._lane_scan_plain(*(x.cpu() for x in planes))):
            _equal(g.cpu(), w)


def test_compress_mesh_on_cuda(cuda, mesh_inputs):
    """compress_mesh on a 2 x 2 grid of cells on one card writes the
    single-device container (16 lanes) through the mesh kernels."""
    from avrecode_tpu_torch.parallel.mesh import make_mesh
    data, _, _ = mesh_inputs
    single, _ = td.compress(data, chunk_mode=1, force_lanes=16, device=cuda)
    _native.reset_launches()
    comp, _ = td.compress_mesh(data, make_mesh(2, 2, [cuda] * 4), chunk_mode=1,
                               force_lanes=16)
    for k in ("wire_expand", "model_pass_v4", "lane_scan", "sharded_v4_compress_step"):
        assert _native.launches[k] > 0, k
    assert comp == single
    dec, _ = pipeline.decompress(comp)
    assert dec == data


def _scan_inputs(rng, G, ns, sup, batch, ud, us, cap, n_dual=200, n_sig=300):
    """Random v3_core arguments (CPU tensors) of G chunks with their own
    tables; `cap` gives deltas of batch to 4 x batch a slot and sub-batch, so
    that the halving runs its whole bounded count."""
    U, m = ud + us, ns * sup * batch
    tot = rng.integers(batch, 4 * batch + 1, (G, ns * sup, U)) if cap else rng.integers(
        0, 20, (G, ns * sup, U))
    tot = np.where(rng.random(tot.shape) < 0.5, 0, tot)
    one = np.minimum((rng.random(tot.shape) * (tot + 1)).astype(np.int64), tot)

    def keys(n, width):
        return np.stack([np.stack([np.sort(rng.choice(n, width, replace=False))
                                   for _ in range(ns)]) for _ in range(G)])

    t = [torch.from_numpy(np.ascontiguousarray(a, np.int32)) for a in (
        rng.integers(0, 4, (G, m)), rng.integers(0, U, (G, m)), rng.integers(0, 65536, (G, m)),
        keys(n_dual + 1 + ud, ud), keys(n_sig + us, us))]
    deltas = torch.from_numpy(np.stack([one, tot], -1).astype(np.int16)).view(torch.uint16)
    dual0, si = (torch.from_numpy(a.astype(np.int32)) for a in (
        rng.integers(1, 30, (G, n_dual, 4)), rng.integers(0, n_sig + 3, (G, 7))))
    sv = torch.from_numpy(rng.integers(0, 40, (G, 7, 2)).astype(np.int16))  # u16 on the wire
    kw = dict(batch=batch, sup=sup, fast_w=48, slow_w=640, sig_w=80, sig_alpha=(24 << 16) | 12,
              ud=ud, us=us, n_sig=n_sig)
    return [*t, deltas, dual0], si, sv, kw


SCAN_CASES = {"chunk_axis_3": (3, 3, 9, 256, 300, 200, False),
              "ns_1": (1, 1, 16, 512, 400, 100, False),
              "halving_cap": (2, 3, 17, 64, 200, 120, True),
              "split_launches": (40, 1, 2, 64, 4096, 4096, False)}


@pytest.mark.parametrize("case", list(SCAN_CASES))
def test_scan_pass_matches_plain(cuda, case):
    """The persistent v3_core pass on a chunk axis with different tables per
    chunk, ns = 1, deltas that make the halving run its whole bounded count,
    and 40 chunks of 8192 slots (more than one launch holds): kernel ==
    plain, with 4 launches a call unless the chunks split the launch."""
    args, si, sv, kw = _scan_inputs(np.random.default_rng(len(case)), *SCAN_CASES[case])
    got = tmp.v3_core(args[0].to(cuda), *(a.to(cuda) for a in args), sig0_idx=si.to(cuda),
                      sig0_val=sv.to(cuda), **kw)
    torch.cuda.synchronize()
    launches = _native.pass_launches()
    assert launches > 4 if case == "split_launches" else launches == 4
    _equal(got.cpu(), tmp.v3_core(args[0], *args, sig0_idx=si, sig0_val=sv, **kw))


def test_model_pass_over_more_chunks_than_a_launch_holds(cuda):
    """model_pass over 20 chunks: more than one launch of chain clusters
    holds (resident / 2 chunks a launch), so the launch loop runs more than
    one trip; kernel == plain per chunk."""
    rng = np.random.default_rng(20)
    G, nb, batch = 20, 2, 512
    streams = [_stream(rng, nb, batch) for _ in range(G)]
    tables = [_tables(rng, g % 3 == 1) for g in range(G)]
    stacked = [torch.from_numpy(np.stack([s[i] for s in streams])) for i in range(4)] + [
        torch.from_numpy(np.stack([t[i] for t in tables])) for i in range(2)]
    got = tmp.model_pass(*(a.to(cuda) for a in stacked), batch=batch, **PASS_KW)
    torch.cuda.synchronize()
    assert _native.pass_launches() > 7
    _equal(got.cpu(), tmp.model_pass(*stacked, batch=batch, **PASS_KW))


def test_lane_outputs_have_jax_widths_on_the_card(cuda):
    """The scan kernels return JAX's widths (x_final u32 as int32, words u16
    as int16, emits bool, counts int32), the compaction takes them, and the
    pre-ANL5 mesh step on a 2 x 2 grid of the card returns the CPU grid's
    outputs at its widths: kernel == plain, dtype for dtype."""
    from avrecode_tpu_torch.parallel import pipeline as tpipe
    from avrecode_tpu_torch.parallel.mesh import make_mesh
    rng = np.random.default_rng(11)
    n, K = 20011, 16
    bits, probs = _random_biased_stream(rng, n)
    b, p = (torch.from_numpy(a.astype(np.int32)) for a in (bits, probs))
    T = tl._bucket(-(-n // K))
    got = tl.lane_scan_dev(b.to(cuda), p.to(cuda), n, T, K)
    assert [t.dtype for t in got] == [torch.int32, torch.int16, torch.bool, torch.int32]
    for g, w in zip(got, tl._lane_scan_dev_plain(b, p, n, T, K)):
        _equal(g.cpu(), w)
    planes = [x.view(T, K)[:, :8] for x in (b[:T * K // 2].repeat(2), p[:T * K // 2].repeat(2),
                                          torch.ones(T * K, dtype=torch.bool))]
    for g, w in zip(tl.lane_scan(*(x.to(cuda) for x in planes)), tl._lane_scan_plain(*planes)):
        _equal(g.cpu(), w)
    maxW = tl._bucket(int(got[3].max()))
    _equal(tl.lane_compact(got[1], got[2], maxW).cpu(),
           tl._lane_compact_plain(got[1].cpu(), got[2].cpu(), maxW))
    G, N = 4, 8192
    kinds = rng.integers(0, 3, (G, N)).astype(np.int32)
    inputs = [torch.from_numpy(a) for a in (
        rng.integers(0, 2, (G, N)).astype(np.int32), kinds,
        np.where(kinds == 2, rng.integers(0, 128, (G, N)),
                 rng.integers(0, 63, (G, N))).astype(np.int32),
        rng.integers(1, 32767, (G, N)).astype(np.int32),
        np.full((G, 64, 4), 3, np.int32), np.zeros((G, 128, 2), np.int32))]
    step = tpipe.sharded_recompress_step(make_mesh(2, 2, [cuda] * 4), batch=4096)(K_total=16)
    plain = tpipe.sharded_recompress_step(make_mesh(2, 2, ["cpu"] * 4), batch=4096)(
        K_total=16)
    out = step(*(x.to(cuda) for x in inputs))
    assert [t.dtype for t in out] == [torch.int16, torch.int32, torch.int16, torch.bool,
                                      torch.int32]
    for g, w in zip(out, plain(*inputs)):
        _equal(g.cpu(), w)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_concurrent_compress_calls_match_single_calls(cuda):
    """Two compress calls at once from two threads (each on its own compute
    and copy streams) write the containers of the same calls alone."""
    clips = [_read(BENCH), _read(CLIP)]
    alone = [td.compress(d, device=cuda)[0] for d in clips]
    got = [None, None]

    def run(i):
        got[i] = td.compress(clips[i], device=cuda)[0]

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert got == alone


def test_multigop_chunk_mode_1_three_runs_match_the_cpu_path(cuda):
    """multigop720.mp4 at chunk mode 1 (its 10 GOP chunks, 16 lanes), three
    runs on the card: each container equals the CPU path's (the plain
    versions), and the host decoder reads it back."""
    data = _read(CLIP)
    want, _ = td.compress(data, chunk_mode=1, force_lanes=16, device="cpu")
    for _ in range(3):
        assert td.compress(data, chunk_mode=1, force_lanes=16, device=cuda)[0] == want
    assert pipeline.decompress(want)[0] == data


def test_counts_readback_does_not_wait_for_the_next_scan(cuda):
    """On bench.mp4's three chunks, chunk i-1's counts copy (copy stream,
    after chunk i-1's scan event) ends before chunk i's lane scan ends, by
    the CUDA event times compress(info=...) reports."""
    info = {}
    td.compress(_read(BENCH), device=cuda, info=info)
    ready, scan = info["counts_ready_ms"], info["scan_end_ms"]
    assert len(scan) == info["n_chunks"] == 3
    for i in range(1, len(scan)):
        assert ready[i - 1] < scan[i], (i, ready, scan)


@pytest.fixture(scope="module")
def corpus_kernels(cuda):
    """One testcorpus.KernelCheck for the corpus cases: its plain versions
    run in worker processes on the host CPU."""
    def check(kernel, got, want, what):
        assert got.shape == want.shape and got.dtype == want.dtype, (kernel, what)
        assert torch.equal(got, want.to(got.device)), (kernel, what)

    with tc.KernelCheck(check, workers=max(1, (os.cpu_count() or 4) - 2)) as kc:
        yield kc


@pytest.mark.parametrize("name", tc.clip_names())
def test_corpus_clip_on_cuda(cuda, corpus_kernels, name):
    """One clip of the frozen test corpus in every mode of its manifest
    entry (testcorpus.check_clip on the card, the mesh on a 2x2 grid of it):
    per chunk probs == host model and blob == C++ encoder, the container's
    digest == the JAX package's (or the same error), exact roundtrip; and
    every kernel those modes launch == its plain version on each chunk's
    staged inputs. The 4:2:2 clips decode here only because decode_coeffs
    (native/h264_slice.h) is built without loop unswitching, which g++ 13.3
    gets wrong there; the rest of the host library is built with
    _native.HOST_CXXFLAGS, which turn no optimization off."""
    r = tc.check_clip(name, cuda, kernels=corpus_kernels)
    before = corpus_kernels.clips[name]
    corpus_kernels.flush()
    assert r["chunks"] > 0 and corpus_kernels.clips[name] > before, r


# The port's host engine under the shipped flags and two variations of
# them: every one must decode what it encodes on the card machine's g++.
HOST_FLAG_SETS = {"shipped": _native.HOST_CXXFLAGS,
                  "O2": ["-O2" if f == "-O3" else f for f in _native.HOST_CXXFLAGS],
                  "no_strict_aliasing": [*_native.HOST_CXXFLAGS, "-fno-strict-aliasing"]}
CLIPS_422 = ("c422.264", "c422.mp4", "mbaff422.mp4", "cav422.264", "cavmbaff422.264")


@pytest.fixture(scope="module")
def host_builds(cuda, tmp_path_factory):
    """The port's native/recode.cc built under each of HOST_FLAG_SETS, all
    at once, into a temporary directory."""
    out = tmp_path_factory.mktemp("host_builds")
    procs = {name: subprocess.Popen(
        ["g++", *flags, '-DARTC_BUILD_ID="nogit"', "-I", _native.NATIVE_DIR,
         "-o", str(out / f"libartc_{name}.so"), os.path.join(_native.NATIVE_DIR, "recode.cc")],
        stderr=subprocess.PIPE, text=True) for name, flags in HOST_FLAG_SETS.items()}
    for name, p in procs.items():
        err = p.communicate()[1]
        assert p.returncode == 0, (name, err[-2000:])
    return out


@pytest.mark.parametrize("flags", list(HOST_FLAG_SETS))
def test_host_engine_roundtrips_the_422_clips_under_each_flag_set(host_builds, flags,
                                                                  monkeypatch):
    """The corpus's five 4:2:2 clips, compressed by the host engine in each
    of tools/host_flags.MODES, decode exactly with the same build. Before
    decode_coeffs carried its attribute, the shipped flags failed 9 of
    these 15 (c422.264, c422.mp4, mbaff422.mp4: "mb address out of range")
    on g++ 13.3."""
    lib = ctypes.CDLL(str(host_builds / f"libartc_{flags}.so"))
    host._bind(lib)
    monkeypatch.setattr(host, "_lib", lib)
    failed = []
    for clip in CLIPS_422:
        data = tc.clip_bytes(clip)
        for kw in HOST_MODES:
            comp, _ = host.compress(data, **kw)
            try:
                out = host.decompress(comp)[0]
            except host.NativeError as e:
                out = str(e)
            if out != data:
                failed.append((clip, kw, out if isinstance(out, str) else "wrong bytes"))
    assert not failed
