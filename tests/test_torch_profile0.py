"""The port's profile-0 device path (avrecode_tpu_torch, plain versions on
the CPU) against the JAX package's on the same inputs and against the host
model's probabilities: model_pass_v2 (the default), model_pass_dict and
model_pass (sort, mm), the masked lane scan, encode_interleaved and
compress(model_profile=0). Every value is an integer: every comparison is
exact.
"""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_coder import _c_encode
from test_torch_jaxlib import ensure_jax_lib

from avrecode_tpu import device as jd
from avrecode_tpu import pipeline
from avrecode_tpu.ops import lanes as jl
from avrecode_tpu.ops import model_pass as jmp
from avrecode_tpu_torch import _native
from avrecode_tpu_torch import device as td
from avrecode_tpu_torch.ops import intmath as im
from avrecode_tpu_torch.ops import lanes as tl
from avrecode_tpu_torch.ops import model_pass as tmp
from avrecode_tpu_torch.testing import assert_same_array

# Both host libraries, each built here under its own lock, before any test
# of any module can reach the JAX package's unlocked build (see
# test_torch_jaxlib.py).
_native.ensure_host_lib()
ensure_jax_lib()

# v16 warm-started sections on a small clip, as test_device_model.py's
# warm profile-0 differential forces them.
WARM = {"ARTC_SECTION_BINS": "150000", "ARTC_SEED_BINS": "100000",
        "ARTC_WARM_BINS": "120000"}

# clip -> (batch size, environment). pcm_mixed carries kind-3 bins, q51/q6
# the extreme QPs, cavlc_b8 the CAVLC transport (all kind 0), multislice
# warm sections with a nonzero sig0.
CLIPS = {
    "i_main.264": (1024, {}),
    "pcm_mixed.mp4": (512, {}),
    "q51.mp4": (1024, {}),
    "q6.mp4": (1024, {}),
    "cavlc_b8.264": (512, {}),
    "multislice.264": (256, WARM),
}


def _read(corpus_dir, clip):
    with open(os.path.join(corpus_dir, clip), "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def analyses(corpus_dir):
    cache = {}

    def get(clip, batch=None):
        default_batch, env = CLIPS[clip]
        key = (clip, batch or default_batch)
        if key not in cache:
            with pytest.MonkeyPatch.context() as mp:
                for k, v in env.items():
                    mp.setenv(k, v)
                cache[key] = jd.analyze(_read(corpus_dir, clip), batch_size=key[1],
                                        model_profile=0)
            assert not cache[key].slim
        return cache[key]
    return get


def _recording_div_floor(monkeypatch):
    """Records max(numerator, denominator) of every plain division, so a test
    can assert the kernels' int32 arithmetic equals the plain int64."""
    seen = []
    div_floor = im._div_floor

    def recording(num, den):
        seen.append(max(int(num.max()), int(den.max())) if num.numel() else 0)
        return div_floor(num, den)

    monkeypatch.setattr(im, "_div_floor", recording)
    return seen


@pytest.mark.parametrize("clip", list(CLIPS))
def test_model_pass_v2_matches_jax_and_host(analyses, clip, monkeypatch):
    """run_chunk_v2_tables / model_pass_v2 on the native export's tables:
    probs equal JAX's and the host model's on every chunk."""
    an = analyses(clip)
    if clip == "multislice.264":
        assert len(an.chunks) > 1
        assert any(c.sig0_idx is not None and len(c.sig0_idx) for c in an.chunks[1:])
    seen = _recording_div_floor(monkeypatch)
    for c in an.chunks:
        sig0 = jd._sig0_dense(c, an.n_sig)
        args = (c.kind, c.prior, c.pre_ones, c.pre_tot, c.v2_m, c.v2_bin_u, c.v2_dk_d,
                c.v2_dk_s, c.v2_dd, c.v2_ds, c.dual0, an.batch, an.sup, an.fast_w,
                an.slow_w, an.sig_w, an.sig_alpha, an.n_sig)
        want = jmp.run_chunk_v2_tables(*args, sig0=sig0)
        got = tmp.run_chunk_v2_tables(*args, sig0=sig0, device="cpu")
        assert got.dtype == np.uint16 and np.array_equal(got, want), f"{clip} n={c.n}"
        assert np.array_equal(got, c.host_probs)
    assert seen and max(seen) < 1 << 31


@pytest.mark.parametrize("clip", list(CLIPS))
def test_scan_mirror_matches_jax_model_pass_v2(analyses, clip, monkeypatch):
    """The CUDA pass's formulation of model_pass_v2 (the numpy mirror of
    csrc/model_pass.cu scan_kernel, with the prefix adders) equals JAX's
    run_chunk_v2_tables on every chunk, taken through the port's CPU route."""
    monkeypatch.setattr(tmp, "_model_pass_v2_plain", tmp._model_pass_v2_mirror)
    an = analyses(clip)
    for c in an.chunks:
        sig0 = jd._sig0_dense(c, an.n_sig)
        args = (c.kind, c.prior, c.pre_ones, c.pre_tot, c.v2_m, c.v2_bin_u, c.v2_dk_d,
                c.v2_dk_s, c.v2_dd, c.v2_ds, c.dual0, an.batch, an.sup, an.fast_w,
                an.slow_w, an.sig_w, an.sig_alpha, an.n_sig)
        want = jmp.run_chunk_v2_tables(*args, sig0=sig0)
        got = tmp.run_chunk_v2_tables(*args, sig0=sig0, device="cpu")
        assert np.array_equal(got, want), f"{clip} n={c.n}"


def _run_chunk_args(an, c):
    return (c.bit, c.kind, c.key, c.prior, c.dual0, an.batch, an.fast_w, an.slow_w, an.sig_w,
            an.sig_alpha, an.n_sig)


@pytest.mark.parametrize("clip,batch", [("i_main.264", 1024), ("pcm_mixed.mp4", 512)])
def test_model_pass_dict_matches_jax_and_host(analyses, clip, batch, monkeypatch):
    """The dict pass (build_dicts + model_pass_dict): probs equal JAX's and
    the host model's on every chunk."""
    an = analyses(clip, batch)
    seen = _recording_div_floor(monkeypatch)
    for c in an.chunks:
        sig0 = jd._sig0_dense(c, an.n_sig)
        want = jmp.run_chunk(*_run_chunk_args(an, c), impl="dict", sig0=sig0)
        got = tmp.run_chunk(*_run_chunk_args(an, c), impl="dict", sig0=sig0, device="cpu")
        assert np.array_equal(got, want), f"{clip} n={c.n}"
        assert np.array_equal(got, c.host_probs)
    assert seen and max(seen) < 1 << 31


@pytest.mark.parametrize("impl", ["sort", "mm"])
@pytest.mark.parametrize("clip,batch", [("i_main.264", 512), ("pcm_mixed.mp4", 1024)])
def test_model_pass_sort_mm_matches_jax_and_host(analyses, clip, batch, impl, monkeypatch):
    """model_pass under both impl names: probs equal JAX's (the same impl)
    and the host model's on every chunk."""
    an = analyses(clip, batch)
    seen = _recording_div_floor(monkeypatch)
    for c in an.chunks:
        sig0 = jd._sig0_dense(c, an.n_sig)
        want = jmp.run_chunk(*_run_chunk_args(an, c), impl=impl, sig0=sig0)
        got = tmp.run_chunk(*_run_chunk_args(an, c), impl=impl, sig0=sig0, device="cpu")
        assert np.array_equal(got, want), f"{clip} n={c.n}"
        assert np.array_equal(got, c.host_probs)
    assert seen and max(seen) < 1 << 31


def test_model_pass_padding_matches_jax(analyses):
    """model_pass called directly on a padded stream (the run_chunk layout,
    two extra all-padding batches): every output, padding included, equals
    JAX's. The dual scratch row takes the padding bins' counts, so padded
    batches exercise its adds and halving."""
    an = analyses("i_main.264")
    c = an.chunks[0]
    batch = 1024
    n = len(c.bit)
    m = (-(-n // batch) + 2) * batch
    n_dual = c.dual0.shape[0]
    pad = m - n
    planes = [np.concatenate([a.astype(np.int32), np.full(pad, v, np.int32)])
              for a, v in ((c.bit, 0), (c.kind, 0), (c.key, n_dual), (c.prior, 0))]
    dual_ext = np.concatenate([c.dual0.astype(np.int32), np.ones((1, 4), np.int32)])
    sig = np.zeros((an.n_sig, 2), np.int32)
    kw = dict(batch=batch, fast_w=an.fast_w, slow_w=an.slow_w, sig_w=an.sig_w,
              sig_alpha=an.sig_alpha)
    want = np.asarray(jmp.model_pass(*(jnp.asarray(a) for a in (*planes, dual_ext, sig)),
                                     impl="sort", **kw))
    got = tmp.model_pass(*(torch.from_numpy(a) for a in (*planes, dual_ext, sig)),
                         impl="mm", **kw)
    assert np.array_equal(got.numpy(), want.astype(np.int32))


def test_prefix_counts_match_definition():
    """The plain within-batch prefix counts (stable sort + segmented sums)
    equal their definition, #{j < i : key_j == key_i [, bit_j == 1]}: the
    masked key-equality count the kernel computes."""
    rng = np.random.default_rng(3)
    key = rng.integers(0, 40, (5, 300))
    bit = rng.integers(0, 2, (5, 300))
    pre1, pret = tmp._prefix_counts_plain(torch.from_numpy(key), torch.from_numpy(bit))
    same = key[:, :, None] == key[:, None, :]
    earlier = np.tri(300, k=-1, dtype=bool)[None]
    assert np.array_equal(pret.numpy(), (same & earlier).sum(2))
    assert np.array_equal(pre1.numpy(), (same & earlier & (bit[:, None, :] == 1)).sum(2))


def _random_planes(rng, T, K, extremes: bool, prefix: bool):
    bits = rng.integers(0, 2, (T, K)).astype(np.int32)
    if extremes:  # p = 1 and 32767 (the clamp bounds), on both sides of every bin
        probs = np.where(rng.random((T, K)) < 0.5, 1, 32767).astype(np.int32)
    else:
        probs = rng.integers(1, 32768, (T, K)).astype(np.int32)
    if prefix:
        valid = (np.arange(T * K) < T * K - 7).reshape(T, K)
    else:  # lane-sliced and ragged, as the mesh slices it
        valid = rng.random((T, K)) < 0.8
        valid[:, ::3] = False
    return bits, probs, valid


@pytest.mark.parametrize("K,extremes,prefix", [(1, False, True), (16, True, False),
                                               (16, False, False), (64, True, True)])
def test_lane_scan_matches_jax(K, extremes, prefix):
    """lane_scan (masked) equals JAX's _lane_scan on random planes: final
    states, words and emissions, with masks that are and are not a prefix."""
    rng = np.random.default_rng(K * 10 + extremes)
    T = 512
    bits, probs, valid = _random_planes(rng, T, K, extremes, prefix)
    jx, jw, je = (np.asarray(a) for a in jl._lane_scan(
        jnp.asarray(bits.astype(np.uint32)), jnp.asarray(probs.astype(np.uint32)),
        jnp.asarray(valid)))
    x, w, e, counts = tl.lane_scan(*(torch.from_numpy(a) for a in (bits, probs, valid)))
    for name, got, want in (("x_final", x, jx), ("words", w, jw), ("emits", e, je),
                            ("counts", counts, je.sum(0, dtype=np.int32))):
        assert_same_array(got, want, name)
    assert not e.numpy()[~valid].any()


@pytest.mark.parametrize("lanes,n", [(1, 17), (16, 5000), (64, 20011)])
def test_encode_interleaved_matches_jax_and_c(lanes, n):
    """encode_interleaved from host arrays: byte-identical to the JAX
    package's and to the C++ encoder, including the probability extremes."""
    rng = np.random.default_rng(lanes + n)
    bits = rng.integers(0, 2, n).astype(np.uint8)
    probs = rng.integers(1, 32768, n).astype(np.uint16)
    probs[::5] = np.where(bits[::5] == 1, 32767, 1)
    blob = tl.encode_interleaved(bits, probs, lanes, device="cpu")
    assert blob == jl.encode_interleaved(bits, probs, lanes)
    assert blob == _c_encode(bits, probs, lanes)


@pytest.mark.parametrize("clip,impl", [
    ("i_main.264", "v2"), ("i_main.264", "dict"), ("i_main.264", "sort"),
    ("i_main.264", "mm"), ("pcm_mixed.mp4", "v2"), ("multislice.264", "v2")])
def test_compress_profile0_identical_to_jax(corpus_dir, monkeypatch, clip, impl):
    """compress(model_profile=0, device="cpu") writes the container
    avrecode_tpu.device.compress writes under the same ARTC_MODEL_IMPL; the
    host decoder returns the input; info holds every chunk's blob and probs."""
    batch, env = CLIPS[clip]
    for k, v in {**env, "ARTC_MODEL_IMPL": impl}.items():
        monkeypatch.setenv(k, v)
    data = _read(corpus_dir, clip)
    info = {}
    comp, st = td.compress(data, batch_size=batch, model_profile=0, device="cpu", info=info,
                           keep_probs=True)
    want, want_st = jd.compress(data, batch_size=batch, model_profile=0)
    assert comp == want
    assert st.n_chunks == want_st.n_chunks == info["n_chunks"] == len(info["blobs"])
    assert len(info["probs"]) == info["n_chunks"]
    dec, _ = pipeline.decompress(comp)
    assert dec == data


def test_profile0_rejects_unknown_impl_and_missing_tables(analyses):
    """An unknown ARTC_MODEL_IMPL raises, as in JAX; a chunk without the
    native v2 tables takes JAX's fallback: the tables built on the host
    (run_chunk_v2), with the same probs as JAX's device_probs."""
    an = analyses("i_main.264")
    c = an.chunks[0]
    with pytest.raises(ValueError, match="impl"):
        td.device_probs(an, c, "cpu", impl="nope")
    with pytest.raises(ValueError, match="impl"):
        tmp.model_pass(*(torch.zeros(8, dtype=torch.int32) for _ in range(4)),
                       torch.ones((2, 4), dtype=torch.int32),
                       torch.zeros((2, 2), dtype=torch.int32), batch=8, fast_w=1,
                       slow_w=1, sig_w=1, sig_alpha=1, impl="v2")
    bare = jd.ChunkAnalysis(c.bit, c.kind, c.key, c.prior, c.pre_ones, c.pre_tot,
                            c.host_probs, c.dual0)
    got = td.device_probs(an, bare, "cpu", impl="v2")
    assert got.dtype == np.uint16 and np.array_equal(got, c.host_probs)
    assert np.array_equal(got, jd.device_probs(an, bare, impl="v2"))


@pytest.mark.parametrize("sup", [1, 4])
def test_run_chunk_v2_matches_host_and_jax(analyses, sup):
    """The port's run_chunk_v2 (host-built tables, the counterpart of
    test_device_model.py's test_model_pass_v2_bit_exact_all_impls) equals
    the host model's probs and JAX's run_chunk_v2 at sup 1 and 4."""
    an = analyses("i_main.264")
    c = an.chunks[0]
    args = (c.bit, c.kind, c.key, c.prior, c.pre_ones, c.pre_tot, c.dual0, an.batch, sup,
            an.fast_w, an.slow_w, an.sig_w, an.sig_alpha, an.n_sig)
    got = tmp.run_chunk_v2(*args, device="cpu")
    assert got.dtype == np.uint16 and np.array_equal(got, c.host_probs)
    assert np.array_equal(got, jmp.run_chunk_v2(*args))


@pytest.mark.parametrize("clip", ["pcm_mixed.mp4", "multislice.264"])
def test_build_v2_inputs_matches_jax(analyses, clip):
    """build_v2_inputs (the port's copy) builds JAX's tables, field by field,
    on kind-3 bins (pcm_mixed) and warm sections; with them the fallback
    path of device_probs equals the host model on every chunk, a warm
    chunk's sig0 included."""
    an = analyses(clip)
    sup = tmp.default_sup()
    for c in an.chunks:
        span = sup * an.batch
        m = tmp._bucket(-(-len(c.bit) // span)) * span
        pad = m - len(c.bit)
        padded = [np.concatenate([a.astype(np.int32), np.full(pad, v, np.int32)])
                  for a, v in ((c.bit, 0), (c.kind, 3), (c.key, 0))]
        n_ext = c.dual0.shape[0] + 1
        got = tmp.build_v2_inputs(*padded, n_ext, an.n_sig, an.batch, sup)
        want = jmp.build_v2_inputs(*padded, n_ext, an.n_sig, an.batch, sup)
        for g, w in zip(got, want):
            assert np.array_equal(g, w) and np.asarray(g).dtype == np.asarray(w).dtype
        bare = dataclasses.replace(c, v2_bin_u=None, v2_dk_d=None, v2_dk_s=None, v2_dd=None,
                                   v2_ds=None)
        assert np.array_equal(td.device_probs(an, bare, "cpu", impl="v2"), c.host_probs)
