"""The port's wire expand, dual0 expand and frozen-batch model pass
(avrecode_tpu_torch.ops.model_pass, plain versions on the CPU) against the
JAX package's functions on the same staged inputs, and against the host
model's probabilities. Every value is an integer: every comparison is exact.
"""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_jaxlib import ensure_jax_lib

from avrecode_tpu import device as jd
from avrecode_tpu.ops import model_pass as jmp
from avrecode_tpu_torch import _native
from avrecode_tpu_torch import device as td
from avrecode_tpu_torch.ops import intmath as im
from avrecode_tpu_torch.ops import model_pass as tmp
from avrecode_tpu_torch.testing import DUAL0_CASES, dual0_case

# Both host libraries, each built here under its own lock, before any test
# of any module can reach the JAX package's unlocked build (see
# test_torch_jaxlib.py).
_native.ensure_host_lib()
ensure_jax_lib()

# clip -> (sub-batch size, environment for the analysis). q51/q6 stress the
# pack widths, cavlc_b8 the CAVLC transport, pcm_mixed the kind-3 bins;
# multislice runs as warm-started sections (as in test_device_model.py's
# warm-section tests), which gives chunks a nonzero sparse sig0.
CLIPS = {
    "i_main.264": (1024, {}),
    "q51.mp4": (1024, {}),
    "q6.mp4": (1024, {}),
    "cavlc_b8.264": (512, {}),
    "pcm_mixed.mp4": (512, {}),
    "multislice.264": (256, {"ARTC_SECTION_BINS": "150000", "ARTC_SEED_BINS": "100000",
                             "ARTC_WARM_BINS": "120000"}),
}


@pytest.fixture(scope="module")
def analyses(corpus_dir):
    cache = {}

    def get(clip):
        if clip not in cache:
            batch, env = CLIPS[clip]
            with open(os.path.join(corpus_dir, clip), "rb") as f:
                data = f.read()
            with pytest.MonkeyPatch.context() as mp:
                for k, v in env.items():
                    mp.setenv(k, v)
                cache[clip] = jd.analyze(data, batch_size=batch, model_profile=2)
        return cache[clip]
    return get


def _expand_kw(an, c, layout):
    return dict(m=c.m, nsub=c.ns * an.sup, U=c.ud + c.us, ud=c.ud, us=c.us, ns=c.ns,
                batch=an.batch, layout=layout)


def _sig0(an, c):
    si, sv = jd._sig0_sparse_padded(c, an.n_sig)
    if si is None:
        return None, None, None, None
    return jnp.asarray(si), jnp.asarray(sv), td._wire(si), td._wire(sv)


@pytest.mark.parametrize("clip", list(CLIPS))
def test_blob_layout_and_build_blob4_match_jax(analyses, clip):
    an = analyses(clip)
    for c in an.chunks:
        layout = jd._chunk_layout(c)
        args = (layout, c.ns * an.sup, c.ns, c.ud, c.us)
        assert tmp._blob_layout_words(*args) == jmp._blob_layout_words(*args)
        jb, js = jd._build_blob4(an, c, layout)
        tb, ts = td._build_blob4(an, c, layout)
        assert jb.dtype == tb.dtype and np.array_equal(jb, tb)
        assert np.array_equal(js, ts)


@pytest.mark.parametrize("clip", list(CLIPS))
def test_wire_expand_matches_jax(analyses, clip):
    """All seven outputs of wire_expand4_blob equal JAX's on every chunk."""
    an = analyses(clip)
    widths = set()
    for c in an.chunks:
        layout = jd._chunk_layout(c)
        blob, sc = td._build_blob4(an, c, layout)
        kw = _expand_kw(an, c, layout)
        want = [np.asarray(x) for x in jmp.wire_expand4_blob(jnp.asarray(blob),
                                                             jnp.asarray(sc), **kw)]
        got = tmp.wire_expand4_blob(td._wire(blob), td._wire(sc), **kw)
        for name, w, g in zip(("bit", "kind", "slot", "prior", "deltas", "dk_d", "dk_s"),
                              want, got):
            g = g.numpy()
            if w.dtype == np.uint32:
                g = g.view(np.uint32)
            assert g.shape == w.shape, name
            assert np.array_equal(g, w.astype(g.dtype)), f"{clip} chunk {c.n}: {name}"
        widths.add((c.wa, c.wb, c.wcs))
    assert widths


@pytest.mark.parametrize("clip", list(CLIPS))
def test_dual0_expand_matches_jax(analyses, clip):
    """The plain version and the kernel's numpy mirror, on the dictionary
    at its wire widths (as staged), equal JAX's dual0_expand and the dense
    table on every chunk."""
    an = analyses(clip)
    for c in an.chunks:
        d0 = td._dual0_dict(c)
        assert [a.dtype for a in d0] == [np.uint16, np.uint8, np.uint32, np.uint16]
        want = np.asarray(jmp.dual0_expand(*(jnp.asarray(a) for a in d0)))
        got = tmp.dual0_expand(*(td._wire(a) for a in d0)).numpy()
        assert np.array_equal(got, want.astype(np.int32))
        assert np.array_equal(got, c.dual0.astype(np.int32))
        assert np.array_equal(tmp._dual0_expand_mirror(*d0), got)


@pytest.mark.parametrize("case", list(DUAL0_CASES))
def test_dual0_expand_synthetic_matches_jax(case):
    """On testing.py's dictionaries (no escapes, escapes at the first and
    last rows, blocks with only padding escapes, a short dictionary whose
    indices clamp, a block of escapes only, 70,000 escapes, bench.mp4's
    shape): plain == the kernel's mirror == JAX."""
    d0 = dual0_case(case)
    want = np.asarray(jmp.dual0_expand(*(jnp.asarray(a) for a in d0))).astype(np.int32)
    assert np.array_equal(tmp.dual0_expand(*(td._wire(a) for a in d0)).numpy(), want)
    assert np.array_equal(tmp._dual0_expand_mirror(*d0), want)


@pytest.mark.parametrize("fault", ["descending", "duplicate", "past_end"])
def test_dual0_escapes_out_of_order_raise(analyses, fault):
    """The kernel searches the escape list, so it needs the writer's order:
    live indices strictly ascending and below n_dual. A list that breaks it
    raises in the staging instead of being expanded (for the descending
    list the kernel's mirror shows that its search would not give JAX's
    table)."""
    an = analyses("i_main.264")
    c = an.chunks[0]
    n_dual = len(c.d0_idx)
    rng = np.random.default_rng(3)
    ei = np.sort(rng.choice(n_dual, 300, replace=False))  # past one search window
    if fault == "descending":
        ei = ei[::-1]
    elif fault == "duplicate":
        ei[1] = ei[0]
    else:
        ei[-1] = n_dual
    ev = rng.integers(0, 1 << 16, (len(ei), 4)).astype(np.uint16)
    bad = dataclasses.replace(c, d0_esc_idx=ei.astype(np.uint32), d0_esc_val=ev)
    with pytest.raises(ValueError, match="strictly ascending"):
        td._dual0_dict(bad)
    with pytest.raises(ValueError, match="strictly ascending"):
        td.to_torch_staged(an, bad, "cpu")
    if fault == "descending":
        rows, idx, _, _ = td._dual0_dict(c)
        pad = 512 - len(ei)
        d0 = (rows, idx, np.concatenate([ei, np.full(pad, n_dual)]).astype(np.uint32),
              np.concatenate([ev, np.zeros((pad, 4), np.uint16)]))
        want = np.asarray(jmp.dual0_expand(*(jnp.asarray(a) for a in d0)))
        assert not np.array_equal(tmp._dual0_expand_mirror(*d0), want.astype(np.int32))


def _v3_case(an, c):
    """JAX's model_pass_v4 probs of chunk c on the JAX expand's planes, and
    the port's arguments for the same call (torch CPU tensors, keywords)."""
    layout = jd._chunk_layout(c)
    blob, sc = td._build_blob4(an, c, layout)
    planes = jmp.wire_expand4_blob(jnp.asarray(blob), jnp.asarray(sc),
                                   **_expand_kw(an, c, layout))
    d0 = td._dual0_dict(c)
    j_si, j_sv, t_si, t_sv = _sig0(an, c)
    mkw = dict(batch=an.batch, sup=an.sup, fast_w=an.fast_w, slow_w=an.slow_w,
               sig_w=an.sig_w, sig_alpha=an.sig_alpha, ud=c.ud, us=c.us, n_sig=an.n_sig)
    want, _ = jmp.model_pass_v4(*planes[:4], *planes[5:], planes[4],
                                jmp.dual0_expand(*(jnp.asarray(a) for a in d0)),
                                sig0_idx=j_si, sig0_val=j_sv, **mkw)
    tp = [torch.from_numpy(np.asarray(x).astype(np.int32)) for x in planes[:4]]
    deltas = torch.from_numpy(np.asarray(planes[4]).copy())
    dk = [torch.from_numpy(np.asarray(x).view(np.int32).copy()) for x in planes[5:]]
    args = (*tp, *dk, deltas, tmp.dual0_expand(*(td._wire(a) for a in d0)))
    return np.asarray(want).astype(np.int32), args, dict(sig0_idx=t_si, sig0_val=t_sv, **mkw)


@pytest.mark.parametrize("clip", list(CLIPS))
def test_v3_core_matches_jax_and_host(analyses, clip, monkeypatch):
    """model_pass_v4 / v3_core on the JAX expand's planes: the port's probs
    equal JAX's and the host model's on every chunk, and every numerator and
    denominator of the probability math stays below 2^31 (so the kernel's
    int32 arithmetic equals the plain version's int64)."""
    an = analyses(clip)
    seen = []
    div_floor = im._div_floor

    def recording_div_floor(num, den):
        seen.append(max(int(num.max()), int(den.max())) if num.numel() else 0)
        return div_floor(num, den)

    monkeypatch.setattr(im, "_div_floor", recording_div_floor)
    if clip == "multislice.264":
        assert any(c.sig0_idx is not None and len(c.sig0_idx) for c in an.chunks[1:])
    for c in an.chunks:
        want, args, kw = _v3_case(an, c)
        got, bits = tmp.model_pass_v4(*args, **kw)
        assert bits is args[0]
        assert np.array_equal(got.numpy(), want)
        assert np.array_equal(got.numpy()[:c.n], c.host_probs.astype(np.int32))
    assert seen and max(seen) < 1 << 31


@pytest.mark.parametrize("clip", list(CLIPS))
def test_scan_mirror_matches_jax_v3_core(analyses, clip, monkeypatch):
    """The CUDA pass's formulation of v3_core (the numpy mirror of
    csrc/model_pass.cu scan_kernel: double-buffered staging, the early-exit
    halving, one gather a bin at its clamped flat index) equals JAX's
    model_pass_v4 on every chunk, taken through model_pass_v4's CPU route."""
    monkeypatch.setattr(tmp, "_v3_core_plain", tmp._v3_core_mirror)
    an = analyses(clip)
    for c in an.chunks:
        want, args, kw = _v3_case(an, c)
        got, _ = tmp.model_pass_v4(*args, **kw)
        assert np.array_equal(got.numpy(), want)


def test_halve_until_matches_jax_halve_while():
    """The kernels' halving (two closed-form steps, then an early exit)
    equals JAX's masked _halve_while on operands within and far over the
    windows, with the bound of _halve_iters and with smaller counts at which
    the cap binds (pairs are still over their window when JAX stops)."""
    rng = np.random.default_rng(17)
    pos = np.concatenate([rng.integers(0, 64, 2000), rng.integers(0, 1 << 20, 2000)])
    neg = np.concatenate([rng.integers(0, 64, 2000), rng.integers(0, 1 << 20, 2000)])
    capped = 0
    for window in (48, 80, 640):
        for iters in (0, 1, 2, 3, im._halve_iters(window, 4096), 16):
            jp, jn = (np.asarray(x) for x in jmp._halve_while(jnp.asarray(pos),
                                                              jnp.asarray(neg), window, iters))
            tp, tn = tmp._halve_until(pos, neg, window, iters)
            assert np.array_equal(tp, jp) and np.array_equal(tn, jn), (window, iters)
            capped += int((tp + tn > window).sum())
    assert capped > 0


def test_intmath_matches_jax():
    """The shared integer math: constants, the halving bound, the bounded
    halving and the dual-voice mix equal the JAX package's on random
    operands within the model's ranges."""
    assert (im.PROB_BITS, im.RES_DIR_ALPHA, im.RES_DIR_K) == (
        jmp.PROB_BITS, jmp.RES_DIR_ALPHA, jmp.RES_DIR_K)
    for window in (48, 128, 640):
        for batch in (1, 256, 1024, 4096):
            assert im._halve_iters(window, batch) == jmp._halve_iters(window, batch)
    rng = np.random.default_rng(11)
    pos = rng.integers(0, 640 + 4096, 4096)
    neg = rng.integers(0, 640 + 4096, 4096)
    it = im._halve_iters(640, 4096)
    jp, jn = jmp._halve_while(jnp.asarray(pos), jnp.asarray(neg), 640, it)
    tp, tn = im._halve_while(torch.from_numpy(pos), torch.from_numpy(neg), 640, it)
    assert np.array_equal(tp.numpy(), np.asarray(jp))
    assert np.array_equal(tn.numpy(), np.asarray(jn))
    ops = [rng.integers(1, w + 1, 20000) for w in (48, 48, 640, 640)]
    prior = rng.integers(0, 1 << 15, 20000)
    tag = rng.integers(0, 2, 20000)
    want = jmp._dual_prob(*(jnp.asarray(a.astype(np.int32)) for a in (*ops, prior, tag)))
    got = im._dual_prob(*(torch.from_numpy(a) for a in (*ops, prior, tag)))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
