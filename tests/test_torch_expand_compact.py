"""The wire expand (row 1 of PERF.md's kernel table) and the lane compaction
(row 5) as csrc/wire_expand.cu and csrc/lanes.cu decompose them: their numpy
mirrors (`ops/model_pass._expand_mirror`, `ops/lanes._compact_mirror`) and
the plain versions against the JAX package's `wire_expand4_blob` and
`_lane_compact`, on the corpus clips in both expand modes, over a chunk
axis, on synthetic blobs whose COO runs end before the live entries do or
whose slots lie past their row, and on lane planes with ragged tiles,
silent lanes and a maxW below a lane's count. Every value is an integer:
every comparison is exact."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_jaxlib import ensure_jax_lib

from avrecode_tpu import device as jd
from avrecode_tpu.ops import lanes as jl
from avrecode_tpu.ops import model_pass as jmp
from avrecode_tpu_torch import _native
from avrecode_tpu_torch import device as td
from avrecode_tpu_torch.ops import lanes as tl
from avrecode_tpu_torch.ops import model_pass as tmp
from avrecode_tpu_torch.testing import (EXPAND_CASES, assert_same_array, empty_coo_blob,
                                        lane_planes, synthetic_blob)

# Both host libraries, each built here under its own lock, before any test
# of any module can reach the JAX package's unlocked build (see
# test_torch_jaxlib.py).
_native.ensure_host_lib()
ensure_jax_lib()

# clip -> sub-batch size (test_torch_model_pass.py's clips that need no
# environment: the pack widths, the CAVLC transport, kind-3 bins).
CLIPS = {"i_main.264": 1024, "q51.mp4": 1024, "q6.mp4": 1024, "cavlc_b8.264": 512,
         "pcm_mixed.mp4": 512}
NAMES = ("bit", "kind", "slot", "prior", "deltas")


def _read(corpus_dir, clip):
    with open(os.path.join(corpus_dir, clip), "rb") as f:
        return f.read()


def _jax(blob_u32, sc, **kw):
    """JAX's five expand outputs as int64 (deltas as u32 [nsub, U])."""
    out = jmp.wire_expand4_blob(jnp.asarray(blob_u32), jnp.asarray(sc), **kw)
    planes = [np.asarray(x).astype(np.int64) for x in out[:4]]
    d = np.asarray(out[4]).astype(np.int64)
    return (*planes, d[..., 0] | (d[..., 1] << 16))


def _plain(blob_u32, sc, **kw):
    out = tmp.wire_expand4_blob(td._wire(blob_u32), td._wire(sc), **kw)
    planes = [x.numpy().astype(np.int64) for x in out[:4]]
    return (*planes, out[4].view(torch.int32).numpy().view(np.uint32).astype(np.int64)
            .reshape(out[4].shape[:-1]))


def _mirror(blob_u32, sc, **kw):
    kw = dict(kw)
    args = [kw.pop(k) for k in ("m", "nsub", "U", "ud", "us", "ns", "batch", "layout")]
    return tmp._expand_mirror(blob_u32, sc, *args, **kw)


def _assert_equal(got, want, what):
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape, f"{what}: {name} shape {g.shape} vs {w.shape}"
        assert np.array_equal(g, w), f"{what}: {name}"


@pytest.mark.parametrize("clip", list(CLIPS))
def test_expand_mirror_and_plain_match_jax(corpus_dir, clip):
    """Every chunk of the clip (mesh=False): the mirror of the three
    launches and the plain version equal JAX's expand."""
    an = jd.analyze(_read(corpus_dir, clip), batch_size=CLIPS[clip], model_profile=2)
    for c in an.chunks:
        layout = jd._chunk_layout(c)
        blob, sc = td._build_blob4(an, c, layout)
        kw = dict(m=c.m, nsub=c.ns * an.sup, U=c.ud + c.us, ud=c.ud, us=c.us, ns=c.ns,
                  batch=an.batch, layout=layout)
        want = _jax(blob, sc, **kw)
        _assert_equal(_plain(blob, sc, **kw), want, f"{clip} plain, chunk n={c.n}")
        got = _mirror(blob[None], sc[None], **kw)
        _assert_equal([x[0] for x in got], want, f"{clip} mirror, chunk n={c.n}")


@pytest.mark.parametrize("clip", ["ipb_high.mp4", "i_main.264"])
def test_expand_mesh_mode_over_the_chunk_axis(corpus_dir, clip):
    """mesh=True on the mesh's packing (pad chunks with 0-bit widths
    included): the mirror over the whole chunk axis and the plain version
    over it equal JAX's expand of each chunk, and a G = 3 chunk axis equals
    a loop over its chunks."""
    an = jd.analyze(_read(corpus_dir, clip), chunk_mode=1, batch_size=512, model_profile=2,
                    sup=4, want_probs=False)
    inp = td.mesh_inputs(an, an.chunks, 4, sup=4, force_lanes=4)
    st = inp.statics
    UD, US, NS = st["ud"], st["us"], st["ns"]
    kw = dict(m=NS * 4 * an.batch, nsub=NS * 4, U=UD + US, ud=UD, us=US, ns=NS,
              batch=an.batch, layout=st["layout"], mesh=True)
    blob = inp.blob.numpy().view(np.uint32)
    sc = inp.sc.numpy()
    assert blob.shape[0] > len(an.chunks) and (sc[len(an.chunks):, :3] == 0).all()
    mirror = _mirror(blob, sc, **kw)
    plain = _plain(blob, sc, **kw)
    for g in range(blob.shape[0]):
        want = _jax(blob[g], sc[g], **kw)
        _assert_equal([x[g] for x in mirror], want, f"{clip} mirror, chunk {g}")
        _assert_equal([x[g] for x in plain], want, f"{clip} plain, chunk {g}")
    three = _mirror(blob[:3], sc[:3], **kw)
    for g in range(3):
        _assert_equal([x[g] for x in three], [x[0] for x in _mirror(blob[g:g + 1],
                                                                    sc[g:g + 1], **kw)],
                      f"{clip} G = 3 chunk axis vs chunk {g} alone")


@pytest.mark.parametrize("case", list(EXPAND_CASES))
def test_expand_synthetic_blob_matches_jax(case):
    """The latent coo_sub divergence, pinned: with n_coo larger than the sum
    of coo_cnt the live entries past the runs land in the last sub-batch in
    JAX, the plain version and the mirror alike. Also an entry whose slot
    lies past its row (it lands in the next row: the kernel's fix-up
    pass), no prior or count escapes, m and U not multiples of 4, and U =
    16,384 (the card cases of tests/test_torch_cuda.py on the same blobs)."""
    kw = EXPAND_CASES[case]
    blob, sc, ekw, (coo, nib, escaped) = synthetic_blob(7, **kw)
    offs = tmp._blob_layout_words(ekw["layout"], ekw["nsub"], ekw["ns"], ekw["ud"], ekw["us"])
    runs = int(blob[offs[8]:offs[9]].view(np.uint16)[:ekw["nsub"]].sum())
    assert sc[4] == runs + kw.get("past_runs", 0)
    assert (coo >= ekw["U"]).any() == bool(kw.get("past_row"))
    want = _jax(blob, sc, **ekw)
    _assert_equal(_plain(blob, sc, **ekw), want, f"{case}: plain")
    _assert_equal([x[0] for x in _mirror(blob[None], sc[None], **ekw)], want,
                  f"{case}: mirror")
    tail = [j for j in range(runs, sc[4]) if not escaped[j]]
    assert len(tail) >= kw.get("past_runs", 0) - 1  # one of them may be escaped
    for j in tail:  # the entries past the runs sit in the last sub-batch's row
        assert want[4][-1, coo[j]] == (nib[j] & 15) | ((nib[j] >> 4) << 16)


def test_expand_empty_coo_stream_plain_equals_mirror():
    """nc = 0 (no COO entry at all; JAX's gather has nothing to read there):
    the plain version and the mirror agree, every live bin's slot reading
    the empty stream's 0, and the delta rows stay zero."""
    empty, sc, kw = empty_coo_blob(3)
    plain = _plain(empty, sc, **kw)
    _assert_equal([x[0] for x in _mirror(empty[None], sc[None], **kw)], plain, "nc = 0")
    assert not plain[4].any()


@pytest.mark.parametrize("K", [1, 7, 33, 128])
def test_compact_mirror_and_plain_match_jax(K):
    """The compaction at K lanes, T not a multiple of the tile (and under
    one tile), maxW at the bucket, at the largest count and below it (the
    overflow drops): the mirror of the two launches and the plain version
    equal JAX's _lane_compact."""
    rng = np.random.default_rng(K)
    for T in (tl._compact_rows(9000, K) * 3 + 17, 20):
        words, emits = lane_planes(rng, T, K)
        top = max(int(emits.sum(0).max()), 1)
        for maxW in (tl._bucket(top), top, max(top // 3, 1)):
            want = jl._lane_compact(jnp.asarray(words.view(np.uint16)), jnp.asarray(emits),
                                    maxW)
            plain = tl.lane_compact(torch.from_numpy(words), torch.from_numpy(emits), maxW)
            assert plain.dtype == torch.int16
            assert_same_array(plain, want, f"plain, T={T} maxW={maxW}")
            mirror = tl._compact_mirror(words, emits, maxW)
            assert_same_array(mirror, want, f"mirror, T={T} maxW={maxW}")
