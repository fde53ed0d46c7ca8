"""The port's lane scans, compaction input, mesh steps and mesh inputs at the
JAX package's widths, on the CPU (the plain versions).

Every output is held against the JAX function's on the same seeded inputs
with avrecode_tpu_torch.testing.assert_same_array: the same shape, itemsize
and nbytes, and the same bytes (a u32 as int32 bit patterns, a u16 as int16
bit patterns, a bool as a bool). Nothing is converted before the
comparison, so a wider type fails here even where its values agree.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_jaxlib import ensure_jax_lib

from avrecode_tpu import device as jd
from avrecode_tpu.ops import lanes as jl
from avrecode_tpu.parallel import mesh as jmesh
from avrecode_tpu.parallel import pipeline as jpipe
from avrecode_tpu_torch import _native
from avrecode_tpu_torch import device as td
from avrecode_tpu_torch.ops import lanes as tl
from avrecode_tpu_torch.parallel import mesh as tmesh
from avrecode_tpu_torch.parallel import pipeline as tpipe
from avrecode_tpu_torch.testing import assert_same_array

# Both host libraries, each built here under its own lock, before any test
# of any module can reach the JAX package's unlocked build (see
# test_torch_jaxlib.py).
_native.ensure_host_lib()
ensure_jax_lib()

SCAN_OUT = ("x_final", "words", "emits", "counts")
STEP_OUT = ("x_final", "words", "emits", "probs", "total_words")
RECOMPRESS_OUT = ("probs", "x_final", "words", "emits", "total_words")
MESH_IN = ("blob", "sc", "dual0", "sig0_idx", "sig0_val", "n_arr")


def _planes(seed: int, lead: tuple, T: int, K: int):
    """Seeded int32 bits / probs (the extremes mixed in) and a ragged valid
    mask, [*lead, T, K]."""
    rng = np.random.default_rng(seed)
    shape = (*lead, T, K)
    bits = rng.integers(0, 2, shape).astype(np.int32)
    probs = rng.integers(1, 32768, shape).astype(np.int32)
    probs = np.where(rng.random(shape) < 0.2, rng.choice([1, 32767], shape), probs)
    valid = rng.random(shape) < 0.8
    return bits, probs.astype(np.int32), valid


@pytest.mark.parametrize("K,n", [(16, 3001), (64, 20011)])
def test_lane_scan_dev_has_jax_widths(K, n):
    """lane_scan_dev: x_final u32, words u16, emits bool, counts int32."""
    rng = np.random.default_rng(n)
    bits = rng.integers(0, 2, n).astype(np.int32)
    probs = rng.integers(0, 32768, n).astype(np.int32)  # 0 is floored to 1, as in JAX
    T = tl._bucket(-(-n // K))
    got = tl.lane_scan_dev(torch.from_numpy(bits), torch.from_numpy(probs), n, T, K)
    want = jl._lane_scan_dev(jnp.pad(jnp.asarray(bits), (0, T * K - n)),
                             jnp.pad(jnp.asarray(probs), (0, T * K - n)), n, T=T, K=K)
    for name, g, w in zip(SCAN_OUT, got, want):
        assert_same_array(g, w, name)


@pytest.mark.parametrize("layout", ["single", "chunk_axis", "lane_slice"])
def test_lane_scan_has_jax_widths(layout):
    """lane_scan on one chunk's [T, K] planes, over a chunk axis [G, T, K]
    (JAX's vmap) and on a lane slice of wider planes read in place (the
    mesh's cells): x_final, words and emits at JAX's _lane_scan widths, and
    counts as JAX's _lane_scan_dev sums them (int32)."""
    T, K = 128, 16
    lead = (3,) if layout == "chunk_axis" else ()
    wide = 2 * K if layout == "lane_slice" else K
    bits, probs, valid = _planes(7, lead, T, wide)
    planes = [torch.from_numpy(a) for a in (bits, probs, valid)]
    if layout == "lane_slice":
        planes = [p[:, K:] for p in planes]
        assert not planes[0].is_contiguous()
    x, w, e, counts = tl.lane_scan(*planes)
    sl = [p.numpy() for p in planes]
    scan = jax.vmap(jl._lane_scan) if lead else jl._lane_scan
    jx, jw, je = scan(*(jnp.asarray(np.ascontiguousarray(a)) for a in sl))
    for name, g, want in zip(SCAN_OUT, (x, w, e, counts),
                             (jx, jw, je, np.asarray(je).sum(-2, dtype=np.int32))):
        assert_same_array(g, want, f"{layout}: {name}")


def test_compaction_takes_the_scans_widths():
    """The compaction's inputs are the scan's words (u16) and emits (bool),
    byte for byte JAX's, and its output from them equals JAX's
    _lane_compact on JAX's scan outputs."""
    n, K = 5000, 16
    T = tl._bucket(-(-n // K))
    bits, probs, _ = _planes(11, (), 1, n)
    b, p = (torch.from_numpy(a.reshape(-1)) for a in (bits, probs))
    _, words, emits, counts = tl.lane_scan_dev(b, p, n, T, K)
    _, jw, je, _ = jl._lane_scan_dev(jnp.pad(jnp.asarray(b.numpy()), (0, T * K - n)),
                                      jnp.pad(jnp.asarray(p.numpy()), (0, T * K - n)),
                                      n, T=T, K=K)
    assert_same_array(words, jw, "words")
    assert_same_array(emits, je, "emits")
    maxW = tl._bucket(int(counts.max()))
    assert_same_array(tl.lane_compact(words, emits, maxW), jl._lane_compact(jw, je, maxW),
                      "compacted")


def _read(corpus_dir, clip):
    with open(os.path.join(corpus_dir, clip), "rb") as f:
        return f.read()


def _jax_mesh(n_gop, n_lane):
    if len(jax.devices()) < n_gop * n_lane:
        pytest.skip("needs the 8-device CPU mesh")
    return jmesh.make_mesh(n_gop=n_gop, n_lane=n_lane)


@pytest.fixture(scope="module")
def v4_steps(corpus_dir):
    """Both sharded_v4_compress_step outputs on a 2 x 2 grid (the port's on
    CPU devices, JAX's on the CPU mesh) for i_main.264's chunks (two dual
    widths, a pad chunk)."""
    jm = _jax_mesh(2, 2)
    an = jd.analyze(_read(corpus_dir, "i_main.264"), chunk_mode=1, batch_size=512,
                    model_profile=2, sup=4, want_probs=False)
    inp = td.mesh_inputs(an, an.chunks, 2, sup=4, force_lanes=4)
    got = tpipe.sharded_v4_compress_step(tmesh.make_mesh(2, 2, ["cpu"] * 4),
                                         **inp.statics)(*inp.tensors())
    jin = (inp.blob.numpy().view(np.uint32), inp.sc.numpy(), inp.dual0.numpy().view(np.uint16),
           inp.sig0_idx.numpy().view(np.uint32), inp.sig0_val.numpy().view(np.uint16),
           inp.n_arr.numpy())
    want = jpipe.sharded_v4_compress_step(jm, **inp.statics)(*(jnp.asarray(a) for a in jin))
    return got, want


@pytest.mark.parametrize("i", range(len(STEP_OUT)), ids=STEP_OUT)
def test_sharded_v4_step_has_jax_widths(v4_steps, i):
    got, want = v4_steps
    assert_same_array(got[i], want[i], STEP_OUT[i])


@pytest.fixture(scope="module")
def recompress_steps():
    """Both sharded_recompress_step outputs on a 2 x 2 grid, seeded inputs
    (test_parallel.py's shapes)."""
    jm = _jax_mesh(2, 2)
    G, N, n_dual, n_sig = 4, 512, 64, 128
    rng = np.random.default_rng(3)
    kinds = rng.integers(0, 3, (G, N)).astype(np.int32)
    inputs = (rng.integers(0, 2, (G, N)).astype(np.int32), kinds,
              np.where(kinds == 2, rng.integers(0, n_sig, (G, N)),
                       rng.integers(0, n_dual - 1, (G, N))).astype(np.int32),
              rng.integers(1, 32767, (G, N)).astype(np.int32),
              np.full((G, n_dual, 4), 3, np.int32), np.zeros((G, n_sig, 2), np.int32))
    got = tpipe.sharded_recompress_step(tmesh.make_mesh(2, 2, ["cpu"] * 4), batch=256)(
        K_total=8)(*(torch.from_numpy(a) for a in inputs))
    want = jpipe.sharded_recompress_step(jm, batch=256)(K_total=8)(
        *(jnp.asarray(a) for a in inputs))
    return got, want


@pytest.mark.parametrize("i", range(len(RECOMPRESS_OUT)), ids=RECOMPRESS_OUT)
def test_sharded_recompress_step_has_jax_widths(recompress_steps, i):
    got, want = recompress_steps
    assert_same_array(got[i], want[i], RECOMPRESS_OUT[i])


def test_mesh_inputs_have_jax_widths(corpus_dir, monkeypatch):
    """What each compress_mesh hands its step: the port's mesh_inputs
    tensors equal the arrays JAX's compress_mesh ships (dual0 u16 among
    them), captured at the step's call in both packages."""
    class Captured(Exception):
        pass

    def capture(pkg):
        def build(mesh, **statics):
            def step(*arrays):
                raise Captured(arrays)
            return step
        monkeypatch.setattr(pkg, "sharded_v4_compress_step", build)

    data = _read(corpus_dir, "i_main.264")
    kw = dict(chunk_mode=1, batch_size=512, sup=4, force_lanes=4)
    capture(jpipe)
    with pytest.raises(Captured) as jax_in:
        jd.compress_mesh(data, _jax_mesh(2, 1), **kw)
    capture(tpipe)
    with pytest.raises(Captured) as port_in:
        td.compress_mesh(data, tmesh.make_mesh(2, 1, ["cpu"] * 2), **kw)
    for name, g, w in zip(MESH_IN, port_in.value.args[0], jax_in.value.args[0]):
        assert_same_array(g, w, name)
