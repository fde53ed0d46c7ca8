"""The port's mesh path (avrecode_tpu_torch.parallel, device.compress_mesh;
plain versions on a grid of CPU devices) against the JAX package's on the
conftest 8-device CPU mesh: the mesh-mode wire expand, the chunk axis of the
frozen-batch pass, the lane-sliced masked scan, both mesh steps and the
mesh container. Every value is an integer: every comparison is exact."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_jaxlib import ensure_jax_lib

from avrecode_tpu import device as jd
from avrecode_tpu import pipeline
from avrecode_tpu.ops import lanes as jlx
from avrecode_tpu.ops import model_pass as jmp
from avrecode_tpu.parallel import mesh as jmesh
from avrecode_tpu.parallel import pipeline as jpipe
from avrecode_tpu_torch import _native
from avrecode_tpu_torch import device as td
from avrecode_tpu_torch.ops import lanes as tl
from avrecode_tpu_torch.ops import model_pass as tmp
from avrecode_tpu_torch.parallel import mesh as tmesh
from avrecode_tpu_torch.parallel import pipeline as tpipe
from avrecode_tpu_torch.testing import assert_same_array

# Both host libraries, each built here under its own lock, before any test
# of any module can reach the JAX package's unlocked build (see
# test_torch_jaxlib.py).
_native.ensure_host_lib()
ensure_jax_lib()

# test_parallel.py's mesh parameters: chunk_mode 1, batch 512, sup 4, 4 lanes.
MESH_KW = dict(chunk_mode=1, batch_size=512, sup=4, force_lanes=4)


def _read(corpus_dir, clip):
    with open(os.path.join(corpus_dir, clip), "rb") as f:
        return f.read()


def _jax_mesh(n_gop, n_lane):
    if len(jax.devices()) < n_gop * n_lane:
        pytest.skip("needs the 8-device CPU mesh")
    return jmesh.make_mesh(n_gop=n_gop, n_lane=n_lane)


def _mesh_inputs(corpus_dir, clip, n_gop):
    an = jd.analyze(_read(corpus_dir, clip), chunk_mode=1, batch_size=512, model_profile=2,
                    sup=4, want_probs=False)
    return an, td.mesh_inputs(an, an.chunks, n_gop, sup=4, force_lanes=4)


def _np(t):
    return np.asarray(t).astype(np.int64)


@pytest.mark.parametrize("clip", ["ipb_high.mp4", "i_main.264"])
def test_mesh_inputs_match_jax_packing(corpus_dir, clip):
    """mesh_inputs packs every chunk as avrecode_tpu.device.compress_mesh
    does: the mesh-uniform layout, scratch-padded key tables, the 6-entry
    scalar vector, and pad chunks with live, distinct scratch keys."""
    an, inp = _mesh_inputs(corpus_dir, clip, n_gop=4)
    st = inp.statics
    UD, US, NS, layout = st["ud"], st["us"], st["ns"], st["layout"]
    assert layout == tuple(max(col) for col in zip(*(jd._chunk_layout(c) for c in an.chunks)))
    blob = inp.blob.numpy().view(np.uint32)
    assert blob.shape[0] % 4 == 0 and blob.shape[0] >= len(an.chunks)
    dk_d0 = an.n_dual + 1 + np.arange(UD, dtype=np.uint32)
    dk_s0 = an.n_sig + np.arange(US, dtype=np.uint32)
    for g, c in enumerate(an.chunks):
        dk_d = np.tile(dk_d0, (NS, 1))
        dk_s = np.tile(dk_s0, (NS, 1))
        dk_d[:c.ns, :c.ud] = c.dk_d
        dk_s[:c.ns, :c.us] = c.dk_s
        want, sc = jd._build_blob4(an, c, layout, dk_d=dk_d, dk_s=dk_s, ud_mesh=UD)
        assert np.array_equal(blob[g], want)
        assert np.array_equal(inp.sc[g].numpy(), sc)
        assert_same_array(inp.dual0[g], c.dual0, f"dual0 of chunk {g}")
        assert int(inp.n_arr[g]) == c.n
    offs = tmp._blob_layout_words(layout, NS * 4, NS, UD, US)
    for g in range(len(an.chunks), blob.shape[0]):  # pad chunks
        dk = blob[g, offs[12]:offs[13]].reshape(NS, UD)
        assert all(len(set(row)) == UD for row in dk.tolist())
        assert int(inp.sc[g, 5]) == UD and int(inp.n_arr[g]) == 0


@pytest.mark.parametrize("clip", ["ipb_high.mp4", "i_main.264"])
def test_wire_expand_mesh_matches_jax(corpus_dir, clip):
    """wire_expand4_blob(mesh=True), plain version, equals JAX's mesh=True
    expand in all seven outputs on every chunk (pad chunks too) under the
    mesh-uniform layout, one chunk at a time and over the chunk axis.
    i_main.264's chunks differ in dual width, so their sig slots shift."""
    an, inp = _mesh_inputs(corpus_dir, clip, n_gop=4)
    st = inp.statics
    UD, US, NS = st["ud"], st["us"], st["ns"]
    kw = dict(m=NS * 4 * an.batch, nsub=NS * 4, U=UD + US, ud=UD, us=US, ns=NS,
              batch=an.batch, layout=st["layout"], mesh=True)
    if clip == "i_main.264":
        assert any(c.ud < UD for c in an.chunks)
    batched = tmp.wire_expand4_blob(inp.blob, inp.sc, **kw)
    for g in range(inp.blob.shape[0]):
        blob, sc = inp.blob[g], inp.sc[g]
        want = jmp.wire_expand4_blob(jnp.asarray(blob.numpy().view(np.uint32)),
                                     jnp.asarray(sc.numpy()), **kw)
        got = tmp.wire_expand4_blob(blob, sc, **kw)
        names = ("bit", "kind", "slot", "prior", "deltas", "dk_d", "dk_s")
        for name, w, one, many in zip(names, want, got, batched):
            w = np.asarray(w)
            assert one.shape == w.shape, name
            assert np.array_equal(_np(one.numpy().view(w.dtype) if name.startswith("dk")
                                      else one.numpy()), _np(w)), f"{clip} chunk {g}: {name}"
            assert torch.equal(many[g], one), f"{clip} chunk {g}: {name} over the chunk axis"


def _expanded(inp, an):
    st = inp.statics
    UD, US, NS = st["ud"], st["us"], st["ns"]
    return tmp.wire_expand4_blob(
        inp.blob, inp.sc, m=NS * 4 * an.batch, nsub=NS * 4, U=UD + US, ud=UD, us=US, ns=NS,
        batch=an.batch, layout=st["layout"], mesh=True)


def test_chunk_batched_model_pass_matches_single_and_jax_vmap(corpus_dir):
    """v3_core over a leading chunk axis (the mesh's vmap written out)
    equals one call per chunk and JAX's vmap of v3_core on the same planes;
    the live bins equal the host model's probs."""
    an, inp = _mesh_inputs(corpus_dir, "i_main.264", n_gop=4)
    st = inp.statics
    bit, kind, slot, prior, deltas, dk_d, dk_s = _expanded(inp, an)
    mkw = dict(batch=an.batch, sup=4, fast_w=an.fast_w, slow_w=an.slow_w, sig_w=an.sig_w,
               sig_alpha=an.sig_alpha, ud=st["ud"], us=st["us"], n_sig=an.n_sig)
    dual0 = inp.dual0.to(torch.int32) & 0xFFFF  # the u16 input widened, as the mesh cell does
    got = tmp.v3_core(bit, kind, slot, prior, dk_d, dk_s, deltas, dual0,
                      sig0_idx=inp.sig0_idx, sig0_val=inp.sig0_val, **mkw)
    for g in range(bit.shape[0]):
        one = tmp.v3_core(bit[g], kind[g], slot[g], prior[g], dk_d[g], dk_s[g], deltas[g],
                          dual0[g], sig0_idx=inp.sig0_idx[g], sig0_val=inp.sig0_val[g],
                          **mkw)
        assert torch.equal(got[g], one), f"chunk {g}"
    j = [jnp.asarray(a) for a in (
        bit.numpy(), kind.numpy(), slot.numpy(), prior.numpy(),
        dk_d.numpy().view(np.uint32), dk_s.numpy().view(np.uint32), deltas.numpy(),
        inp.dual0.numpy().view(np.uint16), inp.sig0_idx.numpy().view(np.uint32),
        inp.sig0_val.numpy().view(np.uint16))]
    want = jax.vmap(lambda b, k, s, p, dd, ds, de, d0, si, sv: jmp.v3_core(
        b, k, s, p, dd, ds, de, d0, sig0_idx=si, sig0_val=sv, **mkw))(*j)
    assert np.array_equal(_np(got.numpy()), _np(want))
    an_p = jd.analyze(_read(corpus_dir, "i_main.264"), chunk_mode=1, batch_size=512,
                      model_profile=2, sup=4)
    for g, c in enumerate(an_p.chunks):
        assert np.array_equal(got[g, :c.n].numpy(), c.host_probs.astype(np.int32))


@pytest.mark.parametrize("lead", [(), (3,)])
def test_lane_scan_on_lane_slices_matches_jax(lead):
    """The masked lane_scan on a lane slice [.., l*k:(l+1)*k] of wider
    [T, K_total] planes (a strided view, with or without a chunk axis),
    probabilities floored at 1 and validity iota(M) < n as the mesh step
    builds them, equals JAX's _lane_scan on the same slice, and equals the
    scan of a contiguous copy."""
    rng = np.random.default_rng(7)
    T, K_total, k_local = 64, 8, 4
    G = lead[0] if lead else 1
    bits = rng.integers(0, 2, (G, T * K_total)).astype(np.int32)
    probs = np.where(rng.random((G, T * K_total)) < 0.2, rng.choice([0, 1, 32767], (
        G, T * K_total)), rng.integers(1, 32768, (G, T * K_total))).astype(np.int32)
    n = rng.integers(T * K_total // 2, T * K_total, G)
    b, p = torch.from_numpy(bits), torch.from_numpy(probs).clamp_min(1)
    valid = torch.arange(T * K_total) < torch.from_numpy(n)[:, None]
    for l in range(K_total // k_local):
        cols = slice(l * k_local, (l + 1) * k_local)
        planes = [x.view(G, T, K_total)[:, :, cols] for x in (b, p, valid)]
        if not lead:
            planes = [x[0] for x in planes]
        assert not planes[0].is_contiguous()
        got = tl.lane_scan(*planes)
        copy = tl.lane_scan(*(x.contiguous() for x in planes))
        for x, y in zip(got, copy):
            assert torch.equal(x, y)
        for g in range(G):
            sl = [x[g] if lead else x for x in planes]
            want = jlx._lane_scan(*(jnp.asarray(x.numpy().astype(np.uint32) if x.dtype
                                                != torch.bool else x.numpy()) for x in sl))
            out = [o[g] if lead else o for o in got]
            for name, o, w in zip(("x_final", "words", "emits"), out, want):
                assert_same_array(o, w, f"slice {l} chunk {g}: {name}")
            assert torch.equal(out[3], out[2].sum(0, dtype=torch.int32))


def test_sharded_v4_compress_step_matches_jax(corpus_dir):
    """sharded_v4_compress_step on a 4 x 2 grid of CPU devices returns what
    JAX's shard_map step returns on the 4 x 2 CPU mesh, in all five outputs,
    for ipb_high.mp4's chunks (two real chunks, two pad chunks)."""
    jm = _jax_mesh(4, 2)
    an, inp = _mesh_inputs(corpus_dir, "ipb_high.mp4", n_gop=4)
    got = tpipe.sharded_v4_compress_step(tmesh.make_mesh(4, 2, ["cpu"] * 8),
                                         **inp.statics)(*inp.tensors())
    jin = (inp.blob.numpy().view(np.uint32), inp.sc.numpy(), inp.dual0.numpy().view(np.uint16),
           inp.sig0_idx.numpy().view(np.uint32), inp.sig0_val.numpy().view(np.uint16),
           inp.n_arr.numpy())
    want = jpipe.sharded_v4_compress_step(jm, **inp.statics)(*(jnp.asarray(a) for a in jin))
    for name, g, w in zip(("x_final", "words", "emits", "probs", "total_words"), got, want):
        assert_same_array(g, w, name)
    assert int(got[4]) == int(got[2].sum()) + 2 * inp.blob.shape[0] * inp.statics["K_total"]


def test_compress_mesh_matches_jax_and_single_device(corpus_dir):
    """compress_mesh on a 4 x 2 grid of CPU devices writes the container
    that JAX's compress_mesh writes on the 4 x 2 CPU mesh and that the
    port's single-device compress writes; the host decoder reads it back."""
    jm = _jax_mesh(4, 2)
    data = _read(corpus_dir, "ipb_high.mp4")
    comp, st = td.compress_mesh(data, tmesh.make_mesh(4, 2, ["cpu"] * 8), **MESH_KW)
    assert st.n_chunks > 1
    want, _ = jd.compress_mesh(data, jm, **MESH_KW)
    assert comp == want
    single, _ = td.compress(data, chunk_mode=1, batch_size=512, force_lanes=4, device="cpu")
    assert comp == single
    assert pipeline.decompress(comp)[0] == data


def test_compress_mesh_shifts_slots_of_narrow_chunks(corpus_dir):
    """On a 2 x 2 grid, i_main.264's three chunks (two dual widths, one pad
    chunk) give the single-device container, which the decoder reads back."""
    data = _read(corpus_dir, "i_main.264")
    comp, st = td.compress_mesh(data, tmesh.make_mesh(2, 2, ["cpu"] * 4), **MESH_KW)
    assert st.n_chunks == 3
    single, _ = td.compress(data, chunk_mode=1, batch_size=512, force_lanes=4, device="cpu")
    assert comp == single
    assert pipeline.decompress(comp)[0] == data


def _recompress_inputs():
    """test_parallel.py's inputs of the pre-ANL5 step."""
    G, N = 4, 512
    n_dual, n_sig = 64, 128
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, (G, N)).astype(np.int32)
    kinds = rng.integers(0, 3, (G, N)).astype(np.int32)
    keys = np.where(kinds == 2, rng.integers(0, n_sig, (G, N)),
                    rng.integers(0, n_dual - 1, (G, N))).astype(np.int32)
    priors = rng.integers(1, 32767, (G, N)).astype(np.int32)
    dual0 = np.ones((G, n_dual, 4), np.int32) * 3
    sig0 = np.zeros((G, n_sig, 2), np.int32)
    return bits, kinds, keys, priors, dual0, sig0


def test_sharded_recompress_step_matches_jax():
    """The pre-ANL5 step on a 4 x 2 grid of CPU devices equals JAX's on the
    4 x 2 CPU mesh in all five outputs, and its probs equal the
    single-device model_pass per chunk (test_parallel.py:48-53)."""
    jm = _jax_mesh(4, 2)
    inputs = _recompress_inputs()
    got = tpipe.sharded_recompress_step(tmesh.make_mesh(4, 2, ["cpu"] * 8), batch=256)(
        K_total=8)(*(torch.from_numpy(a) for a in inputs))
    want = jpipe.sharded_recompress_step(jm, batch=256)(K_total=8)(
        *(jnp.asarray(a) for a in inputs))
    for name, g, w in zip(("probs", "x_final", "words", "emits", "total_words"), got, want):
        assert_same_array(g, w, name)
    for g in range(4):
        one = tmp.model_pass(*(torch.from_numpy(a[g]) for a in inputs), batch=256, fast_w=48,
                             slow_w=640, sig_w=80, sig_alpha=1)
        assert torch.equal(got[0][g], tl._as_i16(one))  # the step's probs: u16 bit patterns


def test_make_mesh():
    mesh = tmesh.make_mesh(4, 2, ["cpu"] * 8)
    assert mesh.shape == {"gop": 4, "lane": 2}
    assert mesh.devices[3][1] == torch.device("cpu")
    assert tmesh.make_mesh(n_lane=2, devices=["cpu"] * 6).shape == {"gop": 3, "lane": 2}
    with pytest.raises(ValueError):
        tmesh.make_mesh(4, 2, ["cpu"] * 4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tmesh.make_mesh(1, 1)


def test_mesh_rejects_chunks_and_lanes_that_do_not_split():
    mesh = tmesh.make_mesh(2, 2, ["cpu"] * 4)
    step = tpipe.sharded_recompress_step(mesh, batch=256)(K_total=6)
    with pytest.raises(ValueError):
        step(*(torch.from_numpy(a) for a in _recompress_inputs()))
