"""The port's lane encoder (avrecode_tpu_torch.ops.lanes) against the JAX
package's and the C++ encoder, on the CPU (the plain versions of the scan
and the compaction). Every value is an integer, so every comparison is exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_coder import _c_decode, _c_encode, _random_biased_stream
from test_torch_jaxlib import ensure_jax_lib

from avrecode_tpu.ops import lanes as jl
from avrecode_tpu_torch import _native
from avrecode_tpu_torch.ops import lanes as tl
from avrecode_tpu_torch.testing import assert_same_array

# Both host libraries, each built here under its own lock, before any test
# of any module can reach the JAX package's unlocked build (see
# test_torch_jaxlib.py).
_native.ensure_host_lib()
ensure_jax_lib()


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.int32))


@pytest.mark.parametrize("lanes", [1, 4, 64])
@pytest.mark.parametrize("n", [1, 17, 5000])
def test_lane_blob_matches_c_and_jax(lanes, n):
    rng = np.random.default_rng(lanes * 1000 + n)
    bits, probs = _random_biased_stream(rng, n)
    blob = tl.encode_interleaved_dev(_t(bits), _t(probs), n, lanes)
    assert blob == _c_encode(bits, probs, lanes)
    assert blob == jl.encode_interleaved_dev(jnp.asarray(bits.astype(np.int32)),
                                             jnp.asarray(probs), n, lanes)


def test_lane_scan_and_compact_match_jax():
    """Raw scan outputs (x_final, words, emits, counts) and the compaction
    equal the JAX functions', with the bin planes shorter than T*K (padding
    bins: p = 1, never emitted)."""
    rng = np.random.default_rng(5)
    n, K = 3001, 16
    T = tl._bucket(-(-n // K))
    bits, probs = _random_biased_stream(rng, n)
    jx = jl._lane_scan_dev(jnp.pad(jnp.asarray(bits.astype(np.int32)), (0, T * K - n)),
                           jnp.pad(jnp.asarray(probs), (0, T * K - n), constant_values=1),
                           n, T=T, K=K)
    tx = tl.lane_scan_dev(_t(bits), _t(probs), n, T, K)
    for name, got, want in zip(("x_final", "words", "emits", "counts"), tx, jx):
        assert_same_array(got, want, name)
    maxW = tl._bucket(int(tx[3].max()))
    assert_same_array(tl.lane_compact(tx[1], tx[2], maxW), jl._lane_compact(jx[1], jx[2], maxW),
                      "compacted")
    assert (tl.assemble_blob(tx[0].numpy(), tx[1].numpy(), tx[2].numpy(), n, K)
            == _c_encode(bits, probs, K))


@pytest.mark.parametrize("cheap", [True, False])
def test_lane_blob_clamp_extremes(cheap):
    """p = 1 and p = 32767 (the clamp bounds), on the cheap and the costly
    side of every bin: byte-identical to the C++ encoder, which decodes it."""
    rng = np.random.default_rng(7)
    n = 2048
    bits = rng.integers(0, 2, n).astype(np.uint8)
    hi, lo = (32767, 1) if cheap else (1, 32767)
    probs = np.where(bits == 1, hi, lo).astype(np.uint16)
    blob = tl.encode_interleaved_dev(_t(bits), _t(probs), n, 4)
    assert blob == _c_encode(bits, probs, 4)
    rc, dec = _c_decode(blob, probs, n)
    assert rc == 0 and np.array_equal(dec, bits)


@pytest.mark.parametrize("lanes", [16, 128])
def test_lane_blob_empty_chunk(lanes):
    """n = 0: no scan; every lane holds only its initial state."""
    empty = torch.zeros(0, dtype=torch.int32)
    blob = tl.encode_interleaved_dev(empty, empty, 0, lanes)
    assert blob == jl.encode_interleaved_dev(jnp.zeros(0, jnp.int32),
                                             jnp.zeros(0, jnp.uint16), 0, lanes)
    assert len(blob) == 8 + 8 * lanes


def test_lane_wrappers_reject_other_devices():
    """A wrapper runs the plain version only for CPU tensors: any other
    device launches the kernel or raises, never a silent CPU run."""
    meta = torch.empty(8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        tl.lane_scan_dev(meta, meta, 8, 8, 1)
    with pytest.raises(ValueError):
        tl.lane_compact(meta.reshape(8, 1), meta.reshape(8, 1), 4)


# The scan kernels' step arithmetic (csrc/lanes.cu), through its numpy
# mirror in ops/lanes.py: the records, the exact division magic and the
# five-instruction chain, held against the plain scan's step.

_U32 = 0xFFFFFFFF


def test_magic_table_is_exact():
    """For every f in [1, 32767]: ((x1 + inc) * m) >> (32 + s) == x1 // f at
    both ends (q*f and q*f + f - 1) of every quotient q < 2^17, which by
    monotonicity covers every x1 < f << 17 (Python integers, no overflow)."""
    table = tl._magic_table()
    assert table.shape == (tl.PROB_SCALE, 2) and table.dtype == np.uint32
    for f in range(1, tl.PROB_SCALE):
        m, word = int(table[f, 0]), int(table[f, 1])
        s, inc = word & 31, word >> 5
        assert inc in (0, 1) and 0 < m <= _U32
        for q in (0, 1, (1 << 17) - 1):
            for x1 in (q * f, q * f + f - 1):
                assert ((x1 + inc) * m) >> (32 + s) == q, (f, x1)


def test_kernel_magic_words_hold_the_table():
    """The words the kernels copy into shared memory give back the proved
    table for every f in [1, 32767]: m, the inc bit, and s = floor(log2 f)
    as the kernels count it."""
    words = tl._magic_words()
    table = tl._magic_table()
    assert words.shape == (tl.PROB_SCALE + tl.PROB_SCALE // 32,) and words.dtype == np.uint32
    f = np.arange(1, tl.PROB_SCALE)
    assert np.array_equal(words[f], table[f, 0])
    inc = words[tl.PROB_SCALE + (f >> 5)] >> (f & 31) & 1
    assert np.array_equal(inc, table[f, 1] >> 5)
    assert np.array_equal(31 - np.array([32 - int(v).bit_length() for v in f]), table[f, 1] & 31)


def _every_f_states(rng, f):
    """Per f: the renorm edges f << 17 (and one below), 2^16, 2^32 - 1,
    0, and 48 random u32 states."""
    edges = np.stack([(f << 17) - 1, f << 17, np.full_like(f, 1 << 16),
                      np.full_like(f, _U32), np.zeros_like(f)], 1)
    return np.concatenate([edges, rng.integers(0, 1 << 32, (len(f), 48))], 1)


@pytest.mark.parametrize("bit", [0, 1])
def test_chain_step_matches_plain_step_for_every_f(bit):
    """Every f in [1, 32767] with this bit (p = f for a one, 32768 - f for
    a zero), at the edge states and random ones: the chain's new state and
    emission equal the plain scan's step, exactly."""
    rng = np.random.default_rng(40 + bit)
    f = np.arange(1, tl.PROB_SCALE, dtype=np.int64)
    p = f if bit else tl.PROB_SCALE - f
    x = _every_f_states(rng, f)
    b = np.full_like(x, bit)
    pp = np.broadcast_to(p[:, None], x.shape)
    v = np.ones(x.shape, bool)
    got, got_e = tl._chain_step(x, tl._pack_steps(b, pp, v))
    want, want_e = tl._plain_step(*(torch.from_numpy(np.ascontiguousarray(a))
                                    for a in (x, b, pp, v)))
    assert np.array_equal(got, want.numpy())
    assert np.array_equal(got_e, want_e.numpy())
    assert got.max() <= _U32  # the state stays u32


def test_invalid_step_is_identity():
    """An invalid step's record leaves every state as it is (2^32 - 1
    included, where a valid step with f + c = 32768 can land) and never
    emits, whatever its bit and probability; the plain step agrees."""
    rng = np.random.default_rng(43)
    f = np.arange(1, tl.PROB_SCALE, dtype=np.int64)
    x = _every_f_states(rng, f)
    b = rng.integers(0, 2, x.shape)
    p = np.broadcast_to(f[:, None], x.shape)
    v = np.zeros(x.shape, bool)
    got, got_e = tl._chain_step(x, tl._pack_steps(b, p, v))
    assert np.array_equal(got, x) and not got_e.any()
    want, want_e = tl._plain_step(*(torch.from_numpy(np.ascontiguousarray(a))
                                    for a in (x, b, p, v)))
    assert np.array_equal(want.numpy(), x) and not want_e.any()
    # a valid step can leave 2^32 - 1: q = 2^17 - 1, r = f - 1, f + c = 32768
    last, _ = tl._chain_step(np.array([(1 << 17) * 5 - 1]),
                             tl._pack_steps(np.array([1]), np.array([5]), np.array([True])))
    assert int(last[0]) == _U32


@pytest.mark.parametrize("K", [1, 7, 16, 128])
def test_chain_scan_matches_plain_scan(K):
    """Whole scans through the kernels' records and chain on random streams
    (p = 1 / 32767 extremes mixed in, non-prefix masks, a chunk axis of 2)
    equal _lane_scan_plain and JAX's _lane_scan (vmapped over the chunks);
    the dense scan's layout (bins past n invalid, p floored at 1) equals
    _lane_scan_dev_plain and JAX's _lane_scan_dev. int64 numpy math, exact."""
    rng = np.random.default_rng(K)
    T = 96
    bits = rng.integers(0, 2, (2, T, K))
    probs = rng.integers(1, tl.PROB_SCALE, (2, T, K))
    probs = np.where(rng.random((2, T, K)) < 0.3, rng.choice([1, 32767], (2, T, K)), probs)
    valid = rng.random((2, T, K)) < 0.75
    valid[:, :, ::3] &= rng.random((2, T, 1)) < 0.5  # ragged, not a prefix
    got = tl._lane_scan_chain(bits, probs, valid)
    want = tl._lane_scan_plain(_t(bits), _t(probs), torch.from_numpy(valid))
    for g, w in zip(got, want):
        assert_same_array(g, w)
    jx = jax.vmap(jl._lane_scan)(*(jnp.asarray(a) for a in (bits.astype(np.int32),
                                                             probs.astype(np.int32), valid)))
    for name, g, w in zip(("x_final", "words", "emits"), got, jx):
        assert_same_array(g, w, name)
    n = T * K - K // 2 - 1
    flat_p = np.where(rng.random(T * K) < 0.1, 0, probs[0].reshape(-1))  # floored to 1
    dense_valid = (np.arange(T * K) < n).reshape(T, K)
    got = tl._lane_scan_chain(bits[0], np.maximum(flat_p, 1).reshape(T, K), dense_valid)
    want = tl._lane_scan_dev_plain(_t(bits[0].reshape(-1)), _t(flat_p), n, T, K)
    for g, w in zip(got, want):
        assert_same_array(g, w)
    jx = jl._lane_scan_dev(jnp.asarray(bits[0].reshape(-1).astype(np.int32)),
                           jnp.asarray(flat_p.astype(np.int32)), n, T=T, K=K)
    for name, g, w in zip(("x_final", "words", "emits", "counts"), got, jx):
        assert_same_array(g, w, name)
