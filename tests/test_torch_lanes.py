"""The port's lane encoder (avrecode_tpu_torch.ops.lanes) against the JAX
package's and the C++ encoder, on the CPU (the plain versions of the scan
and the compaction). Every value is an integer, so every comparison is exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_coder import _c_decode, _c_encode, _random_biased_stream

from avrecode_tpu.ops import lanes as jl
from avrecode_tpu_torch import _native
from avrecode_tpu_torch.ops import lanes as tl

# Built here, under the port's lock, before any test of any module can reach
# the host library's unlocked build (see _native.ensure_host_lib).
_native.ensure_host_lib()


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
    x_final, words, emits, counts = (np.asarray(a) for a in jx)
    assert np.array_equal(tx[0].numpy(), x_final.astype(np.int64))
    assert np.array_equal(tx[1].numpy(), words.astype(np.int32))
    assert np.array_equal(tx[2].numpy(), emits.astype(np.int32))
    assert np.array_equal(tx[3].numpy(), counts)
    maxW = tl._bucket(int(counts.max()))
    assert np.array_equal(tl.lane_compact(tx[1], tx[2], maxW).numpy(),
                          np.asarray(jl._lane_compact(jx[1], jx[2], maxW)).astype(np.int32))
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
