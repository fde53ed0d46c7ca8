"""K-lane interleaved binary rANS encoding on the card (PyTorch + CUDA).

Counterpart of avrecode_tpu/ops/lanes.py, byte-identical to the host codec
(avrecode_tpu/native/rans.h RansInterleaved::encode). Lane l owns bins l,
l+K, l+2K, ...; each lane encodes its subsequence in reverse, and every
step emits at most one u16 word per lane. The encode is staged in three
phases, as in the JAX package: the scan, a tiny per-lane counts readback
that sizes the compaction, and the bulk download that assembles the blob.

`lane_scan_dev` (bins [0, n) of device-resident streams, the profile-2
path), `lane_scan` ([T, K] planes with an explicit valid mask: the profile-0
path's `encode_interleaved`, and per chunk and lane slice the mesh steps of
parallel/pipeline.py) and `lane_compact` each have a plain PyTorch version,
taken only for CPU tensors, and a CUDA kernel (csrc/lanes.cu) for CUDA
tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import _native

PROB_BITS = 15
PROB_SCALE = 1 << PROB_BITS
RANS_L = 1 << 16
# Steps per tile of csrc/lanes.cu's compaction (kTile): sizes its scratch.
_COMPACT_TILE = 256


def _bucket(t: int) -> int:
    b = 1
    while b < t:
        b *= 2
    return b


def lane_scan_dev(bits_m: torch.Tensor, probs_m: torch.Tensor, n: int, T: int, K: int):
    """Reverse rANS scan of bins [0, n) over K lanes and T steps (bin t*K+l
    is lane l's step t). bits_m/probs_m: int32[>= n]. Returns x_final
    int64[K] (u32 states), words int32[T, K] (u16 values), emits int32[T, K]
    (0/1) and counts int32[K] (emissions per lane)."""
    if _native.on_cpu("lane_scan_dev", bits_m):
        return _lane_scan_dev_plain(bits_m, probs_m, n, T, K)
    return _lane_scan_dev_cuda(bits_m, probs_m, n, T, K)


def _lane_scan_dev_plain(bits_m, probs_m, n: int, T: int, K: int):
    """Plain version: the bins as [T, K] planes (probabilities floored at 1,
    as JAX's _lane_scan_dev does), the steps past n invalid."""
    size = T * K
    dev = bits_m.device
    b = torch.zeros(size, dtype=torch.int64, device=dev)
    p = torch.ones(size, dtype=torch.int64, device=dev)
    k = min(size, bits_m.shape[0])
    b[:k] = bits_m[:k]
    p[:k] = probs_m[:k]
    valid = (torch.arange(size, device=dev) < n).reshape(T, K)
    return _lane_scan_plain(b.reshape(T, K), p.reshape(T, K).clamp_min(1), valid)


def _lane_scan_dev_cuda(bits_m, probs_m, n: int, T: int, K: int):
    _native.check_cuda("lane_scan_dev", bits_m, probs_m)
    if bits_m.dim() != 1 or probs_m.shape != bits_m.shape or bits_m.shape[0] < n:
        raise ValueError(f"lane_scan_dev: need 1-D bits/probs of >= {n} bins, "
                         f"got {tuple(bits_m.shape)} / {tuple(probs_m.shape)}")
    if T * K < n or not 1 <= K <= 1024:
        raise ValueError(f"lane_scan_dev: T={T} K={K} cannot hold n={n}")
    dev = bits_m.device
    x_final = torch.empty(K, dtype=torch.int32, device=dev)
    words = torch.empty((T, K), dtype=torch.int32, device=dev)
    emits = torch.empty((T, K), dtype=torch.int32, device=dev)
    counts = torch.empty(K, dtype=torch.int32, device=dev)
    _native.launch("lane_scan_dev", "artc_lane_scan_dev", dev, bits_m, probs_m, x_final,
                   words, emits, counts, n, T, K)
    return x_final.to(torch.int64) & 0xFFFFFFFF, words, emits, counts


def lane_scan(bits_tk: torch.Tensor, probs_tk: torch.Tensor, valid_tk: torch.Tensor):
    """Reverse rANS scan over [T, K] planes with an explicit mask (JAX's
    _lane_scan): step [t, l] encodes bin t*K + l where valid_tk[t, l] is
    true, and an invalid step neither emits nor changes the state. The mask
    need not be a prefix. bits_tk/probs_tk: int32[T, K], valid probabilities
    in [1, 32767]; valid_tk: bool[T, K]. Returns x_final int64[K] (u32
    states), words int32[T, K] (u16 values), emits int32[T, K] (0/1) and
    counts int32[K] (emissions per lane).

    A leading chunk axis ([G, T, K] planes, the mesh's vmap written out)
    scans G chunks at once, and every output gains it. The three planes may
    be views with equal strides and a dense last dimension, such as a lane
    slice [:, :, l*k:(l+1)*k] of wider planes: the kernel reads them in
    place."""
    if _native.on_cpu("lane_scan", bits_tk):
        return _lane_scan_plain(bits_tk, probs_tk, valid_tk)
    return _lane_scan_cuda(bits_tk, probs_tk, valid_tk)


def _lane_scan_plain(bits_tk, probs_tk, valid_tk):
    """Plain version: one Python step per t over the K lanes (and the
    chunks of a leading chunk axis), int64 math."""
    *lead, T, K = bits_tk.shape
    dev = bits_tk.device
    b = bits_tk.to(torch.int64)
    valid = valid_tk.to(torch.bool)
    p = torch.where(valid, probs_tk.to(torch.int64), 1)  # invalid steps never divide
    x = torch.full((*lead, K), RANS_L, dtype=torch.int64, device=dev)
    words = torch.empty((*lead, T, K), dtype=torch.int32, device=dev)
    emits = torch.empty((*lead, T, K), dtype=torch.bool, device=dev)
    for t in range(T - 1, -1, -1):
        one = b[..., t, :] == 1
        pp = p[..., t, :]
        v = valid[..., t, :]
        f = torch.where(one, pp, PROB_SCALE - pp)
        c = torch.where(one, PROB_SCALE - pp, 0)
        emit = (x >= (f << 17)) & v
        words[..., t, :] = x & 0xFFFF
        emits[..., t, :] = emit
        x1 = torch.where(emit, x >> 16, x)
        x = torch.where(v, ((x1 // f) << PROB_BITS) + x1 % f + c, x)
    return x, words, emits.to(torch.int32), emits.sum(-2, dtype=torch.int32)


def _lane_scan_cuda(bits_tk, probs_tk, valid_tk):
    planes = (bits_tk, probs_tk, valid_tk)
    dev = bits_tk.device
    for t, dtype in zip(planes, (torch.int32, torch.int32, torch.bool)):
        if not t.is_cuda or t.device != dev or t.dtype != dtype:
            raise ValueError(f"lane_scan: planes must be int32, int32, bool on {dev}, got "
                             f"{t.dtype} on {t.device}")
    if bits_tk.dim() not in (2, 3) or any(t.shape != bits_tk.shape for t in planes):
        raise ValueError("lane_scan: bits/probs/valid must all be [T, K] or [G, T, K]")
    one = bits_tk.dim() == 2
    if one:
        planes = tuple(t[None] for t in planes)
    G, T, K = planes[0].shape
    strides = planes[0].stride()
    if any(t.stride() != strides for t in planes) or strides[2] != 1 \
            or (G > 1 and strides[0] < T * strides[1]) or (T > 1 and strides[1] < K):
        raise ValueError(f"lane_scan: planes need equal strides and a dense last dimension, "
                         f"got {[t.stride() for t in planes]}")
    if not 1 <= K <= 1024:
        raise ValueError(f"lane_scan: K={K} outside [1, 1024]")
    x_final = torch.empty((G, K), dtype=torch.int32, device=dev)
    words = torch.empty((G, T, K), dtype=torch.int32, device=dev)
    emits = torch.empty((G, T, K), dtype=torch.int32, device=dev)
    counts = torch.empty((G, K), dtype=torch.int32, device=dev)
    _native.launch("lane_scan", "artc_lane_scan", dev, *planes, x_final, words, emits, counts,
                   G, T, K, strides[0], strides[1])
    out = (x_final.to(torch.int64) & 0xFFFFFFFF, words, emits, counts)
    return tuple(o[0] for o in out) if one else out


def lane_compact(words: torch.Tensor, emits: torch.Tensor, maxW: int) -> torch.Tensor:
    """Per-lane compaction of the emitted words in ascending-t order into
    int32[maxW, K] (zeros past each lane's count): the download is then
    about the compressed payload instead of the full [T, K] planes."""
    if _native.on_cpu("lane_compact", words):
        return _lane_compact_plain(words, emits, maxW)
    return _lane_compact_cuda(words, emits, maxW)


def _lane_compact_plain(words, emits, maxW: int):
    T, K = words.shape
    e = emits.to(torch.int64)
    pos = torch.cumsum(e, 0) - e
    lane = torch.arange(K, device=words.device).expand(T, K)
    keep = (e != 0) & (pos < maxW)
    out = torch.zeros(maxW * K, dtype=torch.int32, device=words.device)
    out[(pos * K + lane)[keep]] = words[keep]
    return out.reshape(maxW, K)


def _lane_compact_cuda(words, emits, maxW: int):
    _native.check_cuda("lane_compact", words, emits)
    if words.dim() != 2 or emits.shape != words.shape:
        raise ValueError("lane_compact: words/emits must both be [T, K]")
    T, K = words.shape
    ntile = -(-T // _COMPACT_TILE)
    if ntile > 65535:  # the tiles ride the grid's y dimension
        raise ValueError(f"lane_compact: T={T} exceeds {65535 * _COMPACT_TILE} steps")
    out = torch.zeros((maxW, K), dtype=torch.int32, device=words.device)
    tile_cnt = torch.empty((ntile, K), dtype=torch.int32, device=words.device)
    _native.launch("lane_compact", "artc_lane_compact", words.device, words, emits,
                   out, tile_cnt, T, K, maxW)
    return out


def _empty_blob(K: int) -> bytes:
    """The n == 0 blob: every lane holds only its initial state RANS_L."""
    head = np.array([RANS_L >> 16, RANS_L & 0xFFFF], "<u2").tobytes()
    return (np.array([K, 0], "<u4").tobytes() + np.full(K, 2, "<u4").tobytes()
            + head * K)


def assemble_blob(x_final: np.ndarray, words: np.ndarray, emits: np.ndarray,
                  n: int, K: int) -> bytes:
    """Builds the RansInterleaved wire blob from raw scan outputs on the host
    (x_final u32[K], words u16[T, K], emits bool[T, K])."""
    out = bytearray()
    out += np.uint32(K).tobytes()
    out += np.uint32(n).tobytes()
    lane_words = []
    for lane in range(K):
        tail = words[:, lane][emits[:, lane].astype(bool)]
        lane_words.append(np.concatenate([
            np.array([x_final[lane] >> 16, x_final[lane] & 0xFFFF], np.uint16),
            tail.astype(np.uint16)]))
    for lw in lane_words:
        out += np.uint32(len(lw)).tobytes()
    for lw in lane_words:
        out += lw.astype("<u2").tobytes()
    return bytes(out)


def encode_interleaved_start(bits_dev: torch.Tensor, probs_dev: torch.Tensor,
                             n: int, K: int):
    """Phase 1: launches a chunk's lane scan on the device-resident bits and
    probs, with no readback; returns an opaque handle."""
    if n == 0:
        return (None, None, None, None, n, K)
    T = _bucket(-(-n // K))
    x_final, words, emits, counts = lane_scan_dev(bits_dev, probs_dev, n, T, K)
    return (x_final, words, emits, counts, n, K)


def encode_interleaved_compact(handle):
    """Phase 2: reads back the K per-lane counts (one tiny sync that ends
    when the scan does) and launches the compaction they size."""
    x_final, words, emits, counts, n, K = handle
    if n == 0:
        return (None, None, None, n, K)
    counts_h = counts.cpu().numpy()
    maxW = _bucket(max(int(counts_h.max()), 1))
    return (x_final, lane_compact(words, emits, maxW), counts_h, n, K)


def encode_interleaved_emit(chandle) -> bytes:
    """Phase 3: downloads the compacted words and final states and writes
    the RansInterleaved blob: K, n, per-lane word counts (count + 2), then
    per lane the final state (hi, lo) and its words."""
    x_final, tail_dev, counts_h, n, K = chandle
    if n == 0:
        return _empty_blob(K)
    tail = tail_dev.cpu().numpy()
    x_final = x_final.cpu().numpy()
    out = bytearray()
    out += np.uint32(K).tobytes()
    out += np.uint32(n).tobytes()
    for lane in range(K):
        out += np.uint32(int(counts_h[lane]) + 2).tobytes()
    for lane in range(K):
        head = np.array([x_final[lane] >> 16, x_final[lane] & 0xFFFF], np.uint16)
        out += head.astype("<u2").tobytes()
        out += tail[:counts_h[lane], lane].astype("<u2").tobytes()
    return bytes(out)


def encode_interleaved_finish(handle) -> bytes:
    return encode_interleaved_emit(encode_interleaved_compact(handle))


def encode_interleaved_dev(bits_dev: torch.Tensor, probs_dev: torch.Tensor,
                           n: int, K: int) -> bytes:
    """Full chunk encode from device-resident bits/probs; byte-identical to
    the host codec (native/rans.h)."""
    return encode_interleaved_finish(encode_interleaved_start(bits_dev, probs_dev, n, K))


def encode_interleaved(bits: np.ndarray, probs: np.ndarray, K: int, *, device) -> bytes:
    """Full chunk encode of host arrays (bits[n], probs[n] in [1, 32767]) on
    `device`: the stream is padded to T = pow2(ceil(n / K)) steps with
    invalid steps, uploaded as [T, K] planes, scanned by `lane_scan`,
    compacted and assembled; byte-identical to the host codec
    (native/rans.h)."""
    n = len(bits)
    if n == 0:
        return _empty_blob(K)
    T = _bucket(-(-n // K))
    pad = T * K - n
    planes = [np.concatenate([a.astype(dt), np.full(pad, fill, dt)]).reshape(T, K)
              for a, dt, fill in ((bits, np.int32, 0), (probs, np.int32, 1),
                                  (np.ones(n, bool), bool, False))]
    b, p, v = (torch.from_numpy(a).to(device) for a in planes)
    return encode_interleaved_finish((*lane_scan(b, p, v), n, K))
