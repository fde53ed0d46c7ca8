"""K-lane interleaved binary rANS encoding on the card (PyTorch + CUDA).

Counterpart of avrecode_tpu/ops/lanes.py, byte-identical to the host codec
(native/rans.h RansInterleaved::encode). Lane l owns bins l,
l+K, l+2K, ...; each lane encodes its subsequence in reverse, and every
step emits at most one u16 word per lane. The encode is staged in three
phases, as in the JAX package: the scan, a tiny per-lane counts readback
that sizes the compaction, and the bulk download that assembles the blob.

`lane_scan_dev` (bins [0, n) of device-resident streams, the profile-2
path), `lane_scan` ([T, K] planes with an explicit valid mask: the profile-0
path's `encode_interleaved`, and per chunk and lane slice the mesh steps of
parallel/pipeline.py) and `lane_compact` each have a plain PyTorch version,
taken only for CPU tensors, and a CUDA kernel (csrc/lanes.cu) for CUDA
tensors. Their outputs have the JAX functions' widths, in the dtypes that
carry them (device._wire's mapping): x_final u32 as int32 bit patterns,
words u16 as int16 bit patterns, emits bool, counts int32.

With a `streams.CallStreams` (a compress call on the card) the counts
readback and the bulk downloads go through pinned memory on the call's
copy stream, each waiting only on the event of the kernel it reads.

The scan kernels run each step as a short chain of multiplies fed by
per-step records (csrc/lanes.cu's note). `_magic_table` proves the exact
division magic of every frequency, and `_magic_words` lays it out for the
kernels, which read it from device memory (`_magic_on`). `_pack_steps`,
`_chain_step` and `_lane_scan_chain` mirror how the kernels pack the records
and run the chain, and `_compact_mirror` the compaction's tiles, in numpy,
for the CPU tests (nothing on the main path calls those four).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import _native
from .. import streams as cs

PROB_BITS = 15
PROB_SCALE = 1 << PROB_BITS
RANS_L = 1 << 16
# The tiles of csrc/lanes.cu's compaction (kCompactTiles, kCompactCounts,
# kMaskWords): at most this many tiles of whole rows, this many counts
# (tiles x K) and this many lane masks a tile.
_COMPACT_TILES = 256
_COMPACT_COUNTS = 32768
_COMPACT_MASKS = 8192
# The largest chain index q = x1 // f of a step: x1 < f << 17.
_Q_MAX = (1 << 17) - 1
_U32 = 0xFFFFFFFF
# The magic table on each device the scans have run on.
_MAGIC_ON = {}


def _bucket(t: int) -> int:
    b = 1
    while b < t:
        b *= 2
    return b


@functools.lru_cache(maxsize=None)
def _magic_table() -> np.ndarray:
    """uint32[32768, 2]: for each f in [1, 32767], (m, s | inc << 5) with
    floor(x1 / f) == ((x1 + inc) * m) >> (32 + s) for every x1 < f << 17
    (row 0 is unused). s = floor(log2 f); m = ceil(2^(32+s) / f) with inc
    = 0 where that is exact, else floor(2^(32+s) / f) with inc = 1 (capped
    at 2^32 - 1: f = 1). Proved here for every f: x1 -> ((x1 + inc) * m) >> k
    is monotone, so it equals x1 // f on all of [0, f << 17) iff, for every
    q <= _Q_MAX, it is >= q at x1 = q*f and <= q at x1 = q*f + f - 1; both
    are linear in q, so the two ends of q suffice."""
    f = np.arange(1, PROB_SCALE, dtype=np.int64)
    s = np.frexp(f)[1].astype(np.int64) - 1
    k = 32 + s

    def exact(m, inc):
        d = f * m - (1 << k)
        ok = m < (1 << 32)
        for q in (0, _Q_MAX):
            ok &= q * d + inc * m >= 0
            ok &= q * d + (f - 1 + inc) * m - (1 << k) < 0
        return ok

    up = -(-(1 << k) // f)
    down = np.minimum((1 << k) // f, _U32)
    use_up = exact(up, 0)
    if not (use_up | exact(down, 1)).all():
        raise AssertionError("_magic_table: no exact magic for some f")
    m = np.where(use_up, up, down)
    inc = (~use_up).astype(np.int64)
    table = np.zeros((PROB_SCALE, 2), np.uint32)
    table[1:, 0] = m
    table[1:, 1] = s | inc << 5
    return table


def _magic_words() -> np.ndarray:
    """The table the scan kernels copy into shared memory: uint32[32768 +
    1024], m of each f (_magic_table's first column), then the inc bits, f
    at bit f % 32 of word 32768 + f // 32. s = floor(log2 f) is not stored:
    the kernels count it (31 - clz(f))."""
    table = _magic_table()
    inc = (table[:, 1] >> 5).astype(np.uint32).reshape(-1, 32)
    bits = (inc << np.arange(32, dtype=np.uint32)).sum(1, dtype=np.uint64).astype(np.uint32)
    return np.concatenate([table[:, 0], bits])


def _magic_on(device: torch.device) -> torch.Tensor:
    """_magic_words as int32 on `device`, uploaded once from pinned memory;
    the upload ends before any stream can read it, and the table is never
    freed."""
    t = _MAGIC_ON.get(device)
    if t is None:
        words = _magic_words().view(np.int32)
        t = cs.pinned(words.shape, torch.int32)
        t.numpy()[:] = words
        t = t.to(device)
        torch.cuda.current_stream(device).synchronize()
        _MAGIC_ON[device] = t
    return t


def _pack_steps(bits, probs, valid) -> dict:
    """The scan kernels' per-step records (csrc/lanes.cu Ring::convert), in
    numpy int64: m and w = g << 17 | one << 6 | inc << 5 | s, with g =
    32768 - f, (m, inc) from _magic_words and s = floor(log2 f); an invalid
    step is the record 0, an exact identity of the chain. p is taken as it
    is (the dense scan floors it at 1 first)."""
    b, p = (np.asarray(a, np.int64) for a in (bits, probs))
    v = np.asarray(valid, bool)
    one = (b == 1).astype(np.int64)
    f = np.where(one == 1, p, PROB_SCALE - p) & (PROB_SCALE - 1)
    words = _magic_words().astype(np.int64)
    inc = words[PROB_SCALE + (f >> 5)] >> (f & 31) & 1
    s = np.frexp(f | 1)[1].astype(np.int64) - 1
    w = (PROB_SCALE - f) << 17 | one << 6 | inc << 5 | s
    return {"m": np.where(v, words[f], 0), "w": np.where(v, w, 0)}


def _chain_step(x, rec: dict):
    """One step of the kernels' chain (csrc/lanes.cu chain_step) on u32
    states x (int64 arrays): returns (new state, emitted)."""
    x = np.asarray(x, np.int64)
    m, w = rec["m"], rec["w"]
    thr = ~(w & 0xFFFE0000) & _U32
    g = w >> 17
    a = np.where(w & 32, m, 0)
    c = np.where(w & 64, g, 0)
    emit = x > thr
    x1 = np.where(emit, x >> 16, x)
    prod = x1.astype(np.uint64) * m.astype(np.uint64) + a.astype(np.uint64)
    q = ((prod >> np.uint64(32)) >> (w & 31).astype(np.uint64)).astype(np.int64)
    return (q * g + x1 + c) & _U32, emit


def _lane_scan_chain(bits_tk, probs_tk, valid_tk):
    """The masked scan ([T, K] or [G, T, K]) through _pack_steps and
    _chain_step, as the kernels run it; returns what _lane_scan_plain
    returns, as numpy arrays of the same dtypes."""
    rec = _pack_steps(bits_tk, probs_tk, valid_tk)
    *lead, T, K = rec["m"].shape
    x = np.full((*lead, K), RANS_L, np.int64)
    words = np.empty((*lead, T, K), np.uint16)
    emits = np.empty((*lead, T, K), bool)
    for t in range(T - 1, -1, -1):
        words[..., t, :] = x & 0xFFFF
        x, emits[..., t, :] = _chain_step(x, {k: r[..., t, :] for k, r in rec.items()})
    return (x.astype(np.uint32).view(np.int32), words.view(np.int16), emits,
            emits.sum(-2, dtype=np.int32))


def lane_scan_dev(bits_m: torch.Tensor, probs_m: torch.Tensor, n: int, T: int, K: int):
    """Reverse rANS scan of bins [0, n) over K lanes and T steps (bin t*K+l
    is lane l's step t). bits_m/probs_m: int32[>= n]. Returns x_final
    int32[K] (u32 states' bit patterns), words int16[T, K] (u16 values' bit
    patterns), emits bool[T, K] and counts int32[K] (emissions per lane), as
    JAX's _lane_scan_dev."""
    if _native.on_cpu("lane_scan_dev", bits_m):
        return _lane_scan_dev_plain(bits_m, probs_m, n, T, K)
    return _lane_scan_dev_cuda(bits_m, probs_m, n, T, K)


def _lane_scan_dev_plain(bits_m, probs_m, n: int, T: int, K: int):
    """Plain version: the bins as [T, K] planes (probabilities floored at 1,
    as JAX's _lane_scan_dev does), the steps past n invalid."""
    return _lane_scan_plain(*_dev_planes(bits_m, probs_m, n, T, K))


def _dev_planes(bits_m, probs_m, n: int, T: int, K: int):
    """The [T, K] planes the plain lane_scan_dev scans: bits and probs
    (int64, probabilities floored at 1) and the valid mask, bins past n
    invalid."""
    size = T * K
    dev = bits_m.device
    b = torch.zeros(size, dtype=torch.int64, device=dev)
    p = torch.ones(size, dtype=torch.int64, device=dev)
    k = min(size, bits_m.shape[0])
    b[:k] = bits_m[:k]
    p[:k] = probs_m[:k]
    valid = (torch.arange(size, device=dev) < n).reshape(T, K)
    return b.reshape(T, K), p.reshape(T, K).clamp_min(1), valid


def _lane_scan_dev_cuda(bits_m, probs_m, n: int, T: int, K: int):
    _native.check_cuda("lane_scan_dev", bits_m, probs_m)
    if bits_m.dim() != 1 or probs_m.shape != bits_m.shape or bits_m.shape[0] < n:
        raise ValueError(f"lane_scan_dev: need 1-D bits/probs of >= {n} bins, "
                         f"got {tuple(bits_m.shape)} / {tuple(probs_m.shape)}")
    if T * K < n or not 1 <= K <= 1024:
        raise ValueError(f"lane_scan_dev: T={T} K={K} cannot hold n={n}")
    dev = bits_m.device
    x_final = torch.empty(K, dtype=torch.int32, device=dev)
    words = torch.empty((T, K), dtype=torch.int16, device=dev)
    emits = torch.empty((T, K), dtype=torch.bool, device=dev)
    counts = torch.empty(K, dtype=torch.int32, device=dev)
    _native.launch("lane_scan_dev", "artc_lane_scan_dev", dev, bits_m, probs_m,
                   _magic_on(dev), x_final, words, emits, counts, n, T, K)
    return x_final, words, emits, counts


def lane_scan(bits_tk: torch.Tensor, probs_tk: torch.Tensor, valid_tk: torch.Tensor):
    """Reverse rANS scan over [T, K] planes with an explicit mask (JAX's
    _lane_scan): step [t, l] encodes bin t*K + l where valid_tk[t, l] is
    true, and an invalid step neither emits nor changes the state. The mask
    need not be a prefix. bits_tk/probs_tk: int32[T, K], valid probabilities
    in [1, 32767]; valid_tk: bool[T, K]. Returns x_final int32[K] (u32
    states' bit patterns), words int16[T, K] (u16 values' bit patterns),
    emits bool[T, K] and counts int32[K] (emissions per lane): JAX's
    widths (its counts come from _lane_scan_dev).

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
        words[..., t, :] = x & 0xFFFF
        x, emits[..., t, :] = _plain_step(x, b[..., t, :], p[..., t, :], valid[..., t, :])
    return _as_i32(x), _as_i16(words), emits, emits.sum(-2, dtype=torch.int32)


def _plain_step(x, b, p, v):
    """One step of the plain scan on int64 states x: returns (new state,
    emitted); an invalid step (v false) keeps x and never emits."""
    one = b == 1
    f = torch.where(one, p, PROB_SCALE - p)
    c = torch.where(one, PROB_SCALE - p, 0)
    emit = (x >= (f << 17)) & v
    x1 = torch.where(emit, x >> 16, x)
    return torch.where(v, ((x1 // f) << PROB_BITS) + x1 % f + c, x), emit


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
    words = torch.empty((G, T, K), dtype=torch.int16, device=dev)
    emits = torch.empty((G, T, K), dtype=torch.bool, device=dev)
    counts = torch.empty((G, K), dtype=torch.int32, device=dev)
    _native.launch("lane_scan", "artc_lane_scan", dev, *planes, _magic_on(dev), x_final, words,
                   emits, counts, G, T, K, strides[0], strides[1])
    out = (x_final, words, emits, counts)
    return tuple(o[0] for o in out) if one else out


def lane_compact(words: torch.Tensor, emits: torch.Tensor, maxW: int) -> torch.Tensor:
    """Per-lane compaction of the emitted words in ascending-t order into
    int16[maxW, K] holding the u16 words' bit patterns (JAX's uint16),
    zeros past each lane's count; emissions at positions >= maxW drop. The
    download is then about the compressed payload instead of the full [T,
    K] planes. words: int16 [T, K] (u16 bit patterns), emits: bool [T, K],
    as the scans return them."""
    if _native.on_cpu("lane_compact", words):
        return _lane_compact_plain(words, emits, maxW)
    return _lane_compact_cuda(words, emits, maxW)


def _as_i16(x: torch.Tensor) -> torch.Tensor:
    """u16 values (any integer dtype) -> int16 bit patterns."""
    x = x.to(torch.int32) & 0xFFFF
    return torch.where(x >= 1 << 15, x - (1 << 16), x).to(torch.int16)


def _as_i32(x: torch.Tensor) -> torch.Tensor:
    """u32 values (int64) -> int32 bit patterns."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def _lane_compact_plain(words, emits, maxW: int):
    T, K = words.shape
    e = emits.to(torch.int64)
    pos = torch.cumsum(e, 0) - e
    lane = torch.arange(K, device=words.device).expand(T, K)
    keep = (e != 0) & (pos < maxW)
    out = torch.zeros(maxW * K, dtype=torch.int16, device=words.device)
    out[(pos * K + lane)[keep]] = words[keep]
    return out.reshape(maxW, K)


def _compact_rows(T: int, K: int) -> int:
    """Rows (steps) of one compaction tile: at most _COMPACT_TILES tiles and
    _COMPACT_COUNTS counts, a multiple of 32 rows, at most _COMPACT_MASKS
    lane masks (csrc/lanes.cu compact_rows)."""
    K = max(K, 1)
    tiles = max(1, min(_COMPACT_TILES, _COMPACT_COUNTS // K))
    rows = -(-T // tiles)  # a tile's share of T, up to a multiple of 32
    rows = max(32, -(-rows // 32) * 32)
    return min(rows, max(32, _COMPACT_MASKS * 32 // K // 32 * 32))


def _compact_mirror(words, emits, maxW: int):
    """csrc/lanes.cu's two compaction launches over numpy arrays, in their
    decomposition: per tile of whole rows its lanes' counts, its lane masks
    (bit r of mask (g, l): lane l emits at the tile's row 32 g + r) and its
    share of the output's zeros (16-byte units); then per tile its lanes'
    offsets summed from the tiles before it, each (row group, lane)'s first
    position, and each emitted word at its group's first position plus the
    popcount of its lane's mask below its row (positions >= maxW drop).
    words/emits: int arrays [T, K]. Returns int16 [maxW, K]; raises if an
    output entry was never written."""
    words = np.asarray(words).astype(np.int64)
    e = np.asarray(emits) != 0
    T, K = e.shape
    rows = _compact_rows(T, K)
    ntile, groups = -(-T // rows), rows // 32
    unset = -(1 << 20)
    out = np.full(maxW * K, unset, np.int64)
    units = maxW * K // 8
    per = -(-units // ntile)
    tile_cnt = np.zeros((ntile, K), np.int64)
    masks = np.zeros((ntile, groups, K), np.int64)
    for tile in range(ntile):  # launch 1
        out[tile * per * 8:min((tile + 1) * per, units) * 8] = 0
        if tile == ntile - 1:
            out[units * 8:] = 0
        t, lane = np.nonzero(e[tile * rows:(tile + 1) * rows])
        tile_cnt[tile] = np.bincount(lane, minlength=K)
        np.bitwise_or.at(masks[tile], (t >> 5, lane), 1 << (t & 31))
    def popcount(x):
        return np.unpackbits(x.astype("<u4").view(np.uint8).reshape(*x.shape, 4),
                             axis=-1).sum(-1).astype(np.int64)

    for tile in range(ntile):  # launch 2
        pre = tile_cnt[:tile].sum(0)
        pop = popcount(masks[tile])
        first = pre + np.cumsum(pop, 0) - pop  # [groups, K]
        t, lane = np.nonzero(e[tile * rows:(tile + 1) * rows])
        pos = first[t >> 5, lane] + popcount(masks[tile][t >> 5, lane] & ((1 << (t & 31)) - 1))
        keep = pos < maxW
        out[pos[keep] * K + lane[keep]] = words[tile * rows + t[keep], lane[keep]] & 0xFFFF
    if (out == unset).any():
        raise AssertionError("_compact_mirror: an output entry was never written")
    return out.astype(np.uint16).view(np.int16).reshape(maxW, K)


def _lane_compact_cuda(words, emits, maxW: int):
    _native.check_cuda("lane_compact", words, emits, dtype=(torch.int16, torch.bool))
    if words.dim() != 2 or emits.shape != words.shape:
        raise ValueError("lane_compact: words/emits must both be [T, K]")
    T, K = words.shape
    if T * K >= 1 << 31 or K > 4096:
        raise ValueError(f"lane_compact: T={T} x K={K} beyond 2^31 entries or 4096 lanes")
    out = torch.empty((maxW, K), dtype=torch.int16, device=words.device)
    # The tile counts, then the lane masks (a bit a step and lane).
    rows = _compact_rows(T, K)
    scratch = torch.empty(-(-T // rows) * (K + rows // 32 * K), dtype=torch.int32,
                          device=words.device)
    _native.launch("lane_compact", "artc_lane_compact", words.device, words, emits, out,
                   scratch, T, K, maxW)
    return out


def _empty_blob(K: int) -> bytes:
    """The n == 0 blob: every lane holds only its initial state RANS_L."""
    head = np.array([RANS_L >> 16, RANS_L & 0xFFFF], "<u2").tobytes()
    return (np.array([K, 0], "<u4").tobytes() + np.full(K, 2, "<u4").tobytes()
            + head * K)


def assemble_blob(x_final: np.ndarray, words: np.ndarray, emits: np.ndarray,
                  n: int, K: int) -> bytes:
    """Builds the RansInterleaved wire blob from raw scan outputs on the host
    (x_final u32[K], words u16[T, K], emits bool[T, K]; the port's int32 and
    int16 bit patterns are read as those)."""
    x_final = np.asarray(x_final).view(np.uint32)
    words = np.asarray(words).view(np.uint16)
    out = bytearray()
    out += np.uint32(K).tobytes()
    out += np.uint32(n).tobytes()
    lane_words = []
    for lane in range(K):
        tail = words[:, lane][emits[:, lane]]
        lane_words.append(np.concatenate([
            np.array([x_final[lane] >> 16, x_final[lane] & 0xFFFF], np.uint16), tail]))
    for lw in lane_words:
        out += np.uint32(len(lw)).tobytes()
    for lw in lane_words:
        out += lw.astype("<u2").tobytes()
    return bytes(out)


class ScanHandle(NamedTuple):
    """A chunk's lane scan in flight (phase 1's result): its outputs on the
    device and, on a call's streams, the event after the scan."""
    x_final: torch.Tensor | None
    words: torch.Tensor | None
    emits: torch.Tensor | None
    counts: torch.Tensor | None
    n: int
    K: int
    scanned: torch.cuda.Event | None = None


class CompactHandle(NamedTuple):
    """A chunk's compaction in flight (phase 2's result): the final states
    and compacted words on the device, the counts on the host, and, on a
    call's streams, the event after the counts' copy."""
    x_final: torch.Tensor | None
    tail: torch.Tensor | None
    counts: np.ndarray | None
    n: int
    K: int
    ready: torch.cuda.Event | None = None


def encode_interleaved_start(bits_dev: torch.Tensor, probs_dev: torch.Tensor,
                             n: int, K: int, streams: cs.CallStreams | None = None
                             ) -> ScanHandle:
    """Phase 1: launches a chunk's lane scan on the device-resident bits and
    probs, with no readback. With `streams` the scan runs on their compute
    stream (the caller's current stream) and the handle keeps the event
    after it."""
    if n == 0:
        return ScanHandle(None, None, None, None, n, K)
    T = _bucket(-(-n // K))
    scan = lane_scan_dev(bits_dev, probs_dev, n, T, K)
    scanned = None
    if streams is not None:
        scanned = torch.cuda.Event(enable_timing=True)
        scanned.record(streams.compute)
    return ScanHandle(*scan, n, K, scanned)


def encode_interleaved_compact(handle: ScanHandle, streams: cs.CallStreams | None = None
                               ) -> CompactHandle:
    """Phase 2: reads back the K per-lane counts and launches the compaction
    they size. With `streams` the counts go into pinned memory on the copy
    stream once the scan's event has passed, and the host waits for that
    copy only, not for the kernels queued after the scan; else the readback
    is a `.cpu()` that ends when the scan does."""
    x_final, words, emits, counts, n, K, scanned = handle
    if n == 0:
        return CompactHandle(None, None, None, n, K)
    ready = None
    if streams is None:
        counts_h = counts.cpu().numpy()
    else:
        (counts_p,), ready = streams.download([counts], scanned, timing=True)
        ready.synchronize()
        counts_h = counts_p.numpy()
    maxW = _bucket(max(int(counts_h.max()), 1))
    return CompactHandle(x_final, lane_compact(words, emits, maxW), counts_h, n, K, ready)


def emit_tensors(chandle: CompactHandle) -> list[torch.Tensor]:
    """The device tensors phase 3 downloads: the compacted words and the
    final states (none for an empty chunk)."""
    return [] if chandle.n == 0 else [chandle.tail, chandle.x_final]


def encode_interleaved_emit(chandle: CompactHandle, host: list | None = None) -> bytes:
    """Phase 3: the RansInterleaved blob: K, n, per-lane word counts (count
    + 2), then per lane the final state (hi, lo) and its words. `host`: the
    numpy copies of emit_tensors(chandle), downloaded here when not given."""
    x_final, tail_dev, counts_h, n, K, _ = chandle
    if n == 0:
        return _empty_blob(K)
    tail, x_final = host if host is not None else cs.to_host(emit_tensors(chandle), None)
    tail, x_final = tail.view(np.uint16), x_final.view(np.uint32)
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


def encode_interleaved_finish(handle: ScanHandle) -> bytes:
    return encode_interleaved_emit(encode_interleaved_compact(handle))


def encode_interleaved_dev(bits_dev: torch.Tensor, probs_dev: torch.Tensor,
                           n: int, K: int) -> bytes:
    """Full chunk encode from device-resident bits/probs; byte-identical to
    the host codec (native/rans.h)."""
    return encode_interleaved_finish(encode_interleaved_start(bits_dev, probs_dev, n, K))


def encode_interleaved(bits: np.ndarray, probs: np.ndarray, K: int, *,
                       device="cuda", moved: list | None = None) -> bytes:
    """Full chunk encode of host arrays (bits[n], probs[n] in [1, 32767]) on
    `device`: the stream is padded to T = pow2(ceil(n / K)) steps with
    invalid steps, uploaded as [T, K] planes, scanned by `lane_scan`,
    compacted and assembled; byte-identical to the host codec
    (native/rans.h). `moved`, if given, receives the planes' bytes."""
    n = len(bits)
    if n == 0:
        return _empty_blob(K)
    planes = interleaved_planes(bits, probs, K, device)
    if moved is not None:
        moved.append(sum(t.nbytes for t in planes))
    return encode_interleaved_finish(ScanHandle(*lane_scan(*planes), n, K))


def interleaved_planes(bits: np.ndarray, probs: np.ndarray, K: int, device):
    """encode_interleaved's lane_scan arguments for n > 0 bins: bits, probs
    and the valid mask as [T, K] planes on `device`, T = pow2(ceil(n / K)),
    the steps past n invalid (bit 0, probability 1)."""
    n = len(bits)
    T = _bucket(-(-n // K))
    pad = T * K - n
    planes = [np.concatenate([a.astype(dt), np.full(pad, fill, dt)]).reshape(T, K)
              for a, dt, fill in ((bits, np.int32, 0), (probs, np.int32, 1),
                                  (np.ones(n, bool), bool, False))]
    return tuple(torch.from_numpy(a).to(device) for a in planes)
