"""Device compress path on PyTorch + CUDA: host analysis -> on-card model
pass + rANS lanes -> container.

Counterpart of avrecode_tpu/device.py, for both model profiles and the mesh:

  - profile 2 (frozen batches, the default): the native engine walks the
    syntax and exports one slim (ANL5) chunk at a time; each chunk is packed
    into one fused u32 blob, uploaded, expanded and modelled on the device,
    and lane-encoded there (`to_torch_staged`, `_exec_v4`);
  - profile 0 (immediate increments): native walker threads walk and
    export the dense analysis a few chunks ahead while the caller parses
    chunk i, uploads it, computes its probabilities with the model pass
    chosen by ARTC_MODEL_IMPL (v2, dict, sort or mm), and lane-encodes
    them. Under v2 on the card the chunk goes up once, narrow, and is
    widened there (`_dense_on_card`, ops/dense.py); elsewhere its int32
    planes are built on the host (`device_probs`, `encode_interleaved`);
  - the mesh (`compress_mesh`, profile 2): every chunk is packed with one
    mesh-uniform layout and the whole set runs as one
    parallel.pipeline.sharded_v4_compress_step over a (gop, lane) grid of
    devices.

On the card, a profile-2 `compress` and a `compress_mesh` call are
asynchronous as the JAX package's are (streams.CallStreams): the call's
kernels run on a compute stream of its own, its uploads and downloads on a
copy stream of its own, from and into pinned memory, and each readback
waits only for the buffer it reads. Concurrent calls (the corpus's threads)
then wait on none of each other's work. On "cpu" the same code runs the
plain versions with no streams and no pinning. A profile-0 call on the card
has the same streams for its v2 chunks, which it runs one after the other;
its other chunks keep the caller's stream, as the JAX package runs them
chunk by chunk, each probs readback a synchronise.

The host packs the container. Decompression stays host-only (host.py), so
every container is checked by an independent reader. The parsers live in
analysis.py (re-exported here); every public entry takes an explicit
`device` or mesh.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from . import host
from . import streams as cs
from . import trace
from .analysis import (Analysis, ChunkAnalysis, SlimChunk, _bucket_pow2, _chunk_layout,
                       _sig0_dense, _sig0_sparse_padded, analyze, pick_lanes, read_dense,
                       read_slim)
from .ops import dense
from .ops import lanes as lx
from .ops import model_pass as mp

__all__ = ["Analysis", "ChunkAnalysis", "SlimChunk", "analyze", "compress", "compress_mesh",
           "device_blob", "device_probs", "pick_lanes", "to_torch_staged"]


def _device(device) -> torch.device:
    """The requested device; a CUDA request without a usable card raises
    (the port never falls back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but no CUDA device is available")
    return device


def _build_blob4(an: Analysis, c: SlimChunk, layout: tuple, dk_d: np.ndarray | None = None,
                 dk_s: np.ndarray | None = None, ud_mesh: int | None = None,
                 out: np.ndarray | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Packs one slim chunk's ANL5 planes into the fused u32 blob + scalar
    vector [wa, wb, wcs, n, n_coo] (segments per ops.model_pass
    ._blob_layout_words); a copy of avrecode_tpu.device._build_blob4.
    `layout` may be wider than the chunk's own buckets (the mesh's uniform
    layout); dk_d/dk_s override the chunk's key tables (the mesh pads them
    to uniform shapes with scratch rows), and ud_mesh switches to the
    6-entry mesh scalar vector, which adds the chunk's real dual width.
    `out`, a zeroed uint32 array of the blob's words (a view of pinned
    memory, a row of the mesh's blob), receives the blob in place of a new
    array; the key table segments may hold anything, they are overwritten."""
    n = c.n
    npi, ne, nc, ncc = layout[4:]
    if dk_d is None:
        dk_d, dk_s = c.dk_d, c.dk_s
    ns_l, ud_l = dk_d.shape
    us_l = dk_s.shape[1]
    offs = mp._blob_layout_words(layout, ns_l * an.sup, ns_l, ud_l, us_l)
    blob = np.zeros(offs[-1], np.uint32) if out is None else out

    def put32(k, a):
        blob[offs[k]:offs[k] + len(a)] = a

    def view(k, dtype):
        return blob[offs[k]:offs[k + 1]].view(dtype)

    put32(0, c.hdr_words)
    put32(1, c.a_words)
    put32(2, c.b_words)
    put32(3, c.cs_words)
    view(4, np.uint8)[:n] = c.prior_idx
    pd = view(5, np.uint16)
    pd[:] = 1  # unused dict rows stay neutral
    pd[:len(c.pdict)] = c.pdict
    ei = view(6, np.uint32)
    ei[:] = npi  # pad entries drop in the scatter
    ei[:len(c.esc_idx)] = c.esc_idx
    view(7, np.uint16)[:len(c.esc_val)] = c.esc_val
    view(8, np.uint16)[:len(c.coo_cnt)] = c.coo_cnt
    view(9, np.uint8)[:c.n_coo] = c.coo_nib
    ci = view(10, np.uint32)
    ci[:] = nc  # pad rows drop
    n_cesc = len(c.cesc_idx) if c.cesc_idx is not None else 0
    if n_cesc:
        ci[:n_cesc] = c.cesc_idx
        view(11, np.uint16).reshape(ncc, 2)[:n_cesc] = c.cesc_val
    put32(12, np.ascontiguousarray(dk_d, dtype=np.uint32).reshape(-1))
    put32(13, np.ascontiguousarray(dk_s, dtype=np.uint32).reshape(-1))
    sc = [c.wa, c.wb, c.wcs, n, c.n_coo] + ([c.ud] if ud_mesh is not None else [])
    return blob, np.array(sc, np.int32)


def _dual0_dict(c: SlimChunk) -> tuple[np.ndarray, ...]:
    """The dual0 row dictionary as avrecode_tpu.device._stage_v4 uploads it:
    rows u16[256, 4], idx u8[n_dual], escape indices u32 and rows u16[., 4]
    padded to a power of two (pad indices = n_dual drop).

    The expand kernel finds a block's escapes by searching the list, so the
    live escape indices must be strictly ascending and below n_dual, as the
    native writer emits them (one per row, in row order); a list that is not
    raises here instead of being expanded wrongly."""
    n_dual = len(c.d0_idx)
    live = c.d0_esc_idx.astype(np.int64)
    if len(live) and (live[-1] >= n_dual or np.any(live[1:] <= live[:-1])):
        raise ValueError("dual0 escape indices must be strictly ascending and below "
                         f"n_dual={n_dual}")
    ned = _bucket_pow2(max(len(live), 1))
    ei = np.full(ned, n_dual, np.uint32)
    ei[:len(live)] = c.d0_esc_idx
    ev = np.zeros((ned, 4), np.uint16)
    ev[:len(live)] = c.d0_esc_val
    rows = np.zeros((256, 4), np.uint16)
    rows[:len(c.d0_rows)] = c.d0_rows
    return rows, c.d0_idx, ei, ev


# Wire dtype -> the tensor dtype that carries its bits (torch's unsigned
# 16- and 32-bit types lack most operations).
_WIRE_VIEW = {np.dtype(np.uint32): np.int32, np.dtype(np.int32): np.int32,
              np.dtype(np.uint16): np.int16, np.dtype(np.uint8): np.uint8}


def _wire(a: np.ndarray) -> torch.Tensor:
    """Host array -> tensor of the same width (u32 as int32 and u16 as int16
    bit patterns, u8 as uint8): what the JAX staging ships, byte for byte."""
    return torch.from_numpy(np.ascontiguousarray(a).view(_WIRE_VIEW[a.dtype]))


@dataclass
class StagedChunk:
    """Device-resident inputs of one slim chunk's pass: the fused blob, the
    scalar vector, the expanded dual0 table and the sparse warm sig rows
    (shared tables cached across the chunks that alias them), plus the
    shape parameters the kernels take."""
    blob: torch.Tensor            # int32[total_words] (u32 bit patterns)
    sc: torch.Tensor              # int32[5] = [wa, wb, wcs, n, n_coo]
    dual0: torch.Tensor           # int32[n_dual, 4]
    s_idx: torch.Tensor | None    # int32[k] warm sig rows (u32; pad = n_sig) or None
    s_val: torch.Tensor | None    # int16[k, 2] (u16 bit patterns)
    n: int
    m: int
    layout: tuple                 # (Lh, La, Lb, Lc, npi, ne, nc, ncc)
    statics: dict                 # shape kwargs of wire_expand4_blob / model_pass_v4
    wire_nbytes: int              # bytes uploaded for this chunk (cache misses only)


def to_torch_staged(an: Analysis, chunk: SlimChunk, device, cache: dict | None = None,
                    streams: cs.CallStreams | None = None) -> StagedChunk:
    """Stages one slim chunk on `device` (the port of avrecode_tpu.device
    ._stage_v4): uploads exactly the arrays the JAX staging uploads (fused
    blob, scalar vector, dual0 row dictionary, padded sparse sig0 rows) at
    their wire widths (`_wire`), counts their bytes as it does, and expands
    the dual0 dictionary there.

    With `streams` (a call on the card) the blob is packed straight into
    pinned memory and the small arrays are written into pinned tensors;
    every upload goes on the copy stream without blocking, and the compute
    stream (on which the caller runs) waits on one event after them before
    the dual0 expand and, later, the wire expand. Without, the uploads are
    `.to(device)` on the current stream.

    `cache` (key -> (owner array, tensor)) dedupes the tables that warm
    chunks alias: chunks >= 2 share chunk 1's dual0/sig0 arrays. Each entry
    holds its owner array, which pins the owner's id() for the cache's
    lifetime, so a recycled id can never alias a stale tensor."""
    device = _device(device)
    c = chunk
    ns, ud, us, m, n = c.ns, c.ud, c.us, c.m, c.n
    if m >= 1 << 24:  # the JAX expand's exactness bound; kept for parity
        raise ValueError(f"chunk too large for the ANL5 device path: m={m}")
    wire_nbytes = 0

    def upload(a: np.ndarray, host: torch.Tensor | None = None) -> torch.Tensor:
        """`a` on the device; `host`: its pinned tensor where it was packed
        in one."""
        nonlocal wire_nbytes
        t = _wire(a)
        wire_nbytes += t.nbytes
        if streams is None:
            return t.to(device)
        if host is None:
            host = cs.pinned(t.shape, t.dtype).copy_(t)
        return streams.upload(host)

    def cached(tag: str, owner):
        if cache is not None:
            ent = cache.get((tag, id(owner)))
            if ent is not None and ent[0] is owner:
                return ent[1]
        return None

    def keep(tag: str, owner, v):
        if cache is not None:
            cache[(tag, id(owner))] = (owner, v)
        return v

    layout = _chunk_layout(c)
    blob_host = None
    if streams is not None:
        words = mp._blob_layout_words(layout, ns * an.sup, ns, ud, us)[-1]
        blob_host = cs.pinned(words, torch.int32).zero_()
        blob, sc = _build_blob4(an, c, layout, out=blob_host.numpy().view(np.uint32))
    else:
        blob, sc = _build_blob4(an, c, layout)
    s_idx = s_val = None
    si, sv = _sig0_sparse_padded(c, an.n_sig)
    if si is not None:
        s_idx, s_val = cached("sig0", c.sig0_idx) or keep(
            "sig0", c.sig0_idx, (upload(si), upload(sv)))
    dual0 = cached("dual0x", c.d0_idx)
    d0_dict = None if dual0 is not None else [upload(a) for a in _dual0_dict(c)]
    blob_t = upload(blob, blob_host)
    sc_t = upload(sc)
    if streams is not None:
        streams.uploaded()
    if d0_dict is not None:
        dual0 = keep("dual0x", c.d0_idx, mp.dual0_expand(*d0_dict))
    statics = dict(
        expand=dict(m=int(m), nsub=int(ns * an.sup), U=int(ud + us), ud=int(ud),
                    us=int(us), ns=int(ns), batch=int(an.batch), layout=layout),
        model=dict(batch=int(an.batch), sup=int(an.sup), fast_w=int(an.fast_w),
                   slow_w=int(an.slow_w), sig_w=int(an.sig_w),
                   sig_alpha=int(an.sig_alpha), ud=int(ud), us=int(us),
                   n_sig=int(an.n_sig)))
    return StagedChunk(blob_t, sc_t, dual0, s_idx, s_val, int(n), int(m), layout,
                       statics, wire_nbytes)


def _exec_v4(st: StagedChunk):
    """Runs the wire expand + frozen-batch pass over a staged chunk; returns
    device-resident (probs int32[m], bits int32[m])."""
    bit, kind, slot, prior, deltas, dk_d, dk_s = mp.wire_expand4_blob(
        st.blob, st.sc, **st.statics["expand"])
    return mp.model_pass_v4(bit, kind, slot, prior, dk_d, dk_s, deltas, st.dual0,
                            sig0_idx=st.s_idx, sig0_val=st.s_val, **st.statics["model"])


def _run_v4(an: Analysis, c: SlimChunk, device, cache: dict | None = None):
    """Stage + run one slim chunk; returns (probs int32[m], bits int32[m])."""
    return _exec_v4(to_torch_staged(an, c, device, cache))


def device_probs(an: Analysis, chunk: SlimChunk | ChunkAnalysis, device="cuda",
                 impl: str | None = None, moved: list | None = None) -> np.ndarray:
    """One chunk's model pass on `device` (the card unless the caller asks
    for "cpu"); returns uint16 probs[n]. A slim
    chunk runs the frozen-batch pass; a profile-0 chunk runs the pass that
    `impl` (default ops.model_pass.default_impl()) names: "v2" on the native
    export's tables (built on the host where the export has none), or
    "dict", "sort" or "mm". `moved`, if given, receives a profile-0 pass's
    bytes uploaded and probs' bytes downloaded."""
    if an.slim:
        probs, _ = _run_v4(an, chunk, device)
        return probs[:chunk.n].cpu().numpy().astype(np.uint16)
    device = _device(device)
    impl = impl or mp.default_impl()
    sig0 = _sig0_dense(chunk, an.n_sig)
    if impl == "v2":
        if chunk.v2_bin_u is not None:
            return mp.run_chunk_v2_tables(
                chunk.kind, chunk.prior, chunk.pre_ones, chunk.pre_tot, chunk.v2_m,
                chunk.v2_bin_u, chunk.v2_dk_d, chunk.v2_dk_s, chunk.v2_dd, chunk.v2_ds,
                chunk.dual0, an.batch, an.sup, an.fast_w, an.slow_w, an.sig_w, an.sig_alpha,
                an.n_sig, sig0=sig0, device=device, moved=moved)
        # No native tables: build them on the host, as the JAX package does.
        return mp.run_chunk_v2(chunk.bit, chunk.kind, chunk.key, chunk.prior, chunk.pre_ones,
                               chunk.pre_tot, chunk.dual0, an.batch, mp.default_sup(),
                               an.fast_w, an.slow_w, an.sig_w, an.sig_alpha, an.n_sig,
                               sig0=sig0, device=device, moved=moved)
    return mp.run_chunk(chunk.bit, chunk.kind, chunk.key, chunk.prior, chunk.dual0, an.batch,
                        an.fast_w, an.slow_w, an.sig_w, an.sig_alpha, an.n_sig, impl=impl,
                        sig0=sig0, device=device, moved=moved)


def device_blob(an: Analysis, chunk: SlimChunk | ChunkAnalysis, device="cuda",
                probs: np.ndarray | None = None, force_lanes: int | None = None,
                moved: list | None = None) -> bytes:
    """One chunk's rANS blob on `device`, byte-identical to the C++
    RansInterleaved format. A slim chunk's model pass feeds (probs, bits) to
    the lane scan without leaving the device; a profile-0 chunk encodes its
    host bits with `probs` (computed by device_probs if not given), and
    `moved`, if given, receives the bytes of its lane planes."""
    if an.slim:
        probs_dev, bits_dev = _run_v4(an, chunk, device)
        return lx.encode_interleaved_dev(bits_dev, probs_dev, chunk.n,
                                         force_lanes or pick_lanes(chunk.n))
    if probs is None:
        probs = device_probs(an, chunk, device)
    return lx.encode_interleaved(chunk.bit, probs, force_lanes or pick_lanes(len(chunk.bit)),
                                 device=_device(device), moved=moved)


def compress(data: bytes, lanes: int = 16, chunk_mode: int = 0,
             batch_size: int = 4096, model_profile: int = 2,
             force_lanes: int | None = None, info: dict | None = None, *,
             device="cuda", keep_probs: bool = False) -> tuple[bytes, host.Stats]:
    """Full device-path compression on `device` ("cuda", the default, runs
    the kernels, "cpu" their plain versions); writes the container
    avrecode_tpu.device.compress writes for the same parameters.

    The call is one `call` span tree (trace.py): recorded while the
    recorder is on, and read for `info` and the ARTC_TIMING lines. `info`,
    if given, receives n_chunks, the per-chunk lane blobs, pack_s (host
    seconds of the container pack, `call.pack`) and the profile's phases
    (see _compress_slim / _compress_dense), each from the spans' clock
    readings; with keep_probs also each chunk's probs (uint16[n])."""
    device = _device(device)
    timing = os.environ.get("ARTC_TIMING", "") not in ("", "0")
    with trace.root("call", count=len(data), keep=info is not None or timing) as sc:
        with sc.span("call.open"):
            session = host.Session(data, lanes, chunk_mode, batch_size, model_profile)
        with session:
            try:
                if model_profile == 2:
                    blobs, extra = _compress_slim(session, device, force_lanes, keep_probs, sc,
                                                  timing)
                else:
                    blobs, extra = _compress_dense(session, device, force_lanes, keep_probs, sc)
                with sc.span("call.pack"):
                    result = session.pack(blobs)
            finally:
                if sc.recording:
                    sc.join_native(session.trace())
    if info is not None:
        info.update(extra)
        info.update(_slim_phases(sc) if model_profile == 2 else _dense_phases(sc))
        info["pack_s"] = sc.seconds("call.pack")
        info["blobs"] = blobs
    return result


def _dense_phases(sc) -> dict:
    """Profile 0's info phases from the call's spans."""
    return {"analyze_s": sc.seconds("call.open", "call.begin", "call.header", "chunk.fetch",
                                    "call.parse"),
            "model_s": sc.seconds("chunk.model"), "lanes_s": sc.seconds("chunk.lanes")}


def _slim_phases(sc) -> dict:
    """Profile 2's info phases from the call's spans."""
    header, emit = sc.first("call.header"), sc.first("call.emit")
    out = {"fetch_wait_s": sc.seconds("chunk.fetch", "chunk.take"),
           "parse_s": sc.seconds("chunk.parse"), "stage_s": sc.seconds("chunk.stage"),
           "launch_s": sc.seconds("chunk.launch"), "compact_s": sc.seconds("chunk.compact"),
           "open_s": (header.end_ns - sc.first("call.open").start_ns) / 1e9,
           "dispatch_s": (emit.start_ns - header.end_ns) / 1e9,
           "emit_s": sc.seconds("call.emit", "chunk.emit")}
    out["fetch_s"] = out["fetch_wait_s"] + out["parse_s"]
    return out


def _compress_dense(session, device, force_lanes, keep_probs, sc) -> tuple[list[bytes], dict]:
    """Profile 0: the session's walker threads walk and export the dense
    analysis a few chunks ahead (analysis.read_dense) while this loop takes
    chunk i, parses it, runs its model pass (ARTC_MODEL_IMPL) and its lane
    encode. Returns the blobs and info's other keys. info phases, the
    calling thread's seconds: analyze_s (`call.open`, `call.begin`,
    `call.header`, and per chunk `chunk.fetch`, the wait for the chunk's
    export and its hand-over, and `call.parse`, its parse), model_s (per
    chunk `chunk.model`: its uploads, model pass and, on the host route,
    probs download), lanes_s (per chunk `chunk.lanes`: its lane encode).
    `chunk.model` counts the chunk's bins and (count2) the bytes it moves
    both ways; `chunk.lanes` the chunk's lanes K and (count2) the bytes it
    moves.

    A chunk takes the card route (_dense_on_card) on a CUDA device under
    impl "v2" where its export carries the native tables; every other
    chunk, and every chunk on "cpu", takes the host route:
    device_probs and device_blob, which upload int32 planes built on the
    host and bring the probs back between them."""
    an, chunks = read_dense(session, mp.default_sup(), sc)
    probs, blobs = [], []
    v2 = mp.default_impl() == "v2"
    with cs.for_call(device) as streams:
        for i, c in enumerate(chunks):
            K = force_lanes or pick_lanes(len(c.bit))
            if streams and v2 and c.v2_bin_u is not None and len(c.bit):
                blob, p = _dense_on_card(an, c, i, K, keep_probs, streams, sc)
                blobs.append(blob)
                if keep_probs:
                    probs.append(p)
                continue
            moved: list = []
            with sc.span("chunk.model", chunk=i, count=len(c.bit)) as sp:
                p = device_probs(an, c, device, moved=moved)
                sp.count2 = sum(moved)
            moved = []
            with sc.span("chunk.lanes", chunk=i, count=K) as sp:
                blobs.append(device_blob(an, c, device, probs=p, force_lanes=K, moved=moved))
                sp.count2 = sum(moved)
            if keep_probs:
                probs.append(p)
    extra = {"n_chunks": len(blobs)}
    if keep_probs:
        extra["probs"] = probs
    return blobs, extra


def _dense_on_card(an, c: ChunkAnalysis, i: int, K: int, keep_probs: bool,
                   streams: cs.CallStreams, sc) -> tuple[bytes, np.ndarray | None]:
    """One profile-0 chunk with native tables on the card (ops.dense): in
    `chunk.model` its narrow blob is packed into the call's pinned staging
    bytes and uploaded on the copy stream, widened and padded there
    (dense.expand) and run through model_pass_v2 on the compute stream; in
    `chunk.lanes` the lane planes are written from the blob and the probs
    on the card (dense.lane_planes), lane-scanned, the counts read back
    through pinned memory, compacted and downloaded with the final states
    (and the probs, under keep_probs). count2: the blob's bytes, then the
    counts' and the download's. Returns the blob and the uint16 probs (or
    None)."""
    n = len(c.bit)
    lay = dense.chunk_layout(an, c)
    with torch.cuda.stream(streams.compute):
        with sc.span("chunk.model", chunk=i, count=n) as sp:
            blob = streams.upload_staged(lay.nbytes, lambda buf: dense.pack(c, lay, buf))
            streams.uploaded()
            probs = mp.model_pass_v2(*dense.expand(blob, lay), batch=int(an.batch),
                                     sup=int(an.sup), fast_w=int(an.fast_w),
                                     slow_w=int(an.slow_w), sig_w=int(an.sig_w),
                                     sig_alpha=int(an.sig_alpha))
            sp.count2 = lay.nbytes
        with sc.span("chunk.lanes", chunk=i, count=K) as sp:
            T = lx._bucket(-(-n // K))
            scan = lx.lane_scan(*dense.lane_planes(blob, probs, lay, T, K))
            ch = lx.encode_interleaved_compact(
                lx.ScanHandle(*scan, n, K, streams.compute.record_event()), streams)
            arrays = cs.to_host(lx.emit_tensors(ch) + ([probs[:n]] if keep_probs else []),
                                streams)
            out = lx.encode_interleaved_emit(ch, arrays[:2])
            sp.count2 = ch.counts.nbytes + sum(a.nbytes for a in arrays)
    return out, (arrays[2].astype(np.uint16) if keep_probs else None)


def _compress_slim(session, device, force_lanes, keep_probs, sc,
                   timing) -> tuple[list[bytes], dict]:
    """Profile 2: the native session's workers walk and export chunks while
    the loop fetches chunk i, stages it and launches its expand, model pass
    and lane scan (no readback), then reads chunk i-1's lane counts and
    launches its compaction; the bulk downloads come last, one wait for all.
    On the card the loop runs on the call's own streams (streams
    .CallStreams): uploads and downloads on the copy stream through pinned
    memory, the kernels on the compute stream, and chunk i-1's counts
    readback waits for its own lane scan only. Returns the blobs and info's
    keys other than the phases.

    info phases, each the seconds of its spans: open_s (from `call.open`'s
    start to `call.header`'s end: the session open and the start of the
    native analysis), fetch_s (the sum of fetch_wait_s, `chunk.fetch` and
    `chunk.take`: the time in the native fetch, host.Session.chunk, and the
    export's copy into bytes, and parse_s, `chunk.parse`), stage_s (`chunk.stage`:
    blob packing and uploads), launch_s (`chunk.launch`: kernel launches),
    compact_s (`chunk.compact`: the counts readback, which waits for the
    lane scan, and the compaction launch), dispatch_s (the whole chunk
    loop), emit_s (`call.emit` and `chunk.emit`: downloads and blob
    assembly). Other keys: wire_bytes (host->device bytes, cached shared
    tables once), n_chunks, and on the card, per chunk, scan_end_ms and
    counts_ready_ms: when its lane scan ended and when its counts' copy
    ended, in ms from an event recorded before the loop (CUDA events).

    With `timing` (ARTC_TIMING set, not "0") it prints the JAX package's
    lines, in its order and format, from the spans' readings: per chunk
    fetch+dispatch with its MiB of wire, the previous chunk's compaction,
    each emit, and the wire total."""
    an, chunks = read_slim(session, mp.default_sup(), sc)
    cache: dict = {}
    handles: list = []
    compacted: list = []
    kept: list = []
    wire_bytes = 0

    with cs.for_call(device) as streams, torch.cuda.stream(streams and streams.compute):
        origin = None
        if streams is not None:
            origin = torch.cuda.Event(enable_timing=True)
            origin.record(streams.compute)
        for i, (fetch, c) in enumerate(chunks):
            with sc.span("chunk.stage", chunk=i) as stage:
                st = to_torch_staged(an, c, device, cache, streams)
                stage.count = st.wire_nbytes
            wire_bytes += st.wire_nbytes
            with sc.span("chunk.launch", chunk=i) as launch:
                probs, bits = _exec_v4(st)
                if keep_probs:
                    kept.append(probs[:c.n])
                handles.append(lx.encode_interleaved_start(
                    bits, probs, c.n, force_lanes or pick_lanes(c.n), streams))
            if timing:
                print(f"[artc] device chunk {i}: fetch+dispatch "
                      f"{(launch.end_ns - fetch.start_ns) / 1e9:.3f}s "
                      f"({st.wire_nbytes >> 20} MiB wire)", flush=True)
            if i > 0:
                with sc.span("chunk.compact", chunk=i - 1) as compact:
                    compacted.append(lx.encode_interleaved_compact(handles[i - 1], streams))
                if timing:
                    print(f"[artc] device chunk {i - 1}: compact {compact.seconds:.3f}s",
                          flush=True)
        if handles:
            with sc.span("chunk.compact", chunk=len(handles) - 1):
                compacted.append(lx.encode_interleaved_compact(handles[-1], streams))
        with sc.span("call.emit"):
            parts = [lx.emit_tensors(ch) for ch in compacted]
            arrays = cs.to_host([t for p in parts for t in p] + kept, streams)
    blobs = []
    for i, (ch, p) in enumerate(zip(compacted, parts)):
        with sc.span("chunk.emit", chunk=i) as emit:
            blobs.append(lx.encode_interleaved_emit(ch, arrays[:len(p)]))
        arrays = arrays[len(p):]
        if timing:
            print(f"[artc] device chunk {i}: emit {emit.seconds:.3f}s", flush=True)
    if timing:
        print(f"[artc] device wire total {wire_bytes / 1e6:.1f} MB", flush=True)
    extra = {"wire_bytes": wire_bytes, "n_chunks": len(handles)}
    if keep_probs:
        extra["probs"] = [a.astype(np.uint16) for a in arrays]
    if streams is not None:
        extra["scan_end_ms"] = [origin.elapsed_time(hd.scanned) if hd.scanned else None
                                for hd in handles]
        extra["counts_ready_ms"] = [origin.elapsed_time(ch.ready) if ch.ready else None
                                    for ch in compacted]
    return blobs, extra


@dataclass
class MeshInputs:
    """One mesh step's inputs: every chunk packed with the mesh-uniform
    layout, padded to a multiple of the gop axis (host tensors at the JAX
    package's widths; G = padded chunk count), plus the uniform shapes the
    step is built for."""
    blob: torch.Tensor      # int32[G, W] fused ANL5 planes (u32 bit patterns)
    sc: torch.Tensor        # int32[G, 6] = [wa, wb, wcs, n, n_coo, ud_real]
    dual0: torch.Tensor     # int16[G, n_dual, 4] (u16 bit patterns)
    sig0_idx: torch.Tensor  # int32[G, SK] sparse warm sig rows (u32; pad = n_sig, drops)
    sig0_val: torch.Tensor  # int16[G, SK, 2] (u16 bit patterns)
    n_arr: torch.Tensor     # int32[G] live bins per chunk
    statics: dict           # kwargs of parallel.pipeline.sharded_v4_compress_step

    def tensors(self) -> tuple:
        return self.blob, self.sc, self.dual0, self.sig0_idx, self.sig0_val, self.n_arr


def _host_array(shape, dtype, fill, pin: bool) -> tuple[np.ndarray, torch.Tensor]:
    """A host array of `dtype` filled with `fill`, and the tensor that
    carries it at its wire width (`_wire`): with `pin` the array is a view of
    a pinned tensor's memory."""
    if not pin:
        a = np.full(shape, fill, dtype)
        return a, _wire(a)
    t = cs.pinned(shape, _wire(np.empty(0, dtype)).dtype)
    a = t.numpy().view(dtype)
    a[...] = fill
    return a, t


def mesh_inputs(an: Analysis, chunks: list[SlimChunk], n_gop: int, sup: int,
                force_lanes: int | None = None, pin: bool = False) -> MeshInputs:
    """Packs the chunks for one sharded_v4_compress_step, as
    avrecode_tpu.device.compress_mesh does (device.py:941-993), at its
    widths (dual0 u16): the layout is the elementwise max of the chunks'
    own, dk/ds key tables are padded to the widest chunk's (UD, US, NS) with
    distinct scratch keys, and pad chunks (up to a multiple of n_gop) carry
    live, distinct scratch keys too: the model kernel's sorted-unique row
    scatter writes each row from one slot, so rows of zeros would race on
    row 0. With `pin` every array is packed in pinned memory (a call on the
    card uploads from there without blocking)."""
    G = len(chunks)
    G_pad = -(-G // n_gop) * n_gop
    UD = max(c.ud for c in chunks)
    US = max(c.us for c in chunks)
    NS = max(c.ns for c in chunks)
    M = NS * sup * an.batch
    if M >= 1 << 24:  # the JAX expand's exactness bound (_div_floor2); kept for parity
        raise ValueError(f"mesh chunks too large for the ANL5 device path: M={M}")
    K = force_lanes or pick_lanes(max(c.n for c in chunks))
    layout = tuple(max(col) for col in zip(*(_chunk_layout(c) for c in chunks)))
    # Scratch keys per column, distinct within a row; a chunk's own pad keys
    # occupy [n_dual + 1, n_dual + 1 + ud), so the column fill cannot collide.
    dk_d0 = an.n_dual + 1 + np.arange(UD, dtype=np.uint32)
    dk_s0 = an.n_sig + np.arange(US, dtype=np.uint32)
    offs = mp._blob_layout_words(layout, NS * sup, NS, UD, US)
    SK = _bucket_pow2(max(max(len(c.sig0_idx) if c.sig0_idx is not None else 0
                              for c in chunks), 1))
    blob, blob_t = _host_array((G_pad, offs[-1]), np.uint32, 0, pin)
    sc, sc_t = _host_array((G_pad, 6), np.int32, 0, pin)
    dual0, dual0_t = _host_array((G_pad, an.n_dual, 4), np.uint16, 1, pin)
    n_arr, n_t = _host_array(G_pad, np.int32, 0, pin)
    sig0_idx, si_t = _host_array((G_pad, SK), np.uint32, an.n_sig, pin)
    sig0_val, sv_t = _host_array((G_pad, SK, 2), np.uint16, 0, pin)
    blob[:, offs[12]:offs[13]] = np.tile(dk_d0, NS)
    blob[:, offs[13]:offs[14]] = np.tile(dk_s0, NS)
    sc[:, 5] = UD  # pad chunks: no slot shift
    for g, c in enumerate(chunks):
        dk_d = np.tile(dk_d0, (NS, 1))
        dk_s = np.tile(dk_s0, (NS, 1))
        dk_d[:c.ns, :c.ud] = c.dk_d
        dk_s[:c.ns, :c.us] = c.dk_s
        _, sc[g] = _build_blob4(an, c, layout, dk_d=dk_d, dk_s=dk_s, ud_mesh=UD, out=blob[g])
        dual0[g] = c.dual0
        n_arr[g] = c.n
        if c.sig0_idx is not None and len(c.sig0_idx):
            sig0_idx[g, :len(c.sig0_idx)] = c.sig0_idx
            sig0_val[g, :len(c.sig0_idx)] = c.sig0_val
    statics = dict(batch=int(an.batch), sup=int(sup), fast_w=int(an.fast_w),
                   slow_w=int(an.slow_w), sig_w=int(an.sig_w), sig_alpha=int(an.sig_alpha),
                   ud=int(UD), us=int(US), ns=int(NS), n_sig=int(an.n_sig), K_total=int(K),
                   layout=layout)
    return MeshInputs(blob_t, sc_t, dual0_t, si_t, sv_t, n_t, statics)


def compress_mesh(data: bytes, mesh, lanes: int = 16, chunk_mode: int = 1,
                  batch_size: int = 4096, sup: int = 0,
                  force_lanes: int | None = None,
                  info: dict | None = None) -> tuple[bytes, host.Stats]:
    """Mesh-sharded device compression of a clip into a container (the port
    of avrecode_tpu.device.compress_mesh): the native session exports every
    slim chunk (GOP chunks under chunk_mode=1), mesh_inputs packs them with
    one mesh-uniform layout, and one parallel.pipeline.sharded_v4_compress_step
    over `mesh` (parallel.mesh.make_mesh) expands and models each device
    row's chunks and lane-scans each cell's lane slice. The lane outputs
    reassemble into RansInterleaved blobs, and the session packs the same
    container the single-device path writes where every chunk picks the
    same lanes (the mesh gives every chunk of the file one K, pick_lanes of
    the largest chunk, or force_lanes), which the host decoder reads back.

    Where the mesh's first device is a card, the call has its own streams
    (streams.CallStreams): the inputs are packed in pinned memory, which the
    cells upload from without blocking, the step runs on the compute stream,
    and its outputs (3 bytes a (step, lane) slot) come back into pinned
    memory on the copy stream with one wait.

    The call is one `call` span tree (trace.py), as `compress`'s: `call.open`,
    the walk of every chunk (analysis.read_slim), then `mesh.pack`
    (mesh_inputs; counts the step's host-input bytes and, count2, the
    chunks), `mesh.step` (building the step and issuing every cell's
    launches; counts K), `mesh.fetch` (the one download and its wait;
    counts the bytes downloaded), `mesh.assemble` (every chunk's blob) and
    `call.pack`. `info`, if given, receives from those spans walk_s
    (`call.open`, `call.begin`, `call.header` and every chunk's
    `chunk.fetch`, `chunk.take`, `chunk.parse`), pack_s (`mesh.pack`),
    step_s (`mesh.step` and `mesh.fetch`), emit_s (`mesh.assemble` and
    `call.pack`), upload_bytes (`mesh.pack`'s count) and n_chunks."""
    from .parallel.pipeline import sharded_v4_compress_step
    if sup <= 0:
        sup = mp.default_sup()
    first = mesh.devices[0][0]
    with trace.root("call", count=len(data), keep=info is not None) as sc:
        with sc.span("call.open"):
            session = host.Session(data, lanes, chunk_mode, batch_size, 2)
        with session:
            try:
                an, stream = read_slim(session, sup, sc)
                chunks = [c for _, c in stream]
                with sc.span("mesh.pack", count2=len(chunks)) as pack:
                    inputs = mesh_inputs(an, chunks, mesh.shape["gop"], sup, force_lanes,
                                         pin=first.type == "cuda")
                    pack.count = sum(t.nbytes for t in inputs.tensors())
                K = inputs.statics["K_total"]
                with cs.for_call(first) as streams, torch.cuda.stream(streams and streams.compute):
                    with sc.span("mesh.step", count=K):
                        step = sharded_v4_compress_step(mesh, **inputs.statics)
                        x_final, words, emits, _, total_words = step(*inputs.tensors())
                    with sc.span("mesh.fetch") as fetch:
                        outs = cs.to_host([x_final, words, emits, total_words], streams)
                        fetch.count = sum(a.nbytes for a in outs)
                x_final, words, emits, total_words = outs
                if int(total_words) <= 0:
                    raise RuntimeError("mesh step emitted no payload words")
                with sc.span("mesh.assemble"):
                    blobs = [lx.assemble_blob(x_final[g], words[g], emits[g], c.n, K)
                             for g, c in enumerate(chunks)]
                with sc.span("call.pack"):
                    result = session.pack(blobs)
            finally:
                if sc.recording:
                    sc.join_native(session.trace())
    if info is not None:
        info.update(walk_s=sc.seconds("call.open", "call.begin", "call.header", "chunk.fetch",
                                      "chunk.take", "chunk.parse"),
                    pack_s=sc.seconds("mesh.pack"),
                    step_s=sc.seconds("mesh.step", "mesh.fetch"),
                    emit_s=sc.seconds("mesh.assemble", "call.pack"),
                    upload_bytes=sc.first("mesh.pack").count, n_chunks=len(chunks))
    return result
