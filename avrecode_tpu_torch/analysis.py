"""Host analysis: the native session's exports parsed into numpy chunks, and
the blob layout buckets of the profile-2 wire.

A copy of the JAX-free parsers of avrecode_tpu/device.py (ChunkAnalysis,
SlimChunk, Analysis, analyze, the ANLZ/ANL5 parsers, the layout buckets and
pick_lanes), under the same names, so the port imports nothing of the JAX
package, and the two streaming chunk loops over a session, read_slim and
read_dense. The wire formats are recode.cc's write_analyze_header, the slim
export's write_slim_chunk (native/slim_export.h) and the dense analysis
export's write_dense_chunk (native/dense_export.h).
"""
from __future__ import annotations

from collections.abc import Iterator
from dataclasses import dataclass

import numpy as np

from . import host


@dataclass
class ChunkAnalysis:
    bit: np.ndarray    # uint8[n]
    kind: np.ndarray   # uint8[n]
    key: np.ndarray    # uint32[n]
    prior: np.ndarray  # uint16[n]
    pre_ones: np.ndarray  # uint16[n] — within-batch per-key exclusive 1-count
    pre_tot: np.ndarray   # uint16[n] — within-batch per-key exclusive total
    host_probs: np.ndarray  # uint16[n] — C++ reference, for differential tests
    dual0: np.ndarray  # int32[n_dual, 4]
    # model_pass_v2 tables (C++-precomputed; see recode.cc artc_analyze)
    v2_m: int = 0                      # padded stream length (ns * sup * batch)
    v2_bin_u: np.ndarray | None = None   # uint32[m]
    v2_dk_d: np.ndarray | None = None    # int32[ns, ud]
    v2_dk_s: np.ndarray | None = None    # int32[ns, us]
    v2_dd: np.ndarray | None = None      # int32[ns, sup, ud, 2]
    v2_ds: np.ndarray | None = None      # int32[ns, sup, us, 2]
    # sparse sig start state (v16 warm-started chunks; empty = cold zeros)
    sig0_idx: np.ndarray | None = None  # uint32[k]
    sig0_val: np.ndarray | None = None  # int32[k, 2]


def _np_unpack(words: np.ndarray, pos: np.ndarray, w: int) -> np.ndarray:
    """Host-side mirror of ops.model_pass._unpack: w-bit no-straddle
    entries out of a u32 word stream (native/slim_export.h — entry j lives
    wholly inside word j // (32//w))."""
    epw = 32 // w
    q = pos.astype(np.int64) // epw
    off = ((pos.astype(np.int64) - q * epw) * w).astype(np.uint64)
    wd = words.astype(np.uint64)
    return (wd[q] >> off) & np.uint64((1 << w) - 1)


@dataclass
class SlimChunk:
    """One chunk of the slim (ANL5) analysis export — the bit-packed ~2.3-
    bytes/bin wire format for the frozen-batch (profile 2) device path. See
    native/slim_export.h, which writes it, for the layout. The packed planes
    travel to the device verbatim (wire_expand4_blob unpacks them on chip); `.packed`,
    `.coo_slot` and `.dual0` reconstruct the dense views for host-side
    consumers (tests, the mesh dual0 input)."""
    n: int
    ns: int
    ud: int
    us: int
    m: int
    batch: int             # sub-batch size (for the .packed reconstruction)
    pdict: np.ndarray      # uint16[<=255] prior dictionary
    esc_idx: np.ndarray    # uint32[n_esc]
    esc_val: np.ndarray    # uint16[n_esc]
    wa: int                # hot rank width (bits)
    wb: int                # cold rank width (bits)
    wcs: int               # COO slot width (bits)
    hdr_words: np.ndarray  # uint32[] 4-bit nibbles: bit<<3 | kind<<1 | cls
    a_words: np.ndarray    # uint32[] wa-bit hot ranks (nA entries)
    b_words: np.ndarray    # uint32[] wb-bit cold ranks (nB entries)
    nA: int
    nB: int
    prior_idx: np.ndarray  # uint8[n]   (255 = escape)
    dk_d: np.ndarray       # uint32[ns, ud]
    dk_s: np.ndarray       # uint32[ns, us]
    # dual0 row dictionary (ANL5): rows u16[nd, 4], u8 index per table row
    # (255 = escape), exact escape rows. Chunks >= 2 alias chunk 1's.
    d0_rows: np.ndarray    # uint16[nd, 4]
    d0_idx: np.ndarray     # uint8[n_dual]
    d0_esc_idx: np.ndarray  # uint32[j]
    d0_esc_val: np.ndarray  # uint16[j, 4]
    coo_cnt: np.ndarray    # uint16[ns*sup]
    n_coo: int
    cs_words: np.ndarray   # uint32[] wcs-bit COO slots (freq-ordered runs)
    coo_nib: np.ndarray    # uint8[n_coo]: min(ones,15) | min(tot,15)<<4
    host_probs: np.ndarray | None  # uint16[n] (differential testing only)
    # sparse sig start state (v16 warm-started chunks; empty = cold zeros)
    sig0_idx: np.ndarray | None = None  # uint32[k]
    sig0_val: np.ndarray | None = None  # uint16[k, 2]
    # COO escape list: entries whose (ones, tot) exceeded the nibble
    cesc_idx: np.ndarray | None = None  # uint32[j]
    cesc_val: np.ndarray | None = None  # uint16[j, 2]
    dual0_inline: bool = True  # False = aliases the previous chunk's tables
    sig0_inline: bool = True

    @property
    def dual0(self) -> np.ndarray:
        """Dense uint16[n_dual, 4] dual table (host-side dict expand, cached;
        the device path expands the dict form on chip instead)."""
        v = getattr(self, "_dual0", None)
        if v is None:
            v = self.d0_rows[np.minimum(self.d0_idx, len(self.d0_rows) - 1)]
            if len(self.d0_esc_idx):
                v[self.d0_esc_idx.astype(np.int64)] = self.d0_esc_val
            object.__setattr__(self, "_dual0", v)
        return v

    @property
    def coo_slot(self) -> np.ndarray:
        """Dense uint16[n_coo] COO slots (host-side unpack, cached)."""
        v = getattr(self, "_coo_slot", None)
        if v is None:
            v = _np_unpack(self.cs_words, np.arange(self.n_coo), self.wcs
                           ).astype(np.uint16)
            object.__setattr__(self, "_coo_slot", v)
        return v

    @property
    def packed(self) -> np.ndarray:
        """Dense uint16[n] bit<<15 | kind<<13 | slot (host-side unpack of the
        nibble + rank planes, cached) — the pre-v4 wire word, for host-side
        consumers."""
        v = getattr(self, "_packed", None)
        if v is not None:
            return v
        i = np.arange(self.n, dtype=np.int64)
        hdr = _np_unpack(self.hdr_words, i, 4).astype(np.int64)
        bit = hdr >> 3
        kind = (hdr >> 1) & 3
        cls = hdr & 1
        live = kind != 3
        a_sel = live & (cls == 0)
        b_sel = live & (cls == 1)
        pos_a = np.cumsum(a_sel) - a_sel
        pos_b = np.cumsum(b_sel) - b_sel
        rank = np.where(
            cls == 1, _np_unpack(self.b_words, pos_b, self.wb).astype(np.int64),
            _np_unpack(self.a_words, pos_a, self.wa).astype(np.int64))
        cs = self.coo_slot.astype(np.int64)
        cnts = self.coo_cnt.astype(np.int64)
        starts = np.cumsum(cnts) - cnts
        sub = i // self.batch
        if len(cs):
            sidx = np.clip(starts[sub] + rank, 0, len(cs) - 1)
            slot = np.where(live, cs[sidx], self.ud - 1)
        else:
            slot = np.full(self.n, self.ud - 1, np.int64)
        v = ((bit << 15) | (kind << 13) | slot).astype(np.uint16)
        object.__setattr__(self, "_packed", v)
        return v


@dataclass
class Analysis:
    chunks: list[ChunkAnalysis] | list[SlimChunk]
    lanes: int
    batch: int
    n_dual: int
    n_sig: int
    fast_w: int
    slow_w: int
    sig_w: int
    sig_alpha: int
    profile: int = 0
    sup: int = 16
    slim: bool = False


def analyze(data: bytes, lanes: int = 16, chunk_mode: int = 0, batch_size: int = 1,
            model_profile: int = 0, sup: int = 0, slim: bool | None = None,
            want_probs: bool = True) -> Analysis:
    """Runs the host syntax walk and exports the device model-pass inputs.

    slim (default: model_profile == 2) selects the ANL5 slim wire format
    (frozen-batch semantics); want_probs additionally exports the
    host-computed probabilities for differential testing. sup <= 0 takes
    ops.model_pass.default_sup()."""
    from .ops import model_pass as mp
    if sup <= 0:
        sup = mp.default_sup()
    if slim is None:
        slim = model_profile == 2
    flags = (1 if slim else 0) | (2 if (slim and want_probs) else 0)
    with host.Session(data, lanes, chunk_mode, batch_size, model_profile) as session:
        raw = session.analyze(sup, flags).take()
    return _parse_analysis(raw)


def read_slim(session: host.Session, sup: int, sc) -> tuple[Analysis, Iterator]:
    """Starts a session's slim analysis (`call.begin`), parses its header
    (`call.header`) and returns it with a generator that yields, chunk by
    chunk, (the `chunk.fetch` span, the SlimChunk): the native fetch, the copy
    and free (`chunk.take`) and the parse (`chunk.parse`). `sc`: a
    trace.Scope, or trace.NULL."""
    with sc.span("call.begin"):
        n_chunks = session.begin(sup, 0)
    with sc.span("call.header"):
        an, _ = _parse_header(session.header())

    def chunks():
        prev = None
        for i in range(n_chunks):
            with sc.span("chunk.fetch", chunk=i) as fetch:
                export = session.chunk(i)
            with sc.span("chunk.take", chunk=i):
                raw = export.take()
            with sc.span("chunk.parse", chunk=i):
                prev = _parse_slim_chunk(np.frombuffer(raw, np.uint8), an, prev)
            yield fetch, prev
    return an, chunks()


def read_dense(session: host.Session, sup: int, sc) -> tuple[Analysis, Iterator]:
    """Starts a session's dense analysis (`call.begin`: its walker threads
    walk and export chunks, claimed in order, a few ahead of the ones
    taken), parses its header (`call.header`)
    and returns it with a generator that yields, chunk by chunk, the
    ChunkAnalysis: the native hand-over (`chunk.fetch`, around the native
    `native.rendezvous` and `native.copyout`) and the parse, read in place
    and freed (`call.parse`). `sc`: a trace.Scope, or trace.NULL."""
    with sc.span("call.begin"):
        n_chunks = session.begin(sup, host.DENSE)
    with sc.span("call.header"):
        an, _ = _parse_header(session.header())

    def parse(raw) -> ChunkAnalysis:
        return _parse_dense_chunk(np.frombuffer(raw, np.uint8), an)[0]

    def chunks():
        for i in range(n_chunks):
            with sc.span("chunk.fetch", chunk=i):
                export = session.chunk(i)
            with sc.span("call.parse", chunk=i):
                c = export.read(parse)
            yield c
    return an, chunks()


_HDR_BYTES = 48  # magic + 11 u32 header fields


def _parse_header(raw: bytes) -> tuple[Analysis, int]:
    """Parses the shared analysis header (recode.cc write_analyze_header) into
    an empty Analysis + the chunk count."""
    hdr = np.frombuffer(raw[:_HDR_BYTES], dtype=np.uint32)
    magic = int(hdr[0])
    if magic not in (0x5A4C4E41, 0x354C4E41):  # 'ANLZ' | 'ANL5'
        raise ValueError(f"not an analysis export: magic {magic:#x}")
    slim = magic == 0x354C4E41
    (n_chunks, lanes_out, batch, profile, n_dual, n_sig, fast_w, slow_w,
     sig_w, sig_alpha, sup_out) = (int(x) for x in hdr[1:12])
    an = Analysis([], lanes_out, batch, n_dual, n_sig, fast_w, slow_w,
                  sig_w, sig_alpha, profile, sup_out, slim=slim)
    return an, n_chunks


def _parse_analysis(raw: bytes) -> Analysis:
    buf = np.frombuffer(raw, dtype=np.uint8)
    an, n_chunks = _parse_header(raw)
    pos = _HDR_BYTES
    chunks = an.chunks
    if an.slim:
        prev = None
        while pos < len(buf) and len(chunks) < n_chunks:
            c = _parse_slim_chunk(buf[pos:], an, prev)
            pos += c._raw_len
            chunks.append(c)
            prev = c
        if len(chunks) != n_chunks:
            raise ValueError(f"analysis export holds {len(chunks)} of {n_chunks} chunks")
        return an
    for _ in range(n_chunks):
        c, length = _parse_dense_chunk(buf[pos:], an)
        pos += length
        chunks.append(c)
    return an


def _parse_dense_chunk(buf: np.ndarray, an: Analysis) -> tuple[ChunkAnalysis, int]:
    """Parses the ANLZ chunk at the start of `buf` (native/dense_export.h's
    layout) into arrays of its own, none a view of `buf`; returns it and its
    length in bytes."""
    pos = 0

    def scalar(dtype):
        nonlocal pos
        size = np.dtype(dtype).itemsize
        v = int(buf[pos:pos + size].view(dtype)[0])
        pos += size
        return v

    def arr(dtype, count, widen=None):
        nonlocal pos
        nbytes = np.dtype(dtype).itemsize * count
        v = buf[pos:pos + nbytes].view(dtype)
        pos += nbytes
        return v.copy() if widen is None else v.astype(widen)

    n_dual, sup = an.n_dual, an.sup
    n = scalar(np.uint64)
    bit = arr(np.uint8, n)
    kind = arr(np.uint8, n)
    key = arr(np.uint32, n)
    prior = arr(np.uint16, n)
    pre_ones = arr(np.uint16, n)
    pre_tot = arr(np.uint16, n)
    probs = arr(np.uint16, n)
    dual0 = arr(np.uint16, 4 * n_dual, np.int32).reshape(n_dual, 4)
    n_sig_nz = scalar(np.uint32)
    sig0_idx = arr(np.uint32, n_sig_nz)
    sig0_pos = arr(np.uint16, n_sig_nz)
    sig0_neg = arr(np.uint16, n_sig_nz)
    ns = scalar(np.uint32)
    ud = scalar(np.uint32)
    us = scalar(np.uint32)
    m = scalar(np.uint64)
    bin_u = arr(np.uint32, m)
    dk_d = arr(np.uint32, ns * ud, np.int32).reshape(ns, ud)
    dk_s = arr(np.uint32, ns * us, np.int32).reshape(ns, us)
    dd = arr(np.uint16, ns * sup * ud * 2, np.int32).reshape(ns, sup, ud, 2)
    ds = arr(np.uint16, ns * sup * us * 2, np.int32).reshape(ns, sup, us, 2)
    c = ChunkAnalysis(bit, kind, key, prior, pre_ones, pre_tot, probs, dual0, m, bin_u, dk_d,
                      dk_s, dd, ds, sig0_idx=sig0_idx,
                      sig0_val=np.stack([sig0_pos, sig0_neg], axis=1).astype(np.int32))
    return c, pos


def _parse_slim_chunk(buf: np.ndarray, an: Analysis, prev: SlimChunk | None) -> SlimChunk:
    """Parses one ANL5 chunk (the write_slim_chunk layout). `prev` is
    the previously parsed chunk — warm chunks >= 2 alias its dual0/sig0
    instead of carrying their own (flags bits 1/2)."""
    pos = 0

    def u8():
        nonlocal pos
        v = int(buf[pos])
        pos += 1
        return v

    def u16():
        nonlocal pos
        v = int(buf[pos:pos + 2].view(np.uint16)[0])
        pos += 2
        return v

    def u32():
        nonlocal pos
        v = int(buf[pos:pos + 4].view(np.uint32)[0])
        pos += 4
        return v

    def u64():
        nonlocal pos
        v = int(buf[pos:pos + 8].view(np.uint64)[0])
        pos += 8
        return v

    def arr(dtype, count):
        nonlocal pos
        nbytes = np.dtype(dtype).itemsize * count
        v = buf[pos:pos + nbytes].view(dtype).copy()
        pos += nbytes
        return v

    n = u64()
    ns = u32()
    ud = u32()
    us = u32()
    m = u64()
    flags = u8()
    ndict = u16()
    pdict = arr(np.uint16, ndict)
    n_esc = u32()
    esc_idx = arr(np.uint32, n_esc)
    esc_val = arr(np.uint16, n_esc)
    wa = u8()
    wb = u8()
    wcs = u8()
    nw_hdr = u64()
    hdr_words = arr(np.uint32, nw_hdr)
    nA = u64()
    nwA = u64()
    a_words = arr(np.uint32, nwA)
    nB = u64()
    nwB = u64()
    b_words = arr(np.uint32, nwB)
    prior_idx = arr(np.uint8, n)
    dk_d = arr(np.uint32, ns * ud).reshape(ns, ud)
    dk_s = arr(np.uint32, ns * us).reshape(ns, us)
    dual0_inline = not (flags & 2)
    if dual0_inline:
        nd = u16()
        d0_rows = arr(np.uint16, 4 * nd).reshape(nd, 4)
        d0_idx = arr(np.uint8, an.n_dual)
        ndesc = u32()
        d0_esc_idx = arr(np.uint32, ndesc)
        d0_esc_val = arr(np.uint16, 4 * ndesc).reshape(ndesc, 4)
    else:
        if prev is None:
            raise ValueError("shared dual0 with no previous chunk")
        d0_rows, d0_idx = prev.d0_rows, prev.d0_idx
        d0_esc_idx, d0_esc_val = prev.d0_esc_idx, prev.d0_esc_val
    sig0_inline = not (flags & 4)
    if sig0_inline:
        n_sig_nz = u32()
        sig0_idx = arr(np.uint32, n_sig_nz)
        sig0_pos = arr(np.uint16, n_sig_nz)
        sig0_neg = arr(np.uint16, n_sig_nz)
        sig0_val = np.stack([sig0_pos, sig0_neg], axis=1)
    else:
        if prev is None:
            raise ValueError("shared sig0 with no previous chunk")
        sig0_idx, sig0_val = prev.sig0_idx, prev.sig0_val
    n_coo = u64()
    coo_cnt = arr(np.uint16, ns * an.sup)
    nw_cs = u64()
    cs_words = arr(np.uint32, nw_cs)
    coo_nib = arr(np.uint8, n_coo)
    n_cesc = u32()
    cesc_idx = arr(np.uint32, n_cesc)
    cesc_ones = arr(np.uint16, n_cesc)
    cesc_tot = arr(np.uint16, n_cesc)
    probs = arr(np.uint16, n) if flags & 1 else None
    c = SlimChunk(int(n), ns, ud, us, int(m), an.batch, pdict, esc_idx, esc_val,
                  wa, wb, wcs, hdr_words, a_words, b_words, int(nA), int(nB),
                  prior_idx, dk_d, dk_s, d0_rows, d0_idx, d0_esc_idx, d0_esc_val,
                  coo_cnt, int(n_coo), cs_words, coo_nib, probs,
                  sig0_idx=sig0_idx, sig0_val=sig0_val,
                  cesc_idx=cesc_idx,
                  cesc_val=np.stack([cesc_ones, cesc_tot], axis=1),
                  dual0_inline=dual0_inline, sig0_inline=sig0_inline)
    object.__setattr__(c, "_raw_len", pos)
    return c


def _bucket_pow2(x: int, lo: int = 16) -> int:
    b = lo
    while b < x:
        b *= 2
    return b


def _bucket_lin(x: int, step: int = 1 << 18) -> int:
    """Linear bucketing for big variable-size wire arrays: pow2 overshoots by
    up to 2x (real transfer bytes); 256Ki steps keep the program-variant count
    small while capping padding waste."""
    if x <= 1 << 18:
        return _bucket_pow2(x)
    return -(-x // step) * step


def _sig0_dense(chunk, n_sig: int) -> np.ndarray | None:
    """Dense sig start state from the chunk's sparse v16 warm rows (None =
    cold zeros)."""
    if chunk.sig0_idx is None or len(chunk.sig0_idx) == 0:
        return None
    s = np.zeros((n_sig, 2), np.int32)
    s[chunk.sig0_idx.astype(np.int64)] = chunk.sig0_val.astype(np.int32)
    return s


def _sig0_sparse_padded(chunk, n_sig: int):
    """(idx, val) padded to a power-of-two length for the v3 wire (pad rows
    target n_sig = dropped by the device scatter); (None, None) = cold."""
    if chunk.sig0_idx is None or len(chunk.sig0_idx) == 0:
        return None, None
    k = _bucket_pow2(len(chunk.sig0_idx))
    idx = np.full(k, n_sig, np.uint32)
    idx[:len(chunk.sig0_idx)] = chunk.sig0_idx
    val = np.zeros((k, 2), np.uint16)
    val[:len(chunk.sig0_idx)] = chunk.sig0_val
    return idx, val


def _wlen(a) -> int:
    """Bucketed u32 word length for a bit-packed stream segment."""
    return _bucket_lin(max(len(a), 2), step=1 << 16)


def _chunk_layout(c: SlimChunk) -> tuple:
    """This chunk's own bucketed blob layout (Lh, La, Lb, Lc, npi, ne, nc,
    ncc) — see ops/model_pass._blob_layout_words. The mesh path takes the
    elementwise max over chunks instead (every entry class is closed under
    max: word lengths stay word lengths, pow2s stay pow2s, npi stays a
    multiple of 4)."""
    n_cesc = len(c.cesc_idx) if c.cesc_idx is not None else 0
    return (_wlen(c.hdr_words), _wlen(c.a_words), _wlen(c.b_words),
            _wlen(c.cs_words), _bucket_lin(max(c.n, 1)),
            _bucket_pow2(max(len(c.esc_idx), 1)), _bucket_lin(max(c.n_coo, 1)),
            _bucket_pow2(max(n_cesc, 1)))


def pick_lanes(n_pairs: int) -> int:
    """Adaptive lane count (the JAX package's rule, which fixes the
    container bytes): 16 lanes, doubled up to 128 while a lane would hold
    more than 32,768 pairs; per-lane flush overhead (~6 B) stays well under
    0.1% of payload."""
    k = 16
    while k < 128 and n_pairs // k > 32768:
        k *= 2
    return k
