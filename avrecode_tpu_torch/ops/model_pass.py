"""Device model passes: probabilities for every coded bin of a chunk.

Counterpart of avrecode_tpu/ops/model_pass.py:

  - profile 2 (frozen batches, the ANL5 slim wire):
    - `dual0_expand`: the dual0 row dictionary -> dense dual table;
    - `wire_expand4_blob`: one fused u32 blob -> dense per-bin planes and the
      per-sub-batch update-delta table (single device, mesh=False);
    - `model_pass_v4` / `v3_core`: the frozen-batch probability scan;
  - profile 0 (immediate increments, the dense analysis export):
    - `model_pass_v2` (+ `run_chunk_v2_tables` on the native export's
      tables, `run_chunk_v2` + `build_v2_inputs` where it has none): the
      super-batched scan with host-shipped within-batch prefix counts
      (ARTC_MODEL_IMPL=v2, the default);
    - `model_pass_dict` (+ `build_dicts`, `run_chunk`): the per-batch
      dictionary pass (impl "dict");
    - `model_pass` (+ `run_chunk`): the per-batch scatter-add pass (impls
      "sort" and "mm", which give identical outputs and share one kernel).

Each is bit-exact against the host ModelEncoder of its profile
(native/model.h). Each function has a plain PyTorch version, taken only for
CPU tensors, and a CUDA kernel (csrc/wire_expand.cu, csrc/model_pass.cu) for
CUDA tensors. Tensors are int32; u32 data (the blob, the packed deltas) rides
int32 bit patterns. The plain versions compute in int64 with explicit masks.
The run_* wrappers take and return numpy arrays and upload to an explicit
`device`.
"""
from __future__ import annotations

import ctypes
import functools
import os

import numpy as np
import torch
import torch.nn.functional as F

from .. import _native
from . import intmath as im

# Bins per block of csrc/wire_expand.cu (kBinsPerBlock): sizes its scratch.
_EXPAND_BINS = 2048
# Largest U (dictionary slots) whose delta row fits the shared memory an
# H100 block may opt into (227 KB) beside the kernel's own.
_EXPAND_MAX_U = 56 * 1024


def default_sup() -> int:
    # Super-step size (sub-batches per model step). 128 is the JAX package's
    # default (tuned on a TPU); probabilities do not depend on it.
    return int(os.environ.get("ARTC_MODEL_SUP", "128"))


def default_impl() -> str:
    """The profile-0 model pass: "v2" (default), "dict", "sort" or "mm",
    from ARTC_MODEL_IMPL as in the JAX package."""
    return os.environ.get("ARTC_MODEL_IMPL", "v2")


# Largest batch (and dict width) of the dict and sort/mm kernels
# (csrc/model_pass.cu kMaxPrefixBatch: the pre-pass's hash table and the
# chain's entry ring live in shared memory, and counts pack into 15 bits).
_PREFIX_MAX_BATCH = 12288
_HALVE_DEFAULT = 16  # _halve_while's default count (dict and sort/mm passes)


# Fused-blob segment order (word lengths derived from the element counts in
# `layout`), a copy of avrecode_tpu.ops.model_pass._blob_layout_words;
# device._build_blob4 packs the blob with the identical layout.
def _blob_layout_words(layout, nsub: int, ns: int, ud: int, us: int):
    Lh, La, Lb, Lc, npi, ne, nc, ncc = layout
    sizes = [Lh, La, Lb, Lc,          # u32 word streams (hdr/a/b/cs)
             npi // 4,                # prior_idx u8[npi]
             128,                     # pdict u16[256]
             ne,                      # esc_idx u32[ne]
             ne // 2,                 # esc_val u16[ne]
             (nsub + 1) // 2,         # coo_cnt u16[nsub]
             nc // 4,                 # coo_nib u8[nc] (ones | tot<<4)
             ncc,                     # cesc_idx u32[ncc]
             ncc,                     # cesc_val u16[ncc, 2]
             ns * ud,                 # dk_d u32[ns, ud]
             ns * us]                 # dk_s u32[ns, us]
    offs = [0]
    for s in sizes:
        offs.append(offs[-1] + s)
    return offs


def _as_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding u32 values -> int32 bit patterns."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def _u16s(w: torch.Tensor) -> torch.Tensor:
    """u32 words (int64) -> their little-endian u16 elements."""
    return torch.stack([w & 0xFFFF, w >> 16], 1).reshape(-1)


def _u8s(w: torch.Tensor) -> torch.Tensor:
    """u32 words (int64) -> their little-endian u8 elements."""
    return torch.stack([(w >> s) & 0xFF for s in (0, 8, 16, 24)], 1).reshape(-1)


# ---------------------------------------------------------------- dual0_expand

def dual0_expand(rows: torch.Tensor, idx: torch.Tensor, esc_idx: torch.Tensor,
                 esc_val: torch.Tensor) -> torch.Tensor:
    """ANL5 dual0 row dictionary -> dense int32[n_dual, 4]: row idx[i]
    (clamped to the last dictionary row) for table row i, then the exact
    escape rows at esc_idx (indices >= n_dual are padding and drop).

    The inputs are the wire's arrays at their widths (device._dual0_dict,
    device._wire): rows int16[R, 4] and esc_val int16[j, 4] hold u16 bit
    patterns, idx is uint8[n_dual], esc_idx int32[j] holds u32 bit patterns.
    The kernel also takes the writer's order: the live escape indices
    strictly ascending (device._dual0_dict checks it); the plain version
    takes any list."""
    if _native.on_cpu("dual0_expand", rows):
        return _dual0_expand_plain(rows, idx, esc_idx, esc_val)
    return _dual0_expand_cuda(rows, idx, esc_idx, esc_val)


def _dual0_expand_plain(rows, idx, esc_idx, esc_val):
    d = (rows.to(torch.int32) & 0xFFFF)[idx.to(torch.int64).clamp(0, rows.shape[0] - 1)]
    keep = (esc_idx >= 0) & (esc_idx < d.shape[0])
    d[esc_idx[keep].to(torch.int64)] = esc_val[keep].to(torch.int32) & 0xFFFF
    return d


def _dual0_expand_cuda(rows, idx, esc_idx, esc_val, entry="artc_dual0_expand"):
    """One launch (csrc/model_pass.cu dual0_expand_kernel). With entry
    "artc_launch_floor" the same call launches an empty kernel on the same
    grid instead, uncounted: the floor under this wrapper's time."""
    _native.check_cuda("dual0_expand", rows, idx, esc_idx, esc_val,
                       dtype=(torch.int16, torch.uint8, torch.int32, torch.int16))
    if rows.dim() != 2 or rows.shape[1] != 4 or not rows.shape[0] or idx.dim() != 1 \
            or esc_val.shape != (esc_idx.shape[0], 4):
        raise ValueError("dual0_expand: rows must be [R >= 1, 4], idx [n], esc_val [j, 4]")
    if idx.data_ptr() % 16 or rows.data_ptr() % 8 or esc_val.data_ptr() % 8:
        raise ValueError("dual0_expand: idx must start on 16 bytes, rows and esc_val on 8")
    out = torch.empty((idx.shape[0], 4), dtype=torch.int32, device=rows.device)
    _native.launch("dual0_expand" if entry == "artc_dual0_expand" else None, entry,
                   rows.device, rows, idx, esc_idx, esc_val, out, rows.shape[0],
                   idx.shape[0], esc_idx.shape[0])
    return out


# csrc/model_pass.cu dual0_expand_kernel: rows a block, threads a block.
_DUAL0_ROWS, _DUAL0_THREADS = 1024, 256


def _dual0_expand_mirror(rows, idx, esc_idx, esc_val):
    """dual0_expand by the kernel's formulation (numpy in, at the wire's
    widths; int32[n_dual, 4] out): per block of _DUAL0_ROWS rows, the
    dictionary's first 256 rows (an index past them clamped to the last),
    the escape list narrowed by rounds of one strided probe a thread to a
    window of one entry a thread that holds the block's first escape, then
    walked from there one entry a thread while the entries stay below the
    block's end, entries below its start skipped."""
    n_rows = min(len(rows), 256)
    dic = rows[:n_rows].astype(np.int64) & 0xFFFF
    ei = esc_idx.astype(np.int64) & 0xFFFFFFFF
    ne, n_dual, T = len(ei), len(idx), _DUAL0_THREADS
    out = np.empty((n_dual, 4), np.int32)
    for r0 in range(0, n_dual, _DUAL0_ROWS):
        r1 = min(r0 + _DUAL0_ROWS, n_dual)
        lo, hi = 0, ne
        while hi - lo > T:
            stride = -(-(hi - lo) // T)
            probes = lo + np.arange(T) * stride
            below = int((ei[probes[probes < hi]] < r0).sum())
            if below:
                hi, lo = min(lo + below * stride, hi), lo + (below - 1) * stride + 1
            else:
                hi = lo
        row = dic[np.minimum(idx[r0:r1].astype(np.int64), n_rows - 1)]
        e = lo + np.arange(T)
        while True:
            k = np.where(e < ne, ei[np.minimum(e, ne - 1)], 0xFFFFFFFF)
            mine = (k >= r0) & (k < r1)
            row[k[mine] - r0] = esc_val[e[mine]].astype(np.int64) & 0xFFFF
            if not (k < r1).all():
                break
            e = e + T
        out[r0:r1] = row
    return out


# ----------------------------------------------------------- wire_expand4_blob

def wire_expand4_blob(blob: torch.Tensor, sc: torch.Tensor, *, m: int, nsub: int,
                      U: int, ud: int, us: int, ns: int, batch: int, layout: tuple,
                      mesh: bool = False):
    """ANL5 wire decompression from one fused u32 blob (int32 bit patterns,
    segments per _blob_layout_words) and the scalar vector sc = [wa, wb,
    wcs, n, n_coo] (int32[5], on the blob's device).

    Returns bit, kind, slot, prior int32[m] (bins [n, m) are padding: kind
    3, slot ud-1, prior 1), deltas uint16[nsub, U, 2] ((ones, tot) per
    sub-batch and dictionary slot) and the key tables dk_d int32[ns, ud],
    dk_s int32[ns, us] (views into the blob). See the JAX function of the
    same name for the wire format (native/slim_export.h write_slim_chunk).

    mesh=True is the mesh step's form: the shapes are mesh-uniform (`ud` is
    the widest chunk's dual width) and sc = [..., ud_real] (int32[6])
    carries this chunk's own; COO slots >= ud_real shift up by ud - ud_real.
    A leading chunk axis (blob [G, W], sc [G, 5 or 6]) expands G chunks of
    one layout: every output gains it (dk_d/dk_s as strided views of the
    blobs); the kernel runs one sequence of three launches for all G."""
    args = (m, nsub, U, ud, us, ns, batch, layout, mesh)
    if _native.on_cpu("wire_expand4_blob", blob):
        return _wire_expand_plain(blob, sc, *args)
    return _wire_expand_cuda(blob, sc, *args)


def _key_tables(blob, offs, ns, ud, us):
    """The dk_d/dk_s segments of a blob [W] or blobs [G, W] (segment offsets
    `offs`), as views."""
    lead = blob.shape[:-1]
    return (blob[..., offs[12]:offs[13]].reshape(*lead, ns, ud),
            blob[..., offs[13]:offs[14]].reshape(*lead, ns, us))


def _unpack(words: torch.Tensor, pos: torch.Tensor, w, base=0) -> torch.Tensor:
    """w-bit no-straddle entries (native/slim_export.h: entry j lives
    wholly inside word j // (32//w)) of the stream starting at word `base`;
    word indices clamp to the end of `words`, as a JAX gather clamps them.
    A 0-bit entry (the zero widths of the mesh's pad chunks) is 0."""
    epw = 32 // (w.clamp_min(1) if torch.is_tensor(w) else max(w, 1))
    q = torch.div(pos, epw, rounding_mode="floor")
    off = (pos - q * epw) * w
    return (words[(base + q).clamp(0, words.shape[0] - 1)] >> off) & ((1 << w) - 1)


def _wire_expand_plain(blob, sc, m, nsub, U, ud, us, ns, batch, layout, mesh=False):
    if blob.dim() == 2:  # the chunk axis: one chunk at a time
        outs = [_wire_expand_plain(b, c, m, nsub, U, ud, us, ns, batch, layout, mesh)
                for b, c in zip(blob, sc)]
        planes = [torch.stack(x) for x in list(zip(*outs))[:5]]
        return (*planes, *_key_tables(blob, _blob_layout_words(layout, nsub, ns, ud, us), ns,
                                      ud, us))
    offs = _blob_layout_words(layout, nsub, ns, ud, us)
    Lh, La, Lb, Lc, npi, ne, nc, ncc = layout
    dev = blob.device
    w32 = blob.to(torch.int64) & 0xFFFFFFFF

    def seg(k):
        return w32[offs[k]:offs[k + 1]]

    wa, wb, wcs, n, n_coo = (int(v) for v in sc[:5].tolist())
    i = torch.arange(m, device=dev)
    live_n = i < n
    # Header nibbles: bit<<3 | kind<<1 | cls, 8 per word.
    nib = ((seg(0)[:, None] >> (4 * torch.arange(8, device=dev))[None, :]) & 15).reshape(-1)
    hdr = nib[:m] if Lh * 8 >= m else F.pad(nib, (0, m - Lh * 8))
    bit = torch.where(live_n, hdr >> 3, 0)
    kind = torch.where(live_n, (hdr >> 1) & 3, 3)
    cls = hdr & 1
    live = live_n & (kind != 3)
    a_sel = (live & (cls == 0)).to(torch.int64)
    b_sel = (live & (cls == 1)).to(torch.int64)
    pos_a = torch.cumsum(a_sel, 0) - a_sel
    pos_b = torch.cumsum(b_sel, 0) - b_sel
    # Hot/cold ranks, routed through one unpack at absolute blob offsets.
    cold = cls == 1
    rank = _unpack(w32, torch.where(cold, pos_b, pos_a), torch.where(cold, wb, wa),
                   torch.where(cold, offs[2], offs[1]))
    # COO slots: clamped unpack (the bucketed nc can pass the packed stream);
    # an empty stream reads one 0 (JAX's gather has no entry to read).
    cs = (_unpack(seg(3), torch.arange(nc, device=dev), wcs) if nc
          else torch.zeros(1, dtype=torch.int64, device=dev))
    if mesh:  # this chunk's sig slots start at its own dual width sc[5]
        ud_real = int(sc[5])
        cs = torch.where(cs >= ud_real, cs + (ud - ud_real), cs)
    cnts = _u16s(seg(8))[:nsub]
    starts = torch.cumsum(cnts, 0) - cnts
    sbase = starts.repeat_interleave(batch)
    sidx = torch.where(live, sbase + rank, 0).clamp(0, max(nc - 1, 0))
    slot = torch.where(live, cs[sidx], ud - 1)
    # Priors: u8 -> u16 dictionary, escape scatter (pad indices >= npi drop),
    # neutral 1 beyond n.
    pr = _u16s(seg(5))[_u8s(seg(4))]
    ei = seg(6)
    keep = ei < npi
    pr[ei[keep]] = _u16s(seg(7))[keep]
    prf = pr[:m] if npi >= m else F.pad(pr, (0, m - npi))
    prior = torch.where(live_n, prf, 1)
    # Update deltas: each COO entry's sub-batch from the run starts, (ones,
    # tot) widened from the nibbles with the exact escapes on top, scattered
    # to (sub-batch, slot); dead entries (>= n_coo) drop.
    mark = torch.zeros(nc + 1, dtype=torch.int64, device=dev)
    st_in = starts[starts <= nc]
    mark.index_add_(0, st_in, torch.ones_like(st_in))
    coo_sub = torch.cumsum(mark[:nc], 0) - 1
    livec = torch.arange(nc, device=dev) < n_coo
    flat = torch.where(livec, coo_sub * U + cs[:nc], nsub * U)
    nb = _u8s(seg(9))
    v32 = (nb & 15) | ((nb >> 4) << 16)
    ce = _u16s(seg(11)).reshape(ncc, 2)
    ci = seg(10)
    keep = ci < nc
    v32[ci[keep]] = (ce[:, 0] | (ce[:, 1] << 16))[keep]
    keep = (flat >= 0) & (flat < nsub * U)
    tbl = torch.zeros(nsub * U, dtype=torch.int64, device=dev)
    tbl[flat[keep]] = v32[keep]
    deltas = _as_i32(tbl).view(torch.uint16).reshape(nsub, U, 2)
    i32 = torch.int32
    return (bit.to(i32), kind.to(i32), slot.to(i32), prior.to(i32), deltas,
            *_key_tables(blob, offs, ns, ud, us))


@functools.lru_cache(maxsize=64)
def _expand_offsets(layout: tuple, nsub: int, ns: int, ud: int, us: int):
    """The blob's segment offsets, as a list and as the C entry's array."""
    offs = _blob_layout_words(layout, nsub, ns, ud, us)
    return offs, (ctypes.c_longlong * len(offs))(*offs)


def _wire_expand_cuda(blob, sc, m, nsub, U, ud, us, ns, batch, layout, mesh):
    _native.check_cuda("wire_expand4_blob", blob, sc)
    offs, offs_c = _expand_offsets(tuple(layout), nsub, ns, ud, us)
    Lh, La, Lb, Lc, npi, ne, nc, ncc = layout
    one = blob.dim() == 1
    G, W = (1, blob.shape[0]) if one else blob.shape
    n_sc = 6 if mesh else 5
    if blob.dim() not in (1, 2) or W < offs[-1] or sc.dim() != blob.dim() \
            or sc.shape[-1] < n_sc or (not one and sc.shape[0] != G):
        raise ValueError(f"wire_expand4_blob: blob needs {offs[-1]} words and sc {n_sc} "
                         f"scalars per chunk, got {tuple(blob.shape)} / {tuple(sc.shape)}")
    if m != nsub * batch or m >= 1 << 31 or batch < 1 or G > 65535:
        raise ValueError(f"wire_expand4_blob: m={m} != nsub*batch={nsub * batch}, or "
                         f"G={G} chunks over 65535")
    if U > _EXPAND_MAX_U:
        raise ValueError(f"wire_expand4_blob: U={U} slots exceed the {_EXPAND_MAX_U} whose "
                         f"delta row fits a block's shared memory")
    dev = blob.device
    lead = () if one else (G,)
    planes = torch.empty((4, *lead, m), dtype=torch.int32, device=dev)
    deltas = torch.empty((*lead, nsub, U, 2), dtype=torch.uint16, device=dev)
    # The block counts (u64) and per sub-batch its run start and its count
    # of entries in later rows.
    scratch = torch.empty(2 * G * (-(-m // _EXPAND_BINS) + nsub), dtype=torch.int32,
                          device=dev)
    _native.launch("wire_expand", "artc_wire_expand", dev, blob, sc, planes, deltas, scratch,
                   ctypes.addressof(offs_c), G, W, sc.shape[-1], W, m, nsub, U, ud, batch, Lh,
                   Lc, npi, ne, nc, ncc, int(mesh))
    return (*planes.unbind(0), deltas, *_key_tables(blob, offs, ns, ud, us))


def _expand_mirror(blob, sc, m, nsub, U, ud, us, ns, batch, layout, mesh=False):
    """csrc/wire_expand.cu's three launches over numpy arrays, in the
    kernel's decomposition: per 2,048-bin block the packed rank counts and
    the prior plane, per sub-batch its delta row built from zeros with its
    own run (JAX's mark/cumsum: the last run reaches to the live end) and
    a count of its entries in later rows; the block offsets, those
    entries, the prior escapes; the bins from their block's offset, and the
    count escapes at their run found by a binary search of the starts.
    blob: u32 words [G, W]; sc: [G, 5 or 6]. Returns bit, kind, slot, prior
    int64 [G, m] and deltas uint32 [G, nsub, U]; raises if an output entry
    was never written."""
    blob = np.asarray(blob).astype(np.int64) & 0xFFFFFFFF
    sc = np.asarray(sc).astype(np.int64)
    offs = _blob_layout_words(layout, nsub, ns, ud, us)
    Lh, La, Lb, Lc, npi, ne, nc, ncc = layout
    G, W = blob.shape
    nblk = -(-m // _EXPAND_BINS)
    unset = -(1 << 40)
    planes = np.full((4, G, m), unset, np.int64)
    deltas = np.full((G, nsub * U), unset, np.int64)

    def unpack(w, base, last, pos, width):
        pos = np.asarray(pos, np.int64)
        width = np.broadcast_to(np.asarray(width, np.int64), pos.shape)
        epw = 32 // np.maximum(width, 1)
        q = pos // epw
        wi = np.minimum(base + q, last)
        v = (w[wi] >> ((pos - q * epw) * width)) & ((1 << width) - 1)
        return np.where(width > 0, v, 0)

    def u8(w, k, idx):
        return (w[offs[k] + idx // 4] >> (8 * (idx % 4))) & 255

    def u16(w, k, idx):
        return (w[offs[k] + idx // 2] >> (16 * (idx % 2))) & 0xFFFF

    for g in range(G):
        w = blob[g]
        wa, wb, wcs, n, n_coo = (int(v) for v in sc[g, :5])

        def coo_slot(j):
            c = (unpack(w, offs[3], offs[3] + Lc - 1, j, wcs) if nc
                 else np.zeros(np.shape(j), np.int64))
            if mesh:
                ud_real = int(sc[g, 5])
                c = np.where(c >= ud_real, c + ud - ud_real, c)
            return c

        live = min(nc, n_coo)
        cnt = u16(w, 8, np.arange(nsub))
        starts = (np.cumsum(cnt) - cnt + (1 << 31)) % (1 << 32) - (1 << 31)  # int32

        def run(s):  # sub-batch s's live entries; the last run reaches to the live end
            end = starts[s] + cnt[s] if s + 1 < nsub else live
            return np.arange(starts[s], min(end, live))

        # Launch 1, count blocks: 2,048 bins a block.
        i = np.arange(nblk * _EXPAND_BINS)
        word = np.where(((i >> 3) < Lh) & (i < m), w[np.minimum(offs[0] + (i >> 3), W - 1)], 0)
        h = (word >> (4 * (i & 7))) & 15
        live_n = (i < n) & (i < m)
        bit = np.where(live_n, h >> 3, 0)
        kind = np.where(live_n, (h >> 1) & 3, 3)
        cold = (h & 1) == 1
        hot_sel = ((kind != 3) & ~cold).astype(np.int64).reshape(nblk, -1)
        cold_sel = ((kind != 3) & cold).astype(np.int64).reshape(nblk, -1)
        i0 = i & ~3
        pw = np.where((i0 < npi) & (i0 < n), w[np.minimum(offs[4] + (i0 >> 2), W - 1)], 0)
        pr = np.where(i >= n, 1, np.where(i < npi, u16(w, 5, (pw >> (8 * (i & 3))) & 255), 0))
        planes[3, g] = pr[:m]
        # Launch 1, row blocks: each sub-batch's row from zeros.
        ovf = np.zeros(nsub, np.int64)
        for s in range(nsub):
            j = run(s)
            c = coo_slot(j)
            row = np.zeros(U, np.int64)
            inrow = c < U
            b = u8(w, 9, j[inrow])
            row[c[inrow]] = (b & 15) | ((b >> 4) << 16)
            deltas[g, s * U:(s + 1) * U] = row
            ovf[s] = int(((~inrow) & (c < (nsub - s) * U)).sum())
        # Launch 2: the block offsets, the later-row entries, the prior escapes.
        off_hot = np.cumsum(hot_sel.sum(1)) - hot_sel.sum(1)
        off_cold = np.cumsum(cold_sel.sum(1)) - cold_sel.sum(1)
        for s in np.flatnonzero(ovf):
            j = run(s)
            c = coo_slot(j)
            flat = s * U + c
            keep = (c >= U) & (flat < nsub * U)
            b = u8(w, 9, j[keep])
            deltas[g, flat[keep]] = (b & 15) | ((b >> 4) << 16)
        for k in range(ne):
            idx = int(w[offs[6] + k])
            if idx < npi and idx < n and idx < m:
                planes[3, g, idx] = u16(w, 7, k)
        # Launch 3: the bins from their block's offset; the count escapes.
        pos_hot = (off_hot[:, None] + np.cumsum(hot_sel, 1) - hot_sel).reshape(-1)
        pos_cold = (off_cold[:, None] + np.cumsum(cold_sel, 1) - cold_sel).reshape(-1)
        rank = np.where(kind != 3, unpack(w, np.where(cold, offs[2], offs[1]), W - 1,
                                          np.where(cold, pos_cold, pos_hot),
                                          np.where(cold, wb, wa)), 0)
        sub = np.minimum(i // batch, max(nsub - 1, 0))
        sidx = np.clip(starts[sub] + rank if nsub else rank, None, nc - 1).clip(0)
        slot = np.where(kind != 3, coo_slot(sidx), ud - 1)
        planes[:3, g] = np.stack([bit, kind, slot])[:, :m]
        for e in range(ncc):
            j = int(w[offs[10] + e])
            if j >= live:
                continue
            s = int(np.searchsorted(starts, j, side="right")) - 1
            flat = s * U + int(coo_slot(np.array([j]))[0])
            if flat < nsub * U:
                deltas[g, flat] = u16(w, 11, 2 * e) | (u16(w, 11, 2 * e + 1) << 16)
    if (planes == unset).any() or (deltas == unset).any():
        raise AssertionError("_expand_mirror: an output entry was never written")
    slot = planes[2].astype(np.int32).astype(np.int64)  # the kernel stores int32
    return planes[0], planes[1], slot, planes[3], deltas.reshape(G, nsub, U)


# ------------------------------------------------------ model_pass_v4 / v3_core

# The frozen-batch scans' persistent pass (csrc/model_pass.cu scan_kernel):
# a chunk's barrier line of _SCAN_SYNC ints holds its arrival count and then
# cycle counters, in units of 16 cycles, of what paced the last pass: stage
# block 0's thread 0 staging and at the barrier, the first probability
# block's thread 0 on probability tiles and at the barrier, and stage block
# 0's thread 0 on probability tiles.
_SCAN_SYNC = 32
SCAN_PROF_NAMES = ("stage", "stage_wait", "prob", "prob_wait", "stage_prob")
_LAST_SCAN: dict = {}  # "sync": the barrier lines of the last v3_core / v2 pass


def _scan_words(sup: int, ud: int, us: int) -> int:
    """Ints of one staged-state buffer: a (sub-batch, dual slot)'s int4
    [sup, ud], then a (sub-batch, sig slot)'s int2 [sup, us], padded to 16
    bytes (csrc/model_pass.cu scan_buf_words)."""
    return sup * ud * 4 + -(-sup * us * 2 // 4) * 4


def _scan_scratch(dev, G: int, sup: int, ud: int, us: int) -> dict:
    """Two staged-state buffers and a barrier line per chunk; the C entry
    clears the lines."""
    words = 2 * _scan_words(sup, ud, us)
    return dict(cst=torch.empty((G, words), dtype=torch.int32, device=dev),
                sync=torch.empty((G, _SCAN_SYNC), dtype=torch.int32, device=dev))


def scan_profile(chunk: int = 0) -> dict:
    """A chunk's cycle counters of the last v3_core / model_pass_v2 pass,
    in cycles."""
    words = _LAST_SCAN["sync"][chunk, 1:1 + len(SCAN_PROF_NAMES)].tolist()
    return {k: 16 * v for k, v in zip(SCAN_PROF_NAMES, words)}


def model_pass_v4(bit_all, kind_all, slot_all, prior_all, dk_d, dk_s, deltas, dual0,
                  *, batch: int, sup: int, fast_w: int, slow_w: int, sig_w: int,
                  sig_alpha: int, ud: int, us: int, n_sig: int = 1 << 17,
                  sig0_idx=None, sig0_val=None):
    """Frozen-batch pass over wire_expand4_blob's planes; returns (probs
    int32[m], bits int32[m]), or [G, m] with a leading chunk axis (see
    v3_core)."""
    probs = v3_core(bit_all, kind_all, slot_all, prior_all, dk_d, dk_s, deltas, dual0,
                    batch=batch, sup=sup, fast_w=fast_w, slow_w=slow_w, sig_w=sig_w,
                    sig_alpha=sig_alpha, ud=ud, us=us, n_sig=n_sig,
                    sig0_idx=sig0_idx, sig0_val=sig0_val)
    return probs, bit_all


def v3_core(bit_all, kind_all, slot_all, prior_all, dk_d, dk_s, deltas, dual0, *,
            batch: int, sup: int, fast_w: int, slow_w: int, sig_w: int, sig_alpha: int,
            ud: int, us: int, n_sig: int = 1 << 17, sig0_idx=None, sig0_val=None):
    """Frozen-batch (model profile 2) probability scan.

    kind/slot/prior_all: int32[m], m = ns*sup*batch (pad bins: kind 3, slot
      ud-1, prior 1); bit_all is carried for the caller only.
    dk_d/dk_s: int32[ns, ud/us] per-super-step sorted-unique table rows.
    deltas: uint16[ns*sup, U, 2] per-sub-batch per-slot (ones, total).
    dual0: int32[n_dual, 4] seeded dual table; sig0_idx int32[k] (u32 bit
      patterns) / sig0_val int16[k, 2] (u16 bit patterns) the sparse warm
      sig rows at their wire widths (indices >= n_sig drop), or None.

    Super-steps run in order over a dual table (n_dual+1+ud, 4), whose
    scratch rows hold ones, and a sig table (n_sig+us, 2), zeros with the
    warm rows scattered in and ones in the tail rows. Each step gathers its
    rows, stages every sub-batch's start state (deltas added, halved per
    window), computes each bin's probability by kind from its sub-batch's
    staged state, and writes the final rows back. Returns probs int32[m].

    A leading chunk axis (the mesh step's vmap, written out) runs G chunks
    of one shape at once: planes [G, m], dk_d [G, ns, ud] / dk_s [G, ns,
    us] (rows contiguous; the chunk stride is free, so they may be views of
    the chunks' blobs), deltas [G, ns*sup, U, 2], dual0 [G, n_dual, 4],
    sig0_idx [G, k] / sig0_val [G, k, 2]; probs [G, m]. The kernel puts the
    chunk on a grid dimension: one persistent pass for all G chunks and ns
    super-steps (more only where the chunks do not fit the card at once)."""
    if _native.on_cpu("v3_core", kind_all):
        return _v3_core_plain(kind_all, slot_all, prior_all, dk_d, dk_s, deltas, dual0,
                              batch, sup, fast_w, slow_w, sig_w, sig_alpha, ud, us,
                              n_sig, sig0_idx, sig0_val)
    return _v3_core_cuda(kind_all, slot_all, prior_all, dk_d, dk_s, deltas, dual0,
                         batch, sup, fast_w, slow_w, sig_w, sig_alpha, ud, us, n_sig,
                         sig0_idx, sig0_val)


def _alphas(sig_alpha: int) -> tuple[int, int]:
    alpha_on = sig_alpha & 0xFFFF
    return alpha_on, (sig_alpha >> 16) or alpha_on


def _v3_core_plain(kind_all, slot_all, prior_all, dk_d, dk_s, deltas, dual0, batch, sup,
                   fast_w, slow_w, sig_w, sig_alpha, ud, us, n_sig, sig0_idx, sig0_val):
    if kind_all.dim() == 2:  # the chunk axis: one chunk at a time
        return torch.stack([_v3_core_plain(
            kind_all[g], slot_all[g], prior_all[g], dk_d[g], dk_s[g], deltas[g], dual0[g],
            batch, sup, fast_w, slow_w, sig_w, sig_alpha, ud, us, n_sig,
            None if sig0_idx is None else sig0_idx[g],
            None if sig0_val is None else sig0_val[g]) for g in range(kind_all.shape[0])])
    U = ud + us
    ns = kind_all.shape[0] // (sup * batch)
    dev = kind_all.device
    i64 = torch.int64
    d = deltas.view(torch.int32).reshape(ns, sup, U).to(i64) & 0xFFFFFFFF
    dual = torch.cat([dual0.to(i64), torch.ones((1 + ud, 4), dtype=i64, device=dev)])
    sig = torch.zeros((n_sig + us, 2), dtype=i64, device=dev)
    sig[n_sig:] = 1
    if sig0_idx is not None:
        keep = (sig0_idx >= 0) & (sig0_idx < n_sig)
        sig[sig0_idx[keep].to(i64)] = sig0_val[keep].to(i64) & 0xFFFF
    return _staged_scan_plain(kind_all, slot_all, prior_all, None, None, dk_d, dk_s,
                              d & 0xFFFF, d >> 16, dual, sig, batch, sup, fast_w, slow_w,
                              sig_w, sig_alpha)


def _staged_scan_plain(kind_all, slot_all, prior_all, pre1, pret, dk_d, dk_s, d_one, d_tot,
                       dual, sig, batch, sup, fast_w, slow_w, sig_w, sig_alpha):
    """The super-step scan of v3_core and model_pass_v2 (plain version).
    d_one/d_tot: int64[ns, sup, U] per-sub-batch (ones, total) deltas; dual /
    sig: the int64 start tables, updated in place; pre1/pret: per-bin
    within-batch prefix counts added to every state column (v2), or None."""
    ns, ud = dk_d.shape
    us = dk_s.shape[1]
    U = ud + us
    span = sup * batch
    dev = kind_all.device
    i64 = torch.int64
    alpha_on, alpha_off = _alphas(sig_alpha)
    it_f = im._halve_iters(fast_w, batch)
    it_s = im._halve_iters(slow_w, batch)
    it_g = im._halve_iters(sig_w, batch)
    probs = torch.empty(ns * span, dtype=i64, device=dev)
    sub_base = (torch.arange(sup, device=dev) * U).repeat_interleave(batch)
    for t in range(ns):
        kd = dk_d[t].to(i64)
        ks = dk_s[t].to(i64)
        dst = dual[kd]
        sst = sig[ks]
        cst = torch.ones((sup, U, 6), dtype=i64, device=dev)
        for s in range(sup):
            cst[s, :ud, :4] = dst
            cst[s, ud:, 4:] = sst
            one, tot = d_one[t, s], d_tot[t, s]
            nfp, nfn = im._halve_while(dst[:, 0] + one[:ud], dst[:, 1] + (tot - one)[:ud],
                                       fast_w, it_f)
            nsp, nsn = im._halve_while(dst[:, 2] + one[:ud], dst[:, 3] + (tot - one)[:ud],
                                       slow_w, it_s)
            gp, gn = im._halve_while(sst[:, 0] + one[ud:], sst[:, 1] + (tot - one)[ud:],
                                     sig_w, it_g)
            dst = torch.stack([nfp, nfn, nsp, nsn], 1)
            sst = torch.stack([gp, gn], 1)
        lo, hi = t * span, (t + 1) * span
        # A JAX gather clamps an out-of-range row; slots are < U by
        # construction, so the clamp only mirrors that.
        sub_idx = (sub_base + slot_all[lo:hi].to(i64)).clamp(0, sup * U - 1)
        st = cst.reshape(sup * U, 6)[sub_idx]
        if pre1 is not None:
            ones = pre1[lo:hi].to(i64)
            zeros = pret[lo:hi].to(i64) - ones
            st = st + torch.stack([ones, zeros] * 3, 1)
        probs[lo:hi] = im._prob_by_kind(kind_all[lo:hi].to(i64), prior_all[lo:hi].to(i64),
                                        *st.unbind(1), alpha_on, alpha_off)
        dual[kd] = dst
        sig[ks] = sst
    return probs.to(torch.int32)


def _rows_contiguous(t: torch.Tensor) -> bool:
    """True where every dimension but the first is dense (the first, the
    chunk axis, may have any stride)."""
    want = 1
    for size, stride in zip(reversed(t.shape[1:]), reversed(t.stride()[1:])):
        if size != 1 and stride != want:
            return False
        want *= size
    return True


def _v3_core_cuda(kind_all, slot_all, prior_all, dk_d, dk_s, deltas, dual0, batch, sup,
                  fast_w, slow_w, sig_w, sig_alpha, ud, us, n_sig, sig0_idx, sig0_val):
    one = kind_all.dim() == 1
    if one:  # a single chunk is the chunk axis of length 1
        kind_all, slot_all, prior_all, dk_d, dk_s, deltas, dual0 = (
            t[None] for t in (kind_all, slot_all, prior_all, dk_d, dk_s, deltas, dual0))
        if sig0_idx is not None:
            sig0_idx, sig0_val = sig0_idx[None], sig0_val[None]
    _native.check_cuda("v3_core", kind_all, slot_all, prior_all, dual0)
    U = ud + us
    G, m = kind_all.shape
    ns = m // (sup * batch)
    if m != ns * sup * batch or slot_all.shape != kind_all.shape \
            or prior_all.shape != kind_all.shape:
        raise ValueError(f"v3_core: m={m} planes must hold whole super-steps of "
                         f"{sup}x{batch} bins")
    for t, width in ((dk_d, ud), (dk_s, us)):
        if t.shape != (G, ns, width) or t.dtype != torch.int32 or t.device != kind_all.device \
                or not _rows_contiguous(t):
            raise ValueError(f"v3_core: key tables must be int32 [G, ns, ud|us] with dense "
                             f"rows on {kind_all.device}, got {tuple(t.shape)}")
    if dual0.dim() != 3 or dual0.shape[0] != G or dual0.shape[2] != 4:
        raise ValueError("v3_core: dual0 must be [n_dual, 4] per chunk")
    if deltas.dtype != torch.uint16 or deltas.shape != (G, ns * sup, U, 2) \
            or not deltas.is_contiguous() or deltas.device != kind_all.device:
        raise ValueError(f"v3_core: deltas must be contiguous uint16[{ns * sup}, {U}, 2] "
                         f"per chunk")
    d32 = deltas.view(torch.int32)
    if sig0_idx is None:
        k_sig0, s_idx, s_val = 0, 0, 0
    else:
        _native.check_cuda("v3_core", kind_all, sig0_idx, sig0_val,
                           dtype=(torch.int32, torch.int32, torch.int16))
        if sig0_idx.shape[0] != G or sig0_val.shape != (*sig0_idx.shape, 2):
            raise ValueError("v3_core: sig0_val must be [k, 2] per chunk")
        k_sig0, s_idx, s_val = sig0_idx.shape[1], sig0_idx, sig0_val
    dev = kind_all.device
    n_dual = dual0.shape[1]
    alpha_on, alpha_off = _alphas(sig_alpha)
    dual_tbl = torch.empty((G, (n_dual + 1 + ud) * 4), dtype=torch.int32, device=dev)
    sig_tbl = torch.empty((G, (n_sig + us) * 2), dtype=torch.int32, device=dev)
    w = _scan_scratch(dev, G, sup, ud, us)
    probs = torch.empty((G, m), dtype=torch.int32, device=dev)
    _native.launch("model_pass_v4", "artc_model_pass_v4", dev, kind_all, slot_all, prior_all,
                   dk_d, dk_s, d32, dual0, s_idx, s_val, dual_tbl, sig_tbl, w["cst"], w["sync"],
                   probs, G, dk_d.stride(0), dk_s.stride(0), k_sig0, n_dual, n_sig, ns, sup,
                   batch, ud, us, fast_w, slow_w, sig_w, im._halve_iters(fast_w, batch),
                   im._halve_iters(slow_w, batch), im._halve_iters(sig_w, batch), alpha_on,
                   alpha_off, w["cst"].shape[1])
    _LAST_SCAN["sync"] = w["sync"]
    return probs[0] if one else probs


# -------------------------------------------------------------- model_pass_v2

def model_pass_v2(kinds, priors, pre1, pret, bin_u, dk_d, dk_s, dd, ds, dual0, sig0, *,
                  batch: int, sup: int, fast_w: int, slow_w: int, sig_w: int,
                  sig_alpha: int):
    """Super-batched profile-0 pass: v3_core's scan with the host's
    within-batch prefix counts on top.

    kinds/priors/pre1/pret/bin_u: int32[ns, sup, batch]; bin_u in [0, U)
      over the concatenated (dual ++ sig) dictionary, U = ud + us (kind-3 and
      pad bins point at the last dual pad entry, whose row holds ones).
    dk_d: int32[ns, ud] / dk_s: int32[ns, us] sorted-unique table rows per
      super-step (padded with distinct scratch rows).
    dd: int32[ns, sup, ud, 2] / ds: int32[ns, sup, us, 2] per-sub-batch
      (ones, total) deltas.
    dual0: int32[n_dual + 1 + ud, 4] and sig0: int32[n_sig + us, 2], the
      extended start tables (not modified).

    Each bin's state is its sub-batch's staged row at bin_u plus (pre1,
    pret - pre1) on every (positive, negative) column pair. Returns probs
    int32[ns * sup * batch]."""
    if _native.on_cpu("model_pass_v2", kinds):
        return _model_pass_v2_plain(kinds, priors, pre1, pret, bin_u, dk_d, dk_s, dd, ds,
                                    dual0, sig0, batch, sup, fast_w, slow_w, sig_w,
                                    sig_alpha)
    return _model_pass_v2_cuda(kinds, priors, pre1, pret, bin_u, dk_d, dk_s, dd, ds, dual0,
                               sig0, batch, sup, fast_w, slow_w, sig_w, sig_alpha)


def _model_pass_v2_plain(kinds, priors, pre1, pret, bin_u, dk_d, dk_s, dd, ds, dual0, sig0,
                         batch, sup, fast_w, slow_w, sig_w, sig_alpha):
    i64 = torch.int64
    d = torch.cat([dd, ds], 2).to(i64)  # [ns, sup, U, 2]
    return _staged_scan_plain(kinds.reshape(-1), bin_u.reshape(-1), priors.reshape(-1),
                              pre1.reshape(-1), pret.reshape(-1), dk_d, dk_s, d[..., 0],
                              d[..., 1], dual0.to(i64, copy=True), sig0.to(i64, copy=True),
                              batch, sup, fast_w, slow_w, sig_w, sig_alpha)


def _model_pass_v2_cuda(kinds, priors, pre1, pret, bin_u, dk_d, dk_s, dd, ds, dual0, sig0,
                        batch, sup, fast_w, slow_w, sig_w, sig_alpha):
    _native.check_cuda("model_pass_v2", kinds, priors, pre1, pret, bin_u, dk_d, dk_s, dd, ds,
                       dual0, sig0)
    ns, ud = dk_d.shape
    us = dk_s.shape[1]
    planes = (ns, sup, batch)
    if any(tuple(x.shape) != planes for x in (kinds, priors, pre1, pret, bin_u)):
        raise ValueError(f"model_pass_v2: bin planes must be int32{list(planes)}")
    if dk_s.shape[0] != ns or dd.shape != (ns, sup, ud, 2) or ds.shape != (ns, sup, us, 2):
        raise ValueError("model_pass_v2: dd/ds must be [ns, sup, ud|us, 2]")
    if dual0.dim() != 2 or dual0.shape[1] != 4 or sig0.dim() != 2 or sig0.shape[1] != 2:
        raise ValueError("model_pass_v2: tables must be [n, 4] / [n, 2]")
    if dd.data_ptr() % 8 or ds.data_ptr() % 8:  # the kernel copies (ones, total) as 8 bytes
        raise ValueError("model_pass_v2: dd/ds must start on an 8-byte boundary")
    dev = kinds.device
    alpha_on, alpha_off = _alphas(sig_alpha)
    dual = torch.empty_like(dual0)
    sig = torch.empty_like(sig0)
    w = _scan_scratch(dev, 1, sup, ud, us)
    probs = torch.empty(ns * sup * batch, dtype=torch.int32, device=dev)
    _native.launch("model_pass_v2", "artc_model_pass_v2", dev, kinds, priors, pre1, pret,
                   bin_u, dk_d, dk_s, dd, ds, dual0, sig0, dual, sig, w["cst"], w["sync"], probs,
                   dual0.shape[0], sig0.shape[0], ns, sup, batch, ud, us, fast_w, slow_w,
                   sig_w, im._halve_iters(fast_w, batch), im._halve_iters(slow_w, batch),
                   im._halve_iters(sig_w, batch), alpha_on, alpha_off, w["cst"].shape[1])
    _LAST_SCAN["sync"] = w["sync"]
    return probs


def _upload(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)


def _padded(a: np.ndarray, pad: int, value: int) -> np.ndarray:
    return np.concatenate([a.astype(np.int32), np.full(pad, value, np.int32)])


def run_chunk_v2_tables(kind, prior, pre_ones, pre_tot, v2_m, bin_u, dk_d, dk_s, dd, ds,
                        dual0, batch, sup, fast_w, slow_w, sig_w, sig_alpha, n_sig,
                        sig0=None, *, device, moved: list | None = None):
    """model_pass_v2 over one chunk with the native export's tables (numpy
    in, uint16 probs[n] out): the inputs v2_tables_inputs stages, through
    the pass. `moved`, if given, receives the bytes uploaded and the probs'
    bytes downloaded."""
    n = len(kind)
    if n == 0:
        return np.zeros(0, np.uint16)
    args, kw = v2_tables_inputs(kind, prior, pre_ones, pre_tot, v2_m, bin_u, dk_d, dk_s, dd,
                                ds, dual0, batch, sup, fast_w, slow_w, sig_w, sig_alpha, n_sig,
                                sig0, device=device)
    probs = model_pass_v2(*args, **kw)[:n].cpu()
    if moved is not None:
        moved.append(sum(t.nbytes for t in args) + probs.nbytes)
    return probs.numpy().astype(np.uint16)


def v2_tables_inputs(kind, prior, pre_ones, pre_tot, v2_m, bin_u, dk_d, dk_s, dd, ds, dual0,
                     batch, sup, fast_w, slow_w, sig_w, sig_alpha, n_sig, sig0=None, *,
                     device):
    """model_pass_v2's arguments for one chunk of n > 0 bins, as
    run_chunk_v2_tables passes them: the bin stream padded to v2_m with
    kind-3 no-ops, the tables extended (dual0 + 1 + ud rows of ones, sig0 or
    zeros + us rows of ones), uploaded to `device`. Returns (tensors,
    keywords)."""
    n = len(kind)
    m = int(v2_m)
    pad = m - n
    ns = m // (sup * batch)
    ud = dk_d.shape[1]
    us = dk_s.shape[1]
    sh = (ns, sup, batch)
    dual_ext = np.concatenate([dual0.astype(np.int32), np.ones((1 + ud, 4), np.int32)])
    sig_base = np.zeros((n_sig, 2), np.int32) if sig0 is None else sig0.astype(np.int32)
    sig_ext = np.concatenate([sig_base, np.ones((us, 2), np.int32)])
    planes = [_padded(a, pad, v).reshape(sh) for a, v in (
        (kind, 3), (prior, 1), (pre_ones, 0), (pre_tot, 0))]
    args = (*(_upload(a, device) for a in planes), _upload(bin_u.reshape(sh), device),
            *(_upload(a, device) for a in (dk_d, dk_s, dd, ds, dual_ext, sig_ext)))
    return args, dict(batch=int(batch), sup=int(sup), fast_w=int(fast_w), slow_w=int(slow_w),
                      sig_w=int(sig_w), sig_alpha=int(sig_alpha))


def build_v2_inputs(bit_p, kind_p, key_p, n_dual_ext, n_sig, batch, sup):
    """The host's (numpy) tables of model_pass_v2 where the native export has
    none, a copy of avrecode_tpu.ops.model_pass.build_v2_inputs: per
    super-step sorted-unique dictionaries, per-bin dictionary indices, and
    per-sub-batch per-entry (ones, total) deltas. Returns (bin_u, dk_d,
    dk_s, dd, ds, ud, us)."""
    n = len(kind_p)
    ns = n // (sup * batch)
    off = np.int64(1) << 32
    sent = off * 2
    ukey = np.where(kind_p == 2, key_p.astype(np.int64) + off, key_p.astype(np.int64))
    ukey = np.where(kind_p == 3, sent, ukey)  # ext/pad bins own no dict entry
    slab = ukey.reshape(ns, sup * batch)
    uniqs, invs, nds = [], [], []
    for i in range(ns):
        u, inv = np.unique(slab[i], return_inverse=True)
        if u[-1] == sent:
            u = u[:-1]
        uniqs.append(u)
        invs.append(inv.astype(np.int32))
        nds.append(int(np.searchsorted(u, off)))
    max_d = max(nds, default=0)
    max_s = max((len(u) - nd for u, nd in zip(uniqs, nds)), default=0)
    ud = _bucket(max_d + 1)
    us = _bucket(max_s + 1)
    dk_d = np.empty((ns, ud), np.int32)
    dk_s = np.empty((ns, us), np.int32)
    bin_u = np.empty((ns, sup * batch), np.int32)
    dd = np.zeros((ns, sup, ud, 2), np.int32)
    ds = np.zeros((ns, sup, us, 2), np.int32)
    m_dual = ((kind_p == 0) | (kind_p == 1)).astype(np.int32).reshape(ns, sup, batch)
    m_sig = (kind_p == 2).astype(np.int32).reshape(ns, sup, batch)
    bit_3 = bit_p.astype(np.int32).reshape(ns, sup, batch)
    for i in range(ns):
        u, inv, nd = uniqs[i], invs[i], nds[i]
        nu = len(u)
        dk_d[i, :nd] = u[:nd].astype(np.int32)
        dk_d[i, nd:] = n_dual_ext + np.arange(ud - nd, dtype=np.int32)
        dk_s[i, :nu - nd] = (u[nd:] - off).astype(np.int32)
        dk_s[i, nu - nd:] = n_sig + np.arange(us - (nu - nd), dtype=np.int32)
        bin_u[i] = np.where(inv < nd, inv, np.where(inv < nu, ud + inv - nd, ud - 1))
        inv3 = inv.reshape(sup, batch)
        for s in range(sup):
            iv = inv3[s]
            w_d = m_dual[i, s]
            w_s = m_sig[i, s]
            dd[i, s, :nd, 1] = np.bincount(iv, weights=w_d, minlength=nu)[:nd]
            dd[i, s, :nd, 0] = np.bincount(iv, weights=w_d * bit_3[i, s], minlength=nu)[:nd]
            ds[i, s, :nu - nd, 1] = np.bincount(iv, weights=w_s, minlength=nu)[nd:nu]
            ds[i, s, :nu - nd, 0] = np.bincount(iv, weights=w_s * bit_3[i, s],
                                                minlength=nu)[nd:nu]
    return bin_u, dk_d, dk_s, dd, ds, ud, us


def run_chunk_v2(bit, kind, key, prior, pre_ones, pre_tot, dual0, batch, sup, fast_w,
                 slow_w, sig_w, sig_alpha, n_sig, sig0=None, *, device,
                 moved: list | None = None):
    """model_pass_v2 over one chunk whose export has no v2 tables (numpy in,
    uint16 probs[n] out), as avrecode_tpu.ops.model_pass.run_chunk_v2: the
    tables v2_host_tables builds, through run_chunk_v2_tables on `device`
    (`moved` as there)."""
    if len(bit) == 0:
        return np.zeros(0, np.uint16)
    return run_chunk_v2_tables(kind, prior, pre_ones, pre_tot,
                               *v2_host_tables(bit, kind, key, dual0, batch, sup, n_sig),
                               dual0, batch, sup, fast_w, slow_w, sig_w, sig_alpha, n_sig,
                               sig0=sig0, device=device, moved=moved)


def v2_host_tables(bit, kind, key, dual0, batch, sup, n_sig):
    """run_chunk_v2's tables for n > 0 bins: the stream padded to whole
    super-steps (a power of two of them; pad bins are kind-3 no-ops) and
    build_v2_inputs over it. Returns (m, bin_u, dk_d, dk_s, dd, ds)."""
    n = len(bit)
    span = sup * batch
    m = _bucket(-(-n // span)) * span
    pad = m - n
    bin_u, dk_d, dk_s, dd, ds, _, _ = build_v2_inputs(
        _padded(bit, pad, 0), _padded(kind, pad, 3), _padded(key, pad, 0),
        dual0.shape[0] + 1, n_sig, batch, sup)  # + the scratch row ext bins target
    return m, bin_u, dk_d, dk_s, dd, ds


# ---------------------------------------------- model_pass_dict / model_pass

def _prefix_counts_plain(key: torch.Tensor, bit: torch.Tensor):
    """Within-batch per-key exclusive prefix counts of int64[nb, B] keys and
    bits: pre_ones[b, i] = #{j < i : key[b, j] == key[b, i], bit[b, j] == 1}
    and pre_tot likewise without the bit, by a stable sort and segmented
    cumulative sums (JAX's "sort" formulation)."""
    nb, B = key.shape
    ks, order = torch.sort(key, dim=1, stable=True)
    bs = torch.gather(bit, 1, order)
    pos = torch.arange(B, device=key.device).expand(nb, B)
    start = torch.ones_like(ks, dtype=torch.bool)
    start[:, 1:] = ks[:, 1:] != ks[:, :-1]
    ex = torch.cumsum(bs, 1) - bs
    seg_ex = torch.cummax(torch.where(start, ex, -1), 1).values
    seg_first = torch.cummax(torch.where(start, pos, -1), 1).values
    pre1 = torch.empty_like(ex).scatter_(1, order, ex - seg_ex)
    pret = torch.empty_like(ex).scatter_(1, order, pos - seg_first)
    return pre1, pret


def _halve_table_plain(tbl: torch.Tensor, c: int, window: int) -> None:
    """_halve_while (16 iterations) over columns (c, c+1) of every row of
    `tbl`, in place. Only rows over the window change, so only those are
    computed: the same result as halving the whole table."""
    rows = ((tbl[:, c] + tbl[:, c + 1]) > window).nonzero().squeeze(1)
    p, n = im._halve_while(tbl[rows, c], tbl[rows, c + 1], window, _HALVE_DEFAULT)
    tbl[rows, c] = p
    tbl[rows, c + 1] = n


def model_pass_dict(bits, kinds, priors, bin_u, dict_keys, dual0, sig0, *, batch: int,
                    fast_w: int, slow_w: int, sig_w: int, sig_alpha: int):
    """Per-batch dictionary pass (profile 0).

    bits/kinds/priors/bin_u: int32[nb, batch]; bin_u in [0, U) indexes the
      batch's row of dict_keys: int32[nb, U] unified keys (a dual key, or
      n_dual + a sig key), unique per row except that padding entries repeat
      the dual scratch key n_dual - 1.
    dual0: int32[n_dual, 4] and sig0: int32[n_sig, 2] start tables, each
      ending in its scratch row (not modified).

    Batch by batch: each bin's state is its entry's row as of the batch start
    plus its within-batch per-entry prefix counts; then every entry's row
    takes the batch's counts (kind 3 updates nothing, kind 2 only sig rows)
    and is halved (16 iterations). Scratch rows are never written: they feed
    only kind-3 bins (whose probability is the prior) and padding, and a
    write to them is a race between the entries that alias them. Returns
    probs int32[nb * batch]."""
    if _native.on_cpu("model_pass_dict", bits):
        return _model_pass_dict_plain(bits, kinds, priors, bin_u, dict_keys, dual0, sig0,
                                      batch, fast_w, slow_w, sig_w, sig_alpha)
    return _model_pass_dict_cuda(bits, kinds, priors, bin_u, dict_keys, dual0, sig0, batch,
                                 fast_w, slow_w, sig_w, sig_alpha)


def _model_pass_dict_plain(bits, kinds, priors, bin_u, dict_keys, dual0, sig0, batch, fast_w,
                           slow_w, sig_w, sig_alpha):
    i64 = torch.int64
    nb, U = dict_keys.shape
    n_dual, n_sig = dual0.shape[0], sig0.shape[0]
    dev = bits.device
    alpha_on, alpha_off = _alphas(sig_alpha)
    bit, kind, prior, bu_raw = (x.to(i64).reshape(nb, batch)
                                for x in (bits, kinds, priors, bin_u))
    pre1, pret = _prefix_counts_plain(bu_raw, bit)
    bu = bu_raw.clamp(0, U - 1)
    m_dual = ((kind != 2) & (kind != 3)).to(i64)
    m_sig = (kind == 2).to(i64)
    flat = (torch.arange(nb, device=dev)[:, None] * U + bu).reshape(-1)
    tot = torch.zeros((nb * U, 4), dtype=i64, device=dev)
    tot.index_add_(0, flat, torch.stack([bit * m_dual, m_dual, bit * m_sig, m_sig],
                                        -1).reshape(-1, 4))
    tot = tot.reshape(nb, U, 4)
    dk = dict_keys.to(i64)
    is_sig = dk >= n_dual
    drow = torch.where(is_sig, n_dual - 1, dk).clamp(0, n_dual - 1)
    srow = torch.where(is_sig, dk - n_dual, n_sig - 1).clamp(0, n_sig - 1)
    dual = dual0.to(i64, copy=True)
    sig = sig0.to(i64, copy=True)
    probs = torch.empty((nb, batch), dtype=i64, device=dev)
    for b in range(nb):
        dstate = dual[drow[b]]
        sstate = sig[srow[b]]
        d = dstate[bu[b]]
        s = sstate[bu[b]]
        ones = pre1[b]
        zeros = pret[b] - ones
        probs[b] = im._prob_by_kind(kind[b], prior[b], d[:, 0] + ones, d[:, 1] + zeros,
                                    d[:, 2] + ones, d[:, 3] + zeros, s[:, 0] + ones,
                                    s[:, 1] + zeros, alpha_on, alpha_off)
        t = tot[b]
        fp, fn = im._halve_while(dstate[:, 0] + t[:, 0], dstate[:, 1] + t[:, 1] - t[:, 0],
                                 fast_w, _HALVE_DEFAULT)
        sp, sn = im._halve_while(dstate[:, 2] + t[:, 0], dstate[:, 3] + t[:, 1] - t[:, 0],
                                 slow_w, _HALVE_DEFAULT)
        gp, gn = im._halve_while(sstate[:, 0] + t[:, 2], sstate[:, 1] + t[:, 3] - t[:, 2],
                                 sig_w, _HALVE_DEFAULT)
        live_d = drow[b] != n_dual - 1
        live_s = srow[b] != n_sig - 1
        dual[drow[b][live_d]] = torch.stack([fp, fn, sp, sn], 1)[live_d]
        sig[srow[b][live_s]] = torch.stack([gp, gn], 1)[live_s]
    return probs.reshape(-1).to(torch.int32)


def _check_batch(name: str, batch: int) -> None:
    if not 1 <= batch <= _PREFIX_MAX_BATCH:
        raise ValueError(f"{name}: batch={batch} outside the kernels' "
                         f"[1, {_PREFIX_MAX_BATCH}]")


# Batches whose staged rows may wait for their probabilities at once (the
# persistent kernels' ring in device memory).
_STAGE_RING = 128
# Cycle counters the kernels leave behind the ring's flags (csrc/model_pass.cu
# PassProf), in units of 16 cycles: the chain held up by a full ring; its
# block 0's thread 0 at the batch barrier, waiting for the entries' copies,
# in its own loads to stores, and the rest; the first consumer's thread 0
# waiting and working.
_PASS_PROF = 8
_PASS_CTL = 6  # and the chain cluster's own words
PASS_PROF_NAMES = ("ring", "barrier", "copies", "body", "rest", "consumer_wait",
                   "consumer_work")


def pass_profile(scratch: dict) -> dict:
    """Chunk 0's cycle counters of the last chain run on `scratch`, in
    cycles."""
    words = scratch["sync"][0, 1 + scratch["R"]:1 + scratch["R"] + _PASS_PROF].tolist()
    return {k: 16 * v for k, v in zip(PASS_PROF_NAMES, words)}


def _pass_scratch(dev, G: int, nb: int, batch: int, U: int, n_dual: int, n_sig: int) -> dict:
    """The persistent passes' working memory for G chunks of nb batches with
    up to U entries a batch: the working tables, each bin's packed prefix
    counts and entry, the entries (int4 each) and per-batch meta words of the
    pre-pass, the ring of staged rows (2 x int4 an entry), the ring's flags
    and the output. Nothing needs initialising: the C entry clears what it
    counts in."""
    R = max(1, min(_STAGE_RING, nb))

    def empty(*shape):
        return torch.empty(shape, dtype=torch.int32, device=dev)

    return dict(R=R, dual=empty(G, n_dual * 4), sig=empty(G, n_sig * 2),
                pre=empty(G, nb * batch), bin_e=empty(G, nb * batch),
                entries=empty(G, nb * U * 4), meta=empty(G, nb * 2),
                stage=empty(G, R * U * 8), sync=empty(G, 1 + R + _PASS_PROF + _PASS_CTL), probs=empty(G, nb * batch))


def _model_pass_dict_cuda(bits, kinds, priors, bin_u, dict_keys, dual0, sig0, batch, fast_w,
                          slow_w, sig_w, sig_alpha, phases: int = 7, scratch: dict | None = None):
    """`phases` is a sum of 1 (the pre-pass's ordered walk), 4 (its totals)
    and 2 (the chain), each on the `scratch` of the phases before it, for
    timing them apart; 7 is the pass."""
    _native.check_cuda("model_pass_dict", bits, kinds, priors, bin_u, dict_keys, dual0, sig0)
    _check_batch("model_pass_dict", batch)
    nb, U = dict_keys.shape
    if any(x.numel() != nb * batch for x in (bits, kinds, priors, bin_u)):
        raise ValueError(f"model_pass_dict: bin planes must hold {nb} x {batch} bins")
    if dual0.dim() != 2 or dual0.shape[1] != 4 or sig0.dim() != 2 or sig0.shape[1] != 2:
        raise ValueError("model_pass_dict: tables must be [n, 4] / [n, 2]")
    if not 1 <= U <= _PREFIX_MAX_BATCH:
        raise ValueError(f"model_pass_dict: dict width {U} outside [1, {_PREFIX_MAX_BATCH}]")
    alpha_on, alpha_off = _alphas(sig_alpha)
    n_dual, n_sig = dual0.shape[0], sig0.shape[0]
    w = scratch or _pass_scratch(bits.device, 1, nb, batch, U, n_dual, n_sig)
    _native.launch("model_pass_dict", "artc_model_pass_dict", bits.device, bits, kinds, priors,
                   bin_u, dict_keys, dual0, sig0, w["dual"], w["sig"], w["pre"], w["entries"],
                   w["meta"], w["stage"], w["sync"], w["probs"], nb, batch, U, n_dual, n_sig,
                   w["R"], fast_w, slow_w, sig_w, alpha_on, alpha_off, phases)
    return w["probs"][0]


_IMPLS = ("sort", "mm")


def model_pass(bits, kinds, keys, priors, dual0, sig0, *, batch: int, fast_w: int,
               slow_w: int, sig_w: int, sig_alpha: int, impl: str = "sort"):
    """Per-batch profile-0 pass; "sort" and "mm" name the two TPU
    formulations of its within-batch prefix counts (a stable sort, a masked
    key-equality product), which give identical outputs: both run the same
    kernel here.

    bits/kinds/keys/priors: int32[nb * batch] (padding: kind 0, the scratch
      key n_dual - 1, bit 0, prior 0).
    dual0: int32[n_dual, 4] start table ending in its scratch row; sig0:
      int32[n_sig, 2] (neither is modified).
    A leading chunk axis on all six ([G, nb * batch], [G, n_dual, 4], [G,
    n_sig, 2]) runs G independent chunks, each on its own tables (the mesh's
    vmap over a device's chunks), in one launch sequence.

    Batch by batch: kind-3 bins are retargeted at the dual scratch row and
    sig bins read the sig table (key) and the dual scratch row; each bin's
    state is its rows as of the batch start plus its within-batch per-key
    prefix counts; then every bin adds its count to its row and both whole
    tables are halved (16 iterations). Returns probs int32[nb * batch], or
    [G, nb * batch]."""
    if impl not in _IMPLS:
        raise ValueError(f"model_pass impl must be 'sort' or 'mm', got {impl!r}")
    one = bits.dim() == 1
    if one:
        bits, kinds, keys, priors, dual0, sig0 = (x[None] for x in (bits, kinds, keys, priors,
                                                                    dual0, sig0))
    if _native.on_cpu("model_pass", bits):
        probs = torch.stack([_model_pass_plain(bits[g], kinds[g], keys[g], priors[g], dual0[g],
                                               sig0[g], batch, fast_w, slow_w, sig_w, sig_alpha)
                             for g in range(bits.shape[0])])
    else:
        probs = _model_pass_cuda(bits, kinds, keys, priors, dual0, sig0, batch, fast_w, slow_w,
                                 sig_w, sig_alpha)
    return probs[0] if one else probs


def _model_pass_plain(bits, kinds, keys, priors, dual0, sig0, batch, fast_w, slow_w, sig_w,
                      sig_alpha):
    i64 = torch.int64
    nb = bits.numel() // batch
    n_dual, n_sig = dual0.shape[0], sig0.shape[0]
    dev = bits.device
    alpha_on, alpha_off = _alphas(sig_alpha)
    bit, kind, key, prior = (x.to(i64).reshape(nb, batch) for x in (bits, kinds, keys, priors))
    is_sig = kind == 2
    is_ext = kind == 3
    key = torch.where(is_ext, n_dual - 1, key)
    pre1, pret = _prefix_counts_plain(torch.where(is_sig, key + n_dual, key), bit)
    dkey = torch.where(is_sig, n_dual - 1, key)
    skey = torch.where(is_sig, key, 0)
    # Gathers clamp as JAX's do; adds drop out-of-range rows, and sig / kind-3
    # bins add nothing to the dual table (non-sig bins nothing to sig).
    dg = dkey.clamp(0, n_dual - 1)
    sg = skey.clamp(0, n_sig - 1)
    add_d = ~(is_sig | is_ext) & (dkey >= 0) & (dkey < n_dual)
    add_s = is_sig & (skey >= 0) & (skey < n_sig)
    dual = dual0.to(i64, copy=True)
    sig = sig0.to(i64, copy=True)
    probs = torch.empty((nb, batch), dtype=i64, device=dev)
    for b in range(nb):
        d = dual[dg[b]]
        s = sig[sg[b]]
        ones = pre1[b]
        zeros = pret[b] - ones
        probs[b] = im._prob_by_kind(kind[b], prior[b], d[:, 0] + ones, d[:, 1] + zeros,
                                    d[:, 2] + ones, d[:, 3] + zeros, s[:, 0] + ones,
                                    s[:, 1] + zeros, alpha_on, alpha_off)
        one = bit[b]
        zero = 1 - one
        m = add_d[b]
        dual.index_add_(0, dkey[b][m], torch.stack([one, zero, one, zero], 1)[m])
        m = add_s[b]
        sig.index_add_(0, skey[b][m], torch.stack([one, zero], 1)[m])
        _halve_table_plain(dual, 0, fast_w)
        _halve_table_plain(dual, 2, slow_w)
        _halve_table_plain(sig, 0, sig_w)
    return probs.reshape(-1).to(torch.int32)


def _model_pass_cuda(bits, kinds, keys, priors, dual0, sig0, batch, fast_w, slow_w, sig_w,
                     sig_alpha, phases: int = 7, scratch: dict | None = None):
    """G chunks ([G, n] planes, [G, n_dual, 4] and [G, n_sig, 2] tables);
    `phases` and `scratch` as in _model_pass_dict_cuda. Returns [G, n]."""
    _native.check_cuda("model_pass", bits, kinds, keys, priors, dual0, sig0)
    _check_batch("model_pass", batch)
    G, n = bits.shape
    nb = n // batch
    if n != nb * batch or any(x.shape != bits.shape for x in (kinds, keys, priors)):
        raise ValueError(f"model_pass: bin planes must hold whole batches of {batch} bins")
    if dual0.dim() != 3 or dual0.shape[0] != G or dual0.shape[2] != 4 or sig0.dim() != 3 \
            or sig0.shape[0] != G or sig0.shape[2] != 2:
        raise ValueError("model_pass: tables must be [n, 4] / [n, 2] per chunk")
    alpha_on, alpha_off = _alphas(sig_alpha)
    n_dual, n_sig = dual0.shape[1], sig0.shape[1]
    w = scratch or _pass_scratch(bits.device, G, nb, batch, batch, n_dual, n_sig)
    _native.launch("model_pass", "artc_model_pass", bits.device, bits, kinds, keys, priors,
                   dual0, sig0, w["dual"], w["sig"], w["pre"], w["bin_e"], w["entries"],
                   w["meta"], w["stage"], w["sync"], w["probs"], G, nb, batch, n_dual, n_sig,
                   w["R"], fast_w, slow_w, sig_w, alpha_on, alpha_off, phases)
    return w["probs"]


# ---- numpy mirrors of the persistent kernels' arithmetic (csrc/model_pass.cu)
#
# The CUDA kernels cannot run without a card; these mirrors follow their
# pre-pass (prefix_walk_kernel, dict_entries_kernel, entry_totals_kernel) and
# their chain (chain_role, consumer_role) step by step, so the CPU tests can
# hold the kernels' formulation (entries, packed totals, the whole-table
# halving rule) against the plain versions and JAX.

_TOT_SHIFT = 15
_COUNT_MASK = (1 << _TOT_SHIFT) - 1
_LOAD_BIT = 1 << 31
_LIVE_BIT = 1 << 30


def _walk_mirror(keys, bits, kinds, n_dual: int, n_sig: int, dict_keys=None):
    """One batch's pre-pass. keys/bits/kinds: int arrays [B] (dict: keys is
    bin_u and dict_keys the batch's int[U] dictionary). Returns (pre int64[B]
    = pre_ones | pre_tot << 16, bin_e int64[B], entries int64[n_u, 4] = (dual
    row, sig row, dual totals, sig totals), hazard)."""
    B = len(keys)
    is_dict = dict_keys is not None
    ukey = np.asarray(keys, np.int64)
    if not is_dict:
        ukey = np.where(kinds == 3, n_dual - 1, np.where(kinds == 2, ukey + n_dual, ukey))
    table = {}  # key -> [entry, running ones, running total]
    pre = np.zeros(B, np.int64)
    bin_e = np.zeros(B, np.int64)
    rows = []
    for i0 in range(0, B, 32):  # one warp step: 32 bins, equal keys grouped
        lanes = range(i0, min(i0 + 32, B))
        groups = {}
        for i in lanes:
            groups.setdefault(int(ukey[i]), []).append(i)
        for k, members in groups.items():  # in order of each group's leader (lowest lane)
            if k not in table:
                table[k] = [len(table), 0, 0]
                sk = k - n_dual
                rows.append([min(max(k, 0), n_dual - 1), min(max(sk, 0), n_sig - 1),
                             _LIVE_BIT if 0 <= k < n_dual else 0,
                             _LIVE_BIT if 0 <= sk < n_sig else 0])
            e, ones, tot = table[k]
            for i in members:
                pre[i] = ones | tot << 16
                bin_e[i] = e
                ones += int(bits[i]) & 1
                tot += 1
            table[k][1:] = [ones, tot]
    if is_dict:
        U = len(dict_keys)
        dk = np.asarray(dict_keys, np.int64)
        sig_key = dk >= n_dual
        d = np.clip(np.where(sig_key, n_dual - 1, dk), 0, n_dual - 1)
        s = np.clip(np.where(sig_key, dk - n_dual, n_sig - 1), 0, n_sig - 1)
        entries = np.stack([d, s, _LOAD_BIT | np.where(d != n_dual - 1, _LIVE_BIT, 0),
                            _LOAD_BIT | np.where(s != n_sig - 1, _LIVE_BIT, 0)], 1)
        bin_e = np.clip(np.asarray(keys, np.int64), 0, U - 1)
    else:
        entries = np.array(rows, np.int64).reshape(-1, 4)
    hazard = False
    for i in range(B):
        k = int(kinds[i])
        if k == 3:
            continue
        entries[bin_e[i], 3 if k == 2 else 2] += (int(bits[i]) & 1) | 1 << _TOT_SHIFT
        if not is_dict and not 0 <= int(keys[i]) < (n_sig if k == 2 else n_dual):
            hazard = True
    return pre, bin_e, entries, hazard


def _halve16(p, n, window):
    p, n = im._halve_while(torch.from_numpy(p), torch.from_numpy(n), window, _HALVE_DEFAULT)
    return p.numpy(), n.numpy()


def _entry_pass_mirror(bits, kinds, keys, priors, dual0, sig0, batch, fast_w, slow_w, sig_w,
                       sig_alpha, dict_keys=None):
    """The chain and the consumers over numpy int arrays: per batch the
    entries' rows are staged (all loads before any store), the bins' probs
    come from the staged rows, the entries add and halve, and model_pass
    halves whole tables only while a row is over its window. Returns probs
    int32[nb * batch] and the number of whole-table halvings."""
    n_dual, n_sig = dual0.shape[0], sig0.shape[0]
    nb = len(bits) // batch
    alpha_on, alpha_off = _alphas(sig_alpha)
    dual = dual0.astype(np.int64)
    sig = sig0.astype(np.int64)
    is_dict = dict_keys is not None
    whole, more, n_whole = not is_dict, False, 0
    out = []
    for b in range(nb):
        sl = slice(b * batch, (b + 1) * batch)
        pre, bin_e, ent, _ = _walk_mirror(keys[sl], bits[sl], kinds[sl], n_dual, n_sig,
                                          dict_keys[b] if is_dict else None)
        whole, more = whole or more, False
        tot = ent[:, 2:] >> _TOT_SHIFT & _COUNT_MASK
        ones = ent[:, 2:] & _COUNT_MASK
        load = (ent[:, 2:] & _LOAD_BIT != 0) | (tot > 0)
        write = load & (ent[:, 2:] & _LIVE_BIT != 0)
        d = np.where(load[:, :1], dual[ent[:, 0]], 0)  # the staged rows
        s = np.where(load[:, 1:], sig[ent[:, 1]], 0)
        k = kinds[sl].astype(np.int64)
        dsel = (k == 0) | (k == 1)
        ssel = ~dsel & (k != 3)
        db = np.where(dsel[:, None], d[bin_e], 0)
        sb = np.where(ssel[:, None], s[bin_e], 0)
        p1 = pre & 0xFFFF
        p0 = (pre >> 16) - p1
        t = torch.from_numpy
        out.append(im._prob_by_kind(
            t(k), t(priors[sl].astype(np.int64)), t(db[:, 0] + p1), t(db[:, 1] + p0),
            t(db[:, 2] + p1), t(db[:, 3] + p0), t(sb[:, 0] + p1), t(sb[:, 1] + p0), alpha_on,
            alpha_off).numpy())
        z = tot - ones
        new_d = d + np.stack([ones[:, 0], z[:, 0], ones[:, 0], z[:, 0]], 1)
        new_s = s + np.stack([ones[:, 1], z[:, 1]], 1)
        if not whole:
            new_d[:, 0], new_d[:, 1] = _halve16(new_d[:, 0].copy(), new_d[:, 1].copy(), fast_w)
            new_d[:, 2], new_d[:, 3] = _halve16(new_d[:, 2].copy(), new_d[:, 3].copy(), slow_w)
            new_s[:, 0], new_s[:, 1] = _halve16(new_s[:, 0].copy(), new_s[:, 1].copy(), sig_w)
            wd, ws = write[:, 0], write[:, 1]
            more = bool(((new_d[wd, 0] + new_d[wd, 1] > fast_w)
                         | (new_d[wd, 2] + new_d[wd, 3] > slow_w)).any()
                        or (new_s[ws, 0] + new_s[ws, 1] > sig_w).any()) and not is_dict
        dual[ent[write[:, 0], 0]] = new_d[write[:, 0]]
        sig[ent[write[:, 1], 1]] = new_s[write[:, 1]]
        if whole:
            n_whole += 1
            dt, st = torch.from_numpy(dual), torch.from_numpy(sig)  # views: halved in place
            _halve_table_plain(dt, 0, fast_w)
            _halve_table_plain(dt, 2, slow_w)
            _halve_table_plain(st, 0, sig_w)
            whole = bool(((dual[:, 0] + dual[:, 1] > fast_w) | (dual[:, 2] + dual[:, 3] > slow_w))
                         .any() or (sig[:, 0] + sig[:, 1] > sig_w).any())
    return np.concatenate(out).astype(np.int32), n_whole


# ---- numpy mirror of the frozen-batch scans' persistent pass (scan_kernel)
#
# The same sequence as the kernel over numpy int64 arrays: iteration t
# stages super-step t into buffer t & 1 (a dual slot's int4 [sup, ud], a sig
# slot's int2 [sup, us]) with the early-exit halving, beside the
# probabilities of super-step t - 1 from the other buffer, each bin's state
# one gather at its clamped flat index. The CPU tests hold it against JAX.

def _halve_until(p, n, window: int, iters: int):
    """The kernels' halving (csrc/model_pass.cu halve_fast): the first two
    iterations in closed form ((x + 1) >> 1 is ceil(x / 2), and two of them
    (x + 3) >> 2), then each pair stops at the first iteration that finds it
    within its window, after at most `iters` in all."""
    p1, n1 = (p + 1) >> 1, (n + 1) >> 1
    h1 = (iters >= 1) & (p + n > window)
    h2 = h1 & (iters >= 2) & (p1 + n1 > window)
    p = np.where(h2, (p + 3) >> 2, np.where(h1, p1, p))
    n = np.where(h2, (n + 3) >> 2, np.where(h1, n1, n))
    live = h2
    for _ in range(2, iters):
        live &= p + n > window
        if not live.any():
            break
        p = np.where(live, (p + 1) >> 1, p)
        n = np.where(live, (n + 1) >> 1, n)
    return p, n


def _scan_mirror(kind, slot, prior, pre1, pret, dk_d, dk_s, d_one, d_tot, dual, sig, batch,
                 sup, fast_w, slow_w, sig_w, sig_alpha):
    """scan_kernel on one chunk. kind/slot/prior (pre1/pret or None): int64
    [ns * sup * batch]; d_one/d_tot: int64 [ns, sup, U]; dual/sig: the int64
    start tables, updated in place. Returns probs int32."""
    ns, ud = dk_d.shape
    us = dk_s.shape[1]
    U = ud + us
    span = sup * batch
    its = [im._halve_iters(w, batch) for w in (fast_w, slow_w, sig_w)]
    alpha_on, alpha_off = _alphas(sig_alpha)
    cst_d = np.zeros((2, sup * ud, 4), np.int64)
    cst_s = np.zeros((2, sup * us, 2), np.int64)
    probs = np.zeros(ns * span, np.int32)
    for it in range(ns + 1):
        if it < ns:  # the stage blocks: super-step it
            t, b = it, it & 1
            v = dual[dk_d[t]]
            g = sig[dk_s[t]]
            for s in range(sup):
                cst_d[b, s * ud:(s + 1) * ud] = v
                cst_s[b, s * us:(s + 1) * us] = g
                one, tot = d_one[t, s], d_tot[t, s]
                fp, fn = _halve_until(v[:, 0] + one[:ud], v[:, 1] + tot[:ud] - one[:ud],
                                      fast_w, its[0])
                sp, sn = _halve_until(v[:, 2] + one[:ud], v[:, 3] + tot[:ud] - one[:ud],
                                      slow_w, its[1])
                gp, gn = _halve_until(g[:, 0] + one[ud:], g[:, 1] + tot[ud:] - one[ud:],
                                      sig_w, its[2])
                v = np.stack([fp, fn, sp, sn], 1)
                g = np.stack([gp, gn], 1)
            dual[dk_d[t]] = v
            sig[dk_s[t]] = g
        if it > 0:  # the probability blocks: super-step it - 1
            t, b = it - 1, (it - 1) & 1
            lo = t * span
            k = kind[lo:lo + span]
            sl = slot[lo:lo + span]
            j = np.arange(span)
            flat = np.clip(j // batch * U + sl, 0, sup * U - 1)
            sub = np.where((sl >= 0) & (sl < U), j // batch, flat // U)
            r = flat - sub * U
            live = k != 3
            is_d = live & (r < ud)
            is_s = live & (r >= ud)
            d = np.where(is_d[:, None], cst_d[b, np.where(is_d, sub * ud + r, 0)], 1)
            g = np.where(is_s[:, None], cst_s[b, np.where(is_s, sub * us + r - ud, 0)], 1)
            c = np.concatenate([d, g], 1)
            if pre1 is not None:
                ones = np.where(live, pre1[lo:lo + span], 0)
                zeros = np.where(live, pret[lo:lo + span], 0) - ones
                c = c + np.stack([ones, zeros] * 3, 1)
            tc = torch.from_numpy
            probs[lo:lo + span] = im._prob_by_kind(
                tc(k), tc(prior[lo:lo + span]), *(tc(c[:, q].copy()) for q in range(6)),
                alpha_on, alpha_off).numpy()
    return probs


def _v3_core_mirror(kind_all, slot_all, prior_all, dk_d, dk_s, deltas, dual0, batch, sup,
                    fast_w, slow_w, sig_w, sig_alpha, ud, us, n_sig, sig0_idx, sig0_val):
    """v3_core by the kernel's formulation: the arguments of _v3_core_plain
    (torch CPU tensors), probs as a torch int32 tensor."""
    if kind_all.dim() == 2:
        return torch.stack([_v3_core_mirror(
            kind_all[g], slot_all[g], prior_all[g], dk_d[g], dk_s[g], deltas[g], dual0[g],
            batch, sup, fast_w, slow_w, sig_w, sig_alpha, ud, us, n_sig,
            None if sig0_idx is None else sig0_idx[g],
            None if sig0_val is None else sig0_val[g]) for g in range(kind_all.shape[0])])
    ns = kind_all.shape[0] // (sup * batch)
    d = deltas.view(torch.int32).numpy().astype(np.int64).reshape(ns, sup, ud + us) & 0xFFFFFFFF
    dual = np.concatenate([dual0.numpy().astype(np.int64), np.ones((1 + ud, 4), np.int64)])
    sig = np.zeros((n_sig + us, 2), np.int64)
    sig[n_sig:] = 1
    if sig0_idx is not None:
        si = sig0_idx.numpy().astype(np.int64)
        keep = (si >= 0) & (si < n_sig)
        sig[si[keep]] = sig0_val.numpy()[keep].astype(np.int64) & 0xFFFF
    i64 = [x.numpy().astype(np.int64) for x in (kind_all, slot_all, prior_all, dk_d, dk_s)]
    return torch.from_numpy(_scan_mirror(*i64[:3], None, None, *i64[3:], d & 0xFFFF, d >> 16,
                                         dual, sig, batch, sup, fast_w, slow_w, sig_w,
                                         sig_alpha))


def _model_pass_v2_mirror(kinds, priors, pre1, pret, bin_u, dk_d, dk_s, dd, ds, dual0, sig0,
                          batch, sup, fast_w, slow_w, sig_w, sig_alpha):
    """model_pass_v2 by the kernel's formulation: the arguments of
    _model_pass_v2_plain (torch CPU tensors), probs as a torch int32 tensor."""
    def a(x):
        return x.numpy().astype(np.int64)

    d = np.concatenate([a(dd), a(ds)], 2)
    return torch.from_numpy(_scan_mirror(
        *(a(x).reshape(-1) for x in (kinds, bin_u, priors, pre1, pret)), a(dk_d), a(dk_s),
        d[..., 0], d[..., 1], a(dual0), a(sig0), batch, sup, fast_w, slow_w, sig_w, sig_alpha))


def _bucket(n_batches: int) -> int:
    # Batch counts pad to a power of two, as in the JAX package (its programs
    # are reused across chunk sizes; here only the padded output is the same).
    b = 1
    while b < n_batches:
        b *= 2
    return b


def build_dicts(kind_p, key_p, n_dual_ext, batch):
    """Per-batch unique-key dictionaries for the dict pass (host numpy, a
    copy of the JAX package's: its module imports jax).

    Returns (bin_u int32[n_batches, batch], dict_keys int32[n_batches, U])
    where U is a power-of-two bucket of the max per-batch unique count.
    Unified key space: dual keys as-is (kind-3 bins retargeted at the scratch
    row n_dual_ext - 1, as in model_pass), sig keys offset by n_dual_ext.
    Padding entries repeat the scratch key."""
    scratch = n_dual_ext - 1
    ukey = np.where(kind_p == 3, scratch, key_p.astype(np.int64))
    ukey = np.where(kind_p == 2, key_p.astype(np.int64) + n_dual_ext, ukey)
    nb = len(ukey) // batch
    ukey_b = ukey.reshape(nb, batch)
    uniqs = []
    invs = np.empty((nb, batch), np.int32)
    for i in range(nb):
        u, inv = np.unique(ukey_b[i], return_inverse=True)
        uniqs.append(u)
        invs[i] = inv.astype(np.int32)
    u_width = _bucket(max(len(u) for u in uniqs))
    dict_keys = np.full((nb, u_width), scratch, np.int32)
    for i, u in enumerate(uniqs):
        dict_keys[i, :len(u)] = u.astype(np.int32)
    return invs, dict_keys


def run_chunk(bit, kind, key, prior, dual0, batch, fast_w, slow_w, sig_w, sig_alpha, n_sig,
              impl=None, sig0=None, *, device, moved: list | None = None):
    """The dict / sort / mm pass over one chunk (numpy in, uint16 probs[n]
    out): the inputs run_chunk_inputs stages, through the pass `impl`
    (default default_impl()) names; any other value than "dict", "sort" or
    "mm" raises. `moved`, if given, receives the bytes uploaded and the
    probs' bytes downloaded."""
    impl = impl or default_impl()
    if impl != "dict" and impl not in _IMPLS:
        raise ValueError(f"run_chunk impl must be 'dict', 'sort' or 'mm', got {impl!r}")
    n = len(bit)
    if n == 0:
        return np.zeros(0, np.uint16)
    args, kw = run_chunk_inputs(bit, kind, key, prior, dual0, batch, fast_w, slow_w, sig_w,
                                sig_alpha, n_sig, impl, sig0, device=device)
    probs = model_pass_dict(*args, **kw) if impl == "dict" else model_pass(*args, impl=impl,
                                                                           **kw)
    probs = probs[:n].cpu()
    if moved is not None:
        moved.append(sum(t.nbytes for t in args) + probs.nbytes)
    return probs.numpy().astype(np.uint16)


def run_chunk_inputs(bit, kind, key, prior, dual0, batch, fast_w, slow_w, sig_w, sig_alpha,
                     n_sig, impl, sig0=None, *, device):
    """The arguments run_chunk gives model_pass_dict (impl "dict") or
    model_pass (any other) for one chunk of n > 0 bins: the stream padded
    to a power-of-two count of batches (padding bins: kind 0, the scratch
    key, bit 0, prior 0), the dual scratch row (ones) appended and, for
    dict, the sig scratch row (zeros), uploaded to `device`. Returns
    (tensors, keywords)."""
    n = len(bit)
    n_dual = dual0.shape[0]
    m = _bucket(-(-n // batch)) * batch
    pad = m - n
    scratch = n_dual  # the appended scratch row
    bit_p = _padded(bit, pad, 0)
    kind_p = _padded(kind, pad, 0)
    key_p = _padded(key, pad, scratch)
    prior_p = _padded(prior, pad, 0)
    dual_ext = np.concatenate([dual0.astype(np.int32), np.ones((1, 4), np.int32)])
    sig_base = np.zeros((n_sig, 2), np.int32) if sig0 is None else sig0.astype(np.int32)
    kw = dict(batch=int(batch), fast_w=int(fast_w), slow_w=int(slow_w), sig_w=int(sig_w),
              sig_alpha=int(sig_alpha))
    if impl == "dict":
        nb = m // batch
        bin_u, dict_keys = build_dicts(kind_p, key_p, n_dual + 1, batch)
        sig_ext = np.concatenate([sig_base, np.zeros((1, 2), np.int32)])
        return (*(_upload(a.reshape(nb, batch), device) for a in (bit_p, kind_p, prior_p)),
                *(_upload(a, device) for a in (bin_u, dict_keys, dual_ext, sig_ext))), kw
    return tuple(_upload(a, device) for a in (bit_p, kind_p, key_p, prior_p, dual_ext,
                                              sig_base)), kw
