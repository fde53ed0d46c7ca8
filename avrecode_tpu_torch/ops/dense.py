"""Profile 0's chunk on the card from one narrow blob.

The host route (ops.model_pass.v2_tables_inputs, ops.lanes.interleaved_planes)
widens every array of a dense chunk to int32 and pads it on the host, and
sends the probs down and up again as int32 planes. On the card a chunk
crosses the bus once instead, at the dense export's own widths
(native/dense_export.h), packed by `pack` into one byte blob laid out by
`Layout`:

    bit, kind u8[n]; prior, pre_ones, pre_tot u16[n]; bin_u u32[m];
    dk_d u32[ns, ud]; dk_s u32[ns, us]; dd u16[ns, sup, ud, 2];
    ds u16[ns, sup, us, 2]; dual0 u16[n_dual, 4]; sig0 u16[n_sig, 2]

each segment starting on a 256-byte boundary. Two kernels then write what
the host route builds, exactly:

  - `expand`: model_pass_v2's arguments, as v2_tables_inputs stages them:
    the four bin planes int32 [ns, sup, batch] padded to m (kind 3, prior
    1, prefix counts 0), dd/ds widened to int32, and the extended start
    tables (dual0 then 1 + ud rows of ones; sig0 then us rows of ones).
    bin_u, dk_d and dk_s are int32 views of the blob: their bits are
    already the pass's;
  - `lane_planes`: the masked lane scan's [T, K] planes from the blob's
    bits and the pass's probs on the card, as interleaved_planes builds
    them from host arrays (the steps past n: bit 0, probability 1,
    invalid).

Each has a plain PyTorch version, taken only for CPU tensors, and a CUDA
kernel (csrc/wire_expand.cu dense_expand_kernel and dense_lanes_kernel, one
launch each) for CUDA tensors.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from .. import _native

_ALIGN = 256
# The blob's segments in order: (name, element dtype).
SEGMENTS = (("bit", np.uint8), ("kind", np.uint8), ("prior", np.uint16),
            ("pre_ones", np.uint16), ("pre_tot", np.uint16), ("bin_u", np.uint32),
            ("dk_d", np.uint32), ("dk_s", np.uint32), ("dd", np.uint16), ("ds", np.uint16),
            ("dual0", np.uint16), ("sig0", np.uint16))
# The torch dtype that carries each width's bits.
_CARRIER = {1: torch.uint8, 2: torch.int16, 4: torch.int32}


@dataclass(frozen=True)
class Layout:
    """The shapes of one chunk's blob, its segments' element counts and byte
    offsets (`counts[k]`, `offs[k]` for SEGMENTS[k]) and its length."""
    n: int
    m: int
    ns: int
    sup: int
    batch: int
    ud: int
    us: int
    n_dual: int
    n_sig: int
    counts: tuple
    offs: tuple
    nbytes: int


def layout(n: int, m: int, ns: int, sup: int, batch: int, ud: int, us: int, n_dual: int,
           n_sig: int) -> Layout:
    """The blob of a chunk of n bins padded to m = ns * sup * batch; m stays
    below 2^31, as dense_expand_kernel checks too (it indexes in 64 bits;
    the bound keeps every bin index an int32)."""
    if m >= 1 << 31 or m != ns * sup * batch or not 0 < n <= m:
        raise ValueError(f"dense blob: n={n}, m={m} (ns={ns} x sup={sup} x batch={batch}) "
                         f"outside 0 < n <= m < 2^31")
    counts = (n, n, n, n, n, m, ns * ud, ns * us, ns * sup * ud * 2, ns * sup * us * 2,
              n_dual * 4, n_sig * 2)
    offs, pos = [], 0
    for count, (_, dtype) in zip(counts, SEGMENTS):
        offs.append(pos)
        pos += -(-count * np.dtype(dtype).itemsize // _ALIGN) * _ALIGN
    return Layout(n, m, ns, sup, batch, ud, us, n_dual, n_sig, counts, tuple(offs), pos)


def chunk_layout(an, c) -> Layout:
    """The blob layout of dense chunk `c` (native tables present) of `an`."""
    ns, ud = c.v2_dk_d.shape
    return layout(len(c.bit), int(c.v2_m), ns, an.sup, an.batch, ud, c.v2_dk_s.shape[1],
                  an.n_dual, an.n_sig)


def pack(c, lay: Layout, out: np.ndarray) -> None:
    """Writes chunk `c`'s blob into `out` (uint8[lay.nbytes], pinned memory
    on the card): each array at its export width (the parse's int32 copies
    of dk, dd, ds, dual0 and the sparse sig0 rows narrowed back; every value
    fits by construction), the sig0 segment zero but at the chunk's warm
    rows. The gaps between segments are never read and keep what they
    held."""
    def seg(k: int) -> np.ndarray:
        dtype = SEGMENTS[k][1]
        o = lay.offs[k]
        return out[o:o + lay.counts[k] * np.dtype(dtype).itemsize].view(dtype)

    for k, a in enumerate((c.bit, c.kind, c.prior, c.pre_ones, c.pre_tot, c.v2_bin_u)):
        seg(k)[:] = a
    seg(6).view(np.int32)[:] = c.v2_dk_d.reshape(-1)
    seg(7).view(np.int32)[:] = c.v2_dk_s.reshape(-1)
    for k, a in ((8, c.v2_dd), (9, c.v2_ds), (10, c.dual0)):
        np.copyto(seg(k), a.reshape(-1), casting="unsafe")
    sig = seg(11).reshape(lay.n_sig, 2)
    sig[:] = 0
    if c.sig0_idx is not None and len(c.sig0_idx):
        sig[c.sig0_idx.astype(np.int64)] = c.sig0_val


def _seg(blob: torch.Tensor, lay: Layout, k: int) -> torch.Tensor:
    """Segment k of a blob tensor (uint8), as the dtype that carries its
    width."""
    size = np.dtype(SEGMENTS[k][1]).itemsize
    o = lay.offs[k]
    return blob[o:o + lay.counts[k] * size].view(_CARRIER[size])


def _views(blob: torch.Tensor, lay: Layout) -> tuple:
    """bin_u int32[ns, sup, batch], dk_d int32[ns, ud], dk_s int32[ns, us]:
    views of the blob."""
    return (_seg(blob, lay, 5).reshape(lay.ns, lay.sup, lay.batch),
            _seg(blob, lay, 6).reshape(lay.ns, lay.ud),
            _seg(blob, lay, 7).reshape(lay.ns, lay.us))


def expand(blob: torch.Tensor, lay: Layout) -> tuple:
    """model_pass_v2's tensors from a chunk's blob (uint8[lay.nbytes]):
    (kinds, priors, pre1, pret, bin_u, dk_d, dk_s, dd, ds, dual_ext,
    sig_ext), equal to v2_tables_inputs' for the same chunk."""
    if _native.on_cpu("dense_expand", blob):
        return _expand_plain(blob, lay)
    return _expand_cuda(blob, lay)


def _expand_plain(blob, lay: Layout):
    i32 = torch.int32
    n, m = lay.n, lay.m
    sh = (lay.ns, lay.sup, lay.batch)

    def wide(k):  # the segment's values as int32
        t = _seg(blob, lay, k).to(i32)
        return t & 0xFFFF if SEGMENTS[k][1] == np.uint16 else t

    def padded(k, fill):
        t = torch.full((m,), fill, dtype=i32)
        t[:n] = wide(k)
        return t.reshape(sh)

    planes = [padded(k, v) for k, v in ((1, 3), (2, 1), (3, 0), (4, 0))]
    dd = wide(8).reshape(lay.ns, lay.sup, lay.ud, 2)
    ds = wide(9).reshape(lay.ns, lay.sup, lay.us, 2)
    dual = torch.cat([wide(10).reshape(lay.n_dual, 4), torch.ones((1 + lay.ud, 4), dtype=i32)])
    sig = torch.cat([wide(11).reshape(lay.n_sig, 2), torch.ones((lay.us, 2), dtype=i32)])
    return (*planes, *_views(blob, lay), dd, ds, dual, sig)


def _expand_cuda(blob, lay: Layout):
    _native.check_cuda("dense_expand", blob, dtype=torch.uint8)
    if blob.shape != (lay.nbytes,) or blob.data_ptr() % _ALIGN:
        raise ValueError(f"dense_expand: blob must be uint8[{lay.nbytes}] on a "
                         f"{_ALIGN}-byte boundary, got {tuple(blob.shape)}")
    dev = blob.device
    i32 = torch.int32
    sh = (lay.ns, lay.sup, lay.batch)
    planes = torch.empty((4, *sh), dtype=i32, device=dev)
    dd = torch.empty((lay.ns, lay.sup, lay.ud, 2), dtype=i32, device=dev)
    ds = torch.empty((lay.ns, lay.sup, lay.us, 2), dtype=i32, device=dev)
    dual = torch.empty((lay.n_dual + 1 + lay.ud, 4), dtype=i32, device=dev)
    sig = torch.empty((lay.n_sig + lay.us, 2), dtype=i32, device=dev)
    offs = (ctypes.c_longlong * len(lay.offs))(*lay.offs)
    _native.launch("dense_expand", "artc_dense_expand", dev, blob, ctypes.addressof(offs),
                   planes, dd, ds, dual, sig, lay.n, lay.m, dd.numel(), ds.numel(),
                   lay.n_dual * 4, dual.numel(), lay.n_sig * 2, sig.numel())
    return (*planes.unbind(0), *_views(blob, lay), dd, ds, dual, sig)


def lane_planes(blob: torch.Tensor, probs: torch.Tensor, lay: Layout, T: int, K: int):
    """The masked lane scan's planes of the chunk: bits int32[T, K] from the
    blob, probs int32[T, K] from the pass's int32 probs (their low 16 bits,
    the host route's uint16), valid bool[T, K]; the steps past n hold bit 0,
    probability 1 and false, as interleaved_planes."""
    if T * K < lay.n or probs.shape[0] < lay.n:
        raise ValueError(f"lane_planes: T={T} x K={K} steps or {probs.shape[0]} probs "
                         f"cannot hold n={lay.n}")
    if _native.on_cpu("dense_lanes", blob):
        return _lane_planes_plain(blob, probs, lay, T, K)
    return _lane_planes_cuda(blob, probs, lay, T, K)


def _lane_planes_plain(blob, probs, lay: Layout, T: int, K: int):
    n, size = lay.n, T * K
    bits = torch.zeros(size, dtype=torch.int32)
    bits[:n] = _seg(blob, lay, 0).to(torch.int32)
    p = torch.ones(size, dtype=torch.int32)
    p[:n] = probs[:n] & 0xFFFF
    valid = torch.arange(size) < n
    return bits.reshape(T, K), p.reshape(T, K), valid.reshape(T, K)


def _lane_planes_cuda(blob, probs, lay: Layout, T: int, K: int):
    _native.check_cuda("dense_lanes", blob, probs, dtype=(torch.uint8, torch.int32))
    dev = blob.device
    bits = torch.empty((T, K), dtype=torch.int32, device=dev)
    p = torch.empty((T, K), dtype=torch.int32, device=dev)
    valid = torch.empty((T, K), dtype=torch.bool, device=dev)
    _native.launch("dense_lanes", "artc_dense_lanes", dev, blob, probs, bits, p, valid,
                   lay.offs[0], lay.n, T * K)
    return bits, p, valid
