"""Mesh steps: chunk-parallel model pass + lane-parallel rANS encode over a
(gop, lane) grid of devices.

Counterpart of avrecode_tpu/parallel/pipeline.py. Where the JAX package
jits one shard_map program over its Mesh, the port's controller drives each
cell (g, l) of parallel.mesh.Mesh itself, and the cell computes what its
shard_map instance computes:
  - its row's chunks (rows own G / n_gop whole chunks, with their own
    estimator tables): the chunk axis that vmap adds in JAX is a leading
    dimension of the port's kernels (one launch sequence for all of a
    row's chunks, or one per chunk for the expand);
  - its lane slice [l * k_local, (l + 1) * k_local) of every chunk's
    [T, K_total] planes, read in place by the masked lane scan;
  - its share of the payload-word total, sum(emits) + 2 * G_l * k_local,
    which the JAX psum adds over both axes: the controller adds the cells'
    per-lane counts, each cell once, even where cells share a card.
All launches of all cells are issued first, and only then are the outputs
gathered on the first cell's device, at the JAX step's widths (u32 as int32
and u16 as int16 bit patterns, bool as bool). A cell takes its rows of host
inputs without blocking: from pinned memory (device.compress_mesh pins
them) the copy runs on the cell's stream. A cell on a CUDA device issues its
launches on a stream of its own (made once per built step), which first
waits on the controller's current streams, so cells that share a card
overlap their work as JAX's cells on their own devices do; the gather waits
on each cell's stream before it reads that cell's outputs. A cell on the
CPU runs in place.
"""
from __future__ import annotations

import torch

from .. import _native
from ..ops import lanes as lx
from ..ops import model_pass as mp
from .mesh import Mesh


def _grid(mesh: Mesh, G: int, K_total: int):
    """(rows per gop row, lanes per cell) of G chunks over the mesh."""
    n_gop, n_lane = mesh.shape["gop"], mesh.shape["lane"]
    if G % n_gop or K_total % n_lane:
        raise ValueError(f"{G} chunks / {K_total} lanes do not split over a "
                         f"{n_gop}x{n_lane} mesh")
    return G // n_gop, K_total // n_lane


def _count(mesh: Mesh, name: str) -> None:
    """One launch of a step whose cells run the CUDA kernels (a grid of
    CPU devices runs their plain versions and is not counted)."""
    if any(d.type == "cuda" for row in mesh.devices for d in row):
        _native.count(name)


def _cell_streams(mesh: Mesh) -> dict:
    """A stream of its own for each cell on a CUDA device (None for a CPU
    cell), made once per built step: the caching allocator keeps a stream's
    freed blocks for that stream, so later steps reuse them."""
    return {(g, l): torch.cuda.Stream(device=dev) if dev.type == "cuda" else None
            for g, row in enumerate(mesh.devices) for l, dev in enumerate(row)}


def _run_cells(mesh: Mesh, streams: dict, src: torch.device, cell) -> dict:
    """cell(g, l, dev) for every cell of the mesh, keyed (g, l) -> (outputs,
    stream). A cell on a CUDA device runs on its stream, which first waits on
    the current streams of its device and of the inputs' device `src`; a CPU
    cell runs as it is (stream None)."""
    cells = {}
    for g, row in enumerate(mesh.devices):
        for l, dev in enumerate(row):
            stream = streams[(g, l)]
            if stream is not None:
                stream.wait_stream(torch.cuda.current_stream(dev))
                if src.type == "cuda" and src != dev:
                    stream.wait_stream(torch.cuda.current_stream(src))
            with torch.cuda.stream(stream):
                cells[(g, l)] = (cell(g, l, dev), stream)
    return cells


def _joined(dev: torch.device, outputs, stream):
    """A cell's outputs, readable on `dev`'s current stream, which reads them
    (or copies them to another card, which waits on it): it waits on the
    cell's stream, and the caching allocator keeps the outputs' memory until
    its reads are done."""
    if stream is not None:
        reader = torch.cuda.current_stream(dev)
        reader.wait_stream(stream)
        for t in outputs:
            t.record_stream(reader)
    return outputs


def _gather(mesh: Mesh, cells: dict, G: int, N: int, T: int, K_total: int):
    """Assembles the cells' (probs, x_final, words, emits, counts) on the
    first cell's device at the JAX step's widths: probs int16 [G, N] (u16
    bit patterns) from each row's lane-0 cell, the lane outputs by (rows,
    lane slice), and the payload-word total int32."""
    out = mesh.devices[0][0]
    G_l, k_local = _grid(mesh, G, K_total)
    probs = torch.empty((G, N), dtype=torch.int16, device=out)
    x_final = torch.empty((G, K_total), dtype=torch.int32, device=out)
    words = torch.empty((G, T, K_total), dtype=torch.int16, device=out)
    emits = torch.empty((G, T, K_total), dtype=torch.bool, device=out)
    total = torch.zeros((), dtype=torch.int32, device=out)
    for (g, l), (outputs, stream) in cells.items():
        p, x, w, e, counts = _joined(mesh.devices[g][l], outputs, stream)
        rows, cols = slice(g * G_l, (g + 1) * G_l), slice(l * k_local, (l + 1) * k_local)
        if l == 0:
            probs[rows] = p.to(out)
        x_final[rows, cols] = x.to(out)
        words[rows, :, cols] = w.to(out)
        emits[rows, :, cols] = e.to(out)
        total += counts.sum(dtype=torch.int32).to(out) + 2 * G_l * k_local
    return probs, x_final, words, emits, total


def _lane_slices(planes, G_l: int, T: int, K_total: int, cols: slice):
    """Views [G_l, T, k_local] of a cell's lane slice of [G_l, T * K_total]
    streams (lane l of step t is bin t * K_total + l)."""
    return [p.view(G_l, T, K_total)[:, :, cols] for p in planes]


def sharded_v4_compress_step(mesh: Mesh, *, batch: int, sup: int, fast_w: int, slow_w: int,
                             sig_w: int, sig_alpha: int, ud: int, us: int, ns: int,
                             n_sig: int, K_total: int, layout: tuple):
    """Builds the product mesh step over the ANL5 wire (device.compress_mesh
    packs its inputs): each cell expands its row's fused blobs in mesh mode
    (wire_expand4_blob(mesh=True)), models them with the frozen-batch pass
    (v3_core), and lane-scans its lane slice with probabilities floored at
    1 and validity iota(M) < n, as JAX's step does (pipeline.py:61-94).

    Inputs (G = chunks, a multiple of the mesh's 'gop' size; layout/ud/us/ns
    are the mesh-uniform maxima; M = ns*sup*batch), any device:
      blob: int32[G, W] fused ANL5 planes (pad chunks: zero planes but live,
        distinct dk scratch rows)
      sc: int32[G, 6] = [wa, wb, wcs, n, n_coo, ud_real] per chunk
      dual0: int16[G, n_dual, 4] (u16 bit patterns, JAX's uint16; the cell
        widens it to int32 on its device before v3_core)
      sig0_idx: int32[G, SK]; sig0_val: int16[G, SK, 2] (pad rows = n_sig)
      n_arr: int32[G] live bins per chunk
    Returns, on the mesh's first device, JAX's outputs at its widths:
    (x_final int32[G, K] (u32 bit patterns), words int16[G, T, K] (u16 bit
    patterns), emits bool[G, T, K], probs int16[G, M] (u16 bit patterns),
    total_words int32[])."""
    M = ns * sup * batch
    if M % K_total:
        raise ValueError(f"M={M} bins do not split into {K_total} lanes")
    T = M // K_total
    expand = dict(m=M, nsub=ns * sup, U=ud + us, ud=ud, us=us, ns=ns, batch=batch,
                  layout=layout, mesh=True)
    model = dict(batch=batch, sup=sup, fast_w=fast_w, slow_w=slow_w, sig_w=sig_w,
                 sig_alpha=sig_alpha, ud=ud, us=us, n_sig=n_sig)

    def cell(dev, rows, cols, blob, sc, dual0, sig0_idx, sig0_val, n_arr):
        bl, s, d0, si, sv, n = (t[rows].to(dev, non_blocking=True)
                                for t in (blob, sc, dual0, sig0_idx, sig0_val, n_arr))
        d0 = d0.to(torch.int32) & 0xFFFF  # u16 -> the int32 table v3_core takes
        bit, kind, slot, prior, deltas, dk_d, dk_s = mp.wire_expand4_blob(bl, s, **expand)
        probs = mp.v3_core(bit, kind, slot, prior, dk_d, dk_s, deltas, d0, sig0_idx=si,
                           sig0_val=sv, **model)
        G_l = bl.shape[0]
        valid = torch.arange(M, device=dev) < n[:, None]
        planes = _lane_slices((bit, probs.clamp_min(1), valid), G_l, T, K_total, cols)
        return (probs, *lx.lane_scan(*planes))

    streams = _cell_streams(mesh)

    def step(blob, sc, dual0, sig0_idx, sig0_val, n_arr):
        G = blob.shape[0]
        G_l, k_local = _grid(mesh, G, K_total)
        _count(mesh, "sharded_v4_compress_step")
        cells = _run_cells(mesh, streams, blob.device, lambda g, l, dev: cell(
            dev, slice(g * G_l, (g + 1) * G_l), slice(l * k_local, (l + 1) * k_local),
            blob, sc, dual0, sig0_idx, sig0_val, n_arr))
        probs, x_final, words, emits, total = _gather(mesh, cells, G, M, T, K_total)
        return x_final, words, emits, probs, total

    return step


def sharded_recompress_step(mesh: Mesh, batch: int, fast_w: int = 48, slow_w: int = 640,
                            sig_w: int = 80, sig_alpha: int = 1):
    """Builds the pre-ANL5 mesh step: build(K_total) returns step(bits,
    kinds, keys, priors, dual0, sig0), which runs the per-batch model pass
    (model_pass, impl "sort") over the chunk axis of a cell's row's chunks
    (one launch sequence for all of them), then the unmasked lane scan on the
    cell's lane slice.

    Inputs (G = chunk rows, a multiple of the mesh's 'gop' size; N = padded
    pairs per chunk, a multiple of batch and K):
      bits, kinds, keys, priors: int32[G, N]
      dual0: int32[G, n_dual, 4]   sig0: int32[G, n_sig, 2]
    Returns, on the mesh's first device, JAX's outputs at its widths: probs
    int16[G, N] (u16 bit patterns); x_final int32[G, K] (u32 bit patterns),
    words int16[G, T, K] (u16 bit patterns), emits bool[G, T, K];
    total_words int32[] (over the whole mesh)."""
    kw = dict(batch=batch, fast_w=fast_w, slow_w=slow_w, sig_w=sig_w, sig_alpha=sig_alpha,
              impl="sort")

    def build(K_total: int):
        def cell(dev, rows, cols, bits, kinds, keys, priors, dual0, sig0):
            b, k, y, p, d, s = (t[rows].to(dev, non_blocking=True)
                                for t in (bits, kinds, keys, priors, dual0, sig0))
            G_l, N = b.shape
            probs = mp.model_pass(*(t.contiguous() for t in (b, k, y, p, d, s)), **kw)
            valid = torch.ones((G_l, N), dtype=torch.bool, device=dev)
            planes = _lane_slices((b, probs, valid), G_l, N // K_total, K_total, cols)
            return (probs, *lx.lane_scan(*planes))

        streams = _cell_streams(mesh)

        def step(bits, kinds, keys, priors, dual0, sig0):
            G, N = bits.shape
            if N % K_total:
                raise ValueError(f"N={N} pairs do not split into {K_total} lanes")
            G_l, k_local = _grid(mesh, G, K_total)
            _count(mesh, "sharded_recompress_step")
            cells = _run_cells(mesh, streams, bits.device, lambda g, l, dev: cell(
                dev, slice(g * G_l, (g + 1) * G_l), slice(l * k_local, (l + 1) * k_local),
                bits, kinds, keys, priors, dual0, sig0))
            return _gather(mesh, cells, G, N, N // K_total, K_total)

        return step

    return build
