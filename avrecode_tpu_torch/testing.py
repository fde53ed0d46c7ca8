"""Synthetic inputs for the kernel checks of the wire expand, the dual0
expand and the lane compaction, made from a seed with numpy: the CPU tests
hold the plain versions and the numpy mirrors against the JAX package on
them, and
chip_smoke.py and the card tests hold the kernels against the plain
versions on the same inputs. Nothing on the main path calls this module.
"""
from __future__ import annotations

import numpy as np

from .ops.model_pass import _blob_layout_words


def _pack_ns(vals, width, words):
    """No-straddle `width`-bit entries into `words` u32 words."""
    out = np.zeros(words, np.uint64)
    if width == 0 or len(vals) == 0:
        return out.astype(np.uint32)
    epw = 32 // width
    j = np.arange(len(vals))
    np.add.at(out, j // epw, np.asarray(vals, np.uint64) << ((j % epw) * width).astype(np.uint64))
    return out.astype(np.uint32)


def _pack_bytes(vals, dtype, words):
    raw = np.zeros(words * 4, np.uint8)
    b = np.asarray(vals, dtype).tobytes()
    raw[:len(b)] = np.frombuffer(b, np.uint8)
    return raw.view(np.uint32)


def synthetic_blob(seed: int, *, past_runs: int = 0, past_row: int = 0, nc_pad: int = 8,
                   ne: int = 6, ncc: int = 5, nsub: int = 6, batch: int = 64, ud: int = 64,
                   us: int = 32):
    """A slim-wire blob made from a seed (no host writer): random header
    nibbles with live bins in every sub-batch that has a COO run, ranks
    inside their sub-batch's run, unique slots a sub-batch. `past_runs`
    live COO entries follow the last run (n_coo > sum of coo_cnt: JAX's
    mark/cumsum gives them to the last sub-batch); `past_row` entries of
    the first runs take a slot in [U, 2U), a flat index in the next row.
    Returns (blob u32 [W], sc int32 [5], expand keywords, the COO entries'
    (slot, nibble, escaped) columns)."""
    rng = np.random.default_rng(seed)
    ns = 2
    U, m = ud + us, nsub * batch
    n = m - batch // 2
    wa, wb, wcs = 3, 5, max(8, (2 * U - 1).bit_length())
    cnt = rng.integers(3, 12, nsub)
    cnt[2] = 0  # a sub-batch with no run: its bins are kind 3 or padding
    slots = [rng.choice(U, int(c) + (past_runs if s == nsub - 1 else 0), replace=False)
             for s, c in enumerate(cnt)]
    for s in range(past_row):  # an entry of run s at (row s + 1, a slot run s + 1 lacks)
        free = np.setdiff1d(np.arange(U), slots[s + 1])
        k = int(np.flatnonzero(slots[s] < U)[0]) if cnt[s] else None
        if k is not None:
            slots[s][k] = U + int(rng.choice(free))
    coo = np.concatenate(slots)
    n_coo = len(coo)
    nc = n_coo + nc_pad
    nc += -nc % 4
    nib = rng.integers(0, 256, nc)
    hdr = rng.integers(0, 16, m)
    sub = np.arange(m) // batch
    dead_sub = cnt[sub] == 0
    hdr[dead_sub] = (hdr[dead_sub] & 9) | (3 << 1)  # kind 3
    live = (np.arange(m) < n) & (((hdr >> 1) & 3) != 3)
    cold = (hdr & 1) == 1
    rank = rng.integers(0, np.maximum(cnt[sub], 1))
    hot_r, cold_r = rank[live & ~cold], rank[live & cold]
    npi = -(-(m + 16) // 4) * 4
    pidx = rng.integers(0, 256, npi)
    pdict = rng.integers(0, 65536, 256)
    esc_idx = np.sort(rng.choice(npi + 40, ne, replace=False))  # some past npi: they drop
    esc_val = rng.integers(0, 65536, ne)
    cesc_idx = np.sort(rng.choice(nc + 6, ncc, replace=False))  # some dead or past nc
    if ncc:
        cesc_idx[0] = nc - nc_pad - 1  # the last live entry: one of the runs' tail
    cesc_val = rng.integers(0, 65536, (ncc, 2))
    Lh = -(-m // 8)
    La = -(-max(len(hot_r), 1) // (32 // wa))
    Lb = -(-max(len(cold_r), 1) // (32 // wb))
    Lc = -(-nc // (32 // wcs))
    layout = (Lh, La, Lb, Lc, npi, ne, nc, ncc)
    segs = [_pack_ns(hdr, 4, Lh), _pack_ns(hot_r, wa, La), _pack_ns(cold_r, wb, Lb),
            _pack_ns(np.concatenate([coo, np.zeros(nc - n_coo, int)]), wcs, Lc),
            _pack_bytes(pidx, np.uint8, npi // 4), _pack_bytes(pdict, np.uint16, 128),
            esc_idx.astype(np.uint32), _pack_bytes(esc_val, np.uint16, ne // 2),
            _pack_bytes(cnt, np.uint16, (nsub + 1) // 2), _pack_bytes(nib, np.uint8, nc // 4),
            cesc_idx.astype(np.uint32), _pack_bytes(cesc_val.reshape(-1), np.uint16, ncc),
            rng.integers(0, 1 << 20, ns * ud).astype(np.uint32),
            rng.integers(0, 1 << 20, ns * us).astype(np.uint32)]
    blob = np.concatenate(segs)
    assert len(blob) == _blob_layout_words(layout, nsub, ns, ud, us)[-1]
    sc = np.array([wa, wb, wcs, n, n_coo], np.int32)
    kw = dict(m=m, nsub=nsub, U=U, ud=ud, us=us, ns=ns, batch=batch, layout=layout)
    return blob, sc, kw, (coo, nib[:n_coo], np.isin(np.arange(n_coo), cesc_idx))


# synthetic_blob's edge cases for the expand kernel: live COO entries past
# the sum of the runs (they belong to the last sub-batch), slots past their
# row, no prior or count escapes, m and U not multiples of 4, and U = 16,384
# (a 64 KB delta row: the kernel's shared-memory opt-in).
EXPAND_CASES = {
    "runs_end_before_n_coo": dict(past_runs=5),
    "slot_past_its_row": dict(past_row=3),
    "both": dict(past_runs=4, past_row=2, nc_pad=0),
    "no_escapes": dict(past_runs=2, ne=0, ncc=0),
    "odd_m_and_U": dict(past_runs=3, batch=49, ud=63, us=30),
    "U_16384": dict(past_row=2, nsub=3, ud=8192, us=8192, batch=32),
}


def expand_case(case: str):
    """(blob u32, sc, expand keywords) of an EXPAND_CASES entry (seed 7) or
    of "empty_coo_stream" (empty_coo_blob, seed 3)."""
    if case == "empty_coo_stream":
        return empty_coo_blob(3)
    blob, sc, kw, _ = synthetic_blob(7, **EXPAND_CASES[case])
    return blob, sc, kw


def empty_coo_blob(seed: int):
    """synthetic_blob with no COO entry at all (nc = n_coo = 0) and no
    escapes: every live bin's slot reads the empty stream's 0, every delta
    row stays zero. Returns (blob, sc, expand keywords)."""
    blob, sc, kw, _ = synthetic_blob(seed, ne=0, ncc=0)
    Lh, La, Lb, Lc, npi, ne, nc, ncc = kw["layout"]
    offs = _blob_layout_words(kw["layout"], kw["nsub"], kw["ns"], kw["ud"], kw["us"])
    segs = [blob[offs[k]:offs[k + 1]] for k in range(14)]
    segs[3] = segs[9] = segs[10] = segs[11] = np.zeros(0, np.uint32)
    sc = sc.copy()
    sc[4] = 0
    return np.concatenate(segs), sc, dict(kw, layout=(Lh, La, Lb, 0, npi, 0, 0, 0))


def lane_planes(rng, T: int, K: int):
    """words int16 [T, K] (u16 bit patterns) and emits bool [T, K], as the
    lane scans return them: emissions at about 12%, a silent lane and a lane
    that emits at every step (K > 1)."""
    emits = rng.random((T, K)) < 0.12
    if K > 1:
        emits[:, K // 2] = False
        emits[:, -1] = True
    return rng.integers(0, 65536, (T, K)).astype(np.uint16).view(np.int16), emits


# name -> (seed, n_dual, dictionary rows, live escapes, where they lie):
# no escapes; escapes at row 0 and row n_dual - 1; escapes only in the first
# block, so the later blocks see only padding; a dictionary of fewer than 256
# rows (indices past it clamp); every row of a block an escape (four rounds
# of the kernel's escape loop); 70,000 escapes (three search rounds); and
# bench.mp4's shape. No n_dual is a multiple of the kernel's 1024 rows.
DUAL0_CASES = {
    "no_escapes": (1, 5000, 256, 0, "random"),
    "ends": (2, 3001, 256, 40, "ends"),
    "padding_blocks": (3, 4100, 256, 300, "first_block"),
    "short_dict": (4, 2049, 100, 25, "random"),
    "dense_block": (5, 2500, 256, 1024, "second_block"),
    "many": (6, 200_001, 256, 70_000, "random"),
    "bench_shape": (7, 177_663, 256, 2306, "random"),
}


def dual0_case(case: str):
    """A dual0 row dictionary as device._dual0_dict returns it: rows
    u16[R, 4], idx u8[n_dual], escape indices u32 (live ones strictly
    ascending, padded to a power of two with n_dual) and rows u16[., 4]."""
    seed, n_dual, R, n_esc, where = DUAL0_CASES[case]
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 1 << 16, (R, 4)).astype(np.uint16)
    idx = rng.integers(0, 256, n_dual).astype(np.uint8)
    if where == "ends":
        live = np.concatenate([[0, n_dual - 1], rng.choice(np.arange(1, n_dual - 1),
                                                            n_esc - 2, replace=False)])
    elif where == "first_block":
        live = rng.choice(1024, n_esc, replace=False)
    elif where == "second_block":
        live = 1024 + np.arange(n_esc)
    else:
        live = rng.choice(n_dual, n_esc, replace=False)
    live = np.sort(live)
    ned = 16
    while ned < max(n_esc, 1):
        ned *= 2
    ei = np.full(ned, n_dual, np.uint32)
    ei[:n_esc] = live
    ev = np.zeros((ned, 4), np.uint16)
    ev[:n_esc] = rng.integers(0, 1 << 16, (n_esc, 4))
    return rows, idx, ei, ev


def assert_same_array(got, want, what: str = "") -> None:
    """`got` (a tensor or an array) holds exactly `want` (an array, a JAX
    array through numpy): the same shape, the same itemsize and nbytes, and
    the same bytes, so an int16 holds a uint16's bit patterns and a bool a
    bool. Nothing is converted or widened first."""
    g = np.asarray(got.numpy() if hasattr(got, "numpy") else got)
    w = np.asarray(want)
    assert g.shape == w.shape, f"{what}: shape {g.shape} != {w.shape}"
    assert g.itemsize == w.itemsize and g.nbytes == w.nbytes, (
        f"{what}: {g.dtype} ({g.nbytes} B) != {w.dtype} ({w.nbytes} B)")
    assert g.tobytes() == w.tobytes(), f"{what}: values differ"
