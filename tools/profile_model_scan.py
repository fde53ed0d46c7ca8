#!/usr/bin/env python3
"""Device time of the port's device kernels on one card, split by kernel:
the frozen-batch model scans (rows 3 and 6 of PERF.md's kernel table:
v3_core, model_pass_v2), the wire expand (row 1), the dual0 expand (row 2),
the lane scans (rows 4 and 7) and the lane compaction (row 5).

    python3 tools/profile_model_scan.py [--repo PATH] [--rows 1,2,3,4,5,6,7,10,11]
        [--check]

Runs the kernels of the avrecode_tpu_torch package found under PATH
(default: this checkout; a `git archive` of another commit times that
commit's kernels) at these shapes: benchdata/bench.mp4 chunk 0 under
profile 2 (batch 4096, sup 128: the expand, v3_core, its lane scan,
the masked scan on the same bins as [T, K] planes with a prefix mask, and
the compaction of the scan's words), the same chunk under profile 0 (model_pass_v2),
the dual0 expand of bench.mp4's chunks 0 and 1 on the dictionary as the
checkout stages it (with, where the checkout has it, the launch floor: an
empty kernel through the same wrapper path),
multigop720.mp4's mesh shapes (chunk mode 1: the mesh-mode expand of its
10 chunks in one call and of chunk 0 alone, v3_core over the chunk axis),
and the mesh step of those chunks on a 1x1 and a 2x2 grid of this one card
(row 10), and the pre-ANL5 mesh step on a 2x2 and a 4x2 grid of it (row
11). For each it prints one JSON line: the mean device time of a call
(CUDA events around 10 calls after a warm-up), the host time to launch one
call (the device idle before it) beside the device's busy time in it, from
one call under torch.profiler the device time and count of each kernel,
copy and fill by name (the launches inside a call), and where the package
has them the pass's own cycle counters (chunk 0) and its count of
launches inside the call. --check also holds each result against the
plain version (exact).
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH, SUP = 4096, 128


def events_ms(fn, reps: int = 10) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def by_kernel(fn) -> dict:
    """Device time (ms) and count of each device activity of one call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ms, n = collections.Counter(), collections.Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms[e.name] += e.time_range.elapsed_us() / 1e3
            n[e.name] += 1
    return {k: {"ms": ms[k], "count": n[k]} for k in ms}


def host_ms(fn, reps: int = 10) -> float:
    """Mean host time (ms) for fn() to return, the device idle before each
    call: the time the wrapper takes to launch its work."""
    import time
    import torch
    fn()
    total = 0.0
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        total += time.perf_counter() - t0
    torch.cuda.synchronize()
    return total / reps * 1e3


def max_abs_err(got, want) -> int:
    """Largest |got - want| over a tensor or matching tuples of them (u16
    through their int16 bit patterns)."""
    import torch
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape:
            raise AssertionError(f"shape {tuple(g.shape)} vs {tuple(w.shape)}")
        if g.dtype == torch.uint16:
            g, w = (t.view(torch.int16) for t in (g, w))
        if g.dtype == torch.int16:
            g, w = (t.long() & 0xFFFF for t in (g, w))
        if g.numel():
            err = max(err, int((g.long() - w.long()).abs().max()))
    return err


def _bench_p2(dev):
    """bench.mp4 chunk 0 under profile 2, staged on `dev`, and its expand."""
    from avrecode_tpu_torch import device as td
    from avrecode_tpu_torch.ops import model_pass as mp
    with open(os.path.join(HERE, "benchdata", "bench.mp4"), "rb") as f:
        bench = f.read()
    an = td.analyze(bench, batch_size=BATCH, model_profile=2, sup=SUP)
    c = an.chunks[0]
    st = td.to_torch_staged(an, c, dev)
    return bench, c, st, mp.wire_expand4_blob(st.blob, st.sc, **st.statics["expand"])


def _mesh(dev):
    """multigop720.mp4's mesh inputs (chunk mode 1, 2 gop rows) on `dev`."""
    from avrecode_tpu_torch import device as td
    with open(os.path.join(HERE, "benchdata", "multigop720.mp4"), "rb") as f:
        clip = f.read()
    anm = td.analyze(clip, chunk_mode=1, batch_size=BATCH, model_profile=2, sup=SUP)
    inp = td.mesh_inputs(anm, anm.chunks, 2, SUP, 16)
    s = inp.statics
    ekw = dict(m=s["ns"] * SUP * BATCH, nsub=s["ns"] * SUP, U=s["ud"] + s["us"], ud=s["ud"],
               us=s["us"], ns=s["ns"], batch=BATCH, layout=s["layout"], mesh=True)
    return anm, inp, tuple(t.to(dev) for t in inp.tensors()), ekw


def expand_cases(p2, mesh):
    """Row 1: the expand at bench chunk 0 and at the mesh's shapes, all G
    chunks in one call and chunk 0 alone."""
    from avrecode_tpu_torch.ops import model_pass as mp
    _, c, st, _ = p2
    ex = st.statics["expand"]
    eargs = [ex[k] for k in ("m", "nsub", "U", "ud", "us", "ns", "batch", "layout")]
    yield (f"wire_expand4_blob bench.mp4 chunk 0 (m={c.m}, nsub={ex['nsub']}, U={ex['U']}, "
           f"nc={ex['layout'][6]})",
           lambda: mp.wire_expand4_blob(st.blob, st.sc, **ex),
           lambda: mp._wire_expand_plain(st.blob, st.sc, *eargs))
    _, _, (blob, sc, *_), ekw = mesh
    margs = [ekw[k] for k in ("m", "nsub", "U", "ud", "us", "ns", "batch", "layout", "mesh")]
    for G in (blob.shape[0], 1):
        b, s = blob[:G], sc[:G]
        yield (f"wire_expand4_blob multigop720.mp4 mesh shapes (G={G}, m={ekw['m']}, "
               f"U={ekw['U']}, nc={ekw['layout'][6]})",
               lambda b=b, s=s: mp.wire_expand4_blob(b, s, **ekw),
               lambda b=b, s=s: mp._wire_expand_plain(b, s, *margs))


def dual0_cases(dev):
    """Row 2: the dual0 expand at bench.mp4's chunks 0 (no escapes) and 1
    (escapes), on the dictionary as the checkout stages it (its wire widths,
    or int32 where the checkout widens them), then the launch floor where
    the checkout has one."""
    import inspect
    from avrecode_tpu_torch import device as td
    from avrecode_tpu_torch.ops import model_pass as mp
    with open(os.path.join(HERE, "benchdata", "bench.mp4"), "rb") as f:
        an = td.analyze(f.read(), batch_size=BATCH, model_profile=2, sup=SUP)
    up = getattr(td, "_wire", None) or td._i32  # the parent widens to int32
    for ci in (0, 1):
        c = an.chunks[ci]
        d0 = [up(a).to(dev) for a in td._dual0_dict(c)]
        yield (f"dual0_expand bench.mp4 chunk {ci} (n_dual={len(c.d0_idx)}, "
               f"escapes={len(c.d0_esc_idx)}, padded to {d0[2].shape[0]}, "
               f"idx {d0[1].dtype})",
               lambda d0=d0: mp.dual0_expand(*d0), lambda d0=d0: mp._dual0_expand_plain(*d0))
        if "entry" in inspect.signature(mp._dual0_expand_cuda).parameters:
            yield (f"launch floor: dual0_expand's wrapper and grid, an empty kernel, bench.mp4 "
                   f"chunk {ci}",
                   lambda d0=d0: mp._dual0_expand_cuda(*d0, entry="artc_launch_floor"), None)


def compact_cases(p2):
    """Row 5: the compaction of bench chunk 0's lane scan."""
    from avrecode_tpu_torch import device as td
    from avrecode_tpu_torch.ops import lanes as lx
    from avrecode_tpu_torch.ops import model_pass as mp
    _, c, st, planes = p2
    bit, kind, slot, prior, deltas, dk_d, dk_s = planes
    probs = mp.v3_core(bit, kind, slot, prior, dk_d, dk_s, deltas, st.dual0,
                       sig0_idx=st.s_idx, sig0_val=st.s_val, **st.statics["model"])
    lanes = td.pick_lanes(c.n)
    T = 1 << (-(-c.n // lanes) - 1).bit_length()
    _, words, emits, counts = lx.lane_scan_dev(bit, probs, c.n, T, lanes)
    maxW = 1 << (max(int(counts.max()), 1) - 1).bit_length()
    yield (f"lane_compact bench.mp4 chunk 0 (T={T}, K={lanes}, maxW={maxW})",
           lambda: lx.lane_compact(words, emits, maxW),
           lambda: lx._lane_compact_plain(words, emits, maxW))


def lane_cases(p2, rows: set):
    """Rows 4 and 7: bench chunk 0's lane scan (lane_scan_dev on the model
    pass's bits and probs) and the masked scan of the same bins as [T, K]
    planes, padded with invalid steps (encode_interleaved's layout)."""
    import torch
    from avrecode_tpu_torch import device as td
    from avrecode_tpu_torch.ops import lanes as lx
    from avrecode_tpu_torch.ops import model_pass as mp
    _, c, st, planes = p2
    bit, kind, slot, prior, deltas, dk_d, dk_s = planes
    probs = mp.v3_core(bit, kind, slot, prior, dk_d, dk_s, deltas, st.dual0,
                       sig0_idx=st.s_idx, sig0_val=st.s_val, **st.statics["model"])
    n, lanes = c.n, td.pick_lanes(c.n)
    T = 1 << (-(-n // lanes) - 1).bit_length()
    if 4 in rows:
        yield (f"lane_scan_dev bench.mp4 chunk 0 (n={n}, T={T}, K={lanes})",
               lambda: lx.lane_scan_dev(bit, probs, n, T, lanes),
               lambda: lx._lane_scan_dev_plain(bit, probs, n, T, lanes), 4)
    if 7 in rows:
        b = torch.zeros(T * lanes, dtype=torch.int32, device=bit.device)
        p = torch.ones(T * lanes, dtype=torch.int32, device=bit.device)
        b[:n], p[:n] = bit[:n], probs[:n].clamp_min(1)
        tk = (b.view(T, lanes), p.view(T, lanes),
              (torch.arange(T * lanes, device=bit.device) < n).view(T, lanes))
        yield (f"lane_scan bench.mp4 chunk 0 as [T, K] planes (T={T}, K={lanes})",
               lambda: lx.lane_scan(*tk), lambda: lx._lane_scan_plain(*tk), 7)


def scan_cases(dev, p2, mesh):
    """Rows 3, 6 and 10: the scans at bench chunk 0 (both profiles), v3_core
    over the mesh's chunk axis, and the mesh step on 1x1 and 2x2 grids."""
    import numpy as np
    import torch
    from avrecode_tpu_torch import device as td
    from avrecode_tpu_torch.ops import model_pass as mp
    bench, c, st, (bit, kind, slot, prior, deltas, dk_d, dk_s) = p2
    mo = st.statics["model"]
    tensors = (kind, slot, prior, dk_d, dk_s, deltas, st.dual0)
    yield (f"v3_core bench.mp4 chunk 0 (m={c.m}, ns={c.ns}, ud={c.ud}, us={c.us})",
           lambda: mp.v3_core(bit, *tensors, sig0_idx=st.s_idx, sig0_val=st.s_val, **mo),
           lambda: mp._v3_core_plain(*tensors, *(mo[k] for k in (
               "batch", "sup", "fast_w", "slow_w", "sig_w", "sig_alpha", "ud", "us", "n_sig")),
               st.s_idx, st.s_val))

    an0 = td.analyze(bench, batch_size=BATCH, model_profile=0, sup=SUP)
    c = an0.chunks[0]
    n = len(c.bit)
    ns, ud = c.v2_dk_d.shape
    us = c.v2_dk_s.shape[1]

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    sh = (ns, SUP, BATCH)
    planes = [up(np.concatenate([a.astype(np.int32), np.full(c.v2_m - n, v, np.int32)])
                 .reshape(sh)) for a, v in ((c.kind, 3), (c.prior, 1), (c.pre_ones, 0),
                                            (c.pre_tot, 0))]
    tables = [up(c.v2_bin_u.reshape(sh)), up(c.v2_dk_d), up(c.v2_dk_s), up(c.v2_dd),
              up(c.v2_ds), up(np.concatenate([c.dual0, np.ones((1 + ud, 4), np.int32)])),
              up(np.concatenate([np.zeros((an0.n_sig, 2), np.int32),
                                 np.ones((us, 2), np.int32)]))]
    kw = dict(batch=BATCH, sup=SUP, fast_w=an0.fast_w, slow_w=an0.slow_w, sig_w=an0.sig_w,
              sig_alpha=an0.sig_alpha)
    yield (f"model_pass_v2 bench.mp4 chunk 0 (m={c.v2_m}, ns={ns}, ud={ud}, us={us})",
           lambda: mp.model_pass_v2(*planes, *tables, **kw),
           lambda: mp._model_pass_v2_plain(*planes, *tables, *kw.values()))

    anm, inp, staged, ekw = mesh
    s = inp.statics
    UD, US, NS = s["ud"], s["us"], s["ns"]
    blob, sc, dual0, si, sv, _ = staged
    dual0 = dual0.to(torch.int32) & 0xFFFF  # mesh_inputs ships u16; the cells widen it
    bit, kind, slot, prior, deltas, dk_d, dk_s = mp.wire_expand4_blob(blob, sc, **ekw)
    mkw = dict(batch=BATCH, sup=SUP, fast_w=anm.fast_w, slow_w=anm.slow_w, sig_w=anm.sig_w,
               sig_alpha=anm.sig_alpha, ud=UD, us=US, n_sig=anm.n_sig)
    yield (f"v3_core multigop720.mp4 mesh shapes (G={blob.shape[0]}, ns={NS}, ud={UD}, "
           f"us={US})",
           lambda: mp.v3_core(bit, kind, slot, prior, dk_d, dk_s, deltas, dual0, sig0_idx=si,
                              sig0_val=sv, **mkw),
           lambda: mp._v3_core_plain(kind, slot, prior, dk_d, dk_s, deltas, dual0,
                                     *mkw.values(), si, sv))

    from avrecode_tpu_torch.parallel import pipeline
    from avrecode_tpu_torch.parallel.mesh import make_mesh
    for n_gop, n_lane in ((1, 1), (2, 2)):
        step = pipeline.sharded_v4_compress_step(make_mesh(n_gop, n_lane, [dev] * n_gop * n_lane),
                                                 **s)
        yield (f"sharded_v4_compress_step {n_gop}x{n_lane} on one card (multigop720.mp4)",
               lambda step=step: step(*staged), None)


def recompress_cases(dev):
    """Row 11: the pre-ANL5 mesh step on a 2x2 and a 4x2 grid of this one
    card, on chip_smoke.py's inputs (4 random chunks of 65,536 pairs, batch
    4096, 16 lanes)."""
    import numpy as np
    import torch
    from avrecode_tpu_torch.parallel import pipeline
    from avrecode_tpu_torch.parallel.mesh import make_mesh
    G, N, n_dual, n_sig = 4, 1 << 16, 4096, 1 << 17
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, (G, N))
    kinds = rng.integers(0, 3, (G, N))
    keys = np.where(kinds == 2, rng.integers(0, n_sig, (G, N)),
                    rng.integers(0, n_dual - 1, (G, N)))
    arrays = (bits, kinds, keys, rng.integers(1, 32767, (G, N)), np.full((G, n_dual, 4), 3),
              np.zeros((G, n_sig, 2)))
    staged = [torch.from_numpy(a.astype(np.int32)).to(dev) for a in arrays]
    for n_gop, n_lane in ((2, 2), (4, 2)):
        step = pipeline.sharded_recompress_step(
            make_mesh(n_gop, n_lane, [dev] * n_gop * n_lane), batch=BATCH, fast_w=48,
            slow_w=640, sig_w=80, sig_alpha=1)(K_total=16)
        yield (f"sharded_recompress_step {n_gop}x{n_lane} on one card (G={G}, N={N})",
               lambda step=step: step(*staged), None)


def cases(rows: set):
    """(name, kernel call, plain call, row) for the rows asked for."""
    import torch
    dev = torch.device("cuda")
    if 11 in rows:
        for case in recompress_cases(dev):
            yield (*case, 11)
    if 2 in rows:
        for case in dual0_cases(dev):
            yield (*case, 2)
    if not rows & {1, 3, 4, 5, 6, 7, 10}:
        return
    p2 = _bench_p2(dev)
    mesh = _mesh(dev) if rows & {1, 3, 6, 10} else None
    if 1 in rows:
        for case in expand_cases(p2, mesh):
            yield (*case, 1)
    if rows & {4, 7}:
        yield from lane_cases(p2, rows)
    if 5 in rows:
        for case in compact_cases(p2):
            yield (*case, 5)
    if rows & {3, 6, 10}:
        for case in scan_cases(dev, p2, mesh):
            yield (*case, 3)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--repo", default=HERE, help="checkout whose port is timed")
    p.add_argument("--rows", default="1,2,3,4,5,6,7,10,11",
                   help="kernel table rows to time: 1 (expand), 2 (dual0 expand), 4 and 7 "
                        "(the lane scans), 5 (compaction), 3, 6 or 10 (the model scans and "
                        "the mesh step), 11 (the pre-ANL5 mesh step)")
    p.add_argument("--check", action="store_true", help="hold each result against plain")
    args = p.parse_args()
    rows = {int(r) for r in args.rows.split(",")}
    sys.path.insert(0, os.path.abspath(args.repo))
    import torch
    if not torch.cuda.is_available():
        print("profile_model_scan: no CUDA device", file=sys.stderr)
        return 1
    from avrecode_tpu_torch import _native
    from avrecode_tpu_torch.ops import model_pass as mp
    _native.build()
    _native.ensure_host_lib()
    # Launches inside the last call, where the checkout counts them.
    inside = {1: getattr(_native, "expand_launches", None),
              5: getattr(_native, "compact_launches", None),
              3: getattr(_native, "pass_launches", None),
              2: getattr(_native, "dual0_launches", None), 4: None, 7: None, 11: None}
    for name, fn, plain, row in cases(rows):
        kernels = by_kernel(fn)
        out = {"case": name, "repo": os.path.relpath(os.path.abspath(args.repo), HERE),
               "card": torch.cuda.get_device_name(0), "call_ms": events_ms(fn),
               "host_ms": host_ms(fn),
               "busy_ms": sum(k["ms"] for k in kernels.values()), "by_kernel": kernels}
        if inside[row] is not None and (row != 2 or plain is not None):  # not the floor
            out["launches_in_call"] = inside[row]()
        if row == 3 and hasattr(mp, "scan_profile"):
            out["cycles"] = mp.scan_profile()
        if args.check and plain is not None:
            out["max_abs_err"] = max_abs_err(fn(), plain())
            if out["max_abs_err"] != 0:
                print(json.dumps(out), flush=True)
                return 1
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
