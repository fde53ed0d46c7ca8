#!/usr/bin/env python3
"""Device time of the frozen-batch model scans (v3_core, model_pass_v2) on
one card, split by kernel.

    python3 tools/profile_model_scan.py [--repo PATH] [--check]

Runs the scans of the avrecode_tpu_torch package found under PATH (default:
this checkout; a `git archive` of another commit times that commit's
kernels) at three shapes: benchdata/bench.mp4 chunk 0 under profile 2
(v3_core, batch 4096, sup 128), the same chunk under profile 0
(model_pass_v2), multigop720.mp4's mesh shapes (chunk mode 1, v3_core
over its chunk axis of 10 chunks), and the mesh step of those chunks on a
1x1 and a 2x2 grid of this one card. For each it prints one JSON line: the
mean device time of a call (CUDA events around 10 calls after a warm-up),
from one call under torch.profiler the device time and count of each
kernel, copy and fill by name (the launches inside a call), and where the
package has them the pass's own cycle counters (chunk 0). --check also
holds each result against the plain version (exact).
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


def cases():
    """(name, kernel call, plain call) at the three shapes."""
    import numpy as np
    import torch
    from avrecode_tpu_torch import device as td
    from avrecode_tpu_torch.ops import model_pass as mp
    dev = torch.device("cuda")
    root = os.path.join(HERE, "benchdata")
    with open(os.path.join(root, "bench.mp4"), "rb") as f:
        bench = f.read()
    with open(os.path.join(root, "multigop720.mp4"), "rb") as f:
        mesh_clip = f.read()

    an = td.analyze(bench, batch_size=BATCH, model_profile=2, sup=SUP)
    c = an.chunks[0]
    st = td.to_torch_staged(an, c, dev)
    bit, kind, slot, prior, deltas, dk_d, dk_s = mp.wire_expand4_blob(st.blob, st.sc,
                                                                       **st.statics["expand"])
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

    anm = td.analyze(mesh_clip, chunk_mode=1, batch_size=BATCH, model_profile=2, sup=SUP)
    inp = td.mesh_inputs(anm, anm.chunks, 2, SUP, 16)
    s = inp.statics
    UD, US, NS = s["ud"], s["us"], s["ns"]
    blob, sc, dual0, si, sv, _ = (t.to(dev) for t in inp.tensors())
    bit, kind, slot, prior, deltas, dk_d, dk_s = mp.wire_expand4_blob(
        blob, sc, m=NS * SUP * BATCH, nsub=NS * SUP, U=UD + US, ud=UD, us=US, ns=NS,
        batch=BATCH, layout=s["layout"], mesh=True)
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
    staged = tuple(t.to(dev) for t in inp.tensors())
    for n_gop, n_lane in ((1, 1), (2, 2)):
        step = pipeline.sharded_v4_compress_step(make_mesh(n_gop, n_lane, [dev] * n_gop * n_lane),
                                                 **s)
        yield (f"sharded_v4_compress_step {n_gop}x{n_lane} on one card (multigop720.mp4)",
               lambda step=step: step(*staged), None)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--repo", default=HERE, help="checkout whose port is timed")
    p.add_argument("--check", action="store_true", help="hold each result against plain")
    args = p.parse_args()
    sys.path.insert(0, os.path.abspath(args.repo))
    import torch
    if not torch.cuda.is_available():
        print("profile_model_scan: no CUDA device", file=sys.stderr)
        return 1
    from avrecode_tpu_torch import _native
    from avrecode_tpu_torch.ops import model_pass as mp
    _native.build()
    _native.ensure_host_lib()
    for name, fn, plain in cases():
        out = {"case": name, "repo": os.path.relpath(os.path.abspath(args.repo), HERE),
               "card": torch.cuda.get_device_name(0), "call_ms": events_ms(fn),
               "by_kernel": by_kernel(fn)}
        if hasattr(mp, "scan_profile"):
            out["cycles"] = mp.scan_profile()
        if args.check and plain is not None:
            got, want = fn(), plain()
            out["max_abs_err"] = int((got.long() - want.long()).abs().max())
            if out["max_abs_err"] != 0:
                print(json.dumps(out), flush=True)
                return 1
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
