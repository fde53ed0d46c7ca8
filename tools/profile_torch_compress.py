#!/usr/bin/env python3
"""Where the time of the PyTorch + CUDA compress path goes, on one card.

    python3 tools/profile_torch_compress.py [clip ...] [--out DIR] [--repo PATH]
        [--mesh]

For each clip (default: benchdata/bench.mp4 and benchdata/multigop720.mp4):
one warm-up compress, then one compress under torch.profiler (CPU and CUDA
activities) with the port's span recorder on (avrecode_tpu_torch.trace).
Prints the call's upload bytes, the seconds of its spans summed by name
(the Python phases and the native engine's, walk threads included), the
device time by kernel name, and every memcpy kind (pinned or pageable, by
direction) with its count, device ms and bytes. With --mesh, also
compress_mesh on multigop720.mp4 (chunk mode 1, 16 lanes) on a 1x1 and a 2x2 grid of this
one card: the best of 3 calls after a warm-up, every run, and one call's
memcpy kinds (its download's bytes among them). --repo times the port of
another checkout (a `git archive` of another commit). Writes each trace's
key_averages table and a Chrome trace under DIR (default
avrecode_tpu_torch/build/profile, which git ignores).
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def memcpys(trace_path: str) -> dict:
    """{memcpy name: {count, ms, bytes}} from a Chrome trace's device copies
    (category gpu_memcpy; the name gives the kind, the args the bytes)."""
    with open(trace_path) as f:
        events = json.load(f).get("traceEvents", [])
    out = {}
    for e in events:
        if e.get("cat") == "gpu_memcpy":
            k = out.setdefault(e["name"], {"count": 0, "ms": 0.0, "bytes": 0})
            k["count"] += 1
            k["ms"] += e.get("dur", 0) / 1e3
            k["bytes"] += int(e.get("args", {}).get("bytes", 0))
    return out


def profile_mesh(path: str, out_dir: str) -> dict:
    """compress_mesh on a 1x1 and a 2x2 grid of cuda:0: best of 3 after a
    warm-up, and one profiled call's memcpy kinds."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from avrecode_tpu_torch import device as td
    from avrecode_tpu_torch.parallel.mesh import make_mesh
    with open(path, "rb") as f:
        data = f.read()
    out = {"clip": os.path.relpath(path, REPO)}
    for n_gop, n_lane in ((1, 1), (2, 2)):
        mesh = make_mesh(n_gop, n_lane, [torch.device("cuda", 0)] * n_gop * n_lane)

        def run():
            return td.compress_mesh(data, mesh, chunk_mode=1, force_lanes=16)

        run()
        runs = []
        for _ in range(3):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t0)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        trace = os.path.join(out_dir, f"mesh_{n_gop}x{n_lane}_trace.json")
        prof.export_chrome_trace(trace)
        out[f"{n_gop}x{n_lane}"] = {"best_s": min(runs), "runs_s": runs,
                                    "memcpy": memcpys(trace)}
    return out


def profile_clip(path: str, out_dir: str) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from avrecode_tpu_torch import device as td
    from avrecode_tpu_torch import trace
    with open(path, "rb") as f:
        data = f.read()
    td.compress(data, device="cuda")
    torch.cuda.synchronize()
    info = {}
    trace.enable()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            td.compress(data, device="cuda", info=info)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        trace.disable()
    spans_s = collections.Counter()
    for sp in trace.drain():
        spans_s[sp.name] += sp.seconds
    by_name = collections.Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] += e.time_range.elapsed_us()
    stem = os.path.splitext(os.path.basename(path))[0]
    with open(os.path.join(out_dir, f"{stem}_key_averages.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=40))
    trace = os.path.join(out_dir, f"{stem}_trace.json")
    prof.export_chrome_trace(trace)
    return {
        "clip": os.path.relpath(path, REPO),
        "bytes": len(data),
        "wall_s": wall,
        "wire_bytes": info["wire_bytes"],
        "spans_s": dict(sorted(spans_s.items(), key=lambda kv: -kv[1])),
        "device_ms_by_name": {k: v / 1e3 for k, v in by_name.most_common(12)},
        "memcpy": memcpys(trace),
    }


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("clips", nargs="*", default=[
        os.path.join(REPO, "benchdata", "bench.mp4"),
        os.path.join(REPO, "benchdata", "multigop720.mp4")])
    p.add_argument("--out", default=os.path.join(REPO, "avrecode_tpu_torch", "build", "profile"))
    p.add_argument("--repo", default=REPO, help="checkout whose port is profiled")
    p.add_argument("--mesh", action="store_true",
                   help="also compress_mesh on multigop720.mp4 (1x1 and 2x2 of one card)")
    args = p.parse_args()
    sys.path.insert(0, os.path.abspath(args.repo))
    import torch
    if not torch.cuda.is_available():
        print("profile_torch_compress: no CUDA device", file=sys.stderr)
        return 1
    os.makedirs(args.out, exist_ok=True)
    for path in args.clips:
        print(json.dumps(profile_clip(path, args.out)), flush=True)
    if args.mesh:
        clip = os.path.join(REPO, "benchdata", "multigop720.mp4")
        print(json.dumps(profile_mesh(clip, args.out)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
