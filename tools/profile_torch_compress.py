#!/usr/bin/env python3
"""Where the time of the PyTorch + CUDA compress path goes, on one card.

    python3 tools/profile_torch_compress.py [clip ...] [--out DIR]

For each clip (default: benchdata/bench.mp4 and benchdata/multigop720.mp4):
one warm-up compress, then one compress under torch.profiler (CPU and CUDA
activities). Prints the host-clock phases of the compress loop and its
upload bytes (the `info` fields of avrecode_tpu_torch.device.compress), the
device busy time read from the trace (kernels, copies and fills; one
stream, so they do not overlap) with its share of the wall time, and the
device time by kernel name. Writes each trace's key_averages table and a Chrome trace under DIR
(default avrecode_tpu_torch/build/profile, which git ignores).
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def profile_clip(path: str, out_dir: str) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from avrecode_tpu_torch import device as td
    with open(path, "rb") as f:
        data = f.read()
    td.compress(data, device="cuda")
    torch.cuda.synchronize()
    info = {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        td.compress(data, device="cuda", info=info)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = collections.Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] += e.time_range.elapsed_us()
    busy_s = sum(by_name.values()) / 1e6
    stem = os.path.splitext(os.path.basename(path))[0]
    with open(os.path.join(out_dir, f"{stem}_key_averages.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=40))
    prof.export_chrome_trace(os.path.join(out_dir, f"{stem}_trace.json"))
    return {
        "clip": os.path.relpath(path, REPO),
        "bytes": len(data),
        "wall_s": wall,
        "device_busy_s": busy_s,
        "device_busy_share": busy_s / wall,
        "wire_bytes": info["wire_bytes"],
        "host_phases_s": {k: info[k] for k in ("open_s", "fetch_s", "stage_s", "launch_s",
                                               "compact_s", "dispatch_s", "emit_s",
                                               "pack_s")},
        "device_ms_by_name": {k: v / 1e3 for k, v in by_name.most_common(12)},
    }


def main() -> int:
    sys.path.insert(0, REPO)
    import torch
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("clips", nargs="*", default=[
        os.path.join(REPO, "benchdata", "bench.mp4"),
        os.path.join(REPO, "benchdata", "multigop720.mp4")])
    p.add_argument("--out", default=os.path.join(REPO, "avrecode_tpu_torch", "build", "profile"))
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_compress: no CUDA device", file=sys.stderr)
        return 1
    os.makedirs(args.out, exist_ok=True)
    for path in args.clips:
        print(json.dumps(profile_clip(path, args.out)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
