"""The end-to-end bench of the port: counterpart of bench.py.

    python -m avrecode_tpu_torch.bench [--clip PATH] [--gop-clip PATH]
        [--device cuda] [--batch-size 4096] [--reps 5] [--host-reps 9]

Runs the port's device path (device.compress under profile 2: host
analysis, staged wire, the kernels, the container pack) on --clip (default
benchdata/bench.mp4) in this one process, and the native host engine
(pipeline) beside it as the baseline. --device cpu runs the same code on
the plain versions, with time.perf_counter in place of CUDA events: its
numbers are the CPU's, never the card's.

Gates come first; any failure prints a JSON line with an `error` key and
exits 1:
  - every chunk's device probs equal the host model's (microbench
    .probs_mismatch);
  - every chunk's lane blob from device.compress equals the C++ encoder's
    (host.rans_encode) on those probs;
  - the device container decompresses (host decoder) to the input exactly;
  - the host path's containers of --clip and --gop-clip (chunk mode 1)
    decompress to their inputs exactly.
A failure of the card itself (a kernel error, a hang) is the bench's
failure too: nothing falls back to the host or the CPU.

The last line printed is one JSON object. Its keys:
  metric, unit            "recompress_throughput", "MB/s"
  value                   input MB / device_e2e_s: the device path's best
  value_median            input MB / device_e2e_median_s
  vs_baseline             host_best_s / device_e2e_s, unfloored
  roundtrip_bit_exact     every gate above passed
  device                  torch.cuda.get_device_name, or "cpu"
  card                    nvidia-smi's "name, power.limit" ("cpu" on the CPU)
  clip, gop_clip, batch_size, reps, host_reps, input_mb
  compression_ratio       device container bytes / input bytes
  bins, device_bins       the host engine's coded bins; the device chunks' bins
  device_e2e_s, device_e2e_median_s, device_e2e_runs_s
                          wall seconds of device.compress, best, median and
                          every one of --reps runs after one warm-up, each
                          ending in a device synchronise
  device_e2e_spread       (slowest - best) / best of those runs
  host_phases_s           the host-clock phases of the best run's
                          compress(info=...): open_s, fetch_s, stage_s,
                          launch_s, compact_s, dispatch_s, emit_s, pack_s,
                          and fetch_s's two parts: fetch_wait_s (the time
                          in the native artc_session_analyze_chunk: waiting
                          for the session's workers to walk and export the
                          chunk, and the export's copy out) and parse_s
                          (the Python parse of the export,
                          analysis._parse_slim_chunk)
  wire_bytes              host->device bytes of that run (info["wire_bytes"])
  device_phases_ms        per phase {"best", "median"} over --reps runs after
                          a warm-up, each phase over every chunk and timed
                          with CUDA events from an idle card, on one set of
                          call streams as device.compress makes them (the
                          end event waits for the copy stream too): h2d
                          (to_torch_staged with the shared-table cache: blob
                          packing into pinned memory, uploads on the copy
                          stream, the dual0 expand), expand
                          (wire_expand4_blob), model (model_pass_v4),
                          lane_scan (encode_interleaved_start), compaction
                          (encode_interleaved_compact: the counts readback
                          into pinned memory and lane_compact), d2h (every
                          chunk's downloads into pinned memory, one wait,
                          encode_interleaved_emit's assembly); their blobs
                          must equal device.compress's
  microbench              microbench.measure on the largest chunk: expand,
                          model and chain times, the dense chain
                          (dense_chain_ms) and the dense planes' upload
                          (dense_upload_ms) beside the wire's
  host_best_s, host_median_s, host_run_spread_s
                          wall seconds of pipeline.compress (batch
                          --batch-size, profile 0) over --host-reps runs
                          after a warm-up: best, median, every run sorted
  host_path_mb_s, host_path_mb_s_median
  vm_loaded               (slowest - best) / best host run > 0.6
  host_decompress_mb_s    input MB / best of --host-reps pipeline.decompress
  gop_scaling_1cpu_s, gop_scaling_parallel_s, gop_scaling_x, gop_scaling_cpus
                          best of --host-reps host compresses of --gop-clip
                          at chunk mode 1, pinned to one CPU
                          (sched_setaffinity) and on all of this process's
                          CPUs, their ratio, and the CPU count
  cpu_calib_s             a fixed numpy integer workload, best of 3: the
                          host's load, for comparing host numbers across
                          runs
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from . import device as td
from . import host, microbench, pipeline
from . import streams as cs
from .ops import lanes as lx
from .ops import model_pass as mp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASES = ("h2d", "expand", "model", "lane_scan", "compaction", "d2h")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _cpu_calibration() -> float:
    """Fixed integer+memory workload, best-of-3: an absolute load reference.
    A uniformly busy host slows every rep the same amount, which the
    spread-based vm_loaded flag cannot see; the ratio of cpu_calib_s across
    runs normalizes host numbers."""
    best = float("inf")
    for _ in range(3):
        t0 = time.time()
        x = np.arange(20_000_000, dtype=np.uint64)
        for _ in range(3):
            x ^= x << 13
            x ^= x >> 7
            x ^= x << 17
        int(x[::4096].sum())
        best = min(best, time.time() - t0)
    return best


def _blob_mismatch(an, blobs: list[bytes]) -> str | None:
    """Each chunk's lane blob against the C++ encoder's on the host model's
    probs; the first mismatch, or None."""
    if len(blobs) != len(an.chunks):
        return f"{len(blobs)} lane blobs for {len(an.chunks)} chunks"
    for i, (c, blob) in enumerate(zip(an.chunks, blobs)):
        bits = (c.packed >> 15).astype(np.uint8)
        if blob != host.rans_encode(bits, c.host_probs, td.pick_lanes(c.n)):
            return f"chunk {i}: device lane blob != C++ encoder"
    return None


def _decodes_to(comp: bytes, data: bytes) -> bool:
    try:
        return host.decompress(comp)[0] == data
    except host.NativeError:
        return False


def device_phases(an, dev: torch.device, reps: int) -> tuple[dict, list[bytes]]:
    """The device path's phases over every chunk, each timed on its own
    (microbench.one_ms) in production order, --reps times after a warm-up,
    on one set of call streams (none on the CPU) as device.compress runs
    them; returns {phase: {"best", "median"}} ms and the last run's blobs."""
    with cs.for_call(dev) as streams, torch.cuda.stream(streams and streams.compute):
        return _phases(an, dev, reps, streams)


def _phases(an, dev: torch.device, reps: int, streams) -> tuple[dict, list[bytes]]:
    s: dict = {}

    def h2d():
        s["staged"] = microbench.stage_all(an, dev, streams)

    def expand():
        s["ex"] = [mp.wire_expand4_blob(st.blob, st.sc, **st.statics["expand"])
                   for st in s["staged"]]

    def model():
        s["pb"] = [mp.model_pass_v4(bit, kind, slot, prior, dk_d, dk_s, deltas, st.dual0,
                                    sig0_idx=st.s_idx, sig0_val=st.s_val,
                                    **st.statics["model"])
                   for st, (bit, kind, slot, prior, deltas, dk_d, dk_s)
                   in zip(s["staged"], s["ex"])]

    def lane_scan():
        s["h"] = [lx.encode_interleaved_start(bits, probs, c.n, td.pick_lanes(c.n), streams)
                  for c, (probs, bits) in zip(an.chunks, s["pb"])]

    def compaction():
        s["ch"] = [lx.encode_interleaved_compact(h, streams) for h in s["h"]]

    def d2h():
        parts = [lx.emit_tensors(ch) for ch in s["ch"]]
        arrays = cs.to_host([t for p in parts for t in p], streams)
        s["blobs"] = []
        for ch, p in zip(s["ch"], parts):
            s["blobs"].append(lx.encode_interleaved_emit(ch, arrays[:len(p)]))
            arrays = arrays[len(p):]

    steps = (h2d, expand, model, lane_scan, compaction, d2h)
    runs = {name: [] for name in PHASES}
    for fn in steps:
        fn()
    for _ in range(reps):
        for name, fn in zip(PHASES, steps):
            runs[name].append(microbench.one_ms(fn, dev, streams))
    out = {}
    for name, r in runs.items():
        best, med = microbench.best_median(r)
        out[name] = {"best": best, "median": med}
    return out, s["blobs"]


def _fail(report: dict, msg: str) -> int:
    log(f"bench: FAIL: {msg}")
    print(json.dumps({"metric": "recompress_throughput", "value": 0.0, "unit": "MB/s",
                      "device": report["device"], "card": report["card"], "error": msg}))
    return 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="avrecode_tpu_torch.bench", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--clip", default=os.path.join(REPO, "benchdata", "bench.mp4"))
    p.add_argument("--gop-clip", default=os.path.join(REPO, "benchdata", "multigop720.mp4"))
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda runs the kernels, cpu their plain versions")
    p.add_argument("--batch-size", type=int, default=4096)
    p.add_argument("--reps", type=int, default=5, help="timed runs of the device path")
    p.add_argument("--host-reps", type=int, default=9, help="timed runs of the host path")
    args = p.parse_args(argv)
    dev = td._device(args.device)
    batch = args.batch_size
    with open(args.clip, "rb") as f:
        data = f.read()
    with open(args.gop_clip, "rb") as f:
        gop_data = f.read()
    mb = len(data) / 1e6
    report = {"metric": "recompress_throughput", "unit": "MB/s",
              "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
              "card": microbench.card(dev)}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # ---- gates ----
    an = td.analyze(data, batch_size=batch, model_profile=2, want_probs=True)
    staged = microbench.stage_all(an, dev)
    err = microbench.probs_mismatch(an, staged)
    if err:
        return _fail(report, err)
    info = {}
    comp_dev, _ = td.compress(data, batch_size=batch, device=dev, info=info)  # the warm-up
    err = _blob_mismatch(an, info["blobs"])
    if err:
        return _fail(report, err)
    if not _decodes_to(comp_dev, data):
        return _fail(report, "device container failed roundtrip")
    comp_host, st_host = pipeline.compress(data, batch_size=batch)
    if not _decodes_to(comp_host, data):
        return _fail(report, "host container failed roundtrip")
    comp_gop, _ = pipeline.compress(gop_data, chunk_mode=1, batch_size=batch)
    if not _decodes_to(comp_gop, gop_data):
        return _fail(report, "host gop-clip container failed roundtrip")
    log("bench: gates passed (probs == host, blobs == C++ encoder, containers roundtrip)")

    # ---- device path: best of --reps after the warm-up above ----
    dev_runs, infos = [], []
    for _ in range(args.reps):
        info = {}
        t0 = time.perf_counter()
        comp, _ = td.compress(data, batch_size=batch, device=dev, info=info)
        sync()
        dev_runs.append(time.perf_counter() - t0)
        infos.append(info)
        if comp != comp_dev:
            return _fail(report, "device containers differ between runs")
    dev_best, dev_med = microbench.best_median(dev_runs)
    best_info = infos[dev_runs.index(dev_best)]
    phases, phase_blobs = device_phases(an, dev, args.reps)
    if phase_blobs != best_info["blobs"]:
        return _fail(report, "the timed phases' blobs != device.compress's")
    micro = microbench.measure(an, staged, dev, args.reps)
    log(f"bench: device e2e best {dev_best:.3f} s of {[round(t, 3) for t in dev_runs]}")

    # ---- host baseline ----
    pipeline.compress(data, batch_size=batch)  # warm-up
    host_runs = []
    for _ in range(args.host_reps):
        t0 = time.perf_counter()
        pipeline.compress(data, batch_size=batch)
        host_runs.append(time.perf_counter() - t0)
    host_best, host_med = microbench.best_median(host_runs)
    dec_s = float("inf")
    for _ in range(args.host_reps):
        t0 = time.perf_counter()
        pipeline.decompress(comp_host)
        dec_s = min(dec_s, time.perf_counter() - t0)
    all_cpus = os.sched_getaffinity(0)
    gop_1cpu_s = gop_par_s = float("inf")
    try:
        for _ in range(args.host_reps):
            os.sched_setaffinity(0, {min(all_cpus)})
            t0 = time.perf_counter()
            pipeline.compress(gop_data, chunk_mode=1, batch_size=batch)
            gop_1cpu_s = min(gop_1cpu_s, time.perf_counter() - t0)
            os.sched_setaffinity(0, all_cpus)
            t0 = time.perf_counter()
            pipeline.compress(gop_data, chunk_mode=1, batch_size=batch)
            gop_par_s = min(gop_par_s, time.perf_counter() - t0)
    finally:
        os.sched_setaffinity(0, all_cpus)
    log(f"bench: host best {host_best:.3f} s; gop {gop_1cpu_s:.3f} s on 1 cpu -> "
        f"{gop_par_s:.3f} s on {len(all_cpus)}")

    report.update({
        "value": mb / dev_best,
        "value_median": mb / dev_med,
        "vs_baseline": host_best / dev_best,
        "roundtrip_bit_exact": True,
        "clip": os.path.basename(args.clip),
        "gop_clip": os.path.basename(args.gop_clip),
        "batch_size": batch,
        "reps": args.reps,
        "host_reps": args.host_reps,
        "input_mb": mb,
        "compression_ratio": len(comp_dev) / len(data),
        "bins": st_host.total_bins,
        "device_bins": int(sum(c.n for c in an.chunks)),
        "device_e2e_s": dev_best,
        "device_e2e_median_s": dev_med,
        "device_e2e_runs_s": dev_runs,
        "device_e2e_spread": (max(dev_runs) - dev_best) / dev_best,
        "host_phases_s": {k: best_info[k] for k in (
            "open_s", "fetch_s", "fetch_wait_s", "parse_s", "stage_s", "launch_s",
            "compact_s", "dispatch_s", "emit_s", "pack_s")},
        "wire_bytes": best_info["wire_bytes"],
        "device_phases_ms": phases,
        "microbench": micro,
        "host_best_s": host_best,
        "host_median_s": host_med,
        "host_run_spread_s": sorted(host_runs),
        "host_path_mb_s": mb / host_best,
        "host_path_mb_s_median": mb / host_med,
        "vm_loaded": (max(host_runs) - host_best) / host_best > 0.6,
        "host_decompress_mb_s": mb / dec_s,
        "gop_scaling_1cpu_s": gop_1cpu_s,
        "gop_scaling_parallel_s": gop_par_s,
        "gop_scaling_x": gop_1cpu_s / gop_par_s,
        "gop_scaling_cpus": len(all_cpus),
        "cpu_calib_s": _cpu_calibration(),
    })
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
