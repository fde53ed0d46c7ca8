"""CLI of the PyTorch + CUDA port:

    python -m avrecode_tpu_torch.cli compress <in> <out> [--device cuda | --host]
    python -m avrecode_tpu_torch.cli roundtrip <in> [out] [--device cuda | --host]
    python -m avrecode_tpu_torch.cli decompress <in> <out>
    python -m avrecode_tpu_torch.cli info <container>
    python -m avrecode_tpu_torch.cli corpus <dir|glob> <out_dir> [--device cuda | --host]
        [--host-workers 2] [--resume]

Common options: --lanes N (16), --chunk-mode {0,1} (0), --model-profile
{0,2} (2), --batch-size N (4096), --bill, --bill-table.

compress and roundtrip run the device path (avrecode_tpu_torch.device
.compress) on --device: "cuda" runs the kernels, "cpu" their plain
versions. --model-profile and --batch-size are the device path's: the JAX
CLI has neither, and its compress and roundtrip run the native host engine
at batch 1, profile 0. With --host, compress and roundtrip run exactly
that (avrecode_tpu_torch.pipeline) and print the JAX CLI's report, field
for field. Profile 0 runs the model pass that ARTC_MODEL_IMPL names (v2,
dict, sort, mm); ARTC_TIMING=1 prints the profile-2 path's per-chunk
timings and wire bytes (the spans of trace.py, read as lines).

Decompression, and the roundtrip's check, run on the host decoder
(host.decompress). `info` parses an ATRC container's header without
decoding it. --bill adds the per-class bit accounting to the report and
--bill-table prints it as a table on stderr (compress and roundtrip).
`corpus` recompresses every file of a directory or glob through the port on
--device, each output checked by the host decoder, dealt across the
processes that JAX_COORDINATOR / JAX_NUM_PROCESSES / JAX_PROCESS_ID describe
(parallel/distributed.py; one process needs none of them), at --chunk-mode
and --batch-size (the JAX corpus takes 4096 from corpus_compress's
default); with --host it runs the native host engine instead, as
avrecode_tpu.cli's corpus does without --device. Every command prints one
JSON report, as avrecode_tpu.cli does.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

from . import host, pipeline


def _corpus(p: argparse.ArgumentParser, args) -> int:
    from .parallel import distributed as dist
    if not args.output:
        p.error("corpus requires an output directory")
    if os.path.isdir(args.input):
        paths = [os.path.join(args.input, n) for n in sorted(os.listdir(args.input))
                 if os.path.isfile(os.path.join(args.input, n))]
    else:
        paths = sorted(glob.glob(args.input))
    if not paths:
        p.error(f"no input files match {args.input!r}")
    pidx, pcount = dist.init_distributed()
    rep = dist.corpus_compress(paths, args.output, use_device=not args.host,
                               device=args.device, chunk_mode=args.chunk_mode,
                               batch_size=args.batch_size, host_workers=args.host_workers,
                               resume=args.resume)
    print(json.dumps({
        "process": f"{pidx}/{pcount}",
        "device": "host" if args.host else args.device,
        "files": rep.files,
        "failures": rep.failures,
        "input_bytes": rep.input_bytes,
        "output_bytes": rep.output_bytes,
        "ratio": rep.ratio,
        "wall_s": round(rep.wall_s, 2),
        "mb_s": round(rep.input_bytes / 1e6 / rep.wall_s, 3) if rep.wall_s else 0.0,
    }))
    return 0 if rep.failures == 0 else 1


def _info(data: bytes) -> int:
    """The ATRC header (container version and writing build id), without a
    decode; as avrecode_tpu.cli's info."""
    if data[:4] != b"ATRC" or len(data) < 6:
        print(json.dumps({"error": "not an ATRC container"}))
        return 1
    version = data[4]
    build_id = "pre-v26"
    if version >= 26:
        bl = data[5]
        build_id = data[6:6 + bl].decode("ascii", "replace")
    print(json.dumps({
        "container_version": version,
        "build_id": build_id,
        "reader_version": host.container_version(),
        "readable": version == host.container_version(),
        "bytes": len(data),
    }))
    return 0


def _report(args, n_in: int, n_out: int, st: host.Stats, ok: bool | None) -> dict:
    """The JAX CLI's report for compress (ok None) or roundtrip, in its key
    order, with the bill under --bill."""
    if ok is None:
        report = {"ratio": n_out / n_in, "input_bytes": n_in, "output_bytes": n_out,
                  "slices": st.n_slices, "fallback_slices": st.n_fallback,
                  "chunks": st.n_chunks, "bins": st.total_bins}
    else:
        report = {"roundtrip_ok": ok, "ratio": n_out / n_in if n_in else 0.0,
                  "input_bytes": n_in, "compressed_bytes": n_out,
                  "container_overhead": pipeline.container_overhead(n_out, st),
                  "slices": st.n_slices, "fallback_slices": st.n_fallback}
    if args.bill:
        report["bill"] = st.bill
    return report


def _host_path(args, data: bytes) -> int:
    """compress / roundtrip on the native host engine: what avrecode_tpu.cli
    runs for them, with its report and its output file."""
    if args.command == "compress":
        comp, st = pipeline.compress(data, lanes=args.lanes, chunk_mode=args.chunk_mode)
        with open(args.output, "wb") as f:
            f.write(comp)
        ok, n_out = None, len(comp)
    else:
        rep = pipeline.roundtrip(data, lanes=args.lanes, chunk_mode=args.chunk_mode)
        ok, n_out, st = rep.ok, rep.compressed_bytes, rep.stats
    if args.bill_table:
        from .utils.billing import format_bill
        print(format_bill(st), file=sys.stderr)
    print(json.dumps(_report(args, len(data), n_out, st, ok)))
    if ok and args.output:
        comp, _ = pipeline.compress(data, lanes=args.lanes, chunk_mode=args.chunk_mode)
        with open(args.output, "wb") as f:
            f.write(comp)
    return 0 if ok is not False else 1


def _device_path(args, data: bytes) -> int:
    """compress / roundtrip through the port's device path on --device."""
    import torch

    from . import device as td
    t0 = time.perf_counter()
    comp, st = td.compress(data, lanes=args.lanes, chunk_mode=args.chunk_mode,
                           batch_size=args.batch_size, model_profile=args.model_profile,
                           device=args.device)
    compress_s = time.perf_counter() - t0
    ok = None
    if args.command == "roundtrip":
        dec, _ = host.decompress(comp)
        ok = dec == data
    dev = torch.device(args.device)
    report = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
              **_report(args, len(data), len(comp), st, ok), "chunks": st.n_chunks,
              "bins": st.total_bins, "compress_s": compress_s}
    if args.bill_table:
        from .utils.billing import format_bill
        print(format_bill(st), file=sys.stderr)
    print(json.dumps(report))
    if args.output and ok is not False:
        with open(args.output, "wb") as f:
            f.write(comp)
    return 0 if ok is not False else 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="avrecode-tpu-torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("command", choices=["compress", "decompress", "roundtrip", "corpus", "info"])
    p.add_argument("input", help="file; for corpus: a directory or glob of files")
    p.add_argument("output", nargs="?")
    p.add_argument("--lanes", type=int, default=16, help="rANS entropy lanes per chunk")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda runs the kernels, cpu their plain versions")
    p.add_argument("--chunk-mode", type=int, default=0, choices=[0, 1],
                   help="0 = picture-aligned sections; 1 = one chunk per IDR GOP")
    p.add_argument("--model-profile", type=int, default=2, choices=[0, 2],
                   help="device path: 2 = frozen batches (slim wire); 0 = immediate "
                        "increments")
    p.add_argument("--batch-size", type=int, default=4096,
                   help="device path and corpus: bins per model batch (small clips may "
                        "need 512-1024)")
    p.add_argument("--bill", action="store_true", help="print per-class bit accounting (JSON)")
    p.add_argument("--bill-table", action="store_true",
                   help="print a human-readable ours-vs-CABAC cost table to stderr")
    p.add_argument("--host", action="store_true",
                   help="compress, roundtrip, corpus: run the native host engine instead of "
                        "the device path")
    p.add_argument("--host-workers", type=int, default=2,
                   help="corpus: concurrent files per process")
    p.add_argument("--resume", action="store_true",
                   help="corpus: skip inputs whose output container already exists "
                        "(outputs are written atomically)")
    args = p.parse_args(argv)
    if args.command == "corpus":
        return _corpus(p, args)
    if args.command in ("compress", "decompress") and not args.output:
        p.error(f"{args.command} requires an output path")

    with open(args.input, "rb") as f:
        data = f.read()
    if args.command == "info":
        return _info(data)
    if args.command == "decompress":
        out, st = pipeline.decompress(data)
        with open(args.output, "wb") as f:
            f.write(out)
        print(json.dumps({"output_bytes": len(out), "slices": st.n_slices}))
        return 0
    return _host_path(args, data) if args.host else _device_path(args, data)


if __name__ == "__main__":
    sys.exit(main())
