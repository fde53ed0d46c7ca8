"""CLI of the PyTorch + CUDA device path:

    python -m avrecode_tpu_torch.cli compress <in> <out> [--device cuda] [--model-profile 0]
    python -m avrecode_tpu_torch.cli roundtrip <in> [out] [--device cuda] [--model-profile 0]
    python -m avrecode_tpu_torch.cli corpus <dir|glob> <out_dir> [--device cuda | --host]
        [--chunk-mode {0,1}] [--batch-size N] [--host-workers 2] [--resume]

--chunk-mode defaults to 0 and --batch-size to 4096, as in avrecode_tpu.cli.
Profile 0 runs the model pass that ARTC_MODEL_IMPL names (v2, dict, sort, mm).
ARTC_TIMING=1 prints the profile-2 path's per-chunk timings and wire bytes.

Compression runs through the port (avrecode_tpu_torch.device.compress);
decompression and the roundtrip check run through the host decoder
(avrecode_tpu_torch.host.decompress). `corpus` recompresses every file of a
directory or glob through the port on --device, each output checked by the
host decoder, dealt across the processes that JAX_COORDINATOR /
JAX_NUM_PROCESSES / JAX_PROCESS_ID describe (parallel/distributed.py; one
process needs none of them); with --host it runs the native host engine
instead, as avrecode_tpu.cli's corpus does without --device. Prints one
JSON report, as avrecode_tpu.cli does.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

import torch

from . import device as td
from . import host


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


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="avrecode-tpu-torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("command", choices=["compress", "roundtrip", "corpus"])
    p.add_argument("input", help="file; for corpus: a directory or glob of files")
    p.add_argument("output", nargs="?")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda runs the kernels, cpu their plain versions")
    p.add_argument("--chunk-mode", type=int, default=0, choices=[0, 1],
                   help="0 = picture-aligned sections; 1 = one chunk per IDR GOP")
    p.add_argument("--model-profile", type=int, default=2, choices=[0, 2],
                   help="2 = frozen batches (slim wire); 0 = immediate increments")
    p.add_argument("--batch-size", type=int, default=4096,
                   help="bins per model batch (small clips may need 512-1024)")
    p.add_argument("--host-workers", type=int, default=2,
                   help="corpus: concurrent files per process")
    p.add_argument("--host", action="store_true",
                   help="corpus: run the native host engine instead of the device path")
    p.add_argument("--resume", action="store_true",
                   help="corpus: skip inputs whose output container already exists "
                        "(outputs are written atomically)")
    args = p.parse_args(argv)
    if args.command == "corpus":
        return _corpus(p, args)
    if args.command == "compress" and not args.output:
        p.error("compress requires an output path")

    with open(args.input, "rb") as f:
        data = f.read()
    t0 = time.perf_counter()
    comp, st = td.compress(data, chunk_mode=args.chunk_mode, batch_size=args.batch_size,
                           model_profile=args.model_profile, device=args.device)
    compress_s = time.perf_counter() - t0
    dev = torch.device(args.device)
    report = {
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "ratio": len(comp) / len(data) if data else 0.0,
        "input_bytes": len(data),
        "output_bytes": len(comp),
        "chunks": st.n_chunks,
        "bins": st.total_bins,
        "compress_s": compress_s,
    }
    ok = True
    if args.command == "roundtrip":
        dec, _ = host.decompress(comp)
        ok = dec == data
        report["roundtrip_ok"] = ok
    print(json.dumps(report))
    if args.output and ok:
        with open(args.output, "wb") as f:
            f.write(comp)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
