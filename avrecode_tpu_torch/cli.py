"""CLI of the PyTorch + CUDA device path:

    python -m avrecode_tpu_torch.cli compress <in> <out> [--device cuda] [--model-profile 0]
    python -m avrecode_tpu_torch.cli roundtrip <in> [out] [--device cuda] [--model-profile 0]

Profile 0 runs the model pass that ARTC_MODEL_IMPL names (v2, dict, sort, mm).

Compression runs through the port (avrecode_tpu_torch.device.compress);
decompression and the roundtrip check run through the host decoder
(avrecode_tpu.pipeline.decompress). Prints one JSON report, as
avrecode_tpu.cli does.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from avrecode_tpu import pipeline

from . import device as td


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="avrecode-tpu-torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("command", choices=["compress", "roundtrip"])
    p.add_argument("input")
    p.add_argument("output", nargs="?")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda runs the kernels, cpu their plain versions")
    p.add_argument("--chunk-mode", type=int, default=0, choices=[0, 1],
                   help="0 = picture-aligned sections; 1 = one chunk per IDR GOP")
    p.add_argument("--model-profile", type=int, default=2, choices=[0, 2],
                   help="2 = frozen batches (slim wire); 0 = immediate increments")
    args = p.parse_args(argv)
    if args.command == "compress" and not args.output:
        p.error("compress requires an output path")

    with open(args.input, "rb") as f:
        data = f.read()
    t0 = time.perf_counter()
    comp, st = td.compress(data, chunk_mode=args.chunk_mode, model_profile=args.model_profile,
                           device=args.device)
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
        dec, _ = pipeline.decompress(comp)
        ok = dec == data
        report["roundtrip_ok"] = ok
    print(json.dumps(report))
    if args.output and ok:
        with open(args.output, "wb") as f:
            f.write(comp)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
