#!/usr/bin/env python3
"""The port's host engine under UndefinedBehaviorSanitizer, over the frozen
test corpus.

    python3 tools/host_ubsan.py [--src DIR] [--opt="-O1 -g"] [--workers 4]
        [--clips a,b,...]

Builds DIR/recode.cc (default: the port's copy of the engine,
_native.NATIVE_DIR) with --opt and -fsanitize=undefined
-fno-sanitize-recover=all into avrecode_tpu_torch/build/host_ubsan/. Then a
fresh process per clip (--workers at once) binds that build as the port's
host library and runs the clip
  - through testcorpus.check_clip on the CPU in every mode of its manifest
    entry (the host engine's analysis session, its pack and its decoder;
    each container against the manifest's digest, exact roundtrip);
  - through the host engine's own compress and decompress at profile 0 and
    2 (batch 512) and at profile 2 with chunk mode 1.
The first finding aborts its process (-fno-sanitize-recover), and the clip
is reported with the sanitizer's message. One JSON line a clip, then a
summary line; exits 1 if any clip failed. CPU only.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "avrecode_tpu_torch", "build", "host_ubsan")
FLAGS = ["-std=c++17", "-fsanitize=undefined", "-fno-sanitize-recover=all", "-fPIC",
         "-shared", "-pthread"]


def run(lib_path: str, clip: str) -> dict:
    """One clip through check_clip (every manifest mode) and the host
    engine's roundtrips, on the sanitized library."""
    from host_flags import MODES  # the host modes tools/host_flags.py runs

    from avrecode_tpu_torch import host
    from avrecode_tpu_torch import testcorpus as tc
    lib = ctypes.CDLL(lib_path)
    host._bind(lib)
    host._lib = lib
    t0 = time.perf_counter()
    r = tc.check_clip(clip, "cpu")
    data = tc.clip_bytes(clip)
    for kw in MODES:
        comp, _ = host.compress(data, **kw)
        if host.decompress(comp)[0] != data:
            raise AssertionError(f"{clip} {kw}: host roundtrip differs")
    return {"clip": clip, "modes": r["modes"], "host_modes": len(MODES),
            "seconds": time.perf_counter() - t0}


def main() -> int:
    sys.path.insert(0, REPO)
    from avrecode_tpu_torch import _native
    from avrecode_tpu_torch import testcorpus as tc
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=_native.NATIVE_DIR, help="the engine's source directory")
    ap.add_argument("--opt", default="-O1 -g", help="optimisation flags of the build")
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--clips", help="comma-separated clips (default: the whole corpus)")
    args = ap.parse_args()
    os.makedirs(OUT, exist_ok=True)
    lib_path = os.path.join(OUT, "libartc_ubsan.so")
    t0 = time.perf_counter()
    flags = [*args.opt.split(), *FLAGS]
    b = subprocess.run(["g++", *flags, '-DARTC_BUILD_ID="nogit"', "-I", args.src,
                        "-o", lib_path, os.path.join(args.src, "recode.cc")],
                       capture_output=True, text=True)
    if b.returncode:
        print(f"host_ubsan: build failed: {b.stderr[-2000:]}", file=sys.stderr)
        return 1
    build_s = time.perf_counter() - t0
    clips = args.clips.split(",") if args.clips else tc.clip_names()

    def one(clip: str) -> dict:
        # Two CPU threads a process, so --workers processes share the cores.
        env = {**os.environ, "OMP_NUM_THREADS": "2"}
        out = subprocess.run([sys.executable, __file__, "--run", lib_path, clip], env=env,
                             capture_output=True, text=True, timeout=1800, cwd=REPO)
        if out.returncode == 0:
            return {**json.loads(out.stdout.strip().splitlines()[-1]), "ok": True}
        findings = [ln for ln in out.stderr.splitlines() if "runtime error" in ln]
        return {"clip": clip, "ok": False, "rc": out.returncode, "findings": findings,
                "stderr": out.stderr[-1500:]}

    failed = []
    with concurrent.futures.ThreadPoolExecutor(args.workers) as ex:
        for rec in ex.map(one, clips):
            print(json.dumps(rec), flush=True)
            if not rec["ok"]:
                failed.append(rec["clip"])
    print(json.dumps({"src": args.src, "flags": " ".join(flags), "build_s": build_s,
                      "clips": len(clips), "failed": failed,
                      "seconds": time.perf_counter() - t0}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--run"]:
        sys.path.insert(0, REPO)
        print(json.dumps(run(sys.argv[2], sys.argv[3])))
        sys.exit(0)
    sys.exit(main())
