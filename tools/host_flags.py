#!/usr/bin/env python3
"""The port's host library under several g++ flag sets: does each build
decode what it writes, and how fast is its host engine.

    python3 tools/host_flags.py [--flags "-O2" ...] [--rounds 2]

Builds the port's copy of the engine, avrecode_tpu_torch/native/recode.cc
(_native.NATIVE_DIR), once per flag set, all at once, into
avrecode_tpu_torch/build/host_flags/: the port's HOST_CXXFLAGS ("port"), the
same with -fno-unswitch-loops ("no_unswitch", the flag the library carried
before decode_coeffs got its attribute), the same with -DARTC_NO_UNSWITCH=
("unguarded": that attribute defined away), and a set for each --flags
(after -std=c++17 -fPIC -shared -pthread). Then, in turns (the sets in
order, then reversed, --rounds times), a fresh process per set loads its
build and
  - compresses every clip of the frozen corpus with the host engine at
    profile 0 and 2 (batch 512) and profile 2 at chunk mode 1, decodes each
    container and counts the ones that fail or differ from the input;
  - times the host engine's compress of benchdata/bench.mp4 at its defaults
    (best of 3, host clock).
One JSON line a run, then a summary line. Run it where the library is
used: the toolchain, not the sources, decides what a flag does.
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
OUT = os.path.join(REPO, "avrecode_tpu_torch", "build", "host_flags")
MODES = (dict(batch_size=512, model_profile=0), dict(batch_size=512, model_profile=2),
         dict(chunk_mode=1, batch_size=512, model_profile=2))


def build(name: str, flags: list[str]) -> tuple[str, int, str]:
    from avrecode_tpu_torch import _native
    path = os.path.join(OUT, f"libartc_{name}.so")
    r = subprocess.run(["g++", *flags, '-DARTC_BUILD_ID="nogit"', "-I", _native.NATIVE_DIR,
                        "-o", path, os.path.join(_native.NATIVE_DIR, "recode.cc")],
                       capture_output=True, text=True)
    return name, r.returncode, r.stderr[-1000:]


def run(name: str) -> dict:
    """One build's roundtrips over the corpus and its host compress time."""
    from avrecode_tpu_torch import host
    from avrecode_tpu_torch import testcorpus as tc
    lib = ctypes.CDLL(os.path.join(OUT, f"libartc_{name}.so"))
    host._bind(lib)
    host._lib = lib
    failed = []
    for clip in tc.clip_names():
        data = tc.clip_bytes(clip)
        for kw in MODES:
            comp, _ = host.compress(data, **kw)
            try:
                ok = host.decompress(comp)[0] == data
            except host.NativeError:
                ok = False
            if not ok:
                failed.append(f"{clip} {kw}")
    with open(os.path.join(REPO, "benchdata", "bench.mp4"), "rb") as f:
        bench = f.read()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        host.compress(bench)
        times.append(time.perf_counter() - t0)
    return {"build": name, "roundtrips": len(tc.clip_names()) * len(MODES),
            "failed": failed, "compress_best_s": min(times), "compress_s": times}


def main() -> int:
    sys.path.insert(0, REPO)
    from avrecode_tpu_torch import _native
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--flags", action="append", help="a g++ flag set (repeatable)")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    port = _native.HOST_CXXFLAGS
    sets = {"port": port, "no_unswitch": [*port, "-fno-unswitch-loops"],
            "unguarded": [*port, "-DARTC_NO_UNSWITCH="]}
    for i, flags in enumerate(args.flags or []):
        sets[f"set{i}"] = ["-std=c++17", "-fPIC", "-shared", "-pthread", *flags.split()]
    os.makedirs(OUT, exist_ok=True)
    with concurrent.futures.ThreadPoolExecutor(len(sets)) as ex:
        for name, rc, err in ex.map(lambda kv: build(*kv), sets.items()):
            if rc:
                print(f"host_flags: build {name} failed: {err}", file=sys.stderr)
                return 1
    results: dict = {name: [] for name in sets}
    order = list(sets) + list(reversed(sets))
    for _ in range(args.rounds):
        for name in order:
            out = subprocess.run([sys.executable, __file__, "--run", name], capture_output=True,
                                 text=True, timeout=900, cwd=REPO)
            if out.returncode:
                print(f"host_flags: {name} exited {out.returncode}: {out.stderr[-2000:]}",
                      file=sys.stderr)
                return 1
            rec = json.loads(out.stdout.strip().splitlines()[-1])
            results[name].append(rec)
            print(json.dumps(rec), flush=True)
    print(json.dumps({name: {"flags": " ".join(sets[name]),
                             "failed_roundtrips": [len(r["failed"]) for r in recs],
                             "compress_best_s": [r["compress_best_s"] for r in recs]}
                      for name, recs in results.items()}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--run"]:
        sys.path.insert(0, REPO)
        print(json.dumps(run(sys.argv[2])))
        sys.exit(0)
    sys.exit(main())
