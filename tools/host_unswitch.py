#!/usr/bin/env python3
"""Finds the loop of the port's host engine that g++ miscompiles when it
unswitches it, and checks that a build decodes the 4:2:2 clips it encodes.

    python3 tools/host_unswitch.py [--diff] [--bisect] [--repro]
        [--exempt NAME=FILE:FIRST-LAST[,FILE:FIRST-LAST...]] [--clips a,b,...]

native/h264_slice.h keeps loop unswitching out of decode_coeffs with an
attribute (ARTC_NO_UNSWITCH). Every build here compiles the port's copy of
the engine (avrecode_tpu_torch/native/recode.cc) with the port's
HOST_CXXFLAGS, all at once, into avrecode_tpu_torch/build/host_unswitch/:
"port" as shipped, and "unguarded", with -DARTC_NO_UNSWITCH= (the attribute
defined away, so nothing in the engine is exempt from unswitching):

  --diff     also builds "unguarded_d" (with -fdump-tree-unswitch-details)
             and "nsa" (with -fno-strict-aliasing), and prints the
             "unswitching loop" reports (-fopt-info-loop-optimized) of the
             first that the second lacks, by source location and condition
             with SSA version numbers dropped: the candidate loops, and the
             function of the dump that each was unswitched in. Each such
             function's section of the dump is kept beside the builds
             (fn0.txt, ...).
  --bisect   builds "unguarded" once per unswitching it does, with only
             that one allowed (-fdbg-cnt=loop_unswitch:K-K, g++ 13), then
             with only the ones that fail alone, and with all but those
             (where the pass may unswitch the same loop under a later
             counter value).
  --repro    compiles native/repro_unswitch.cc under REPRO_FLAGS and prints
             what each binary says, and keeps the unswitch dump of the -O3
             build beside the builds (repro_O3.unswitch).
  --exempt   another build: "unguarded" on a copy of the sources in which
             each FILE:FIRST-LAST line range (1-based, inclusive, whole
             function definitions) is wrapped in
             `#pragma GCC optimize ("no-unswitch-loops")`. A function so
             marked is not inlined into unmarked callers.

Then one process loads every build, compresses each clip (default: the
corpus's five 4:2:2 clips) in each of tools/host_flags.MODES with every
build, and decodes each container with every build. One JSON line a build:
its own roundtrip failures, whether its containers equal "port"'s, the
failures when it decodes "port"'s containers and "port" decodes its, and
its unswitching reports (how many, how many on a switch, the first four).
Run it where the library is used: the toolchain decides what a flag does.
"""
from __future__ import annotations

import argparse
import collections
import concurrent.futures
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

from avrecode_tpu_torch import _native, host  # noqa: E402
from avrecode_tpu_torch import testcorpus as tc  # noqa: E402
from host_flags import MODES  # noqa: E402

OUT = os.path.join(REPO, "avrecode_tpu_torch", "build", "host_unswitch")
CLIPS_422 = ("c422.264", "c422.mp4", "mbaff422.mp4", "cav422.264", "cavmbaff422.264")
UNGUARDED = [*_native.HOST_CXXFLAGS, "-DARTC_NO_UNSWITCH="]
# The reproducer's flag sets: the library's code-generating flags, then
# variations that show what the miscompile depends on.
REPRO_FLAGS = ("-O3 -march=native", "-O3", "-O3 -march=native -fno-strict-aliasing",
               "-O3 -march=native -fno-unswitch-loops", "-O2 -march=native",
               "-O3 -march=native -DARTC_GUARD")
_REPORT = re.compile(r"^(\S+?:\d+:\d+): optimized: (?:U|u)nswitching loop(?: \d+)?(.*)$")
_SSA = re.compile(r"\b([A-Za-z_.]*?)_\d+\b")


def exempt_copy(name: str, spec: str) -> str:
    """A copy of native/ with each FILE:FIRST-LAST range of `spec` wrapped
    in a no-unswitch-loops pragma region; returns the copy's directory."""
    src = os.path.join(OUT, f"src_{name}")
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(_native.NATIVE_DIR, src)
    by_file = collections.defaultdict(list)
    for part in spec.split(","):
        fname, span = part.rsplit(":", 1)
        first, last = (int(x) for x in span.split("-"))
        by_file[fname].append((first, last))
    for fname, spans in by_file.items():
        path = os.path.join(src, fname)
        with open(path) as f:
            lines = f.readlines()
        for first, last in sorted(spans, reverse=True):
            lines.insert(last, "#pragma GCC pop_options\n")
            lines[first - 1:first - 1] = ["#pragma GCC push_options\n",
                                          '#pragma GCC optimize ("no-unswitch-loops")\n']
        with open(path, "w") as f:
            f.writelines(lines)
    return src


def build(name: str, flags: list[str], src: str = _native.NATIVE_DIR,
          extra: tuple[str, ...] = ()) -> tuple[str, int, str]:
    vs = f"-Wl,--version-script={os.path.join(src, 'libartc_host.map')}"
    flags = [vs if f.startswith("-Wl,--version-script=") else f for f in flags]
    info = f"-fopt-info-loop-optimized={os.path.join(OUT, name + '.optinfo')}"
    r = subprocess.run(["g++", *flags, *extra, info, '-DARTC_BUILD_ID="nogit"', "-I", src,
                        "-o", os.path.join(OUT, f"libartc_{name}.so"),
                        os.path.join(src, "recode.cc")],
                       capture_output=True, text=True, cwd=OUT)
    return name, r.returncode, r.stderr[-2000:]


def _report(line: str) -> tuple[str, str] | None:
    """(file:line:column, condition) of an unswitching report, the file's
    directory and the condition's SSA version numbers dropped."""
    m = _REPORT.match(line.strip())
    if m is None:
        return None
    where = m.group(1)
    return (os.path.basename(where.split(":")[0]) + ":" + where.split(":", 1)[1],
            _SSA.sub(r"\1_", m.group(2).strip()))


def reports(path: str) -> list[tuple[str, str]]:
    """The unswitching reports of an opt-info file."""
    with open(path) as f:
        return [r for r in map(_report, f) if r is not None]


def dump_functions(dump: str, candidates: collections.Counter) -> dict:
    """For each function of the unswitch dump with a candidate report: its
    candidate reports; keeps each such function's dump section."""
    found: dict[str, list[str]] = {}
    left = collections.Counter(candidates)
    section: list[str] = []
    func = None

    def close():
        if func is not None and func in found:
            with open(os.path.join(OUT, f"fn{list(found).index(func)}.txt"), "w") as f:
                f.writelines(section)

    with open(dump, errors="replace") as f:
        for line in f:
            if line.startswith(";; Function "):
                close()
                func, section = line[len(";; Function "):].strip(), []
            section.append(line)
            key = _report(line)
            if key is not None and func is not None and left[key] > 0:
                left[key] -= 1
                found.setdefault(func, []).append(f"{key[0]} {key[1]}")
        close()
    return found


def diff() -> dict:
    """The unswitching reports of "unguarded_d" that "nsa" lacks, and the
    dump's function of each."""
    ra = reports(os.path.join(OUT, "unguarded_d.optinfo"))
    rb = reports(os.path.join(OUT, "nsa.optinfo"))
    cand = collections.Counter(ra) - collections.Counter(rb)
    dumps = [os.path.join(OUT, f) for f in os.listdir(OUT)
             if f.startswith("libartc_unguarded_d") and f.endswith(".unswitch")]
    funcs = dump_functions(dumps[0], cand) if dumps else {}
    return {"unswitched_strict": len(ra), "unswitched_no_strict_aliasing": len(rb),
            "only_under_strict_aliasing": sum(cand.values()),
            "candidates": sorted(f"{k[0]} {k[1]}" + (f" x{n}" if n > 1 else "")
                                 for k, n in cand.items()),
            "functions": funcs}


def roundtrips(names: list[str], clips: list[str]) -> list[dict]:
    libs = {}
    for name in names:
        lib = ctypes.CDLL(os.path.join(OUT, f"libartc_{name}.so"))
        host._bind(lib)
        libs[name] = lib

    def call(name, fn, *args, **kw):
        host._lib = libs[name]
        try:
            return (fn(*args, **kw)[0], None)
        except host.NativeError as e:
            return (None, str(e))

    res = {n: {"build": n, "failed": [], "differs_from_port": [], "decodes_port_failed": [],
               "port_decodes_failed": []} for n in names}
    for clip in clips:
        data = tc.clip_bytes(clip)
        for kw in MODES:
            tag = f"{clip} p{kw['model_profile']} m{kw.get('chunk_mode', 0)}"
            comps = {n: call(n, host.compress, data, **kw)[0] for n in names}
            for n in names:
                out, err = call(n, host.decompress, comps[n])
                if out != data:
                    res[n]["failed"].append(f"{tag}: {err or 'wrong bytes'}")
                if comps[n] != comps["port"]:
                    res[n]["differs_from_port"].append(tag)
                    if call(n, host.decompress, comps["port"])[0] != data:
                        res[n]["decodes_port_failed"].append(tag)
                    if call("port", host.decompress, comps[n])[0] != data:
                        res[n]["port_decodes_failed"].append(tag)
    host._lib = None
    return [dict(r, roundtrips=len(clips) * len(MODES)) for r in res.values()]


def build_all(jobs: list[tuple]) -> bool:
    with concurrent.futures.ThreadPoolExecutor(os.cpu_count()) as ex:
        for name, rc, err in ex.map(lambda j: build(*j), jobs):
            if rc:
                print(f"host_unswitch: build {name} failed: {err}", file=sys.stderr)
                return False
    return True


def unswitched(name: str) -> dict:
    """The build's unswitching reports: how many, how many on a switch,
    and the first four."""
    rep = reports(os.path.join(OUT, f"{name}.optinfo"))
    return {"unswitched": len(rep), "on_switch": sum("switch" in k[1] for k in rep),
            "reports": [f"{k[0]} {k[1]}" for k in rep[:4]]}


def ranges(ks: list[int]) -> str:
    """1-based counter values as -fdbg-cnt's closed ranges, e.g. 1-4:6-9."""
    out, start = [], None
    for i, k in enumerate(ks):
        start = k if start is None else start
        if i + 1 == len(ks) or ks[i + 1] != k + 1:
            out.append(f"{start}-{k}")
            start = None
    return ":".join(out)


def bisect(clips: list[str]) -> bool:
    """Builds "unguarded" once per unswitching with only that one allowed,
    then with only the ones that fail alone and with all but those; one
    JSON line a build."""
    n = unswitched("unguarded")["unswitched"]
    jobs = [(f"only{k}", UNGUARDED, _native.NATIVE_DIR, (f"-fdbg-cnt=loop_unswitch:{k}-{k}",))
            for k in range(1, n + 1)]
    if not build_all(jobs):
        return False
    bad = []
    for k, rec in enumerate(roundtrips(["port"] + [j[0] for j in jobs], clips)[1:], 1):
        print(json.dumps(dict(rec, **unswitched(rec["build"]))), flush=True)
        bad += [k] if rec["failed"] else []
    good = [k for k in range(1, n + 1) if k not in bad]
    jobs = [(name, UNGUARDED, _native.NATIVE_DIR, (f"-fdbg-cnt=loop_unswitch:{ranges(ks)}",))
            for name, ks in (("all_but_failing", good), ("only_failing", bad)) if ks]
    if not build_all(jobs):
        return False
    for rec in roundtrips(["port"] + [j[0] for j in jobs], clips)[1:]:
        print(json.dumps(dict(rec, **unswitched(rec["build"]))), flush=True)
    print(json.dumps({"bisect": {"unswitchings": n, "failing_alone": bad}}), flush=True)
    return True


def repro() -> list[dict]:
    """What the reproducer prints under each of REPRO_FLAGS."""
    src = os.path.join(_native.NATIVE_DIR, "repro_unswitch.cc")
    out = []
    for i, flags in enumerate(REPRO_FLAGS):
        exe = os.path.join(OUT, f"repro{i}")
        dump = ("-fdump-tree-unswitch-details",) if i == 1 else ()
        subprocess.run(["g++", "-std=c++17", *flags.split(), *dump,
                        f"-fopt-info-loop-optimized={exe}.optinfo", "-I", _native.NATIVE_DIR,
                        "-o", exe, src], check=True, cwd=OUT)
        r = subprocess.run([exe], capture_output=True, text=True)
        out.append({"repro_flags": flags, "exit": r.returncode,
                    "says": r.stdout.strip().splitlines()[-1], **unswitched(f"repro{i}")})
    for f in os.listdir(OUT):
        if f.startswith("repro1") and f.endswith(".unswitch"):
            os.replace(os.path.join(OUT, f), os.path.join(OUT, "repro_O3.unswitch"))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--diff", action="store_true")
    ap.add_argument("--bisect", action="store_true")
    ap.add_argument("--repro", action="store_true")
    ap.add_argument("--exempt", action="append", default=[], metavar="NAME=SPEC")
    ap.add_argument("--clips", default=",".join(CLIPS_422))
    args = ap.parse_args()
    shutil.rmtree(OUT, ignore_errors=True)
    os.makedirs(OUT)
    print(json.dumps({"gxx": subprocess.run(["g++", "--version"], capture_output=True,
                                            text=True).stdout.splitlines()[0],
                      "unguarded_flags": " ".join(UNGUARDED)}), flush=True)
    jobs = [("port", _native.HOST_CXXFLAGS), ("unguarded", UNGUARDED)]
    jobs += [(n, UNGUARDED, exempt_copy(n, spec)) for n, spec in (s.split("=", 1)
                                                               for s in args.exempt)]
    if args.diff:
        jobs += [("unguarded_d", UNGUARDED, _native.NATIVE_DIR, ("-fdump-tree-unswitch-details",)),
                 ("nsa", UNGUARDED, _native.NATIVE_DIR, ("-fno-strict-aliasing",))]
    if not build_all(jobs):
        return 1
    for rec in repro() if args.repro else []:
        print(json.dumps(rec), flush=True)
    if args.diff:
        print(json.dumps({"diff": diff()}), flush=True)
    clips = args.clips.split(",")
    for rec in roundtrips([j[0] for j in jobs], clips):
        print(json.dumps(dict(rec, **unswitched(rec["build"]))), flush=True)
    return 0 if not args.bisect or bisect(clips) else 1


if __name__ == "__main__":
    sys.exit(main())
