#!/usr/bin/env python3
"""One run of one benchmark cell, from the root of a checkout:

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (counted in setup_s, from the interpreter's first line here): the
cell's parts found by name (harness/spec.py), the program imported and its
libraries built or loaded, the mix's files loaded and cut, and one call of
every distinct file of the mix, so that every shape the window sends has
run once. The window: the cell's driver sends the mix's files for --seconds
seconds and no more after that; it ends when the last call returns, so
every file it sent is in its work and all of its time is in its length.
With --trace 1
the window runs under torch.profiler and the run reports the cell's
per-layer metrics; with --trace 0 its end-to-end metrics. Then the peak of
device memory is read, the program's state freed, and every container of
the run judged against the reference (harness/check.py) on the CPU.

The last line of standard output is the result's JSON; the numbers compared
and their limits are the last lines of standard error and the result's last
key. No result and a nonzero exit: no CUDA device, fewer than the cell's
chips, or a module of JAX or of the JAX package loaded in this process.
"""
import time

_T_START = time.monotonic()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# Top-level module names that may not be loaded in the process that prints
# a result: JAX and the JAX package (compared as whole names).
FORBIDDEN = ("jax", "jaxlib", "flax", "avrecode_tpu")


def _environment() -> None:
    """Fixed cache directories inside the checkout, and no JAX through any
    library that would load it by itself."""
    cache = os.path.join(HERE, ".cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list[str]:
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


@dataclass
class Context:
    """What a metric's reader (metrics/<name>.py) may read."""
    records: list            # every file the window sent
    window_s: float          # from the first send to the return of the last call
    setup_s: float
    config: dict
    trace: object = None     # harness.trace.Trace of a --trace 1 run
    calls: list = field(default_factory=list)  # a pool driver's (wall s, workers, [file s])
    _chunks: dict = field(default_factory=dict)

    @property
    def done(self) -> list:
        """The files whose container came."""
        return [r for r in self.records if r.ok]

    def chunks(self, r) -> list:
        """[(K, n)] of a completed file's chunks, read from its container."""
        from harness import container
        if id(r) not in self._chunks:
            self._chunks[id(r)] = container.chunks(r.output)
        return self._chunks[id(r)]


def _card() -> str:
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return res.stdout.strip().splitlines()[0] if res.returncode == 0 else "unknown"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "unknown"


def main(argv=None, *, device: str | None = None, bench: str | None = None,
         base: str = HERE) -> int:
    """Runs the cell. `device` None means the card, checked; the tests pass
    "cpu" (the program's plain versions), and `bench` and `base` to run the
    lookup on a copy of the benchmark."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _environment()
    for path in (ROOT, HERE):
        if path not in sys.path:
            sys.path.insert(0, path)
    from harness import check, spec, traffic
    from harness import trace as tr
    cell = spec.cell(bench or os.path.join(ROOT, "BENCHMARK.json"), args.workload,
                     bool(args.trace), base)

    import torch
    on_card = device is None
    if on_card:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            print(f"run: the cell needs {cell.chips} CUDA device(s); "
                  f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    stream = traffic.Stream(cell.traffic, args.seed)
    workdir = tempfile.mkdtemp(prefix="perfbench-")
    try:
        drv = cell.driver.Driver(cell.config, device, workdir)
        drv.warm(stream.items)
        sync()
        setup_s = time.monotonic() - _T_START

        spans: set = set()
        if args.trace:
            from torch.profiler import ProfilerActivity, profile, record_function
            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
            prof = profile(activities=acts)

            def span(name):
                spans.add(name)
                return record_function(name)
        else:
            prof, span = contextlib.nullcontext(), lambda name: contextlib.nullcontext()
        with prof:
            t_window = time.perf_counter()
            records = drv.run(stream, args.seconds, span)
            sync()
            window_s = time.perf_counter() - t_window
        memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
        trace = tr.read(prof, window_s, spans) if args.trace else None
        drv.collect(records)
        calls = getattr(drv, "calls", [])
        del drv
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()

        from reference import engine
        numbers = check.judge(records, {it.name: it.data for it in stream.items},
                              cell.config, engine.Engine(), check.expected_build_id(ROOT))
        ctx = Context(records=records, window_s=window_s, setup_s=setup_s,
                      config=cell.config, trace=trace, calls=calls)
        metrics = {}
        for entry, reader in cell.metrics:
            value = reader.read(ctx)
            if value is not None:
                metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
        dev = {"platform": "gpu" if on_card else "cpu",
               "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
               "count": cell.chips, "memory_peak_bytes": int(memory_peak)}
        result = {"correct": check.verdict(numbers, len(records)), "attempted": len(records),
                  "failed": numbers["files_failed"], "metrics": metrics, "device": dev,
                  "card": _card() if on_card else "cpu"}
        if trace is not None:
            dev["busy_s"] = trace.busy_s
            dev["window_s"] = trace.window_s
            result["breakdown"] = {"device_ops": trace.device_ops(),
                                   "idle_gaps": trace.idle_gaps()}
        result["checks"] = {k: {"value": v, "limit": check.LIMITS[k]} for k, v in numbers.items()}
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    found = forbidden_modules()
    if found:
        print(f"run: modules of JAX or the JAX package loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for k, v in numbers.items():
        print(f"check {k} {v} limit {check.LIMITS[k]}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
