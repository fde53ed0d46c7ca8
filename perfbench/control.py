#!/usr/bin/env python3
"""The control of `correct`: the reference put in the program's place, with
the model's probabilities handed to the rANS coder at 14 bits instead of the
15 the configurations state (the reference built with PERFBENCH_PROB_BITS).

    python3 perfbench/control.py --workload <name> --seeds <n> [<n> ...]

For each seed it sends the cell's mix, in the seed's order, to the control
for the cell's run_seconds, in a closed loop as the cell's window does, and
judges every container with the benchmark's own comparison
(harness/check.py). It prints one JSON line per seed: the
numbers compared, their limits and the verdict, which has to be false. It
needs no card; the benchmark's runs do not run it.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
PROB_BITS = 14


def control_records(eng, stream, config: dict, seconds: float, build_id: bytes) -> list:
    from harness.record import Record
    recs = []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        it = next(stream)
        s = time.perf_counter()
        out = eng.compress(it.data, config["chunk_mode"], config["batch_size"],
                           build_id, config["model_profile"], config["lanes"])
        recs.append(Record(it.name, len(it.data), s - t0, time.perf_counter() - t0, True, out))
    return recs


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    sys.path.insert(0, HERE)
    from harness import check, spec, traffic
    from reference import engine
    cell = spec.cell(os.path.join(ROOT, "BENCHMARK.json"), args.workload, False)
    control, ref = engine.Engine(PROB_BITS), engine.Engine()
    build_id = check.expected_build_id(ROOT)
    for seed in args.seeds:
        stream = traffic.Stream(cell.traffic, seed)
        recs = control_records(control, stream, cell.config, cell.run_seconds, build_id)
        numbers = check.judge(recs, {it.name: it.data for it in stream.items}, cell.config,
                              ref, build_id)
        print(json.dumps({"workload": args.workload, "seed": seed, "prob_bits": PROB_BITS,
                          "files": len(recs), "correct": check.verdict(numbers, len(recs)),
                          "checks": {k: {"value": v, "limit": check.LIMITS[k]}
                                     for k, v in numbers.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
