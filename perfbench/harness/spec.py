"""Finds a cell's parts by the names in BENCHMARK.json.

Everything that belongs to one configuration, traffic mix, driver or metric
sits in a file of its own, found by name, so a cell, a configuration, a mix
or a metric is added by adding files and entries, never by editing one:

    configs/<file named in the configuration's entry>   sizes and settings
    traffic/<traffic>.json                             the mix's parameters
    drivers/<the configuration's "entry">.py           the call the window drives
    metrics/<metric name>.py                           one metric's reader
"""
from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass

BASE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclass
class Cell:
    name: str
    chips: int
    config: dict      # the configuration's file, with "name" and "reduced" beside it
    traffic: dict     # traffic/<traffic>.json
    driver: object    # the module drivers/<entry>.py
    metrics: list     # (entry of BENCHMARK.json, reader module), in file order
    run_seconds: int


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def cell(bench_path: str, name: str, trace: bool, base: str = BASE) -> Cell:
    """The cell `name` of the BENCHMARK.json at bench_path, with the metrics
    its run reports: the end-to-end ones with trace off, the per-layer ones
    with trace on (each limited by its "workloads" list)."""
    with open(bench_path) as f:
        bench = json.load(f)
    root = os.path.dirname(os.path.abspath(bench_path))
    wl = next((w for w in bench["workloads"] if w["name"] == name), None)
    if wl is None:
        raise KeyError(f"no workload {name!r} in {bench_path}")
    conf_entry = next(c for c in bench["configs"] if c["name"] == wl["config"])
    with open(os.path.join(root, conf_entry["file"])) as f:
        config = json.load(f)
    config = {**config, "name": conf_entry["name"], "reduced": conf_entry["reduced"]}
    with open(os.path.join(base, "traffic", wl["traffic"] + ".json")) as f:
        traffic = {**json.load(f), "name": wl["traffic"]}
    driver = load_module(os.path.join(base, "drivers", config["entry"] + ".py"),
                         f"perfbench_driver_{config['entry']}")
    listed = bench["per_layer"] if trace else bench["end_to_end"]
    metrics = [(m, load_module(os.path.join(base, "metrics", m["name"] + ".py"),
                               "perfbench_metric_" + m["name"].replace(".", "_")))
               for m in listed if _applies(m, name)]
    return Cell(name=name, chips=int(wl["chips"]), config=config, traffic=traffic,
                driver=driver, metrics=metrics, run_seconds=int(bench["run_seconds"]))
