"""The harness is driven by data: a configuration, a mix and a metric that
a later change adds as new files and entries are found by name, and no file
that was there changes."""
import hashlib
import json
import os
import shutil

from harness import spec

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def _digests(base: str) -> dict:
    out = {}
    for root, dirs, files in os.walk(base):
        dirs[:] = [d for d in dirs if d not in ("build", "__pycache__", ".cache")]
        for f in files:
            p = os.path.join(root, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, base)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def copy_bench(tmp_path) -> tuple[str, str]:
    """A copy of BENCHMARK.json and of the harness's files (the clips and
    the reference linked, not copied): (BENCHMARK.json path, perfbench dir)."""
    base = tmp_path / "perfbench"
    shutil.copytree(BENCH, base, ignore=shutil.ignore_patterns(
        "clips", "reference", "tests", "__pycache__", ".cache"))
    os.symlink(os.path.join(BENCH, "clips"), base / "clips")
    os.symlink(os.path.join(BENCH, "reference"), base / "reference")
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    return str(tmp_path / "BENCHMARK.json"), str(base)


def add_cell(bench_path: str, base: str, *, config: str, traffic: dict, entry: str = "compress",
             config_over: dict | None = None, metric_src: str | None = None) -> str:
    """Adds a configuration, a mix, a cell and (optionally) a metric as new
    files and entries; returns the cell's name."""
    with open(os.path.join(base, "configs", "p2_default.json")) as f:
        conf = {**json.load(f), "entry": entry, **(config_over or {})}
    with open(os.path.join(base, "configs", config + ".json"), "w") as f:
        json.dump(conf, f)
    mix = "mix_" + config
    with open(os.path.join(base, "traffic", mix + ".json"), "w") as f:
        json.dump(traffic, f)
    with open(bench_path) as f:
        bench = json.load(f)
    name = f"{config}.{mix}"
    bench["configs"].append({"name": config, "source": "test", "file":
                             f"perfbench/configs/{config}.json", "reduced": [], "why": "test"})
    bench["workloads"].append({"name": name, "config": config, "traffic": mix, "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m and m["name"] in ("throughput_mb_s", "kernels.ms_per_mb"):
            m["workloads"].append(name)
    if metric_src is not None:
        with open(os.path.join(base, "metrics", "dummy.files.py"), "w") as f:
            f.write(metric_src)
        bench["per_layer"].append({"name": "dummy.files", "unit": "files", "better": "higher",
                                   "source": "program_counter", "layer": "call driver",
                                   "moves": "throughput_mb_s", "workloads": [name]})
    with open(bench_path, "w") as f:
        json.dump(bench, f)
    return name


def test_a_new_configuration_mix_and_metric_are_found_by_name(tmp_path):
    bench_path, base = copy_bench(tmp_path)
    before = _digests(BENCH)
    name = add_cell(bench_path, base, config="dummy_conf",
                    traffic={"clips": ["multigop.mp4"], "cut": "gop"},
                    metric_src="def read(ctx):\n    return float(len(ctx.done))\n")
    cell = spec.cell(bench_path, name, trace=True, base=base)
    assert cell.config["name"] == "dummy_conf" and cell.config["entry"] == "compress"
    assert cell.traffic["name"] == "mix_dummy_conf"
    assert [m["name"] for m, _ in cell.metrics] == ["kernels.ms_per_mb", "dummy.files"]
    assert hasattr(cell.driver, "Driver")
    e2e = spec.cell(bench_path, name, trace=False, base=base)
    assert [m["name"] for m, _ in e2e.metrics] == ["throughput_mb_s", "setup_s"]
    assert _digests(BENCH) == before


def test_every_cell_of_the_benchmark_resolves():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for w in bench["workloads"]:
        for trace in (False, True):
            cell = spec.cell(os.path.join(ROOT, "BENCHMARK.json"), w["name"], trace)
            names = {m["name"] for m, _ in cell.metrics}
            assert ("setup_s" in names) != trace and names
