"""Loads one metric's reader by name, as the harness does."""
import os

from harness import spec

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def metric(name: str):
    return spec.load_module(os.path.join(BENCH, "metrics", name + ".py"),
                            "perfbench_metric_" + name.replace(".", "_"))
