"""On the card: one short run of the first cell (skips without a card)."""
import json
import os
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


@pytest.mark.cuda
def test_a_short_run_of_the_first_cell_is_correct():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    r = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"), "--workload",
                        "p2_default.archive", "--seed", "3000000031", "--seconds", "5",
                        "--trace", "1"], cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    result = json.loads(r.stdout.strip().splitlines()[-1])
    assert result["correct"] is True and result["device"]["platform"] == "gpu"
    assert 0 < result["device"]["busy_s"] < result["device"]["window_s"]
    assert 0 < result["metrics"]["kernels_roofline"]["value"] < 100
