"""The control at a size a test holds: the reference in the program's place
with 14-bit probabilities fails the comparison; at the configurations' 15
bits it passes it (multigop.mp4, 67,605 B, at p2_default's and
p2_gop_corpus's settings)."""
import json
import os

import pytest

import control
from harness import check, traffic
from reference import engine

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MIX = {"clips": ["multigop.mp4"], "cut": "whole"}


@pytest.fixture(scope="module")
def ref():
    return engine.Engine()


@pytest.mark.parametrize("config", ["p2_default", "p2_gop_corpus"])
@pytest.mark.parametrize("prob_bits,correct", [(14, False), (15, True)])
def test_control_fails_and_the_reference_passes(ref, config, prob_bits, correct):
    with open(os.path.join(BENCH, "configs", config + ".json")) as f:
        conf = json.load(f)
    stream = traffic.Stream(MIX, 3000000029)
    eng = ref if prob_bits == 15 else engine.Engine(prob_bits)
    recs = control.control_records(eng, stream, conf, 0.5, b"nogit")
    numbers = check.judge(recs, {it.name: it.data for it in stream.items}, conf, ref, b"nogit")
    assert check.verdict(numbers, len(recs)) is correct
    if not correct:
        assert numbers["container_bytes_differing"] > 0
        assert numbers["roundtrip_bytes_differing"] > 0
