"""The build id that containers are judged against is worked out from the
checkout, not read from the program's container: outside a git checkout it
is "nogit", and a container whose header carries another id fails the
comparison (the store-or-recode choice sees the id's length)."""
import subprocess

import pytest

from harness import check, clips
from harness.record import Record
from reference import engine

CONF = {"chunk_mode": 0, "batch_size": 4096, "model_profile": 2, "lanes": 16}


@pytest.fixture(scope="module")
def ref():
    return engine.Engine()


def test_outside_a_git_checkout_the_id_is_nogit(tmp_path):
    assert check.expected_build_id(str(tmp_path)) == b"nogit"


def test_in_a_git_checkout_the_id_is_heads_revision(tmp_path):
    git = ["git", "-c", "user.name=t", "-c", "user.email=t@t", "-C", str(tmp_path)]
    subprocess.run(git + ["init", "-q"], check=True)
    subprocess.run(git + ["commit", "-q", "--allow-empty", "-m", "x"], check=True)
    rev = subprocess.run(git + ["rev-parse", "HEAD"], capture_output=True, text=True,
                         check=True).stdout.strip()
    assert check.expected_build_id(str(tmp_path)) == rev[:12].encode()


def test_a_container_with_another_build_id_differs(ref):
    data = clips.load(["multigop.mp4"])["multigop.mp4"]
    judged = ref.compress(data, 0, 4096, b"0123456789ab", 2, 16)
    rec = Record("multigop.mp4", len(data), 0.0, 1.0, True, judged)
    numbers = check.judge([rec], {"multigop.mp4": data}, CONF, ref, b"nogit")
    assert numbers["container_bytes_differing"] > 0
    assert numbers["roundtrip_bytes_differing"] == 0
    assert check.judge([rec], {"multigop.mp4": data}, CONF, ref,
                       b"0123456789ab")["container_bytes_differing"] == 0
