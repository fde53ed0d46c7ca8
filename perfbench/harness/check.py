"""The comparison that decides `correct`.

Every file the window handed to the program is judged once the window has
closed (the call in flight at the close is waited for):

    files_failed              files that raised or never gave a container
    container_bytes_differing bytes by which each container differs from the
                              reference's container of the same input, made
                              with the same settings and the build id that
                              expected_build_id works out from the checkout
                              (a length difference counts in full)
    roundtrip_bytes_differing bytes by which the reference decoder's output of
                              each distinct container differs from its input
                              (the whole input where it cannot decode it)

Each has the limit 0: the format is exact. The reference (reference/engine.py)
computes each distinct input's container once, on the CPU.
"""
from __future__ import annotations

import hashlib
import subprocess

import numpy as np

from . import container

LIMITS = {"files_failed": 0, "container_bytes_differing": 0, "roundtrip_bytes_differing": 0}


def expected_build_id(root: str) -> bytes:
    """The build id that the program's containers should carry when its
    library was built in the checkout at `root`: the git revision of HEAD
    to 12 digits, or b"nogit" outside a git checkout (as the program's build
    documents it). Worked out here, never read from a container, so a wrong
    id in a header, and the store-or-recode choice that its length sways,
    count as differing bytes."""
    try:
        res = subprocess.run(["git", "rev-parse", "--short=12", "HEAD"], cwd=root,
                             capture_output=True, text=True)
    except FileNotFoundError:
        return b"nogit"
    rev = res.stdout.strip()
    return (rev if res.returncode == 0 and rev else "nogit").encode()


def bytes_differing(a: bytes, b: bytes) -> int:
    n = min(len(a), len(b))
    x = np.frombuffer(a, np.uint8, n)
    y = np.frombuffer(b, np.uint8, n)
    return int(np.count_nonzero(x != y)) + abs(len(a) - len(b))


def judge(records, inputs: dict, config: dict, engine, build_id: bytes) -> dict:
    """{number: value} over `records` (each with .name, .ok, .output) against
    the reference `engine`, whose containers carry `build_id`; `inputs` maps
    a file's name to its bytes."""
    failed = sum(1 for r in records if not r.ok or r.output is None)
    want: dict = {}
    decoded: dict = {}
    differing = roundtrip = 0
    for r in records:
        if not r.ok or r.output is None:
            continue
        data = inputs[r.name]
        if r.name not in want:
            want[r.name] = engine.compress(data, config["chunk_mode"], config["batch_size"],
                                           build_id, config["model_profile"], config["lanes"])
        differing += bytes_differing(r.output, want[r.name])
        digest = hashlib.sha256(r.output).digest()
        if digest not in decoded:
            try:
                decoded[digest] = bytes_differing(engine.decompress(r.output), data)
            except RuntimeError:
                decoded[digest] = len(data)
            roundtrip += decoded[digest]
    return {"files_failed": failed, "container_bytes_differing": differing,
            "roundtrip_bytes_differing": roundtrip}


def verdict(numbers: dict, attempted: int) -> bool:
    return attempted > 0 and all(numbers[k] <= lim for k, lim in LIMITS.items())
