"""The frozen corpus's manifest (avrecode_tpu_torch/testdata/corpus/
manifest.json) against the JAX package, so the reference the port is held
to on the card cannot go stale: every committed clip's SHA-256 equals the
manifest's, and for every (clip, mode) the digest of the JAX package's
container on the CPU (testcorpus.container_digest: its SHA-256 without the
writing build's git revision), or the error it raises, equals the
manifest's entry. A flipped clip byte and a flipped manifest digest each
make the check fail.

The clips are dealt to this module and its two siblings (..._b, ..._c)
(part_clips), so that no file holds a worker long.

Rewrite the manifest (JAX on the CPU) after a change to the clips, the
modes (avrecode_tpu_torch.testcorpus.CORPUS_MODES) or the container format:

    python tests/test_torch_corpus_manifest.py --write

and regenerate the clips themselves (tests/conftest.py's generator, then
--write) with --generate.
"""
import argparse
import copy
import json
import os
import pathlib
import shutil
import sys

if __name__ == "__main__":  # a script: the repository root, and JAX on the CPU as in tests
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import conftest  # noqa: F401

import pytest
from test_torch_jaxlib import ensure_jax_lib

from avrecode_tpu import device as jd
from avrecode_tpu_torch import _native
from avrecode_tpu_torch import testcorpus as tc

# Both host libraries, each built here under its own lock, before any test
# of any module can reach the JAX package's unlocked build (see
# test_torch_jaxlib.py).
_native.ensure_host_lib()
ensure_jax_lib()

PARTS = 3
GENERATOR = ("tests/conftest.py corpus_dir: tools/make_corpus.cc (libx264 through the "
             "system libavcodec) and tools/make_synth.cc")


def part_clips(part: int) -> list[str]:
    """The clips of part `part` (0, 1, 2). The ten ipb_* clips hold one
    stream in ten containers, so their JAX programs compile once in one
    process: they are part 0; parts 1 and 2 share the rest."""
    names = tc.clip_names()
    same = [n for n in names if n.startswith("ipb_")]
    rest = [n for n in names if n not in same]
    return same if part == 0 else rest[part - 1::PARTS - 1]


def jax_outcome(data: bytes, mode: tc.CorpusMode) -> dict:
    """The JAX package's container digest for `mode` on the CPU, or its error:
    device.compress at the mode's keywords (for a mesh mode too: the mesh
    must write the single-device container)."""
    with tc.corpus_env(mode.env):
        return tc.outcome(lambda: jd.compress(data, **mode.kw))


def jax_gop_chunks(data: bytes) -> int:
    return len(jd.analyze(data, chunk_mode=1, batch_size=512, model_profile=2).chunks)


def clip_entry(name: str) -> dict:
    """A clip's manifest entry, computed with the JAX package."""
    data = tc.clip_bytes(name)
    gops = jax_gop_chunks(data)
    return {"sha256": tc.sha256(data), "bytes": len(data), "gop_chunks": gops,
            "modes": {m: jax_outcome(data, mode) for m, mode in tc.CORPUS_MODES.items()
                      if mode.admits(name, gops)}}


def check_clip_hash(name: str, data: bytes, man: dict) -> None:
    got, want = tc.sha256(data), man["clips"][name]["sha256"]
    assert got == want, f"{name}: SHA-256 {got} != the manifest's {want}"


def check_entry(name: str, got: dict, man: dict) -> None:
    """`got` (clip_entry's) equals the manifest's entry, mode by mode."""
    want = man["clips"][name]
    assert got["sha256"] == want["sha256"], f"{name}: clip SHA-256 differs"
    assert got["gop_chunks"] == want["gop_chunks"], f"{name}: GOP chunks differ"
    assert sorted(got["modes"]) == sorted(want["modes"]), f"{name}: modes differ"
    for mode, outcome in got["modes"].items():
        assert outcome == want["modes"][mode], (
            f"{name} {mode}: JAX gives {outcome}, the manifest holds {want['modes'][mode]}")


@pytest.fixture(scope="module")
def man():
    return tc.manifest()


def test_manifest_lists_every_clip_and_mode(man):
    """Every file of the corpus is in the manifest and no other; every mode
    is in it with its parameters; every clip has an entry for every mode it
    admits (the mesh needs two GOP chunks), each a hash or JAX's error."""
    assert sorted(man["clips"]) == tc.clip_names()
    assert len(man["clips"]) >= 43
    assert man["modes"] == {m: mode.record() for m, mode in tc.CORPUS_MODES.items()}
    for name, entry in man["clips"].items():
        want = [m for m, mode in tc.CORPUS_MODES.items() if mode.admits(name, entry["gop_chunks"])]
        assert sorted(entry["modes"]) == sorted(want), name
        for outcome in entry["modes"].values():
            assert list(outcome) in (["digest"], ["error"]), (name, outcome)
    assert sum("mesh_2x2" in e["modes"] for e in man["clips"].values()) >= 10


def test_committed_clips_match_the_manifest(man):
    for name in tc.clip_names():
        check_clip_hash(name, tc.clip_bytes(name), man)


def test_a_flipped_clip_byte_fails_the_check(man):
    name = tc.clip_names()[0]
    data = bytearray(tc.clip_bytes(name))
    data[len(data) // 2] ^= 0x01
    with pytest.raises(AssertionError, match="SHA-256"):
        check_clip_hash(name, bytes(data), man)


def test_a_flipped_manifest_digest_fails_the_check(man):
    """check_entry against a manifest whose one digest has a flipped hex
    digit: the JAX package's entry (here the manifest's own, which the
    parametrised cases hold to JAX) no longer matches, and the message
    names the clip and the mode."""
    name = "sp_cavlc.264"
    got = copy.deepcopy(man["clips"][name])
    check_entry(name, got, man)
    bad = copy.deepcopy(man)
    outcome = bad["clips"][name]["modes"]["p2_b512"]
    outcome["digest"] = ("0" if outcome["digest"][0] != "0" else "1") + outcome["digest"][1:]
    with pytest.raises(AssertionError, match=f"{name} p2_b512"):
        check_entry(name, got, bad)


@pytest.mark.parametrize("name", part_clips(0))
def test_jax_containers_match_the_manifest(man, name):
    check_entry(name, clip_entry(name), man)


def write_manifest() -> dict:
    man = {"generator": GENERATOR,
           "reference": "avrecode_tpu.device.compress on the CPU (a mesh mode: the "
                        "single-device compress at the same keywords)",
           "digest": "SHA-256 of the container without its build provenance (the u8 "
                     "length and git revision after the version byte, native/recode.h)",
           "modes": {m: mode.record() for m, mode in tc.CORPUS_MODES.items()},
           "clips": {}}
    for name in tc.clip_names():
        man["clips"][name] = clip_entry(name)
        print(name, json.dumps(man["clips"][name]["modes"]), flush=True)
    with open(tc.MANIFEST, "w") as f:
        json.dump(man, f, indent=1, sort_keys=True)
        f.write("\n")
    return man


def generate_clips(scratch: str) -> None:
    """Regenerates the clips with tests/conftest.py's corpus_dir generator
    (in `scratch`) and replaces the frozen copies."""
    import conftest

    class Factory:
        def mktemp(self, name):
            path = pathlib.Path(scratch) / name
            path.mkdir(parents=True, exist_ok=True)
            return path

    gen = getattr(conftest.corpus_dir, "__wrapped__", None) or \
        conftest.corpus_dir.__pytest_wrapped__.obj
    out = gen(Factory())
    for name in tc.clip_names():
        os.remove(os.path.join(tc.CORPUS_DIR, name))
    for name in sorted(os.listdir(out)):
        if name not in ("make_corpus", "make_synth"):
            shutil.copy(os.path.join(out, name), os.path.join(tc.CORPUS_DIR, name))


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--write", action="store_true",
                    help="rewrite manifest.json from the JAX package on the CPU")
    ap.add_argument("--generate", metavar="SCRATCH",
                    help="regenerate the clips in SCRATCH with conftest's generator first")
    args = ap.parse_args()
    if args.generate:
        generate_clips(args.generate)
    if args.write or args.generate:
        write_manifest()
    else:
        ap.print_help()
