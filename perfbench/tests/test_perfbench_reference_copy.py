"""The reference's C++ sources are the format's original engine (the JAX
package's avrecode_tpu/native, read here as text) with three marked edits
in recode.cc and nothing else: taking out each "perfbench edit" block, and
putting back the origin's lines that it keeps after "//- ", gives the origin
byte for byte."""
import os

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
COPY = os.path.join(BENCH, "reference", "native")
ORIGIN = os.path.join(ROOT, "avrecode_tpu", "native")
BEGIN, END, KEPT = "// perfbench edit begin", "// perfbench edit end", "//- "


def _sources(base: str) -> list[str]:
    out = []
    for root, dirs, files in os.walk(base):
        dirs[:] = [d for d in dirs if d != "build"]
        out += [os.path.relpath(os.path.join(root, f), base) for f in files
                if f.endswith((".h", ".cc"))]
    return sorted(out)


def restore(text: str) -> tuple[str, int]:
    """(the origin's text, the number of edit blocks) of a copy's file."""
    out, blocks, inside = [], 0, False
    for line in text.splitlines(keepends=True):
        mark = line.strip()
        if mark.startswith(BEGIN):
            assert not inside, "nested edit block"
            inside, blocks = True, blocks + 1
        elif mark.startswith(END):
            assert inside, "edit end without a begin"
            inside = False
        elif not inside:
            out.append(line)
        elif line.startswith(KEPT):
            out.append(line[len(KEPT):])
    assert not inside, "edit block left open"
    return "".join(out), blocks


def test_the_copy_holds_the_origins_files_and_no_others():
    assert _sources(COPY) == _sources(ORIGIN)


@pytest.mark.parametrize("name", _sources(ORIGIN))
def test_each_file_is_the_origins_outside_the_marked_edits(name):
    with open(os.path.join(COPY, name)) as f:
        restored, blocks = restore(f.read())
    with open(os.path.join(ORIGIN, name)) as f:
        assert restored == f.read()
    # the lane rule with the control's probabilities, and the build id in three places
    assert blocks == (4 if name == "recode.cc" else 0)


def test_restore_finds_a_change_outside_the_blocks():
    text = f"head\n{BEGIN}: x\n{KEPT}kept\nnew\n{END}\ntail\n"
    assert restore(text) == ("head\nkept\ntail\n", 1)
    assert restore(text.replace("tail", "tale"))[0] != "head\nkept\ntail\n"
