"""The edit to the port's copy of recode.cc (avrecode_tpu_torch/native) that
puts the port's own slim export in place of the original's: the copy's
write_slim_chunk is the one in native/slim_export.h, which recode.cc
includes where the original defined it. Each pair is a text of the original
(avrecode_tpu/native/recode.cc) and the text the copy holds in its place,
applied after the span edits (torch_native_spans.py), each old text found
exactly once. The old texts are cut from the original between the markers
below and pinned by their SHA-256: the original's BitPacker and ceil_log2,
which only its export used, and the definition of its write_slim_chunk.
write_sig0_sparse between them, which the dense export shares, stays.
test_torch_host_copy.py applies the pairs; test_torch_slim_export.py holds
the port's export to the original's byte for byte."""
import hashlib
import os

ORIGINAL = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "avrecode_tpu", "native", "recode.cc")


def _cut(text: str, start: str, end: str, after: str, sha256: str) -> str:
    """The text from the first `start` past `after` up to the next `end`,
    checked against its SHA-256."""
    i = text.index(start, text.index(after))
    cut = text[i:text.index(end, i)]
    assert hashlib.sha256(cut.encode()).hexdigest() == sha256, f"original changed at {start!r}"
    return cut


def _pairs() -> list[tuple[str, str]]:
    with open(ORIGINAL, "rb") as f:
        text = f.read().decode()
    packer = _cut(text, "struct BitPacker {\n", "static void write_sig0_sparse(",
                  "// Slim per-chunk analysis export",
                  "325ef5d1336929a0d2304988f96926644504642b79a760b3df32b848597bfe72")
    export = _cut(text, "static void write_slim_chunk(", "static void write_analyze_header(",
                  "static void write_sig0_sparse(",
                  "046da3fe228212224ec077bbd43ae8b35e852e2562bee7e044bba80c29120058")
    return [(packer, ""), (export, '#include "slim_export.h"  // write_slim_chunk\n\n')]


RECODE_EXPORT = _pairs()
