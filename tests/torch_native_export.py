"""The edits to the port's copy of recode.cc (avrecode_tpu_torch/native) that
put the port's own slim and dense exports in place of the original's: the
copy's write_slim_chunk is the one in native/slim_export.h, which recode.cc
includes where the original defined it, and the dense branch of
artc_session_analyze2 writes each chunk through native/dense_export.h's
write_dense_chunk and gathers the export with its gather_dense. Each pair
is a text of the original (avrecode_tpu/native/recode.cc) and the text the
copy holds in its place, applied after the span edits
(torch_native_spans.py), each old text found exactly once. The old texts
are cut between the markers below and pinned by their SHA-256: from the
original, its BitPacker and ceil_log2, which only its slim export used, and
the definition of its write_slim_chunk; from the original with the span
edits applied, the dense branch from its export of a chunk to its return.
write_sig0_sparse, which the slim export uses, stays.
test_torch_host_copy.py applies the pairs; test_torch_slim_export.py and
test_torch_dense_export.py hold the port's exports to the original's byte
for byte."""
import hashlib
import os

from torch_native_spans import RECODE_SPANS

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
    for old, new in RECODE_SPANS:
        text = text.replace(old, new)
    dense = _cut(text, "      // The export: the streams and prefix counts, then the v2 tables (an\n",
                 "  } catch (const std::exception& e) {\n", "int artc_session_analyze2(",
                 "71be7f906fe569db9126e45ca651bbeb896188ee99e5f621c7972350c7db9c74")
    return [(packer, ""),
            (export, '#include "slim_export.h"  // write_slim_chunk\n'
                     '#include "dense_export.h"  // write_dense_chunk, gather_dense\n\n'),
            ("    write_analyze_header(w, se, sup_u, /*slim=*/false);\n"
             "    WarmCtx warm;\n",
             "    write_analyze_header(w, se, sup_u, /*slim=*/false);\n"
             "    // Each chunk's walk, then its export into sections of exact size\n"
             "    // (native/dense_export.h), which the copy-out gathers behind the header.\n"
             "    std::vector<DenseBuf> parts;\n"
             "    WarmCtx warm;\n"),
            (dense,
             "      write_dense_chunk(parts, se->trace, int64_t(ci), trace, probs, dual0, sig0,\n"
             "                        opt.batch_size ? opt.batch_size : 1, sup_u);\n"
             "    }\n"
             '    Phase copy(se->trace, "native.copyout");\n'
             "    *out_len = gather_dense(w.buf, parts, out);\n"
             "    copy.end(*out_len);\n"
             "    return 0;\n")]


RECODE_EXPORT = _pairs()
