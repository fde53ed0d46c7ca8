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
RECODE_STREAM then puts the dense analysis on walker threads.
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

# Then the streaming dense analysis (native/dense_export.h's start_dense and
# take_dense): artc_session_analyze_begin takes the dense flag and starts the
# walker threads, artc_session_analyze_chunk hands their chunks over, the
# analysis state holds the blocks and stops the walkers when the session
# closes (before anything else of the session goes), and the dense branch of
# artc_session_analyze2 collects the walkers' chunks. Applied after
# RECODE_EXPORT, to the text it leaves.
RECODE_STREAM = [
    (
     '  std::atomic<size_t> next{0};\n'
     '  ~AnalyzeState() {\n'
     '    for (auto& t : workers)\n'
     '      if (t.joinable()) t.join();\n',
     '  std::atomic<size_t> next{0};\n'
     '  // The dense analysis (native/dense_export.h: its walker threads claim\n'
     "  // chunks through `next`): each chunk's export, one malloc'd block, until\n"
     "  // the caller takes it; the chunks taken; the close's request to stop\n"
     '  // (guarded by mu).\n'
     '  bool dense = false;\n'
     '  std::vector<uint8_t*> blocks;\n'
     '  std::vector<size_t> block_len;\n'
     '  size_t taken = 0;\n'
     '  bool stop = false;\n'
     '  ~AnalyzeState() {\n'
     '    {\n'
     '      std::lock_guard<std::mutex> lock(mu);\n'
     '      stop = true;\n'
     '    }\n'
     '    cv.notify_all();\n'
     '    for (auto& t : workers)\n'
     '      if (t.joinable()) t.join();\n'
     '    for (uint8_t* p : blocks) free(p);\n'),
    (
     '  ~ArtcSession() {\n',
     '  ~ArtcSession() {\n'
     '    astate.reset();  // its threads read the fields above and record into trace\n'),
    (
     '#include "slim_export.h"  // write_slim_chunk\n'
     '#include "dense_export.h"  // write_dense_chunk, gather_dense\n',
     '#include "slim_export.h"  // write_slim_chunk\n'
     '#include "dense_export.h"  // write_dense_chunk, start_dense, take_dense, gather_dense\n'),
    (
     '\n'
     '// Starts the streaming (slim/ANL5) analyze: spawns background workers that\n'
     '// walk + export chunks in parallel. Returns the chunk count, or -1.\n'
     '// flags bit1 = also export host-computed probs (differential testing).\n'
     'int artc_session_analyze_begin(void* h, int sup, int flags) {\n'
     '  using namespace artc;\n'
     '  auto* se = static_cast<ArtcSession*>(h);\n'
     '  try {\n'
     '    if (!session_ready(se)) return -1;\n'
     '    if (se->opt.model_profile != 2)\n'
     '      throw std::runtime_error("slim analysis requires model_profile=2 (frozen batches)");\n'
     '    const uint32_t sup_u = sup > 0 ? uint32_t(sup) : 16;\n'
     '    const bool want_probs = (flags & 2) != 0;\n'
     '    se->astate.reset(new AnalyzeState);\n'
     '    AnalyzeState* as = se->astate.get();\n'
     '    {\n'
     '      Writer w;\n'
     '      write_analyze_header(w, se, sup_u, /*slim=*/true);\n'
     '      as->header = std::move(w.buf);\n'
     '    }\n'
     '    const size_t n_chunks = se->ranges.size();\n'
     '    as->bufs.resize(n_chunks);\n'
     '    as->status.assign(n_chunks, 0);\n',
     '\n'
     '// Starts the streaming analyze: by default the slim (ANL5) one, whose\n'
     '// background workers walk + export chunks in parallel; with flags bit2\n'
     '// (kAnalyzeDense) the dense (ANLZ) one, whose walkers walk + export chunks\n'
     '// a few ahead of the caller (native/dense_export.h). Returns the chunk\n'
     '// count, or -1.\n'
     '// flags bit1 = also export host-computed probs (slim; differential testing;\n'
     '// the dense export always holds them).\n'
     'int artc_session_analyze_begin(void* h, int sup, int flags) {\n'
     '  using namespace artc;\n'
     '  auto* se = static_cast<ArtcSession*>(h);\n'
     '  try {\n'
     '    if (!session_ready(se)) return -1;\n'
     '    const bool dense = (flags & kAnalyzeDense) != 0;\n'
     '    if (!dense && se->opt.model_profile != 2)\n'
     '      throw std::runtime_error("slim analysis requires model_profile=2 (frozen batches)");\n'
     '    const uint32_t sup_u = sup > 0 ? uint32_t(sup) : 16;\n'
     '    const bool want_probs = (flags & 2) != 0;\n'
     '    se->astate.reset(new AnalyzeState);\n'
     '    AnalyzeState* as = se->astate.get();\n'
     '    {\n'
     '      Writer w;\n'
     '      write_analyze_header(w, se, sup_u, /*slim=*/!dense);\n'
     '      as->header = std::move(w.buf);\n'
     '    }\n'
     '    const size_t n_chunks = se->ranges.size();\n'
     '    as->status.assign(n_chunks, 0);\n'
     '    if (dense) {\n'
     '      start_dense(se, as, sup_u);\n'
     '      return int(n_chunks);\n'
     '    }\n'
     '    as->bufs.resize(n_chunks);\n'),
    (
     "// Blocks until chunk idx's export is ready, then hands it over (the internal\n"
     '// copy is released — each chunk can be fetched once).\n'
     'int artc_session_analyze_chunk(void* h, uint32_t idx, uint8_t** out, size_t* out_len) {\n'
     '  auto* se = static_cast<ArtcSession*>(h);\n'
     '  AnalyzeState* as = se->astate.get();\n'
     '  if (!as || idx >= as->bufs.size()) {\n'
     '    g_error = "bad analyze chunk index";\n'
     '    return -1;\n'
     '  }\n',
     "// Blocks until chunk idx's export is ready, then hands it over (the internal\n"
     '// copy is released — each chunk can be fetched once; dense chunks in order).\n'
     'int artc_session_analyze_chunk(void* h, uint32_t idx, uint8_t** out, size_t* out_len) {\n'
     '  auto* se = static_cast<ArtcSession*>(h);\n'
     '  AnalyzeState* as = se->astate.get();\n'
     '  if (!as || idx >= as->status.size()) {\n'
     '    g_error = "bad analyze chunk index";\n'
     '    return -1;\n'
     '  }\n'
     '  if (as->dense) return take_dense(se, as, idx, out, out_len) ? 0 : -1;\n'),
    (
     '    if (!session_ready(se)) return -1;\n'
     '    const Options& opt = se->opt;\n'
     '    const Pass1& p1 = se->p1;\n'
     '    const auto& ranges = se->ranges;\n'
     '    const bool slim = (flags & 1) != 0;\n'
     '    const bool want_probs = (flags & 2) != 0 || !slim;\n'
     '    uint32_t sup_u = sup > 0 ? uint32_t(sup) : 16;\n',
     '    if (!session_ready(se)) return -1;\n'
     '    const bool slim = (flags & 1) != 0;\n'
     '    const bool want_probs = (flags & 2) != 0 || !slim;\n'),
    (
     '    }\n'
     '    Writer w;\n'
     '    write_analyze_header(w, se, sup_u, /*slim=*/false);\n'
     "    // Each chunk's walk, then its export into sections of exact size\n"
     '    // (native/dense_export.h), which the copy-out gathers behind the header.\n'
     '    std::vector<DenseBuf> parts;\n'
     '    WarmCtx warm;\n'
     '    warm.src_slices = se->warm_slices;\n'
     '    for (size_t ci = 0; ci < ranges.size(); ++ci) {\n'
     '      auto [b, e] = ranges[ci];\n'
     '      std::vector<PriorModel::Coded> trace;\n'
     '      std::vector<uint16_t> probs;\n'
     '      std::vector<Dual> dual0;\n'
     '      std::vector<Estimator> sig0;\n'
     '      Stats tmp;\n'
     '      uint64_t modes = se->nz_modes[ci];\n'
     '      Phase walk(se->trace, "native.dense_walk", int64_t(ci));\n'
     '      run_chunk_model(p1.slices, b, e, opt, tmp, &trace, &probs, &dual0, modes,\n'
     '                      /*encode_blob=*/false,\n'
     '                      ci == 0 && warm.src_slices ? &warm : nullptr,\n'
     '                      ci > 0 && warm.src_slices ? &warm : nullptr, &sig0,\n'
     '                      se->alpha_off);\n'
     '      const double sec = walk.end(trace.size());\n'
     '      if (timing_enabled())\n'
     '        fprintf(stderr, "[artc] analyze chunk %zu: trace walk %.3fs (%zu bins)\\n",\n'
     '                ci, sec, trace.size());\n'
     '      write_dense_chunk(parts, se->trace, int64_t(ci), trace, probs, dual0, sig0,\n'
     '                        opt.batch_size ? opt.batch_size : 1, sup_u);\n'
     '    }\n'
     '    Phase copy(se->trace, "native.copyout");\n'
     '    *out_len = gather_dense(w.buf, parts, out);\n',
     '    }\n'
     '    // One-shot collection over the dense walkers (same bytes as the\n'
     '    // per-chunk fetch path: header ++ chunk0 ++ chunk1 ++ ...).\n'
     '    const int n_chunks = artc_session_analyze_begin(h, sup, kAnalyzeDense);\n'
     '    if (n_chunks < 0) return -1;\n'
     '    AnalyzeState* as = se->astate.get();\n'
     '    std::vector<DenseBlock> parts(n_chunks);\n'
     '    for (int ci = 0; ci < n_chunks; ++ci) {\n'
     '      uint8_t* p = nullptr;\n'
     '      if (!take_dense(se, as, uint32_t(ci), &p, &parts[ci].n)) return -1;\n'
     '      parts[ci].p.reset(p);\n'
     '    }\n'
     '    Phase copy(se->trace, "native.copyout");\n'
     '    *out_len = gather_dense(as->header, parts, out);\n'),
]
