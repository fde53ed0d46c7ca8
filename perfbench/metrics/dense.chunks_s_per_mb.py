"""dense.chunks_s_per_mb (s/MB, program span): host-clock seconds of the
profile-0 chunk loop, each chunk's `chunk.model` (uploads, model pass,
probs download) and `chunk.lanes` (lane planes' upload, lane scan,
compaction, download), over the traced window's calls, over the input MB
of the files whose container came."""
from harness import spans

spans.enable()


def read(ctx):
    w = spans.load(ctx)
    return w.s_per_mb(ctx, "chunk.model", "chunk.lanes") if w else None
