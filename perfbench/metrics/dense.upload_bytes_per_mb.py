"""dense.upload_bytes_per_mb (B/MB, program counter): the bytes that the
profile-0 chunk loop moves between host and device, the count2 of each
chunk's `chunk.model` (the pass's inputs and its probs download) and
`chunk.lanes` (the lane planes), over the traced window's calls, over the
input MB of the files whose container came."""
from harness import spans

spans.enable()


def read(ctx):
    w = spans.load(ctx)
    found = w.named("chunk.model", "chunk.lanes") if w else []
    mb = sum(r.nbytes for r in ctx.done) / 1e6
    if not found or not mb:
        return None
    return sum(s.count2 for s in found) / mb
