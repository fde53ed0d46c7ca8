"""mesh.upload_bytes_per_mb (B/MB, program counter): the bytes of the mesh
step's host inputs, the count of each call's `mesh.pack` (the nbytes of
every tensor the step uploads), over the traced window's calls, over the
input MB of the files whose container came."""
from harness import spans

spans.enable()


def read(ctx):
    w = spans.load(ctx)
    found = w.named("mesh.pack") if w else []
    mb = sum(r.nbytes for r in ctx.done) / 1e6
    if not found or not mb:
        return None
    return sum(s.count for s in found) / mb
