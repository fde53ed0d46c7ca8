"""walk.wait_s_per_mb (s/MB, program span): seconds the calling thread
blocks on the walk, `native.ready_wait` (for the session opener) and
`native.rendezvous` (for each chunk's export), over the traced window's
calls, over the input MB of the files whose container came: the part of
the walk that holds the result back."""
from harness import spans

spans.enable()


def read(ctx):
    w = spans.load(ctx)
    return w.s_per_mb(ctx, "native.ready_wait", "native.rendezvous") if w else None
