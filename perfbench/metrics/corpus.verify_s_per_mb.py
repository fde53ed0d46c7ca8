"""corpus.verify_s_per_mb (s/MB, program span): seconds of the corpus pool's
verify decodes (`corpus.verify`, the host decoder on each container) over
the traced window's files, over the input MB of the files whose container
came."""
from harness import spans

spans.enable()


def read(ctx):
    w = spans.load(ctx)
    return w.s_per_mb(ctx, "corpus.verify") if w else None
