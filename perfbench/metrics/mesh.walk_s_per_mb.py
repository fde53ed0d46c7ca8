"""mesh.walk_s_per_mb (s/MB, program span): host-clock seconds of the mesh
calls' walk, which the step waits for: the session open and the start of
the native analysis (`call.open`, `call.begin`, `call.header`) and every
chunk's fetch, copy and parse (`chunk.fetch`, `chunk.take`,
`chunk.parse`), over the traced window's calls, over the input MB of the
files whose container came. None in a window with no mesh step."""
from harness import spans

spans.enable()


def read(ctx):
    w = spans.load(ctx)
    if not w or not w.named("mesh.step"):
        return None
    return w.s_per_mb(ctx, "call.open", "call.begin", "call.header", "chunk.fetch",
                      "chunk.take", "chunk.parse")
