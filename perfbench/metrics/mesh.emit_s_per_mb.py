"""mesh.emit_s_per_mb (s/MB, program span): host-clock seconds of the mesh
calls' container work: every chunk's blob assembled from the step's lane
outputs (`mesh.assemble`) and the container packed (`call.pack`), over the
traced window's calls, over the input MB of the files whose container
came. None in a window with no mesh step."""
from harness import spans

spans.enable()


def read(ctx):
    w = spans.load(ctx)
    if not w or not w.named("mesh.step"):
        return None
    return w.s_per_mb(ctx, "mesh.assemble", "call.pack")
