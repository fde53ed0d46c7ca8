"""mesh.pack_s_per_mb (s/MB, program span): host-clock seconds of the mesh
calls' packing of every chunk into the step's inputs (`mesh.pack`:
mesh_inputs, into pinned memory on the card), over the traced window's
calls, over the input MB of the files whose container came."""
from harness import spans

spans.enable()


def read(ctx):
    w = spans.load(ctx)
    return w.s_per_mb(ctx, "mesh.pack") if w else None
