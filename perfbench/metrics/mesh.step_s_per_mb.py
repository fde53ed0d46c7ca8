"""mesh.step_s_per_mb (s/MB, program span): host-clock seconds of the mesh
step, from its build to its outputs in host memory: `mesh.step` (the step
built and every cell's launches issued) and `mesh.fetch` (the one download
and its wait, which holds the device work), over the traced window's
calls, over the input MB of the files whose container came."""
from harness import spans

spans.enable()


def read(ctx):
    w = spans.load(ctx)
    return w.s_per_mb(ctx, "mesh.step", "mesh.fetch") if w else None
