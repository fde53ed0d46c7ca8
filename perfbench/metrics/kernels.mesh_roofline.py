"""kernels.mesh_roofline (%, device trace): the least time of the mesh
step's kernels (kernel table rows 1, 3 and 7; harness/roofline_mesh.py,
from each chunk's coded bins and lanes as its container gives them) over
every chunk the traced window completed, over the device time of every
kernel in the window."""
from harness import roofline_mesh


def read(ctx):
    return roofline_mesh.share(ctx)
