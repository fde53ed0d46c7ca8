"""kernels.model_v2_roofline (%, device trace): the least time of the v2
model pass (kernel table row 6; harness/roofline_p0.py, from each chunk's
coded bins and lanes as its container gives them) over every chunk the
traced window completed, over the device time of its kernel
(scan_kernel<int2>) in the window."""
from harness import roofline_p0


def read(ctx):
    return roofline_p0.share(ctx, "model_v2")
