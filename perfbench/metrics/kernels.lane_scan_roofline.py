"""kernels.lane_scan_roofline (%, device trace): the least time of the
masked lane scan and the compaction (kernel table rows 7 and 5;
harness/roofline_p0.py, from each chunk's coded bins and lanes as its
container gives them) over every chunk the traced window completed, over
the device time of their kernels (lane_scan_kernel, compact_count_kernel,
compact_write_kernel) in the window."""
from harness import roofline_p0


def read(ctx):
    return roofline_p0.share(ctx, "lane_scan")
