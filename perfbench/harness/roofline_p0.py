"""The least time the card could take for the profile-0 kernels of one
chunk (the v2 model pass, the masked lane scan and the compaction), from
the chunk's coded-bin count n and lane count K alone, so the count reads
the same work whatever implements it.

Peaks and rule as harness/roofline.py: one NVIDIA H100 SXM, 3.35 TB/s of
HBM and 67 T int32 operations a second; each kernel's least time is the
larger of its bytes (each input read once, each output written once) over
the first and its integer operations over the second. Bytes and operations
are those of the port's kernel table (PERF.md section 6) at its shapes,
bench.mp4's chunk 0 under profile 0 (n = 4,305,700 bins, K = 128 lanes,
T = 65,536 steps), turned into constants per bin, or per lane slot (T x K)
for the kernels whose planes are lane-major:

    model_pass_v2  (row 6)  214,032,384 B  387,973,120 ops  per bin
    lane_scan      (row 7)  12 B a lane slot + 8 B a lane; 10 ops a bin
    lane_compact   (row 5)  3.0625 B and 3 ops a lane slot

Every one of them is bound by its bytes at these peaks. Each share puts
the least time of its rows over the device time of the kernels that
implement them, picked by name in the trace (KERNELS).
"""
from __future__ import annotations

import re

from harness import roofline

N_TABLE = 4_305_700
V2_PER_BIN = (214_032_384 / N_TABLE, 387_973_120 / N_TABLE)  # (bytes, operations) a bin

# The kernels that implement each share's rows, as the profiler names them
# ("void (anonymous namespace)::scan_kernel<int2>(...)"; sanitised names
# keep the words): row 6 is scan_kernel's int2 instance (the v2 pass; the
# profile-2 pass is its unsigned-int instance), rows 7 and 5 the masked
# lane scan and the compaction's two kernels.
KERNELS = {
    "model_v2": re.compile(r"scan_kernel[^A-Za-z0-9]*int2(?![0-9])"),
    "lane_scan": re.compile(r"lane_scan_kernel|compact_count_kernel|compact_write_kernel"),
}
ROWS = {"model_v2": ("model_pass_v2",), "lane_scan": ("lane_scan", "lane_compact")}


def work(n: int, K: int) -> dict:
    """{kernel: (bytes, operations)} of one chunk."""
    slots = roofline.steps(n, K) * K
    b, o = V2_PER_BIN
    return {"model_pass_v2": (b * n, o * n),
            "lane_scan": (12 * slots + 8 * K, 10 * n),
            "lane_compact": (3.0625 * slots, 3 * slots)}


def least_s(n: int, K: int, share: str) -> float:
    """Seconds: over the share's rows, the larger of bytes over the HBM peak
    and operations over the int32 peak."""
    w = work(n, K)
    return sum(max(w[k][0] / roofline.HBM_BYTES_S, w[k][1] / roofline.INT32_OPS_S)
               for k in ROWS[share])


def bound_by(n: int, K: int) -> dict:
    """{kernel: "bytes" or "operations"}: which peak bounds each kernel."""
    return {k: "bytes" if b / roofline.HBM_BYTES_S >= o / roofline.INT32_OPS_S else "operations"
            for k, (b, o) in work(n, K).items()}


def kernel_s(trace, share: str) -> float:
    """Device seconds of the window's kernels that implement the share."""
    pat = KERNELS[share]
    return sum(e - s for name, s, e in trace.kernels if pat.search(name)) / 1e6


def share(ctx, name: str) -> float | None:
    """The share (%) of the traced window: the least time of every chunk
    of the files whose container came over the device time of the share's
    kernels; None without a trace or without such kernels."""
    if ctx.trace is None:
        return None
    busy = kernel_s(ctx.trace, name)
    if busy <= 0:
        return None
    least = sum(least_s(n, k, name) for r in ctx.done for k, n in ctx.chunks(r))
    return 100.0 * least / busy if least > 0 else None
