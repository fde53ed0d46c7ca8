"""The least time the card could take for the mesh step's kernels on one
chunk (parallel.pipeline.sharded_v4_compress_step: the mesh-mode wire
expand, the frozen-batch pass v3_core and the masked lane scan; kernel
table rows 1, 3 and 7), from the chunk's coded-bin count n and lane count
K alone, so the count reads the same work whatever implements it.

Peaks and rule as harness/roofline.py: one NVIDIA H100 SXM, 3.35 TB/s of
HBM and 67 T int32 operations a second; each kernel's least time is the
larger of its bytes over the first and its integer operations over the
second; the chain term is left out, as in roofline.py and roofline_p0.py.
Per live bin, the expand's and the pass's bytes and operations are
roofline.py's (rows 1 and 3 at bench.mp4's chunk 0; 32.8 and 30.0 B a
bin). The masked scan's are roofline_p0.py's row 7: 12 B a lane slot and
8 B a lane, 10 operations a bin. Its lane slots are T x K with T =
ceil(n / K), the steps that hold the chunk's live bins: the padding of
the mesh's uniform shapes (M = ns x sup x batch bins a chunk) is work of
the implementation, not of the chunk, and is not counted. The step
launches no compaction and no dual0 expand (the host packs dual0).
"""
from __future__ import annotations

from harness import roofline

SCAN_B_SLOT, SCAN_B_LANE, SCAN_OPS_BIN = 12, 8, 10  # roofline_p0.py's row 7


def work(n: int, K: int) -> dict:
    """{kernel: (bytes, operations)} of one chunk."""
    slots = -(-n // K) * K
    out = {k: (b * n, o * n) for k, (b, o) in roofline.PER_BIN.items()
           if k in ("wire_expand4_blob", "model_pass_v4")}
    out["lane_scan"] = (SCAN_B_SLOT * slots + SCAN_B_LANE * K, SCAN_OPS_BIN * n)
    return out


def least_s(n: int, K: int) -> float:
    """Seconds: the sum over the chunk's kernels of the larger of bytes over
    the HBM peak and operations over the int32 peak."""
    return sum(max(b / roofline.HBM_BYTES_S, o / roofline.INT32_OPS_S)
               for b, o in work(n, K).values())


def bound_by(n: int, K: int) -> dict:
    """{kernel: "bytes" or "operations"}: which peak bounds each kernel."""
    return {k: "bytes" if b / roofline.HBM_BYTES_S >= o / roofline.INT32_OPS_S else "operations"
            for k, (b, o) in work(n, K).items()}


def share(ctx) -> float | None:
    """The share (%) of the traced window: the least time of every chunk of
    the files whose container came over the device time of every kernel in
    the window; None without a trace or without kernels."""
    if ctx.trace is None or ctx.trace.kernel_s <= 0:
        return None
    least = sum(least_s(n, k) for r in ctx.done for k, n in ctx.chunks(r))
    return 100.0 * least / ctx.trace.kernel_s if least > 0 else None
