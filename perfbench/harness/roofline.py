"""The least time the card could take for the profile-2 kernels of one
chunk, from the chunk's coded-bin count n and lane count K alone, so the
count reads the same work whatever implements it.

Peaks: one NVIDIA H100 SXM, 3.35 TB/s of HBM and 67 T int32 operations a
second (NVIDIA's data sheet; at its 700 W limit). Per kernel, bytes (each
input read once, each output written once) and integer operations are those
of the port's kernel table (PERF.md section 6) at its shapes, bench.mp4's
chunk 0 under profile 2 (n = 4,305,675 bins, K = 128 lanes, T = 65,536
steps), turned into constants per bin, or per lane slot (T x K) for the
kernels whose planes are lane-major:

    wire_expand4_blob  141,364,340 B  92,274,688 ops  per bin
    dual0_expand         3,022,511 B     710,716 ops  per bin
    model_pass_v4      128,999,408 B 356,515,840 ops  per bin
    lane_scan_dev      8 B a bin + 3 B a lane slot + 8 B a lane; 10 ops a bin
    lane_compact       3.0625 B and 3 ops a lane slot

Every one of them is bound by its bytes at these peaks.
"""
from __future__ import annotations

HBM_BYTES_S = 3.35e12
INT32_OPS_S = 67e12
N_TABLE = 4_305_675
PER_BIN = {  # kernel: (bytes a bin, operations a bin)
    "wire_expand4_blob": (141_364_340 / N_TABLE, 92_274_688 / N_TABLE),
    "dual0_expand": (3_022_511 / N_TABLE, 710_716 / N_TABLE),
    "model_pass_v4": (128_999_408 / N_TABLE, 356_515_840 / N_TABLE),
}


def steps(n: int, K: int) -> int:
    """T: the lane scan's steps, ceil(n / K) rounded up to a power of two."""
    need, t = -(-n // K), 1
    while t < need:
        t *= 2
    return t


def work(n: int, K: int) -> dict:
    """{kernel: (bytes, operations)} of one chunk."""
    slots = steps(n, K) * K
    out = {k: (b * n, o * n) for k, (b, o) in PER_BIN.items()}
    out["lane_scan_dev"] = (8 * n + 3 * slots + 8 * K, 10 * n)
    out["lane_compact"] = (3.0625 * slots, 3 * slots)
    return out


def least_s(n: int, K: int) -> float:
    """Seconds: the sum over the chunk's kernels of the larger of bytes over
    the HBM peak and operations over the int32 peak."""
    return sum(max(b / HBM_BYTES_S, o / INT32_OPS_S) for b, o in work(n, K).values())


def bound_by(n: int, K: int) -> dict:
    """{kernel: "bytes" or "operations"}: which peak bounds each kernel."""
    return {k: "bytes" if b / HBM_BYTES_S >= o / INT32_OPS_S else "operations"
            for k, (b, o) in work(n, K).items()}
