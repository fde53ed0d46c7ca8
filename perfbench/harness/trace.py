"""Reads the traced window: torch.profiler with CPU and CUDA activities.

From the device's timeline: each kernel, copy and fill as an interval; the
busy time is the union of those intervals (merged, never summed: a copy on
the copy stream may overlap a kernel); the idle gaps are what the union
leaves of the window. Each gap is named by what the host was doing at its
middle: the shortest CPU-side event that covers it (a torch operator, or
the harness's own span around a call), or "no host event".
"""
from __future__ import annotations

from dataclasses import dataclass, field


def union(intervals) -> list[tuple[float, float]]:
    """The merged intervals of (start, end) pairs, in order."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def gaps(merged, start: float, end: float) -> list[tuple[float, float]]:
    """The parts of [start, end] that the merged intervals leave idle."""
    out, t = [], start
    for s, e in merged:
        if s > t:
            out.append((t, min(s, end)))
        t = max(t, e)
    if t < end:
        out.append((t, end))
    return [(s, e) for s, e in out if e > s]


@dataclass
class Trace:
    window_s: float                        # the traced window, host clock
    kernels: list = field(default_factory=list)   # (name, start_us, end_us)
    copies: list = field(default_factory=list)    # memcpy and memset, same form
    host: list = field(default_factory=list)      # CPU events (name, start_us, end_us)

    @property
    def merged(self):
        return union([(s, e) for _, s, e in self.kernels + self.copies])

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.merged) / 1e6

    @property
    def kernel_s(self) -> float:
        return sum(e - s for _, s, e in self.kernels) / 1e6

    def span_us(self) -> tuple[float, float]:
        """The device timeline's extent taken as the window: from the first
        event of any kind to the first plus the window's length."""
        first = min([s for _, s, _ in self.kernels + self.copies + self.host], default=0.0)
        return first, first + self.window_s * 1e6

    def device_ops(self, k: int = 10) -> list:
        by: dict = {}
        for name, s, e in self.kernels + self.copies:
            by[name] = by.get(name, 0.0) + (e - s) / 1e6
        return sorted(([n, v] for n, v in by.items()), key=lambda x: -x[1])[:k]

    def idle_gaps(self, k: int = 10) -> list:
        lo, hi = self.span_us()
        longest = sorted(gaps(self.merged, lo, hi), key=lambda g: g[0] - g[1])[:k]
        out = []
        for s, e in longest:
            mid = (s + e) / 2
            cover = [(he - hs, name) for name, hs, he in self.host if hs <= mid <= he]
            out.append([min(cover)[1] if cover else "no host event", (e - s) / 1e6])
        return out


def read(prof, window_s: float, spans=frozenset()) -> Trace:
    """The Trace of a finished torch.profiler.profile. The harness's own
    spans (named in `spans`) are the host's; their mirrors on the device's
    timeline (user annotations) are no device work and are left out."""
    from torch.autograd import DeviceType
    t = Trace(window_s=window_s)
    for e in prof.events():
        item = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False) or e.name in spans:
                continue
            (t.copies if e.name.startswith(("Memcpy", "Memset")) else t.kernels).append(item)
        elif e.device_type == DeviceType.CPU:
            t.host.append(item)
    return t
