"""file_p95_s (s, host clock): the 95th percentile (nearest rank) of the
per-file time over every file the window sent; a failed file counts as
infinitely late. A file's time runs from its call's start until its
container is in host memory."""
import math


def read(ctx):
    times = sorted(r.end - r.start if r.ok else math.inf for r in ctx.records)
    if not times:
        return None
    return times[math.ceil(0.95 * len(times)) - 1]
