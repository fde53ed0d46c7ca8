"""dense.parse_s_per_mb (s/MB, program span): seconds of the profile-0
export's hand-over, `native.copyout` (into a malloc buffer) and `call.parse`
(into Python bytes, then parsed), over the traced window's calls, over the
input MB of the files whose container came."""
from harness import spans

spans.enable()


def read(ctx):
    w = spans.load(ctx)
    if not w or not w.named("call.parse"):
        return None
    return w.s_per_mb(ctx, "native.copyout", "call.parse")
