"""device.idle_walk_share (%, device trace): of the traced window's
device-idle time (what the union of kernel, copy and fill intervals leaves),
the share during which a call is open and every open call's thread waits
for the native walk (`native.ready_wait`, `native.rendezvous`), with the
program's spans put on the profile's timeline (harness/spans.py)."""
from harness import spans

spans.enable()


def read(ctx):
    w = spans.load(ctx)
    if w is None or not (ctx.trace.kernels or ctx.trace.copies):
        return None
    return spans.idle_walk_share(ctx.trace, w)
