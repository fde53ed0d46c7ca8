"""stage.wire_bytes_per_mb (B/MB, program counter): host-to-device bytes of
the staging (wire_bytes of device.compress(info=...)) over input MB, over
the traced window's files."""


def read(ctx):
    done = [r for r in ctx.done if r.info]
    mb = sum(r.nbytes for r in done) / 1e6
    return sum(r.info["wire_bytes"] for r in done) / mb if mb else None
