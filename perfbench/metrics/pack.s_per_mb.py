"""pack.s_per_mb (s/MB, program span): seconds of the container pack, pack_s
of device.compress(info=...), summed over the traced window's files, over
their input MB."""


def read(ctx):
    done = [r for r in ctx.done if r.info]
    mb = sum(r.nbytes for r in done) / 1e6
    return sum(r.info['pack_s'] for r in done) / mb if mb else None
