"""throughput_mb_s (MB/s, host clock): input bytes (1 MB = 10**6 B) of every
file whose container came, over the window's seconds: from the first send to
the return of the last call, which the driver sends before --seconds have
passed. All the work over all the time: a file's bytes count whole, and no
part of the window is left out."""


def read(ctx):
    return sum(r.nbytes for r in ctx.done) / 1e6 / ctx.window_s
