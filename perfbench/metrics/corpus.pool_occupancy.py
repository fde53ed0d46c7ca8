"""corpus.pool_occupancy (%, program counter): the seconds the pool's
workers spent on files (CorpusReport.per_file) over the workers times the
wall seconds of the pool's calls, over the traced window."""


def read(ctx):
    if not ctx.calls:
        return None
    busy = sum(sum(files) for _, _, files in ctx.calls)
    room = sum(wall * workers for wall, workers, _ in ctx.calls)
    return 100.0 * busy / room if room > 0 else None
