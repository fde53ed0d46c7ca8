"""setup_s (s, host clock): from the run's first line to the window's start:
imports, the program's libraries (built on a checkout's first run), the
mix's files, and one call of each distinct file."""


def read(ctx):
    return ctx.setup_s
