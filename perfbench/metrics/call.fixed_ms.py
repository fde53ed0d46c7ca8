"""call.fixed_ms (ms, program span): the mean per file of the call's wall
time less open_s, fetch_s and stage_s of device.compress(info=...): the
launches, the compaction's waits, the emit, the pack and what surrounds
them, over the traced window's files."""


def read(ctx):
    done = [r for r in ctx.done if r.info]
    if not done:
        return None
    rest = [(r.end - r.start) - r.info["open_s"] - r.info["fetch_s"] - r.info["stage_s"]
            for r in done]
    return 1e3 * sum(rest) / len(rest)
