"""Share of the profiled passes' wall time (from the first pass's call to
the last one's image on the host) that no device kernel, copy or fill
covers. Profiled, so an upper bound of the unprofiled window's."""


def read(ctx):
    if not ctx.traced or ctx.window_ns <= 0:
        return None
    return 100.0 * (ctx.window_ns - ctx.busy_ns) / ctx.window_ns
