"""Graph nodes the program's replays ran a pass: `render/graphs.py`
STATS["replayed_ops"] (each replay adds its graph's node count) over the
whole window's passes (a program counter); nothing where the program or
the harness's counters lack it (the sharded harness sums fixed keys)."""


def read(ctx):
    if ctx.passes == 0 or "replayed_ops" not in ctx.stats:
        return None
    return ctx.stats["replayed_ops"] / ctx.passes
