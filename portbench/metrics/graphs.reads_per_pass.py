"""Host reads of the program's loop state a pass: `render/graphs.py`
STATS["reads"] over the whole window's passes (a program counter)."""


def read(ctx):
    if ctx.passes == 0:
        return None
    return ctx.stats["reads"] / ctx.passes
