"""Ray-sphere tests the program handed its sphere pass a pass, in 10^9:
`render/graphs.py` STATS["sphere_tests"] (lanes times the sphere table's
rows, padding included, a call, as the kernel's loop runs them; counted at
capture and added at each replay) over the whole window's passes (a
program counter); nothing where the program lacks the counter.

Every lane of every bounce step counts, live or not: on a scene the
traffic fixes, the count moves only where fewer lanes are handed to the
pass (compaction, fewer steps) or fewer spheres are (culling), not where
the kernel skips dead lanes inside its own launch."""


def read(ctx):
    if ctx.passes == 0 or "sphere_tests" not in ctx.stats:
        return None
    return ctx.stats["sphere_tests"] / ctx.passes / 1e9
