"""Device idle ms a profiled pass while the host is inside the program's
`graphs.read.*` spans (`render/graphs.py` `Entry.read`: the wait and copy
of a read of the loop state, and the device's ramp after a launch that has
returned), from the profiled passes' trace (`harness/spans.py`); nothing
where the program opens no such span."""

from harness import spans


def read(ctx):
    return spans.idle_ms_per_pass(ctx, "read")
