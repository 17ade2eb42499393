"""Device idle ms a profiled pass while the host is inside the program's
`graphs.run.*` spans (`render/graphs.py` `Entry.run`: a replay's launch),
from the profiled passes' trace (`harness/spans.py`); nothing where the
program opens no such span."""

from harness import spans


def read(ctx):
    return spans.idle_ms_per_pass(ctx, "launch")
