"""Device idle ms a profiled pass while the host is inside any other of the
program's `mpt/` spans: the progressive entries (`entry.*`), their eager
stages (`wavefront.start`, `compact`, `flush`, `scan.begin`, `result`,
`shard.rays`), `to_image`, the progressive add, and the loop's Python
between its runs and reads; from the profiled passes' trace
(`harness/spans.py`); nothing where the program opens no `entry.*` span."""

from harness import spans


def read(ctx):
    return spans.idle_ms_per_pass(ctx, "entry")
