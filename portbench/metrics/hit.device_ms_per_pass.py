"""Device ms a pass of the closest hit's kernels (`layers/hit.json`), from
the profiled passes' trace."""


def read(ctx):
    return ctx.layer_ms_per_pass("hit")
