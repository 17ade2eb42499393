"""Device ms a pass of the bounce step's and the regeneration's kernels
(`layers/step.json`), from the profiled passes' trace."""


def read(ctx):
    return ctx.layer_ms_per_pass("step")
