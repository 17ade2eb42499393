"""Device ms a pass of the device work no layer file claims: torch's own
kernels that the port calls (sorts, copies, fills, scatters, elementwise),
from the profiled passes' trace."""


def read(ctx):
    return ctx.layer_ms_per_pass("unclaimed")
