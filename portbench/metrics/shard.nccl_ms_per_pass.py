"""Device ms a pass of rank 0's nccl kernels (`layers/shard.json`), from
the profiled passes' trace; nothing where the cell runs on one card."""


def read(ctx):
    return ctx.layer_ms_per_pass("shard")
