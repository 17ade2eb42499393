"""The hand-written CUDA kernels (closest hit, tile cull, the RNG's threefry),
their plain twins, their tables, and how they are built and launched."""
