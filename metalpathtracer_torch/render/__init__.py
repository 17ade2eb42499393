"""Camera, BSDFs, intersection, the scan integrator and the pipeline."""
