"""Device probe: Kineto captures -> per-kernel spans, step rollups and
memory samples, shipped as TPU_SPAN / STEP_METRICS frames."""
