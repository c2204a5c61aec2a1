"""Image ops, detection, matching and the CUDA kernel wrappers."""
