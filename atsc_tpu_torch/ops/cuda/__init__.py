"""Hand-written CUDA kernels (csrc/*.cu), their wrappers and plain twins."""
