"""Support code: the CUDA kernel build and the render checks."""
