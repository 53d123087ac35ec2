"""Build and load of the CUDA kernels."""
