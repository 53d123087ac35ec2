"""Device stages of the encoder: plain PyTorch and CUDA kernels."""
