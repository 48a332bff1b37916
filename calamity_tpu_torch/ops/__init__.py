"""Device ops: forward model and chi-square loss, the fused dense-chunk
loss and the shared-basis chunk loss (CUDA kernels + plain versions), the
gain products, and the Cholesky warm start."""
