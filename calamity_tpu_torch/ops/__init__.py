"""Device ops: forward model and chi-square loss, the fused dense-chunk
loss (CUDA kernel + plain version), and the Cholesky warm start."""
