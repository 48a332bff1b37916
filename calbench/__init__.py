"""calbench: the benchmark of calamity_tpu_torch on one NVIDIA H100 (see README.md)."""
