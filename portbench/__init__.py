"""The benchmark of eco_tpu_torch on an NVIDIA H100 (see README.md)."""
