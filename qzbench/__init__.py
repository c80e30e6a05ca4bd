"""The benchmark of qatzip_tpu_torch on NVIDIA GPUs (README.md)."""
