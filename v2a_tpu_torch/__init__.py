"""PyTorch/CUDA port of v2a_tpu for one NVIDIA H100; see README.md."""
