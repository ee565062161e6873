"""Compute kernels: hand-written CUDA kernels with their plain PyTorch
versions, and the host numpy helpers of the sketch route."""
