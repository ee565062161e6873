"""Compute kernels: hand-written CUDA kernels with their plain PyTorch
versions, the torch int64 hash chain and CSetSketch pass (on the card or
the CPU, by the tensor's device), and the host numpy helpers of the
sketch route."""
