"""Kernel registry, the CUDA kernels' wrappers and their plain versions."""
