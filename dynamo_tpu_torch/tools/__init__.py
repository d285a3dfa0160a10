"""Measurement tools for the port's CUDA kernels; each needs an NVIDIA card."""
