"""Metrics, gating quantities and the fused CUDA kernels."""
