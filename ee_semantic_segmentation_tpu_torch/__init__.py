"""PyTorch/CUDA port of ``ee_semantic_segmentation_tpu`` for NVIDIA Hopper.

The JAX package beside this one is the reference; this package imports
``torch`` and never JAX or the JAX package.  Its layout and module names
follow the JAX package so each counterpart is easy to find; the TPU
(Pallas) kernels become hand-written CUDA kernels under ``ops/kernels``.
Entry points run on CUDA unless the caller asks for the CPU.
"""
