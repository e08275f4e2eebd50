"""PyTorch/CUDA port of the volumetric path tracer.

Mirrors `acceleratedvolrenderer_tpu` module for module; each port module is
held to its JAX counterpart by `tests/test_torch_*.py`.  The package imports
`torch` and never `jax`.  The one kernel on the render path, the fused DDA
march (`ops/march.py`), is CUDA C++ under `csrc/`, built with `nvcc` on
first use into `build/kernels/` at the repository root.
"""
