"""PyTorch/CUDA port of the volumetric path tracer.

Mirrors `acceleratedvolrenderer_tpu` module for module; each port module is
held to its JAX counterpart by `tests/test_torch_*.py`.  The package imports
`torch` and never `jax` or the JAX package.  Its CUDA kernels are C++
sources under `csrc/` (the fused DDA march, `ops/march.py`; the table
gather of the march's window route, `ops/gather.py`; the tile-DMA gather of
the gather-design measurement, `ops/dma_gather.py`), built with `nvcc` on
first use into `build/kernels/` at the repository root.  Entry points run
on the CUDA card unless given another `device`.
"""
