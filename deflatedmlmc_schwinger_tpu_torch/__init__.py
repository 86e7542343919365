"""PyTorch + CUDA port of deflatedmlmc_schwinger_tpu (deflated Hutchinson
trace estimation of the 2D Schwinger Wilson--Dirac operator with an
aggregation multigrid solver).

Module paths and public names follow the JAX package, which stays the
reference; this package never imports jax. The fine-level stencil kernels
are hand-written CUDA C++ (csrc/stencil.cu), built with nvcc at first use.
"""
