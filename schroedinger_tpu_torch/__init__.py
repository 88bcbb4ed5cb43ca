"""schroedinger_tpu_torch — the Dirac / VC-2 codec in PyTorch for CUDA.

A port of `schroedinger_tpu` (the JAX reference package) to PyTorch, with
the ME patch-refine search as a hand-written CUDA kernel for Hopper
(`csrc/patch_refine.cu`).  Module paths mirror the JAX package's.  The
jax-free host modules of the JAX package (params, tables, bitstream, the
C++ arith/VLC/MV coder and MD5) are shared unchanged.

This package imports `torch` and never `jax`.  Every tensor function runs
on the device of its inputs; the encoder and decoder take an explicit
`device`.
"""

__version__ = "0.1.0"
