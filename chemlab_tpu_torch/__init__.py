"""chemlab_tpu_torch: the PyTorch + CUDA port of chemlab_tpu.

The JAX package ``chemlab_tpu`` is the reference.  This package mirrors
its engine module by module (``engine/``), runs on torch tensors with an
explicit device, and replaces the Pallas TPU kernel on the reactive melt's
path with a hand-written CUDA kernel for Hopper (``csrc/``).  It imports
the reference's jax-free host layer (topology, parsers, file I/O) and never
imports jax.
"""
