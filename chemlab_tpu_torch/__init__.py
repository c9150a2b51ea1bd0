"""chemlab_tpu_torch: the PyTorch + CUDA port of chemlab_tpu.

The JAX package ``chemlab_tpu`` is the reference.  This package mirrors
its engine module by module (``engine/``), runs on torch tensors with an
explicit device, and replaces the Pallas TPU kernels on its paths with
hand-written CUDA kernels for Hopper (``csrc/``).  ``parallel/`` runs the
engine on several ranks of a ``torch.distributed`` group, the pair sum
split by x-slab.  It keeps its own copies of the reference's host layer
(topology, parsers, file I/O) and imports neither jax nor the reference.
"""
