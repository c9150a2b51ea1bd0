"""The torch device engine (port of ``chemlab_tpu/engine``).

  - ``spec``, ``state``   EngineConfig / SimSpec / MDState dataclasses
  - ``build``             topology + coordinates -> tensors
  - ``neighbor``          cell binning and the build-time Verlet rows
  - ``cell_pair``         the cell-tile pair kernels (K1, K1c/K1d/K1e, K2,
                          K1f: CUDA + plain versions) and the excluded-pair
                          correction
  - ``cell_pair_halo``    the pair sum split by x-slab over a mesh's ranks
  - ``excl_dense``        exclusion correction on rolled planes
  - ``bonded_forces``     bonds/angles, forces by autograd
  - ``bonded_dense``      chain terms on rolled planes
  - ``integrate``         velocity Verlet + Langevin
  - ``reactions``, ``topo``  the reactive layer
  - ``runner``            run blocks and measurement
"""
