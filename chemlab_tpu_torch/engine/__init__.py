"""The torch device engine (port of ``chemlab_tpu/engine``).

  - ``spec``, ``state``   EngineConfig / SimSpec / MDState dataclasses
  - ``build``             topology + coordinates -> tensors
  - ``neighbor``          cell binning and the build-time Verlet rows
  - ``cell_pair``         K1 cell-tile LJ (CUDA kernel + plain version) and
                          the excluded-pair correction
  - ``excl_dense``        exclusion correction on rolled planes
  - ``bonded_forces``     bonds/angles, forces by autograd
  - ``bonded_dense``      chain terms on rolled planes
  - ``integrate``         velocity Verlet + Langevin
  - ``reactions``, ``topo``  the reactive layer
  - ``runner``            run blocks and measurement
"""
