"""Several ranks, one replicated state, the pair sum split by x-slab (port
of ``chemlab_tpu/parallel``).

  - ``sharding``  ``SlabMesh``, ``make_mesh``, ``meshed_cfg``,
                  ``shard_system``, ``shard_state``
  - ``launch``    starts D ranks of a ``torch.distributed`` group and runs
                  a named job of ``jobs`` on each
  - ``jobs``      the jobs a launch can run
"""

from .sharding import (SlabMesh, make_mesh, meshed_cfg, shard_state,
                       shard_system)

__all__ = ["SlabMesh", "make_mesh", "meshed_cfg", "shard_state",
           "shard_system"]
