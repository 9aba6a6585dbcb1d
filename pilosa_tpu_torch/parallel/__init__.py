"""Background planes over a holder (the integrity scrubber and its
pacer) and the single-process device mesh: ``make_mesh`` lays a query's
shard slots over a grid of members, and ``DistExecutor`` runs each
launch over them and reduces their partials through the mesh lanes
(``parallel/reduction.py``)."""

from pilosa_tpu_torch.parallel.mesh import (
    GROUPS_AXIS,
    SHARDS_AXIS,
    ShardAssignment,
    make_mesh,
    mesh_groups,
)
from pilosa_tpu_torch.parallel.dist import DistExecutor
