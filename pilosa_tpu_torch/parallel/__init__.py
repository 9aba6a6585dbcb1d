"""Background planes over a holder (the integrity scrubber and its
pacer), the keep-alive connection pool (``connpool``) and the
single-process device mesh: ``make_mesh`` lays a query's shard slots
over a grid of members, and ``DistExecutor`` runs each launch over them
and reduces their partials through the mesh lanes
(``parallel/reduction.py``).

The mesh's names load at first use, so a module of this package that
needs no device (``connpool``, which a serving worker imports) does not
import torch."""

_LAZY = {
    "GROUPS_AXIS": "pilosa_tpu_torch.parallel.mesh",
    "SHARDS_AXIS": "pilosa_tpu_torch.parallel.mesh",
    "ShardAssignment": "pilosa_tpu_torch.parallel.mesh",
    "make_mesh": "pilosa_tpu_torch.parallel.mesh",
    "mesh_groups": "pilosa_tpu_torch.parallel.mesh",
    "DistExecutor": "pilosa_tpu_torch.parallel.dist",
}

__all__ = sorted(_LAZY)


def __getattr__(name: str):
    module = _LAZY.get(name)
    if module is None:
        raise AttributeError(
            f"module 'pilosa_tpu_torch.parallel' has no attribute {name!r}")
    import importlib

    value = getattr(importlib.import_module(module), name)
    globals()[name] = value
    return value
