"""Device mesh + shard→member assignment (single process).

The port's copy of ``pilosa_tpu.parallel.mesh``. The reference lays a
query's shard list out as the leading axis of one global array sharded
over a ``jax.sharding.Mesh``, and one process drives every device of it.
The port keeps that single-controller model: a ``Mesh`` is a grid of
members, each a ``torch.device``; a member owns a contiguous range of
shard slots and runs the existing kernels over a view of the resident
stacked leaf (``parallel/dist.py``). Members may repeat a device, so 8
members can share one CPU in the tests or one H100 on the card.

Multi-host (the reference's ``initialize_distributed`` and its
per-process slot feeding) comes with the cluster planes.
"""

from __future__ import annotations

import numpy as np
import torch

from pilosa_tpu_torch.executor.batch import ShardBlock
from pilosa_tpu_torch.shardwidth import next_pow2

SHARDS_AXIS = "shards"
GROUPS_AXIS = "groups"


class Mesh:
    """A grid of members: ``devices`` is an object array of
    ``torch.device`` of shape ``(size,)`` on the flat form or ``(groups,
    shards_per_group)`` on the 2-D one, named by ``axis_names``. Member
    g·S + s is slot (g, s); ``members`` lists them in that order."""

    def __init__(self, devices: np.ndarray, axis_names: tuple):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-D members for axes "
                             f"{axis_names!r}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.members = [torch.device(d) for d in devices.ravel()]

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))


def visible_devices() -> list:
    """Every CUDA device this process sees (none without a GPU)."""
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_devices: int | None = None, devices=None,
              groups: int | None = None) -> Mesh:
    """Mesh over the shard axis, flat by default.

    ``devices`` defaults to the visible CUDA devices. Where ``n_devices``
    exceeds the devices given, members repeat them in order, so
    ``make_mesh(8, devices=[cuda:0], groups=2)`` is 8 members on one
    card: the counterpart of the reference's forced host device count
    (``--xla_force_host_platform_device_count``), which gives one CPU 8
    devices. ``groups`` > 1 factors the same members as a 2-D ``groups x
    shards`` mesh, member g·S + s at slot (g, s), and every reduction
    takes the hierarchical two-stage form (``parallel/dist.py``);
    results stay bit-identical to the flat form."""
    if devices is None:
        devices = visible_devices()
        if not devices:
            raise RuntimeError("no CUDA device visible; pass devices=")
    devices = [torch.device(d) for d in devices]
    if n_devices is not None:
        devices = [devices[i % len(devices)] for i in range(n_devices)]
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    if groups is not None and groups > 1:
        if arr.size % groups:
            raise ValueError(
                f"groups={groups} does not divide {arr.size} devices"
            )
        return Mesh(arr.reshape(groups, -1), (GROUPS_AXIS, SHARDS_AXIS))
    return Mesh(arr, (SHARDS_AXIS,))


def mesh_groups(mesh: Mesh) -> tuple[int, int] | None:
    """(groups, shards_per_group) for a 2-D hierarchical mesh, None for
    the flat 1-D form."""
    if GROUPS_AXIS in mesh.axis_names:
        return (mesh.shape[GROUPS_AXIS], mesh.shape[SHARDS_AXIS])
    return None


class ShardAssignment(ShardBlock):
    """Maps a query's shard list onto mesh slots: the local layout
    (``ShardBlock``, slots in sorted shard order) padded to
    ``n_devices · next_pow2(⌈n / n_devices⌉)`` slots, member m owning
    slots ``[m·per, (m+1)·per)``. A stacked leaf lives once, on the
    holder's device; a member on that device reads its slots as a
    view."""

    def __init__(self, shards: list[int], mesh: Mesh):
        super().__init__(shards)
        self.n_devices = mesh.size
        n = max(len(self.shards), 1)
        self.per = next_pow2(-(-n // self.n_devices))
        self.padded = self.n_devices * self.per
        self.mesh = mesh
        self.local_slots = (0, self.padded)
        self._key = None

    @property
    def slot_of(self) -> dict[int, int]:
        return {s: i for i, s in enumerate(self.shards)}
