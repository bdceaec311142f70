"""The particle mesh: the shard devices of multi-GPU rendering.

Counterpart of ``topsy_tpu/parallel/mesh.py``.  Rendering is data
parallel over particles with a framebuffer reduction, so the mesh is one
axis (``PARTICLE_AXIS``): an ordered list of shard devices.  A device may
repeat: ``make_mesh(8, devices=["cpu"] * 8)`` holds eight shards on the
CPU (the reference suite's eight virtual CPU devices), ``make_mesh(2,
devices=["cuda:0"] * 2)`` two shards on one card.  With a
``torch.distributed`` process group the mesh spans every process of the
group: ``n_devices`` counts the shards of all of them, each process holds
its own ``n_devices // world_size`` consecutive shards (``devices``), and
the partial framebuffers are reduced across the group after the local
reduction.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

PARTICLE_AXIS = "particles"


@dataclass(frozen=True)
class Mesh:
    """The shard devices of this process (``devices``, in shard order),
    the mesh's total shard count over every process of ``group`` and the
    axis name."""

    devices: tuple
    n_devices: int
    group: object = None
    axis_name: str = PARTICLE_AXIS

    @property
    def first_device(self) -> torch.device:
        """The device the partial framebuffers reduce onto (the store's)."""
        return self.devices[0]

    @property
    def shard_offset(self) -> int:
        """The global index of this process's first shard."""
        if self.group is None:
            return 0
        import torch.distributed as dist
        return dist.get_rank(self.group) * len(self.devices)


def _default_devices(count: int) -> list:
    if torch.cuda.is_available():
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())][:count]
    raise RuntimeError("make_mesh: no CUDA device is available; pass "
                       "devices=['cpu'] * n to shard on the CPU")


def make_mesh(n_devices: int | None = None, devices=None, group=None,
              axis_name: str = PARTICLE_AXIS) -> Mesh:
    """A 1-D mesh over the particle axis.

    Without ``devices``: one shard per visible CUDA card (the first
    ``n_devices`` of them).  ``devices`` lists this process's shard devices
    (torch devices or strings; a device may repeat), and ``n_devices``,
    when given, must equal its length times the size of ``group`` (a
    ``torch.distributed`` process group, which needs ``devices``)."""
    world = 1
    if group is not None:
        if devices is None:
            raise ValueError("make_mesh: a process group needs this "
                             "process's shard devices")
        import torch.distributed as dist
        world = dist.get_world_size(group)
    if devices is None:
        devices = _default_devices(n_devices or torch.cuda.device_count()
                                   or 1)
    devices = tuple(torch.device(d) for d in devices)
    if n_devices is None:
        n_devices = len(devices) * world
    if not devices or len(devices) * world != n_devices:
        raise ValueError(f"{len(devices)} local shard devices x {world} "
                         f"processes != n_devices {n_devices}")
    return Mesh(devices=devices, n_devices=int(n_devices), group=group,
                axis_name=axis_name)
