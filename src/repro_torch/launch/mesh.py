"""Device meshes for the port (counterpart of ``repro.launch.mesh``).

  * ``make_mesh`` / ``make_production_mesh``: a
    ``torch.distributed.device_mesh.DeviceMesh`` with a ``MeshConfig``'s
    shape and axis names over the current process group, for the models'
    sharded steps (``launch.steps``).  Each rank of the group is one device
    of the mesh; the caller initialises the group.
  * ``make_node_mesh``: a :class:`NodeMesh`, an ordered tuple of
    ``torch.device``s along one axis named ``"node"``, over which
    ``FleetVM(mesh=...)`` partitions the leading node axis of its stacked
    ``VMState`` (``sharding.rules.make_fleet_rules``); it needs no process
    group.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.config import MeshConfig


@dataclass(frozen=True)
class NodeMesh:
    """An ordered 1-D mesh of devices.  Several entries may name the same
    device: each entry is a shard of its own, with state of its own."""

    devices: tuple
    axis_names: tuple = ("node",)

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "devices", tuple(torch.device(d) for d in self.devices))
        if len(self.axis_names) != 1:
            raise ValueError("a NodeMesh has exactly one axis")

    @property
    def size(self) -> int:
        return len(self.devices)

    def distinct_devices(self) -> list:
        """The mesh's devices without repeats, in mesh order."""
        return list(dict.fromkeys(self.devices))


def make_mesh(cfg: MeshConfig, device_type: str = "cuda") -> DeviceMesh:
    """A mesh of ``cfg.shape`` over ``cfg.axis_names`` on the current
    process group, whose world size must be ``cfg.num_devices``
    (``MeshConfig(data=1, model=1)`` on a world of one card is the (1, 1)
    mesh).  ``device_type="cpu"`` builds it over a gloo group; the default
    wants CUDA and raises without it."""
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device; pass device_type=\"cpu\" over a gloo group")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: initialise a process group first "
                           "(torch.distributed.init_process_group)")
    world = dist.get_world_size()
    if world != cfg.num_devices:
        raise ValueError(f"make_mesh: mesh {cfg.shape} needs {cfg.num_devices} ranks, "
                         f"the world has {world}")
    return init_device_mesh(device_type, cfg.shape, mesh_dim_names=cfg.axis_names)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> DeviceMesh:
    """The production mesh: one pod = (16, 16) over ("data", "model"); two
    pods add an outer "pod" axis -> (2, 16, 16).  It raises unless the
    world has that many ranks, and never shrinks to fit."""
    return make_mesh(MeshConfig(multi_pod=multi_pod), device_type)


def _cuda(index: int) -> torch.device:
    return torch.device("cuda", index)


def make_node_mesh(n_devices: int | None = None, device=None) -> NodeMesh:
    """A 1-D mesh over the ``"node"`` axis for the VM fleet.

    With no arguments: one shard per visible CUDA device; it raises when
    there is none and never falls back to the CPU.  ``n_devices`` alone
    takes the first ``n_devices`` CUDA devices.  With ``device`` (``"cpu"``,
    ``"cuda"`` or ``"cuda:1"``) it gives ``n_devices`` shards (default 1) on
    that one device: the counterpart of the reference's forced host
    devices (``--xla_force_host_platform_device_count``)."""
    if device is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count == 0:
            raise RuntimeError(
                "make_node_mesh: no CUDA device; pass device=\"cpu\" for a mesh on the CPU"
            )
        n = count if n_devices is None else int(n_devices)
        if not 1 <= n <= count:
            raise ValueError(f"make_node_mesh: {n} devices asked for, {count} visible")
        return NodeMesh(tuple(_cuda(i) for i in range(n)))
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("make_node_mesh: CUDA is not available")
        dev = _cuda(dev.index if dev.index is not None else torch.cuda.current_device())
    n = 1 if n_devices is None else int(n_devices)
    if n < 1:
        raise ValueError(f"make_node_mesh: n_devices must be >= 1, got {n}")
    return NodeMesh((dev,) * n)
