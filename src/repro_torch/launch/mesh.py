"""Device meshes for the port (counterpart of ``repro.launch.mesh``).

Only the fleet's node mesh is here: ``make_node_mesh`` returns a
:class:`NodeMesh`, an ordered tuple of ``torch.device``s along one axis
named ``"node"``.  ``FleetVM(mesh=...)`` partitions the leading node axis
of its stacked ``VMState`` over it (``sharding.rules.make_fleet_rules``).
The model meshes (``make_mesh``, ``make_production_mesh``) come with the
model-side sharding rules.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


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
