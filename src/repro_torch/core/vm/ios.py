"""Input-Output System (paper §3.6, Def. 2): the VM's foreign interface.

``FiosRegistry``  — host functions bridged into the word set (fiosAdd);
                    a deprecation shim over the numbered SVC table in
                    ``repro_torch.exec.syscalls`` (opcode = ``FIOS_BASE`` +
                    the syscall number, so the bytecode a frame compiles to
                    equals the reference's).
``DiosRegistry``  — host data arrays mapped into the VM address space at
                    ``MEM_BASE`` (diosAdd); e.g. the ADC sample buffer.
``HostLink``      — host-side message bus between REXAVM nodes: wires each
                    node's ``send`` into the destination's ``recv_queue``.
``FleetIOService``— partial-state IO service for the fleet: it gathers only
                    the suspended nodes' rows of the stacked device state,
                    services them through the ordinary per-node frontends
                    and scatters the rows back.

Device-side execution of a FIOS word suspends the task (``ST_IOWAIT`` — the
paper's "leaving the current VM interpreter loop round"); the host service
loop pops arguments from the data stack, invokes the callback, pushes the
result, and resumes (the nested execution loop of paper Fig. 10).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Callable, Optional

import numpy as np

from repro_torch.core.vm.spec import MEM_BASE

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.core.vm.machine import REXAVM


class FiosRegistry:
    """Deprecated name-keyed facade over the numbered SVC table (the
    reference's shim).

    Host callbacks live in :class:`repro_torch.exec.syscalls.SyscallTable`
    (stable syscall numbers, declared arities, vectorized handlers).  ``add``
    forwards into ``table.register`` at the lowest free number, which keeps
    the registration-order opcodes, and ``entries``/``by_name``/``opcode``/
    ``entry_for_opcode`` read straight through, so the compiler and
    ``REXAVM._service_io`` see the table.  New code registers through
    ``vm.fios.table.register(...)`` or ``REXAVM.svc_add``.
    """

    def __init__(self):
        # Imported here: exec.syscalls imports this module (FleetIOService).
        from repro_torch.exec.syscalls import SyscallTable

        self.table = SyscallTable()

    @property
    def entries(self):
        return self.table.entries

    @property
    def by_name(self):
        return self.table.by_name

    def add(self, name: str, fn: Callable, args: int = 0, ret: int = 0) -> int:
        """fiosAdd (paper Def. 2).  Returns the assigned opcode.

        Deprecated: registrations land in the numbered syscall table."""
        import warnings

        warnings.warn(
            "FiosRegistry.add is deprecated; register numbered syscalls via "
            "repro_torch.exec.syscalls.SyscallTable (vm.fios.table.register)",
            DeprecationWarning,
            stacklevel=3,
        )
        return self.table.register(name, fn, args=args, ret=ret)

    def opcode(self, name: str) -> Optional[int]:
        return self.table.opcode(name)

    def entry_for_opcode(self, opcode: int):
        return self.table.entry_for_opcode(opcode)


@dataclass
class DiosEntry:
    name: str
    offset: int         # offset of the data (header cell is at offset-1)
    cells: int


class DiosRegistry:
    """Maps named host arrays into ``mem`` at MEM_BASE+offset.

    Layout per entry: [len, data...]; the VM name resolves to the address of
    data[0] so that array header conventions match frame-embedded arrays.
    """

    def __init__(self, mem_size: int):
        self.mem_size = mem_size
        self.free = 0
        self.entries: dict[str, DiosEntry] = {}

    def add(self, name: str, cells: int) -> DiosEntry:
        """diosAdd (paper Def. 2). Reserves [header + cells] in mem."""
        if name in self.entries:
            return self.entries[name]
        need = cells + 1
        if self.free + need > self.mem_size:
            raise MemoryError("DIOS mem exhausted")
        e = DiosEntry(name, self.free + 1, cells)
        self.free += need
        self.entries[name] = e
        return e

    def address(self, name: str) -> Optional[int]:
        e = self.entries.get(name)
        return None if e is None else MEM_BASE + e.offset

    def init_mem(self, mem: np.ndarray) -> None:
        """Write headers for all registered arrays into a mem buffer."""
        for e in self.entries.values():
            mem[e.offset - 1] = e.cells


class FleetIOService:
    """Gather/scatter host-IO service over the fleet's node axis.

    Moves only the suspended rows of the stacked state:

      1. ``take_nodes(S, idx)`` gathers the suspended rows on the device and
         copies just those rows to the host;
      2. each suspended node's host frontend gets its fresh row and runs
         ``REXAVM._service_io(route_net=False)``;
      3. ``put_nodes(S, idx, rows)`` scatters the serviced rows back.

    ``d2h_bytes``/``h2d_bytes`` count the rows actually moved.  On a
    sharded state (``FleetVM(mesh=)``) each suspended row is gathered from
    its own shard straight to the host and scattered back to it, so the
    counters stay the nodes serviced times one node's bytes.
    """

    def __init__(self, nodes: "list[REXAVM]"):
        self.nodes = list(nodes)
        self.services = 0            # service invocations
        self.nodes_serviced = 0      # node rows moved (both directions)
        self.d2h_bytes = 0
        self.h2d_bytes = 0
        self.tracer = None           # optional repro_torch.obs.RoundTracer

    def service(self, S, node_idx) -> tuple[object, bool]:
        """Service host-IO suspensions of ``node_idx`` against the stacked
        device state ``S``.  Returns ``(S, progress)``; ``S`` is updated in
        place.  With a tracer, the service is an ``io_service`` span."""
        tr = self.tracer
        if tr is not None and tr.enabled:
            with tr.span("io_service"):
                return self._service(S, node_idx)
        return self._service(S, node_idx)

    def _gather(self, S, idx: list[int]) -> None:
        """Copy rows ``idx`` of ``S`` into those nodes' host frontends."""
        from repro_torch.core.vm import vmstate as vms

        host = vms.take_nodes(S, idx, device="cpu")
        self.d2h_bytes += vms.state_nbytes(host)
        for j, i in enumerate(idx):
            self.nodes[i].state = vms.unstack(host, j)

    def _scatter(self, S, idx: list[int]) -> None:
        """Write those nodes' host states back into rows ``idx`` of ``S``."""
        from repro_torch.core.vm import vmstate as vms

        back = vms.stack_states([self.nodes[i].state for i in idx])
        self.h2d_bytes += vms.state_nbytes(back)
        vms.put_nodes(S, idx, back)

    def _service(self, S, node_idx) -> tuple[object, bool]:
        node_idx = [int(i) for i in node_idx]
        if not node_idx:
            return S, False
        self._gather(S, node_idx)
        progress = False
        for i in node_idx:
            progress |= self.nodes[i]._service_io(route_net=False)
        self._scatter(S, node_idx)
        self.services += 1
        self.nodes_serviced += len(node_idx)
        return S, progress


class HostLink:
    """Host-routed inter-node message bus (the pre-fleet transport).

    Wires every node's ``on_send`` callback so that ``v dst send`` lands in
    node ``dst``'s ``recv_queue`` tagged with the sender's index;
    out-of-range destinations are dropped and recorded.  ``recv_queue`` is
    unbounded — there is no backpressure.
    """

    def __init__(self, nodes: "list[REXAVM]"):
        self.nodes = list(nodes)
        self.dropped: list[tuple[int, int, int]] = []   # (src, dst, value)
        for src, vm in enumerate(self.nodes):
            vm.on_send = self._make_on_send(src)

    def _make_on_send(self, src: int) -> Callable[[int, int], None]:
        def on_send(dst: int, value: int) -> None:
            if 0 <= dst < len(self.nodes):
                self.nodes[dst].recv_queue.append((src, value))
            else:
                self.dropped.append((src, dst, value))
        return on_send
