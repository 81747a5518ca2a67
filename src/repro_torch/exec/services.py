"""First-party vectorized syscalls: UART, FS, and CAN (counterpart of
``repro.exec.services``).

Each service is one object shared by every node in the fleet and registered
at a *pinned* syscall number (the published SVC ABI below), so a single
handler invocation serves the whole fleet's batch — the
``VectorSyscallService`` calls it once per round-chunk regardless of how
many nodes suspended on it.

====  ============  =====================  =================================
num   word          stack effect           host binding
====  ============  =====================  =================================
56    ``uart.write``  ``(v --)``           per-node ``out_stream`` (the sink
                                           ``serve/vmhook.py`` reports) plus
                                           a fleet-wide tagged stream
57    ``fs.save``     ``(tag -- ckptid)``  one ``CheckpointManager.save`` for
                                           the *whole batch* of requesters
58    ``can.send``    ``(v id --)``        host CAN bus: id-subscribed nodes
                                           get ``(src, v)`` posted into their
                                           mailbox rings (lossy when full)
====  ============  =====================  =================================

``install_services(nodes, ...)`` registers the trio on every node's table;
programs then use the words directly (``42 uart.write``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

SVC_UART = 56
SVC_FS = 57
SVC_CAN = 58


class UARTService:
    """``uart.write (v --)``: batched serial sink.

    Values land on the writing node's ``out_stream`` — the exact stream
    ``serve.vmhook.FleetServeMonitor.reports()`` renders — and on the
    service's fleet-wide ``stream`` as ``(node, value)`` in deterministic
    (node, task) order.
    """

    name = "uart.write"
    num = SVC_UART

    def __init__(self):
        self.stream: list[tuple[int, int]] = []
        self.writes = 0
        self.batches = 0

    def __call__(self, rows, svc):
        self.batches += 1
        for row in rows:
            (v,) = row.args
            row.vm.out_stream.append(v)
            self.stream.append((row.node, v))
            self.writes += 1
        return None


class FSService:
    """``fs.save (tag -- ckptid)``: batched checkpoint store.

    All nodes that requested a save in the same round-chunk share one
    atomic ``CheckpointManager.save`` (tmp + fsync + rename); every
    requester gets the same monotonic checkpoint id back on its stack.
    The saved tree maps ``node<i>`` to that node's tag and DIOS memory.
    """

    name = "fs.save"
    num = SVC_FS

    def __init__(self, manager):
        self.manager = manager          # repro_torch.resilience.CheckpointManager
        self.saves = 0                  # handler invocations (= checkpoints)
        self.requests = 0               # rows serviced
        self._next_id = 0

    def __call__(self, rows, svc):
        self._next_id += 1
        ckpt_id = self._next_id
        tree = {
            f"node{row.node}": {
                "tag": np.int32(row.args[0]),
                "mem": np.asarray(row.vm.state.mem),
            }
            for row in rows
        }
        self.manager.save(ckpt_id, tree, blocking=True)
        self.saves += 1
        self.requests += len(rows)
        return [ckpt_id] * len(rows)


class CANService:
    """``can.send (v id --)``: host CAN bus bridged into mailbox rings.

    Nodes ``subscribe`` to CAN ids; a published frame is posted as a
    ``(src, v)`` mailbox message to every subscriber (consumed on device by
    the ordinary ``receive`` word).  Like a real CAN bus — and unlike the
    fleet's ``send`` backpressure — delivery to a full ring is lossy
    (``VectorSyscallService.post_drops`` counts the losses).
    """

    name = "can.send"
    num = SVC_CAN

    def __init__(self):
        self.subs: dict[int, list[int]] = {}
        self.frames = 0                 # frames published
        self.deliveries = 0             # subscriber posts queued

    def subscribe(self, can_id: int, node: int) -> None:
        self.subs.setdefault(int(can_id), []).append(int(node))

    def __call__(self, rows, svc):
        for row in rows:
            v, can_id = row.args
            self.frames += 1
            for dst in self.subs.get(int(can_id), []):
                svc.post(dst, row.node, v)
                self.deliveries += 1
        return None


class ServiceSet:
    """The installed trio, for test/benchmark introspection."""

    def __init__(self, uart, fs, can):
        self.uart = uart
        self.fs = fs
        self.can = can


def install_services(nodes, checkpoint_manager=None) -> ServiceSet:
    """Register UART/FS/CAN at their pinned numbers on every node.

    ``fs.save`` is skipped when no ``CheckpointManager`` is supplied.
    Returns the shared service objects.
    """
    uart = UARTService()
    fs: Optional[FSService] = (
        FSService(checkpoint_manager) if checkpoint_manager is not None else None
    )
    can = CANService()
    for vm in nodes:
        table = vm.fios.table
        table.register(uart.name, uart, args=1, ret=0, num=uart.num, vectorized=True)
        if fs is not None:
            table.register(fs.name, fs, args=1, ret=1, num=fs.num, vectorized=True)
        table.register(can.name, can, args=2, ret=0, num=can.num, vectorized=True)
    return ServiceSet(uart, fs, can)
