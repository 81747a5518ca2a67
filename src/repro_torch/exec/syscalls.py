"""Numbered syscall plane: the SVC table and its vectorized host service
(counterpart of ``repro.exec.syscalls``).

``SyscallTable``        — the SVC table: every host service gets a stable
                          syscall number with declared arg/ret arity; the
                          word opcode is ``FIOS_BASE + num``, so bytecode and
                          the compiler's name resolution are the reference's.
                          ``FiosRegistry`` (core/vm/ios.py) is a deprecation
                          shim over this table.
``VectorSyscallService``— the host half of the plane: one gather of *all*
                          SVC-suspended node rows, rows grouped by syscall
                          number, **one handler invocation per distinct
                          syscall** for vectorized services (instead of one
                          Python callback per node), then one scatter back.
                          Byte-compatible with the per-node
                          ``REXAVM._service_io`` pop/push/resume semantics.

A *vectorized* handler has signature ``fn(rows, svc)`` where ``rows`` is a
list of :class:`SyscallRow` and ``svc`` is the calling service (handlers use
``svc.post`` to deliver mailbox messages — the CAN bridge).  It returns a
list of return values (one per row) when the syscall declares ``ret``, else
``None``.  Scalar callbacks keep their ``fn(*args)`` signature and are
invoked per row (counted in ``scalar_calls``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import numpy as np

from repro_torch.core.vm import vmstate as vms
from repro_torch.core.vm.ios import FleetIOService
from repro_torch.core.vm.spec import FIOS_BASE, MAX_FIOS, ST_IOWAIT, ST_YIELD


@dataclass
class Syscall:
    """One SVC table row: a stable number with declared arg/ret arity."""

    name: str
    fn: Callable
    args: int = 0           # cells popped from DS
    ret: int = 0            # cells pushed (0 or 1)
    num: int = 0            # stable syscall number; opcode = FIOS_BASE + num
    vectorized: bool = False  # fn(rows, svc) serves a whole batch

    @property
    def opcode(self) -> int:
        return FIOS_BASE + self.num


class SyscallTable:
    """The numbered SVC table.

    ``register`` without an explicit ``num`` allocates the lowest free slot,
    which reproduces the registration-order numbering of ``fios_add``.
    Services that must share a number across every node in a fleet (the
    ``exec.services`` trio) pin ``num``; pinning a slot that is already
    bound to a *different* name is an error.
    """

    def __init__(self):
        # Dense slot list indexed by syscall number; holes (None) appear
        # only between auto-allocated entries and pinned ones.
        self.entries: list[Optional[Syscall]] = []
        self.by_name: dict[str, int] = {}

    def register(self, name: str, fn: Callable, args: int = 0, ret: int = 0,
                 num: int | None = None, vectorized: bool = False) -> int:
        """svcAdd: bind ``name`` to syscall ``num``.  Returns the opcode."""
        if name in self.by_name:
            cur = self.by_name[name]
            if num is not None and num != cur:
                raise ValueError(f"syscall {name!r} already bound to number {cur}, not {num}")
            # Re-registration replaces the callback (incremental updates).
            self.entries[cur] = Syscall(name, fn, args, ret, cur, vectorized)
            return FIOS_BASE + cur
        if num is None:
            num = next((i for i, e in enumerate(self.entries) if e is None), len(self.entries))
            if num >= MAX_FIOS:
                raise RuntimeError("FIOS table full")
        if not 0 <= num < MAX_FIOS:
            raise ValueError(f"syscall number {num} outside 0..{MAX_FIOS - 1}")
        while len(self.entries) <= num:
            self.entries.append(None)
        if self.entries[num] is not None:
            raise ValueError(f"syscall number {num} already bound to {self.entries[num].name!r}")
        self.entries[num] = Syscall(name, fn, args, ret, num, vectorized)
        self.by_name[name] = num
        return FIOS_BASE + num

    def opcode(self, name: str) -> Optional[int]:
        num = self.by_name.get(name)
        return None if num is None else FIOS_BASE + num

    def entry_for_opcode(self, opcode: int) -> Optional[Syscall]:
        return self.entries[opcode - FIOS_BASE]

    def numbers(self) -> dict[str, int]:
        """Name -> stable syscall number (the published SVC ABI)."""
        return dict(self.by_name)


class SyscallRow(NamedTuple):
    """One SVC-suspended (node, task) request, arguments already popped."""

    node: int
    task: int
    num: int
    args: tuple
    vm: object  # the node's REXAVM frontend (handlers may read state/dios)


def _view(vm):
    """Writable numpy views of a node's host state (CPU tensors)."""
    return vms.VMState(*[x.numpy() for x in vm.state])


class VectorSyscallService(FleetIOService):
    """Batched SVC servicing over the fleet's node axis.

    The same gather and scatter as :class:`FleetIOService` (``take_nodes``
    -> ``to_host`` -> rows into the host frontends -> ``stack_states`` ->
    ``put_nodes``), but suspended rows are grouped by syscall number and
    each *vectorized* service is invoked once per group.  ``svc_batches``
    vs ``scalar_calls`` is the batched-vs-per-node comparison.

    Stack effects (pop arity, push, pc advance, ST_YIELD resume) replicate
    ``REXAVM._service_io`` cell for cell.  Rows are collected and resumed in
    (node, task) order; handler *invocation* order is first-seen syscall
    number, which matters only to handlers with cross-node side effects.
    """

    def __init__(self, nodes):
        super().__init__(nodes)
        self.syscalls = 0        # SVC rows serviced
        self.svc_batches = 0     # vectorized handler invocations
        self.scalar_calls = 0    # per-row callback invocations
        self.posts = 0           # mailbox messages delivered (svc.post)
        self.post_drops = 0      # posts dropped on a full ring or a bad node
        self._pending_posts: list[tuple[int, int, int]] = []  # (dst, src, v)

    # -- handler-facing API ----------------------------------------------------

    def post(self, dst: int, src: int, value: int) -> None:
        """Queue a mailbox message for node ``dst`` (delivered after the
        scatter, dropped when its ring is full)."""
        self._pending_posts.append((int(dst), int(src), int(value)))

    # -- service ---------------------------------------------------------------

    def _service(self, S, node_idx):
        node_idx = [int(i) for i in node_idx]
        if not node_idx:
            return S, False
        self._gather(S, node_idx)
        progress = self._service_host(node_idx)
        self._scatter(S, node_idx)
        self.services += 1
        self.nodes_serviced += len(node_idx)
        self._deliver_posts(S)
        return S, progress

    def _service_host(self, node_idx) -> bool:
        groups: dict[int, list[SyscallRow]] = {}
        progress = False
        for i in node_idx:
            vm = self.nodes[i]
            st = _view(vm)
            for t in range(vm.cfg.max_tasks):
                if int(st.tstatus[t]) != ST_IOWAIT or int(st.io_op[t]) == 0:
                    continue
                opcode = int(st.io_op[t])
                if opcode in (vm._op_send, vm._op_receive):
                    continue  # routed on the device by the fleet
                if opcode < FIOS_BASE:
                    progress |= self._builtin(vm, st, t, opcode)
                    continue
                entry = vm.fios.entry_for_opcode(opcode)
                args = self._pop(vm, st, t, entry.args) if entry.args else ()
                num = opcode - FIOS_BASE
                groups.setdefault(num, []).append(SyscallRow(i, t, num, args, vm))
        for num, rows in groups.items():            # first-seen number order
            entries = [r.vm.fios.entry_for_opcode(FIOS_BASE + num) for r in rows]
            if len({id(e.fn) for e in entries}) == 1 and all(e.vectorized for e in entries):
                rets = entries[0].fn(rows, self)
                self.svc_batches += 1
            else:
                rets = [e.fn(*r.args) for e, r in zip(entries, rows)]
                self.scalar_calls += len(rows)
            self.syscalls += len(rows)
            for k, (row, entry) in enumerate(zip(rows, entries)):
                st = _view(row.vm)
                if entry.ret:
                    rv = None if rets is None else rets[k]
                    self._push(row.vm, st, row.task, int(rv) if rv is not None else 0)
                self._resume(st, row.task)
            progress = True
        return progress

    # -- per-row primitives (byte mirrors of REXAVM._service_io) ----------------

    @staticmethod
    def _pop(vm, st, t: int, n: int) -> tuple:
        vals = tuple(int(st.ds[t, max(int(st.dsp[t]) - n + k, 0)]) for k in range(n))
        st.dsp[t] -= n
        return vals

    @staticmethod
    def _push(vm, st, t: int, v: int) -> None:
        st.ds[t, min(int(st.dsp[t]), vm.cfg.ds_size - 1)] = np.int32(v)
        st.dsp[t] += 1

    @staticmethod
    def _resume(st, t: int) -> None:
        st.io_op[t] = 0
        st.pc[t] = int(st.pc[t]) + 1
        st.tstatus[t] = ST_YIELD

    def _builtin(self, vm, st, t: int, opcode: int) -> bool:
        if opcode == vm._op_out:
            (v,) = self._pop(vm, st, t, 1)
            vm.out_stream.append(v)
            self._resume(st, t)
            return True
        if opcode == vm._op_in:
            if vm.in_queue:
                self._push(vm, st, t, vm.in_queue.pop(0))
                self._resume(st, t)
                return True
            return False
        # Unknown builtin: leave the task suspended (as the per-node path).
        return False

    # -- CAN-style mailbox delivery ---------------------------------------------

    def _deliver_posts(self, S) -> None:
        if not self._pending_posts:
            return
        posts, self._pending_posts = self._pending_posts, []
        in_range = [p for p in posts if 0 <= p[0] < len(self.nodes)]
        self.post_drops += len(posts) - len(in_range)
        if not in_range:
            return
        dsts = sorted({p[0] for p in in_range})
        self._gather(S, dsts)
        for dst, src, v in in_range:
            vm = self.nodes[dst]
            st = _view(vm)
            MB = vm.cfg.mbox_size
            if int(st.mbox_wr) - int(st.mbox_rd) >= MB:
                self.post_drops += 1   # lossy bus: no backpressure on CAN
                continue
            slot = int(st.mbox_wr) % MB
            st.mbox[2 * slot] = np.int32(src)
            st.mbox[2 * slot + 1] = np.int32(v)
            st.mbox_wr[...] = int(st.mbox_wr) + 1
            self.posts += 1
        self._scatter(S, dsts)
