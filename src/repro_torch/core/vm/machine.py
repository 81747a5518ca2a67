"""REXAVM facade — the system call-gate interface (paper §3.7, Fig. 7a).

Counterpart of ``repro.core.vm.machine``: compiler + executor + IOS
registries behind one object.  The host application compiles code frames,
runs micro-slices on the device, services FIOS calls and host streams
between slices (the nested IO service loop of Fig. 10), and reads the
output ring.  The host-canonical state is a single ``VMState`` of CPU
tensors.  Slices run on one of four backends (``executor.make_executor``):

  * ``torch``  — the batched interpreter on ``device`` (the state is copied
                 there and back for each slice);
  * ``oracle`` — the plain-Python reference, in place on the host state;
  * ``cuda``   — the vmloop kernel with the hand-back of declined words (the
                 reference's ``"pallas"``), copied as ``torch``; its
                 executor counts ``kernel_steps``, ``bailouts``, ``bail_hist``;
  * ``trace``  — the trace-JIT (``core/vm/trace.py``): the node's recorded
                 path as guarded specialized steps, the kernel as the tail.

All give byte-identical states.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.config import VMConfig
from repro_torch.core.vm import vmstate as vms
from repro_torch.core.vm.compiler import Compiler
from repro_torch.core.vm.executor import make_executor
from repro_torch.core.vm.frames import CodeFrame, FrameManager
from repro_torch.core.vm.ios import DiosRegistry, FiosRegistry
from repro_torch.core.vm.spec import (
    FIOS_BASE,
    ISA,
    ST_DONE,
    ST_ERR,
    ST_EVENT,
    ST_HALT,
    ST_IOWAIT,
    ST_SLEEP,
    ST_YIELD,
    get_isa,
)
from repro_torch.core.vm.vmstate import VMState, resolve_device  # noqa: F401  (re-exported)


@dataclass
class RunResult:
    slices: int
    steps: int
    status: str          # done | halt | error | deadlock | budget
    output: str


class REXAVM:
    """One VM node (paper mode 1: library embedded in a host application).

    ``device=None`` runs the slices on CUDA and raises when there is none;
    ``device="cpu"`` runs them on the CPU."""

    def __init__(
        self,
        cfg: VMConfig | None = None,
        backend: str = "torch",
        isa: ISA | None = None,
        lookup: str = "pht",
        seed: int = 1,
        device=None,
    ):
        self.cfg = cfg or VMConfig()
        self.isa = isa or get_isa()
        self.backend = backend
        self.device = resolve_device(device)
        self.fios = FiosRegistry()
        self.dios = DiosRegistry(self.cfg.mem_size)
        self.compiler = Compiler(self.isa, self.fios, self.dios, lookup=lookup)
        self.frames = FrameManager(self.cfg.cs_size)
        self.executor = make_executor(backend, self.cfg, isa, self.device)
        # Backend internals, kept addressable for tests and tools.
        self.interp = getattr(self.executor, "interp", None)
        self.oracle = getattr(self.executor, "oracle", None)
        self.state: VMState = vms.init_state(self.cfg, seed)
        # Cell 0 = canonical `end` (task return-to-zero convention).
        self.state.cs[0] = self.isa.enc_op("end")
        self.frames.allocate(1)  # reserve cell 0
        self.out_stream: list[int] = []
        self.in_queue: list[int] = []
        self.recv_queue: list[tuple[int, int]] = []   # (src, value)
        self.sent: list[tuple[int, int]] = []         # (dst, value)
        self.on_send: Optional[Callable[[int, int], None]] = None
        self._op_out = self.isa.opcode["out"]
        self._op_in = self.isa.opcode["in"]
        self._op_send = self.isa.opcode["send"]
        self._op_receive = self.isa.opcode["receive"]

    # -- IOS (paper Def. 2) ----------------------------------------------------

    def fios_add(self, name: str, fn: Callable, args: int = 0, ret: int = 0) -> int:
        return self.fios.add(name, fn, args, ret)

    def svc_add(self, name: str, fn: Callable, args: int = 0, ret: int = 0,
                num: int | None = None, vectorized: bool = False) -> int:
        """Register a numbered syscall (the non-deprecated ``fios_add``).
        ``num`` pins a syscall number (fleet services share one across
        nodes); ``vectorized`` marks an ``fn(rows, svc)`` batch handler for
        :class:`repro_torch.exec.syscalls.VectorSyscallService`.  Returns
        the opcode."""
        return self.fios.table.register(name, fn, args=args, ret=ret, num=num,
                                        vectorized=vectorized)

    def dios_add(self, name: str, data) -> int:
        """Register a host array; returns its VM address."""
        if isinstance(data, int):
            cells, arr = data, None
        else:
            arr = np.asarray(data, dtype=np.int32)
            cells = arr.shape[0]
        e = self.dios.add(name, cells)
        mem = self.state.mem.numpy()
        mem[e.offset - 1] = cells
        if arr is not None:
            mem[e.offset : e.offset + cells] = arr
        return self.dios.address(name)

    def dios_read(self, name: str) -> np.ndarray:
        e = self.dios.entries[name]
        return self.state.mem.numpy()[e.offset : e.offset + e.cells].copy()

    def dios_write(self, name: str, data) -> None:
        e = self.dios.entries[name]
        arr = np.asarray(data, dtype=np.int32)
        self.state.mem.numpy()[e.offset : e.offset + len(arr)] = arr

    # -- code frames -------------------------------------------------------------

    def load(self, text: str, persistent: bool = False) -> CodeFrame:
        """Compile an active message (text code frame) into the CS."""
        return self.compiler.compile_frame(text, self.state.cs.numpy(), self.frames, persistent)

    def remove(self, frame: CodeFrame) -> bool:
        ok = self.frames.remove(frame)
        if ok:
            self.compiler.dictionary.drop_frame(frame.fid)
        return ok

    # -- execution ----------------------------------------------------------------

    def launch(self, frame: CodeFrame, task: int = 0, prio: int = 0, deadline: int = 0) -> None:
        vms.launch_task(self.state, task, frame.entry, prio, deadline)

    def _slice(self, steps: int) -> None:
        self.state = self.executor.run_slice(self.state, steps)

    def _service_io(self, route_net: bool = True) -> bool:
        """Service FIOS/stream suspensions.  Returns True if any progress.

        ``route_net=False`` leaves ``send``/``receive`` suspensions alone —
        the fleet routes those through the mailbox rings instead."""
        st = self.state
        ds = st.ds.numpy()
        dsp = st.dsp.numpy()
        pc = st.pc.numpy()
        io_op = st.io_op.numpy()
        tstatus = st.tstatus.numpy()
        progress = False
        for t in range(self.cfg.max_tasks):
            if int(tstatus[t]) != ST_IOWAIT or int(io_op[t]) == 0:
                continue
            opcode = int(io_op[t])
            if not route_net and opcode in (self._op_send, self._op_receive):
                continue

            def resume():
                io_op[t] = 0
                pc[t] = int(pc[t]) + 1
                tstatus[t] = ST_YIELD

            def pop(n):
                vals = tuple(int(ds[t, max(int(dsp[t]) - n + k, 0)]) for k in range(n))
                dsp[t] -= n
                return vals

            def push(v):
                ds[t, min(int(dsp[t]), self.cfg.ds_size - 1)] = np.int32(v)
                dsp[t] += 1

            if opcode >= FIOS_BASE:
                entry = self.fios.entry_for_opcode(opcode)
                args = pop(entry.args) if entry.args else ()
                r = entry.fn(*args)
                if entry.ret:
                    push(int(r) if r is not None else 0)
                resume()
                progress = True
            elif opcode == self._op_out:
                (v,) = pop(1)
                self.out_stream.append(v)
                resume()
                progress = True
            elif opcode == self._op_in:
                if self.in_queue:
                    push(self.in_queue.pop(0))
                    resume()
                    progress = True
            elif opcode == self._op_send:
                v, dst = pop(2)
                self.sent.append((dst, v))
                if self.on_send is not None:
                    self.on_send(dst, v)
                resume()
                progress = True
            elif opcode == self._op_receive:
                if self.recv_queue:
                    src, v = self.recv_queue.pop(0)
                    push(src)
                    push(v)
                    resume()
                    progress = True
        return progress

    def run(
        self,
        frame: CodeFrame | None = None,
        max_slices: int = 10_000,
        steps: int | None = None,
    ) -> RunResult:
        """Drive the VM to completion (the host application's IO loop)."""
        if frame is not None:
            self.launch(frame)
        steps = steps or self.cfg.steps_per_slice
        start_steps = int(self.state.steps)
        slices = 0
        status = "budget"
        while slices < max_slices:
            before = int(self.state.steps)
            self._slice(steps)
            slices += 1
            executed = int(self.state.steps) - before
            # Virtual clock from the calibrated per-instruction time.
            self.state.now.fill_(int(self.state.now) + max(1, executed * self.cfg.us_per_instr // 1000))
            io_progress = self._service_io()
            sts = [int(s) for s in self.state.tstatus]
            if sts[0] == ST_ERR:
                status = "error"
                break
            if sts[0] == ST_HALT:
                status = "halt"
                break
            runnable = ST_YIELD in sts
            waiting = [i for i, s in enumerate(sts) if s in (ST_SLEEP, ST_EVENT)]
            iowait = ST_IOWAIT in sts
            if sts[0] == ST_DONE and not runnable and not waiting and not iowait:
                status = "done"
                break
            if not runnable and not io_progress and not iowait:
                if waiting:
                    # Virtual-time warp to the earliest wake-up.
                    wake = min(int(self.state.timeout[i]) for i in waiting)
                    if wake > int(self.state.now):
                        self.state.now.fill_(wake)
                    elif all(
                        sts[i] == ST_EVENT and int(self.state.timeout[i]) <= int(self.state.now)
                        for i in waiting
                    ):
                        status = "deadlock"      # an event nobody will deliver
                        break
                elif executed == 0:
                    status = "deadlock"
                    break
        return RunResult(
            slices=slices,
            steps=int(self.state.steps) - start_steps,
            status=status,
            output=self.output(),
        )

    def eval(self, text: str, **kw) -> RunResult:
        """Compile + run + auto-remove (paper single-tasking incremental mode)."""
        frame = self.load(text)
        res = self.run(frame, **kw)
        self.remove(frame)
        return res

    # -- output -------------------------------------------------------------------

    def output(self) -> str:
        s = vms.decode_output(self.state)
        vms.clear_output(self.state)
        return s

    # -- checkpointing (paper resilience feature 5: stop-and-go) ----------------

    def checkpoint(self) -> dict:
        """Snapshot the full machine state (host side): ``state`` a
        ``VMState`` of numpy arrays with the reference's dtypes (``rng``
        uint32), ``now`` the virtual clock."""
        return {"state": vms.to_reference(self.state), "now": int(self.state.now)}

    def restore(self, ckpt: dict) -> None:
        """Load a snapshot from ``checkpoint`` (or the reference's, whose
        ``state`` is numpy arrays of the same fields)."""
        self.state = vms.from_reference(ckpt["state"], "cpu")
