"""Bytecode decoder + control-flow classification for the static analyzer
(counterpart of ``repro.analysis.cfg``).

The runtime's fetch/decode (``interp.Interpreter._fetch`` / ``_keys`` and
the vmloop kernel's ``Vm::step``) is mirrored here *exactly*, on host ints,
so the verifier reasons about the same program the kernels execute:

* a cell is a signed int32; ``tag = cell & 3`` and the payload is the
  *arithmetic* shift ``cell >> 2`` (what ``(instr >> 2).astype(int32)``
  computes on the device) — except ``TAG_CALL``, whose encoder never sign-
  normalizes, so its target is the unsigned ``(cell & 0xFFFFFFFF) >> 2``;
* a ``TAG_OP`` payload is clipped to ``0..num_ops`` before dispatch, so a
  *negative* payload executes ``nop`` and a payload ``>= num_ops`` lands in
  the FIOS-or-trap branch (``>= FIOS_BASE`` suspends for the host syscall
  plane, anything else raises ``EXC_TRAP``);
* ``branch``/``0branch``/``doloop``/``dlit`` read one *raw* operand cell at
  ``pc + 1``; ``prstr`` reads a length cell clipped to ``PRSTR_MAX`` and
  skips that many payload cells.

:class:`Instr` is the single decoded-instruction record both the verifier
(`repro_torch.analysis.verifier`) and the feasibility pass
(`repro_torch.analysis.feasibility`) consume; ``trace_kind`` reproduces the
trace-JIT's ``(tag, opcode)`` branch-set element byte for byte
(``core/vm/trace.py``, as the reference's).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.vm.spec import (
    FIOS_BASE,
    ISA,
    TAG_CALL,
    TAG_LIT,
    TAG_OP,
    TAG_RESERVED,
    get_isa,
)

# The runtime clips an inline ``prstr`` string to 64 cells when skipping it.
PRSTR_MAX = 64

# TAG_OP words that consume one raw operand cell at pc + 1.
OPERAND_WORDS = frozenset({"branch", "0branch", "doloop", "dlit", "prstr"})

# Words that end the current activation record / task outright.
TERMINAL_WORDS = frozenset({"halt", "end"})

# Words whose suspension resumes at pc + 1 with the declared net effect
# already applied by the host service (IO plane) or the scheduler wake.
SUSPEND_WORDS = frozenset({"out", "in", "send", "receive", "sleep", "yield"})


@dataclass(frozen=True)
class Instr:
    """One decoded cell (plus operands) at ``pc`` — the CFG node."""

    pc: int
    cell: int              # raw signed int32 cell value
    tag: int
    payload: int           # arithmetic cell >> 2 (TAG_CALL: unsigned)
    size: int              # cells occupied, incl. operand/string payload
    name: str | None       # word name for in-range TAG_OP, else None
    operand: int | None    # raw operand cell for OPERAND_WORDS, else None

    @property
    def is_op(self) -> bool:
        return self.tag == TAG_OP

    @property
    def is_lit(self) -> bool:
        return self.tag == TAG_LIT

    @property
    def is_call(self) -> bool:
        return self.tag == TAG_CALL

    @property
    def next_pc(self) -> int:
        return self.pc + self.size

    def trace_kind(self, num_ops: int) -> tuple[int, int]:
        """The trace-JIT branch-set element for this cell (byte-identical
        to the reference recorder's ``kinds_raw``)."""
        if self.tag == TAG_OP:
            return (TAG_OP, min(max(self.payload, 0), num_ops))
        return (self.tag, -1)

    def label(self) -> str:
        """Human-readable mnemonic for diagnostics and CLI dumps."""
        if self.tag == TAG_LIT:
            return f"lit {self.payload}"
        if self.tag == TAG_CALL:
            return f"call {self.payload}"
        if self.tag == TAG_RESERVED:
            return "reserved"
        if self.name is None:
            return f"op#{self.payload}"
        if self.operand is not None:
            return f"{self.name} {self.operand}"
        return self.name


def decode(cs: np.ndarray, pc: int, isa: ISA | None = None) -> Instr:
    """Decode the instruction at ``pc`` from a host code-segment array.

    ``pc`` must be in bounds (the caller checks — an out-of-bounds pc is a
    *control-flow* diagnostic, not a decode error).  Operand cells past the
    end of CS decode as ``None`` (the verifier turns that into an error).
    """
    isa = isa or get_isa()
    n = len(cs)
    cell = int(np.int32(cs[pc]))
    tag = cell & 3
    if tag == TAG_CALL:
        payload = (cell & 0xFFFFFFFF) >> 2
        return Instr(pc, cell, tag, payload, 1, None, None)
    payload = cell >> 2
    if tag != TAG_OP:
        return Instr(pc, cell, tag, payload, 1, None, None)
    eff = min(max(payload, 0), isa.num_ops)
    name = isa.name[eff] if eff < isa.num_ops else None
    if name in OPERAND_WORDS:
        operand = int(np.int32(cs[pc + 1])) if pc + 1 < n else None
        size = 2
        if name == "prstr":
            size = 2 + min(max(operand or 0, 0), PRSTR_MAX)
        return Instr(pc, cell, tag, payload, size, name, operand)
    return Instr(pc, cell, tag, payload, 1, name, None)


def classify_fios(payload: int, num_ops: int) -> str | None:
    """For a TAG_OP payload outside ``0..num_ops-1``: ``"fios"`` when it
    reaches the host syscall plane, ``"trap"`` when it raises EXC_TRAP,
    ``None`` when it is an ordinary (or clipped-to-nop) opcode."""
    if payload >= FIOS_BASE:
        return "fios"
    if payload >= num_ops:
        return "trap"
    return None
