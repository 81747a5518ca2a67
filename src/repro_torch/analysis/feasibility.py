"""Backend-feasibility analysis: which fleet engine fits a verified program
(counterpart of ``repro.analysis.feasibility``).

Three static products drive ``FleetVM(executor="auto")``:

``bail_words``      the program's static opcode footprint intersected with
                    the vmloop kernel's declined set
                    (``kernels.vmloop.ref.BAILOUT_WORDS`` plus the
                    FIOS/trap branch) — exactly the key set the observed
                    ``kernel_stats()["bail_hist"]`` can ever contain, so
                    prediction vs. telemetry is an equality check;
``predict_branch_set``  the trace-JIT compile key for single-path programs:
                    a host simulation of the recorder's fetch walk
                    (stop at the first revisited pc — the closed loop —
                    or at a suspension), producing the identical sorted
                    ``(tag, opcode)`` tuple the reference's recorder builds;
``plan_backend``    the selection policy, the reference's word for word:
                    the vmloop kernel (``"cuda"``, the reference's
                    ``"pallas"``) when it claims the whole footprint,
                    the trace-JIT (``"trace"``, ``core/vm/trace.py``) when
                    every program is a predictable single path, the batched
                    interpreter otherwise — and the checks-elided instance
                    if and only if every live entry verified.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.analysis.cfg import SUSPEND_WORDS, TERMINAL_WORDS, decode
from repro_torch.analysis.verifier import ERROR, VERIFIED, ProgramReport
from repro_torch.core.vm.spec import ISA, STACK_EFFECTS, get_isa


def bail_words(report: ProgramReport) -> frozenset:
    """Predicted ``kernel_stats()["bail_hist"]`` key universe for a
    program: statically reachable words the kernel declines."""
    from repro_torch.kernels.vmloop.ref import BAILOUT_WORDS

    out = {w for w in report.words if w in BAILOUT_WORDS}
    if "fios/trap" in report.words or report.has_fios:
        out.add("fios/trap")
    return frozenset(out)


def predict_branch_set(
    cs, entry: int, isa: ISA | None = None, cap: int = 128
) -> tuple | None:
    """Statically replay the trace recorder's fetch walk from ``entry``.

    Follows the unique successor chain with a small concrete stack (only
    literal flow — enough for ``lit lit doinit`` loop heads and constant
    ``exec``/``0branch`` decisions); stops where the recorder stops: at the
    first *revisited* pc (the closed loop), at a suspension/terminal, or at
    ``cap`` fetched instructions.  Returns the sorted ``(tag, opcode)``
    branch set — byte-identical to the reference recorder's for the same
    path — or ``None`` when the path is not statically predictable (data-
    dependent branch, dynamic target, syscall): such programs are not
    AOT-traceable and deopt to the generic engines.
    """
    kinds, _ = _walk(cs, entry, isa, cap)
    return kinds


def predict_branch_sets(
    cs, entry: int, isa: ISA | None = None, cap: int = 128
) -> tuple:
    """All branch sets the trace engine will ever record for this program:
    the entry trace plus the steady-state loop trace.

    A slice boundary can re-enter execution at *any* pc of the closed
    loop; every rotation of the cycle records the same instruction set, so
    one extra walk from the first revisited pc (the loop head, with no
    entry preamble) covers all of them.  Returns ``()`` when the entry
    path itself is unpredictable.
    """
    first, loop_pc = _walk(cs, entry, isa, cap)
    if first is None:
        return ()
    sets = [first]
    if loop_pc is not None:
        steady, _ = _walk(cs, loop_pc, isa, cap)
        if steady is not None and steady != first:
            sets.append(steady)
    return tuple(sets)


def _walk(
    cs, entry: int, isa: ISA | None, cap: int
) -> tuple[tuple | None, int | None]:
    """Recorder-walk core: ``(branch_set | None, revisited_pc | None)``."""
    isa = isa or get_isa()
    cs = np.asarray(cs)
    CS = len(cs)
    num_ops = isa.num_ops
    pc = int(entry)
    seen: set[int] = set()
    kinds: list[tuple[int, int]] = []
    ds: list = []            # concrete-or-None data stack
    fs: list = []            # concrete-or-None FOR stack
    rs: list = []            # concrete return pcs (calls followed inline)

    def pop(n):
        vals = []
        for _ in range(n):
            vals.append(ds.pop() if ds else None)
        return vals[::-1]

    loop_pc: int | None = None
    for _ in range(cap):
        if not 0 <= pc < CS:
            break
        if pc in seen:
            loop_pc = pc
            break
        seen.add(pc)
        ins = decode(cs, pc, isa)
        kinds.append(ins.trace_kind(num_ops))
        if ins.is_lit:
            ds.append(ins.payload)
            pc += 1
            continue
        if ins.is_call:
            rs.append(pc + 1)
            pc = ins.payload
            continue
        if not ins.is_op or ins.payload >= num_ops or ins.payload < 0:
            return None, None                # reserved / fios / trap / nop-clip
        name = ins.name
        if name in TERMINAL_WORDS or name in SUSPEND_WORDS or name in (
            "await", "throw", "halt",
        ):
            break                            # recorder stops on status change
        if name in ("ret", "exit"):
            if not rs:
                break                        # top-level return: path ends
            pc = rs.pop()
            continue
        if name == "branch":
            pc = int(ins.operand) if ins.operand is not None else -1
            continue
        if name == "0branch":
            (flag,) = pop(1)
            if flag is None:
                return None, None            # data-dependent branch
            pc = int(ins.operand) if flag == 0 else pc + 2
            continue
        if name == "doinit":
            limit, start = pop(2)
            fs.append(limit)
            fs.append(start)
            pc += 1
            continue
        if name == "doloop":
            if len(fs) < 2 or fs[-1] is None or fs[-2] is None:
                return None, None
            fs[-1] += 1
            if fs[-1] >= fs[-2]:
                fs.pop(); fs.pop()
                pc += 2
            else:
                pc = int(ins.operand)
            continue
        if name == "exec":
            (tgt,) = pop(1)
            if tgt is None:
                return None, None
            rs.append(pc + 1)
            pc = int(tgt)
            continue
        if name in STACK_EFFECTS:
            din, dout, fin, fout = STACK_EFFECTS[name]
            # Only structural words keep constants; computed results are
            # unknown (a dup keeps the copy — cheap and common in loops).
            if name == "dup" and ds:
                ds.append(ds[-1])
            else:
                pop(din)
                ds.extend([None] * dout)
            for _ in range(fin):
                if fs:
                    fs.pop()
            fs.extend([None] * fout)
            pc = ins.next_pc
            continue
        return None, None
    return (tuple(sorted(set(kinds))) if kinds else None), loop_pc


@dataclass
class BackendPlan:
    """Resolved ``executor="auto"`` decision for one fleet."""

    executor: str
    elide_checks: bool
    reasons: list = field(default_factory=list)
    bail_words: frozenset = frozenset()
    branch_sets: list = field(default_factory=list)  # per node, None = no AOT


def plan_backend(reports, branch_sets=None) -> BackendPlan:
    """Pick the fleet engine from per-node :class:`ProgramReport`s.

    Policy (the reference's): programs with errors run on the
    always-checked batched interpreter (nothing is elided, every runtime
    guard stays); a footprint the vmloop kernel fully claims runs on the
    card (``"cuda"``); fleets whose every program is a predictable single
    path run trace-specialized (``"trace"``); everything else takes the
    batched engine.  Checks are elided only when *every* entry of every
    node verified.
    """
    reasons: list[str] = []
    predicted = frozenset().union(*(bail_words(r) for r in reports)) \
        if reports else frozenset()
    all_verified = bool(reports) and all(
        r.verdict == VERIFIED for r in reports
    )
    if any(r.verdict == ERROR for r in reports):
        reasons.append("verifier errors: checked batched engine, no elision")
        return BackendPlan("batched", False, reasons, predicted,
                           list(branch_sets or []))
    if not predicted:
        reasons.append("no bail-out words in the static footprint: cuda")
        ex = "cuda"
    elif branch_sets and all(bs is not None for bs in branch_sets):
        reasons.append("single-path programs with bail-out words: trace")
        ex = "trace"
    else:
        reasons.append("bail-out words in footprint, not single-path: batched")
        ex = "batched"
    elide = all_verified and ex in ("batched", "cuda")
    if elide:
        reasons.append("all entries verified: stack checks elided")
    return BackendPlan(ex, elide, reasons, predicted, list(branch_sets or []))
