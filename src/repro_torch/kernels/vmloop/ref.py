"""The vmloop kernel's contract and its plain PyTorch version.

Counterpart of ``repro.kernels.vmloop.ref``: the kernel-visible
:class:`CoreState` (24 VMState fields), the constant :class:`Tables`, the
opcode claim (``SUPPORTED_WORDS`` / ``BAILOUT_WORDS``, identical to the
reference so the bail histograms stay comparable) and the plain loop.

Unlike the reference, the port does not carry an independent second
transliteration of the step semantics: the JAX package is the independent
check.  The plain version ``run_core`` is the batched interpreter's
``vmloop`` (``repro_torch.core.vm.interp``) with the claim mask on — it
runs over a ``CoreState`` directly because the claimed opcodes touch only
CoreState fields — and the CUDA kernel (``vmloop.py``) is held against it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.config import VMConfig
from repro_torch.core.fixedpoint.luts import LOG10_LUT, SGLUT13, SGLUT310, _SIN_QUARTER
from repro_torch.core.vm.interp import STACK_NEEDS, interp_for
from repro_torch.core.vm.spec import ISA, get_isa

# VMState fields the claimed opcode set can read or write, in VMState order.
CORE_FIELDS = (
    "cs", "mem", "ds", "rs", "fs",
    "dsp", "rsp", "fsp", "pc", "tstatus",
    "timeout", "ev_addr", "ev_val",
    "catch_pc", "catch_rsp", "pending_exc", "last_exc",
    "io_op", "handlers", "cur", "now", "steps",
    "out", "outp",
)
SCALAR_FIELDS = ("cur", "now", "steps", "outp")
READONLY_FIELDS = ("cur", "now")      # never written by a claimed opcode
MUTATED_FIELDS = tuple(f for f in CORE_FIELDS if f not in READONLY_FIELDS)


class Tables(NamedTuple):
    """Constant dispatch + LUT tables, all int32: the claim mask ``sup`` and
    the stack-effect pre-check ``din``/``dout``/``fin``/``fout`` (each
    ``(num_ops + 1,)``), and the LUTs ``log10`` (90), ``sg13`` (24),
    ``sg310`` (6), ``sinq`` (256)."""

    sup: object
    din: object
    dout: object
    fin: object
    fout: object
    log10: object
    sg13: object
    sg310: object
    sinq: object


class CoreState(NamedTuple):
    """The kernel-visible machine state, stacked over nodes (see CORE_FIELDS)."""

    cs: torch.Tensor          # (N, CS)
    mem: torch.Tensor         # (N, MEM)
    ds: torch.Tensor          # (N, T, DS)
    rs: torch.Tensor          # (N, T, RS)
    fs: torch.Tensor          # (N, T, FS)
    dsp: torch.Tensor         # (N, T)
    rsp: torch.Tensor         # (N, T)
    fsp: torch.Tensor         # (N, T)
    pc: torch.Tensor          # (N, T)
    tstatus: torch.Tensor     # (N, T)
    timeout: torch.Tensor     # (N, T)
    ev_addr: torch.Tensor     # (N, T)
    ev_val: torch.Tensor      # (N, T)
    catch_pc: torch.Tensor    # (N, T)
    catch_rsp: torch.Tensor   # (N, T)
    pending_exc: torch.Tensor # (N, T)
    last_exc: torch.Tensor    # (N, T)
    io_op: torch.Tensor       # (N, T)
    handlers: torch.Tensor    # (N, NUM_EXC)
    cur: torch.Tensor         # (N,)  read-only
    now: torch.Tensor         # (N,)  read-only
    steps: torch.Tensor       # (N,)
    out: torch.Tensor         # (N, 2 * OUTN)
    outp: torch.Tensor        # (N,)


# --- opcode classification (must partition the whole word list) -------------

SUPPORTED_WORDS = (
    "nop", "dup", "drop", "swap", "over", "rot", "nip", "tuck", "pick",
    "2dup", "2drop", "depth",
    "+", "-", "*", "/", "mod", "*/", "negate", "abs", "min", "max",
    "1+", "1-", "2*", "2/",
    "=", "<>", "<", ">", "<=", ">=", "0=", "0<", "0>",
    "and", "or", "xor", "invert", "lshift", "rshift",
    "@", "!", "+!", "get", "put", "push", "pop", "len", "fill",
    "branch", "0branch", "ret", "exit", "exec",
    "doinit", "doloop", "i", "j", "unloop", "halt", "end",
    "dlit",
    ".", "emit", "cr", "prstr", "vecprint",
    # IO suspension runs in-kernel (pc rewind + io_op + ST_IOWAIT); delivery
    # stays with the host service and the router.
    "out", "in", "send", "receive",
    "yield", "sleep", "await", "taskid", "ms", "steps",
    "exception", "catch", "throw",
    "sin", "log", "sigmoid", "relu", "sqrt",
    "vecload", "vecscale", "vecadd", "vecmul", "vecfold", "vecmap",
    "dotprod", "vecmax", "hull", "lowp", "highp",
)

BAILOUT_WORDS = (
    # task spawn writes prio/deadline (outside CoreState); rnd advances the
    # LCG (outside CoreState).  Kept declined as in the reference.
    "task", "rnd",
)


def supported_mask(isa: ISA | None = None) -> np.ndarray:
    """(num_ops + 1,) bool: kernel-claimed opcodes.  Index ``num_ops`` (FIOS
    calls and traps) is always False.  Raises if an ISA word is
    unclassified or listed twice."""
    isa = isa or get_isa()
    sup, bail = set(SUPPORTED_WORDS), set(BAILOUT_WORDS)
    both = sup & bail
    if both:
        raise RuntimeError(f"words claimed and declined: {sorted(both)}")
    mask = np.zeros(isa.num_ops + 1, bool)
    for code in range(isa.num_ops):
        nm = isa.name[code]
        if nm in sup:
            mask[code] = True
        elif nm not in bail:
            raise RuntimeError(
                f"ISA word {nm!r} is neither in SUPPORTED_WORDS nor "
                f"BAILOUT_WORDS — classify it for the vmloop kernel"
            )
    return mask


def make_tables(isa: ISA | None = None) -> Tables:
    """Numpy dispatch + LUT tables for one ISA (see :class:`Tables`)."""
    isa = isa or get_isa()
    num_ops = isa.num_ops
    need = np.zeros((4, num_ops + 1), np.int32)
    for code in range(num_ops):
        need[:, code] = STACK_NEEDS.get(isa.name[code], (0, 0, 0, 0))
    return Tables(
        sup=supported_mask(isa).astype(np.int32),
        din=need[0].copy(), dout=need[1].copy(),
        fin=need[2].copy(), fout=need[3].copy(),
        log10=np.asarray(LOG10_LUT, np.int32),
        sg13=np.asarray(SGLUT13, np.int32),
        sg310=np.asarray(SGLUT310, np.int32),
        sinq=np.asarray(_SIN_QUARTER, np.int32),
    )


def device_tables(isa: ISA | None, device) -> Tables:
    return Tables(*[torch.as_tensor(t, device=device) for t in make_tables(isa)])


# --- VMState <-> CoreState ---------------------------------------------------

def core_of(S) -> CoreState:
    """The kernel-visible fields of a stacked state (the same tensors, not
    copies: the kernel updates them in place)."""
    return CoreState(*[getattr(S, f) for f in CORE_FIELDS])


def merge_core(S, core: CoreState):
    """Write the kernel's mutated fields back into the full state."""
    return S._replace(**{f: getattr(core, f) for f in MUTATED_FIELDS})


# --- the plain loop ------------------------------------------------------------

def check_instance(obs: bool, elide_checks: bool) -> None:
    """Raise for ``obs`` with ``elide_checks``: the counting instance runs
    with the checks on, and the reference never builds that pair."""
    if obs and elide_checks:
        raise ValueError("vmloop: the counting instance runs with the checks on "
                         "(obs=True with elide_checks=True is not an instance)")


def run_core(core: CoreState, tb: Tables, steps: int, cfg: VMConfig, isa: ISA | None = None,
             rows: torch.Tensor | None = None, budget: torch.Tensor | None = None,
             obs: bool = False, elide_checks: bool = False):
    """Per row, up to its budget of instructions of the node's current
    task, stopping on the budget, a status change, or *before* the first
    declined opcode.  Updates ``core`` in place and returns ``(core, n_exec,
    bailed, bail_op)``, each of the last three (R,) int32, as the
    reference's ``run_core``: ``bail_op`` is -1 where the row did not bail,
    else the declined opcode (``num_ops`` for FIOS calls and traps).

    Without ``rows`` row j is node j (R = N); with it, row j is node
    ``rows[j]`` (distinct; a row outside [0, N) runs nothing).  Row j runs
    up to ``budget[j]`` instructions, or ``steps`` without a budget.

    ``obs=True`` is the counting instance's plain version, the reference's
    ``make_run_core(obs=True)``: a fifth output ``op_hist`` (R, num_ops + 4)
    int32 counts each row's retired instructions by bin
    (``repro_torch.obs.metrics``); the declined instruction a row stops
    before is not retired and not counted.

    ``elide_checks=True`` is the checks-elided instance's plain version,
    the reference's ``make_run_core(elide_checks=True)``: the interpreter's
    ``vmloop`` with the stack pre-check and the literal push's overflow
    test dropped (``Interpreter(elide_checks=True)``).  The reference never
    builds it with ``obs``, and neither does the port."""
    check_instance(obs, elide_checks)
    it = interp_for(cfg, isa, elide_checks)
    N = core.pc.shape[0]
    dev = core.pc.device
    hist = torch.zeros(N, it.num_ops + 4, dtype=torch.int32, device=dev) if obs else None
    if rows is None and budget is None:
        n_exec, bailed, bail_op = it.vmloop(core, steps, sup=tb.sup, hist=hist)
        return (core, n_exec, bailed, bail_op) + ((hist,) if obs else ())
    if rows is None:
        rows = torch.arange(N, dtype=torch.int32, device=dev)
    ok = (rows >= 0) & (rows < N)
    node = torch.clamp(rows, 0, N - 1).long()
    active = torch.zeros(N, dtype=torch.bool, device=dev)
    active[node[ok]] = True
    per_node = torch.zeros(N, dtype=torch.int32, device=dev)
    per_node[node[ok]] = (budget if budget is not None
                          else torch.full_like(rows, int(steps)))[ok]
    n_exec, bailed, bail_op = it.vmloop(core, steps, active=active, budget=per_node, sup=tb.sup,
                                        hist=hist)
    out = (core, torch.where(ok, n_exec[node], 0), torch.where(ok, bailed[node], 0),
           torch.where(ok, bail_op[node], -1))
    if obs:
        out += (torch.where(ok[:, None], hist[node], 0),)
    return out


def vmloop_ref(S, steps: int, cfg: VMConfig, isa: ISA | None = None, obs: bool = False,
               elide_checks: bool = False):
    """The plain version over a stacked state: ``run_core`` on its
    CoreState.  Returns ``(S, n_exec, bailed, bail_op)``, and ``op_hist``
    with ``obs=True``; ``S`` is updated in place."""
    core = core_of(S)
    core, *out = run_core(core, device_tables(isa, S.pc.device), steps, cfg, isa, obs=obs,
                          elide_checks=elide_checks)
    return (merge_core(S, core), *out)
