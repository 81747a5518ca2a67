"""Static bytecode verifier: abstract interpretation over decoded cells
(counterpart of ``repro.analysis.verifier``; the same analysis, verdicts,
WCET and diagnostic text).

The verifier proves, per task entry, that ``EXC_STACK`` is unreachable and
that every control transfer lands on a valid cell — *before* the program
runs.  It is the admission half of the kernel contract: programs it marks
``VERIFIED`` may execute on the checks-elided fast path
(``elide_checks=True`` in ``kernels.vmloop`` / ``core.vm.executor`` /
``core.vm.interp``), where the per-step stack pre-check and the
literal-push bound are compiled out.

Model
-----
Programs are analyzed *per function* (a function = the instruction region
reachable from a ``TAG_CALL`` / constant ``exec`` target up to its
``ret``/``exit``), with a worklist abstract interpretation whose state is

* a data-stack depth interval ``[dlo, dhi]`` relative to function entry,
* a FOR-stack depth interval ``[flo, fhi]``,
* a bounded constant view of the top-of-stack cells (literals survive;
  anything computed becomes unknown) — enough to resolve ``doinit`` trip
  counts, ``exec``/``task`` targets, and ``pick`` depths.

Function summaries (deepest fall below entry, highest rise above it, net
effect at return, return-stack growth, worst-case instruction count) make
the analysis compositional: call sites apply the callee summary instead of
re-walking it, and recursion is detected and *flagged* rather than unrolled.

Verdicts
--------
``VERIFIED``  every path is depth-safe and lands in bounds: stack checks
              may be elided.
``FLAGGED``   nothing provably wrong, but some construct defeats the
              analysis (dynamic ``exec`` target, exception handler binding,
              unknown syscall arity, unconverged loop): run with checks on.
``ERROR``     a path provably (path-insensitively) underflows, overflows,
              jumps out of bounds, or executes a trapping cell: reject.

WCET
----
``wcet`` is an IPET-style sound upper bound on instructions executed from
the entry: every reachable instruction weighted by the product of the trip
counts of its enclosing back-edge regions.  ``do``/``loop`` regions with
literal ``doinit`` bounds contribute ``max(limit - start, 1)``; any other
back edge (``begin``/``again``/``until``) or a non-literal bound makes the
WCET ``None`` — unbounded statically, quantum-bounded at admission
(``repro_torch.exec.Executive.spawn`` then admits on the deadline alone).

Scope: the verifier covers the exceptions the elided kernel checks guard
(``EXC_STACK`` and the literal push bound) plus control-flow validity.
Value-dependent exceptions behind *non-elided* runtime checks (division by
zero, DIOS address bounds, ``pick`` index) stay checked at runtime either
way; a statically unknown ``pick`` depth is flagged, not rejected.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np

from repro_torch.config import VMConfig
from repro_torch.core.vm.spec import (
    FIOS_BASE,
    ISA,
    STACK_EFFECTS,
    TAG_LIT,
    TAG_RESERVED,
    get_isa,
)
from repro_torch.analysis.cfg import TERMINAL_WORDS, Instr, decode

VERIFIED = "verified"
FLAGGED = "flagged"
ERROR = "error"

_RANK = {VERIFIED: 0, FLAGGED: 1, ERROR: 2}

# Worklist joins per pc before the analysis gives up on convergence and
# flags the function (depth-balanced loops stabilize in 2; this bounds
# adversarial net-growing loops).
MAX_JOINS = 64
# Constant top-of-stack cells tracked per abstract state.
CONST_DEPTH = 8


def worst(a: str, b: str) -> str:
    return a if _RANK[a] >= _RANK[b] else b


@dataclass(frozen=True)
class Diagnostic:
    """One source-mapped finding: severity, pc, decoded mnemonic, message,
    and the enclosing function (dictionary name or entry pc)."""

    severity: str          # "error" | "warn"
    pc: int
    label: str             # decoded instruction mnemonic
    message: str
    function: str = ""

    def __str__(self) -> str:
        where = f" in {self.function}" if self.function else ""
        return f"{self.severity}: pc {self.pc} ({self.label}){where}: {self.message}"


@dataclass
class FnSummary:
    """Compositional per-function facts, relative to entry depth 0."""

    entry: int
    name: str
    min_fall_ds: int = 0       # deepest data-stack fall below entry depth
    max_rise_ds: int = 0       # highest post-op depth above entry depth
    min_fall_fs: int = 0
    max_rise_fs: int = 0
    net_ds: tuple[int, int] | None = None   # depth interval at return
    net_fs: tuple[int, int] | None = None
    rs_rise: int = 0           # return-stack growth incl. deepest callee
    wcet: int | None = 0       # worst-case instructions, None = unbounded
    returns: bool = False
    words: set = field(default_factory=set)       # executed word names
    kinds: set = field(default_factory=set)       # trace (tag, opcode) set
    has_fios: bool = False
    spawn_entries: set = field(default_factory=set)  # const `task` targets
    diags: list = field(default_factory=list)
    flagged: bool = False
    # Argmax sites (pc, mnemonic) for the four depth metrics — they become
    # source-mapped diagnostics at entry level, where launch depths and the
    # DS/FS bounds are known.
    _fall_ds_site: tuple | None = None
    _fall_fs_site: tuple | None = None
    _rise_ds_site: tuple | None = None
    _rise_fs_site: tuple | None = None


@dataclass(frozen=True)
class _Abs:
    """Abstract machine state at one pc (depths relative to fn entry)."""

    dlo: int
    dhi: int
    flo: int
    fhi: int
    const: tuple = ()      # top cells, most-recent last; None = unknown


def _pop_const(const: tuple, n: int) -> tuple[tuple, tuple]:
    """Split the tracked constants into (rest, popped-top-n); popped is in
    stack order (deepest first) padded with None below tracking depth."""
    if n == 0:
        return const, ()
    known = const[-n:] if n <= len(const) else const
    popped = (None,) * (n - len(known)) + tuple(known)
    return const[: len(const) - len(known)], popped


def _push_const(const: tuple, vals: tuple) -> tuple:
    out = const + tuple(vals)
    return out[-CONST_DEPTH:]


def _join_const(a: tuple, b: tuple) -> tuple:
    i, n = 0, min(len(a), len(b))
    while i < n and a[len(a) - 1 - i] == b[len(b) - 1 - i]:
        i += 1
    return a[len(a) - i:] if i else ()


def _join(a: _Abs, b: _Abs) -> _Abs:
    return _Abs(
        min(a.dlo, b.dlo),
        max(a.dhi, b.dhi),
        min(a.flo, b.flo),
        max(a.fhi, b.fhi),
        _join_const(a.const, b.const),
    )


class _Analyzer:
    """Shared analysis context over one code segment."""

    def __init__(self, cs, isa, vmcfg, fios_effects, symbols):
        self.cs = np.asarray(cs)
        self.isa = isa
        self.vmcfg = vmcfg
        self.fios_effects = fios_effects or {}
        self.names = {addr: n for n, addr in (symbols or {}).items()}
        self.summaries: dict[int, FnSummary] = {}
        self.in_progress: set[int] = set()
        self.loop_trips: dict[int, int | None] = {}   # doinit pc -> trips
        self._decoded: dict[int, Instr] = {}

    def fn_name(self, entry: int) -> str:
        return self.names.get(entry, f"fn@{entry}")

    def decode(self, pc: int) -> Instr:
        ins = self._decoded.get(pc)
        if ins is None:
            ins = decode(self.cs, pc, self.isa)
            self._decoded[pc] = ins
        return ins

    # -- per-function worklist ------------------------------------------------

    def summary(self, entry: int) -> FnSummary:
        cached = self.summaries.get(entry)
        if cached is not None:
            return cached
        if entry in self.in_progress:
            # Recursion: a sound depth summary would need widening over the
            # call graph; flag instead (no elision) and stop the walk.
            s = FnSummary(entry, self.fn_name(entry), flagged=True, wcet=None,
                          returns=True, net_ds=(0, 0), net_fs=(0, 0))
            s.diags.append(Diagnostic(
                "warn", entry, self.fn_name(entry),
                "recursive call: depth effect not statically summarized",
                self.fn_name(entry),
            ))
            return s
        self.in_progress.add(entry)
        try:
            s = self._analyze_fn(entry)
        finally:
            self.in_progress.discard(entry)
        self.summaries[entry] = s
        return s

    def _analyze_fn(self, entry: int) -> FnSummary:
        CS = len(self.cs)
        fn = self.fn_name(entry)
        s = FnSummary(entry, fn)
        fall_ds = fall_fs = rise_ds = rise_fs = 0
        fall_ds_site = fall_fs_site = rise_ds_site = rise_fs_site = None
        nets_d: list[tuple[int, int]] = []
        nets_f: list[tuple[int, int]] = []
        instrs: dict[int, Instr] = {}
        back_edges: list[tuple[int, int]] = []   # (doloop/branch pc, target)
        call_costs: dict[int, int | None] = {}   # call-site pc -> callee wcet

        def diag(sev, pc, label, msg):
            s.diags.append(Diagnostic(sev, pc, label, msg, fn))
            if sev == "warn":
                s.flagged = True

        states: dict[int, _Abs] = {entry: _Abs(0, 0, 0, 0)}
        joins: dict[int, int] = {}
        work = [entry]

        def flow(u: Instr, v_pc: int, st: _Abs):
            if not 0 <= v_pc < CS:
                diag("error", u.pc, u.label(),
                     f"control transfer to out-of-bounds pc {v_pc}")
                return
            if v_pc <= u.pc:
                back_edges.append((u.pc, v_pc))
            cur = states.get(v_pc)
            if cur is None:
                states[v_pc] = st
                work.append(v_pc)
                return
            new = _join(cur, st)
            if new == cur:
                return
            joins[v_pc] = joins.get(v_pc, 0) + 1
            if joins[v_pc] > MAX_JOINS:
                if joins[v_pc] == MAX_JOINS + 1:
                    diag("warn", v_pc, self.decode(v_pc).label(),
                         "abstract state did not converge "
                         "(net-growing loop?); analysis truncated here")
                return
            states[v_pc] = new
            work.append(v_pc)

        while work:
            pc = work.pop()
            st = states[pc]
            ins = self.decode(pc)
            instrs[pc] = ins
            lab = ins.label()

            def need(stx, din, fin, _pc=pc, _lab=lab):
                nonlocal fall_ds, fall_fs, fall_ds_site, fall_fs_site
                if din - stx.dlo > fall_ds:
                    fall_ds, fall_ds_site = din - stx.dlo, (_pc, _lab)
                if fin - stx.flo > fall_fs:
                    fall_fs, fall_fs_site = fin - stx.flo, (_pc, _lab)

            def rise(dhi, fhi, _pc=pc, _lab=lab):
                nonlocal rise_ds, rise_fs, rise_ds_site, rise_fs_site
                if dhi > rise_ds:
                    rise_ds, rise_ds_site = dhi, (_pc, _lab)
                if fhi > rise_fs:
                    rise_fs, rise_fs_site = fhi, (_pc, _lab)

            s.kinds.add(ins.trace_kind(self.isa.num_ops))

            if ins.tag == TAG_LIT:
                s.words.add("lit")
                rise(st.dhi + 1, st.fhi)
                flow(ins, pc + 1, replace(
                    st, dlo=st.dlo + 1, dhi=st.dhi + 1,
                    const=_push_const(st.const, (ins.payload,)),
                ))
                continue

            if ins.tag == TAG_RESERVED:
                diag("error", pc, lab,
                     "reserved-tag cell traps (EXC_TRAP) when executed")
                continue

            if ins.is_call:
                s.words.add("call")
                tgt = ins.payload
                if not 0 <= tgt < CS:
                    diag("error", pc, lab,
                         f"call target {tgt} outside the code segment")
                    continue
                self._apply_call(ins, st, s, 1, tgt, need, rise, flow,
                                 call_costs, diag)
                continue

            # TAG_OP ------------------------------------------------------
            payload = ins.payload
            if payload >= self.isa.num_ops:
                if payload >= FIOS_BASE:
                    s.has_fios = True
                    s.words.add("fios/trap")
                    eff = self.fios_effects.get(payload - FIOS_BASE)
                    if eff is None:
                        diag("warn", pc, lab,
                             f"syscall opcode {payload} (num "
                             f"{payload - FIOS_BASE}) has no declared "
                             "arity; depth effect unknown")
                        eff = (0, 0)
                    args, ret = eff
                    need(st, args, 0)
                    nd = (st.dlo - args + ret, st.dhi - args + ret)
                    rise(nd[1], st.fhi)
                    rest, _ = _pop_const(st.const, args)
                    flow(ins, pc + 1, _Abs(
                        nd[0], nd[1], st.flo, st.fhi,
                        _push_const(rest, (None,) * ret),
                    ))
                else:
                    s.words.add("fios/trap")
                    diag("error", pc, lab,
                         f"opcode {payload} is outside the ISA and below "
                         "FIOS_BASE: traps (EXC_TRAP) when executed")
                continue
            if payload < 0:
                diag("warn", pc, lab,
                     f"negative opcode payload {payload} clips to nop")
            name = ins.name or "nop"
            s.words.add(name)
            din, dout, fin, fout = STACK_EFFECTS[name]
            if name in ("ret", "exit"):
                need(st, din, fin)
                nets_d.append((st.dlo, st.dhi))
                nets_f.append((st.flo, st.fhi))
                s.returns = True
                continue
            if name in TERMINAL_WORDS:
                continue
            if name == "throw":
                need(st, din, fin)
                diag("warn", pc, lab,
                     "explicit throw: task dies (ST_ERR) unless a handler "
                     "is bound")
                continue
            if name == "exception":
                diag("warn", pc, lab,
                     "binds an exception handler: post-dispatch stack "
                     "depth is dynamic, checks stay on")
            if name == "pick":
                _, (top,) = _pop_const(st.const, 1)
                if top is not None:
                    need(st, int(top) + 2, fin)
                else:
                    diag("warn", pc, lab,
                         "pick depth not statically known (bounds stay "
                         "runtime-checked)")

            need(st, din, fin)
            rest, popped = _pop_const(st.const, din)
            nd = (st.dlo - din + dout, st.dhi - din + dout)
            if name == "await":
                # The scheduler's wake pushes one status cell (0 = event,
                # -1 = timeout) before the task resumes at pc + 1.
                nd = (nd[0] + 1, nd[1] + 1)
                dout += 1
            nf = (st.flo - fin + fout, st.fhi - fin + fout)
            rise(nd[1], nf[1])
            nxt = _Abs(nd[0], nd[1], nf[0], nf[1],
                       _push_const(rest, (None,) * dout))

            if name == "dlit":
                # The operand cell is a known push (deferred literal).
                val = int(ins.operand) if ins.operand is not None else None
                flow(ins, ins.next_pc,
                     replace(nxt, const=_push_const(rest, (val,))))
            elif name == "doinit":
                limit, start = popped if len(popped) == 2 else (None, None)
                trips = (
                    max(int(limit) - int(start), 1)
                    if limit is not None and start is not None
                    else None
                )
                prev = self.loop_trips.get(pc, trips)
                self.loop_trips[pc] = trips if trips == prev else None
                flow(ins, pc + 1, nxt)
            elif name == "branch":
                if ins.operand is None:
                    diag("error", pc, lab, "branch operand past end of CS")
                else:
                    flow(ins, int(ins.operand), nxt)
            elif name == "0branch":
                if ins.operand is None:
                    diag("error", pc, lab, "0branch operand past end of CS")
                else:
                    flow(ins, int(ins.operand), nxt)
                    flow(ins, pc + 2, nxt)
            elif name == "doloop":
                if ins.operand is None:
                    diag("error", pc, lab, "doloop operand past end of CS")
                else:
                    flow(ins, int(ins.operand), nxt)           # next iter
                    flow(ins, pc + 2, replace(                 # loop done
                        nxt, flo=nxt.flo - 2, fhi=nxt.fhi - 2))
            elif name == "exec":
                tgt = popped[-1] if popped else None
                if tgt is None:
                    diag("warn", pc, lab,
                         "dynamic exec target: callee not analyzed")
                    flow(ins, pc + 1, nxt)
                else:
                    self._apply_call(ins, nxt, s, 1, int(tgt), need, rise,
                                     flow, call_costs, diag)
            elif name == "task":
                tgt = popped[-1] if popped else None
                if tgt is None:
                    diag("warn", pc, lab,
                         "dynamic task entry: spawned program not analyzed")
                else:
                    s.spawn_entries.add(int(tgt))
                flow(ins, pc + 1, nxt)
            else:
                flow(ins, ins.next_pc, nxt)

        # -- fold ------------------------------------------------------------
        s.min_fall_ds, s.max_rise_ds = fall_ds, rise_ds
        s.min_fall_fs, s.max_rise_fs = fall_fs, rise_fs
        if nets_d:
            s.net_ds = (min(lo for lo, _ in nets_d), max(hi for _, hi in nets_d))
            s.net_fs = (min(lo for lo, _ in nets_f), max(hi for _, hi in nets_f))
        s._fall_ds_site = fall_ds_site
        s._fall_fs_site = fall_fs_site
        s._rise_ds_site = rise_ds_site
        s._rise_fs_site = rise_fs_site
        s.wcet = self._wcet(instrs, back_edges, call_costs)
        s.flagged = s.flagged or any(d.severity == "warn" for d in s.diags)
        return s

    def _apply_call(self, ins, st, s, rs_cells, tgt, need, rise, flow,
                    call_costs, diag):
        """Apply a callee summary at a call site (TAG_CALL / const exec)."""
        callee = self.summary(tgt)
        s.words |= callee.words
        s.kinds |= callee.kinds
        s.has_fios = s.has_fios or callee.has_fios
        s.spawn_entries |= callee.spawn_entries
        s.diags.extend(callee.diags)
        s.flagged = s.flagged or callee.flagged
        s.rs_rise = max(s.rs_rise, rs_cells + callee.rs_rise)
        # need() subtracts the current depth floor itself, so the callee's
        # entry-relative requirement is passed through unchanged.
        need(st, callee.min_fall_ds, callee.min_fall_fs)
        rise(st.dhi + callee.max_rise_ds, st.fhi + callee.max_rise_fs)
        call_costs[ins.pc] = callee.wcet
        if callee.net_ds is None:
            return  # callee never returns; fallthrough unreachable
        nd = (st.dlo + callee.net_ds[0], st.dhi + callee.net_ds[1])
        nf = (st.flo + callee.net_fs[0], st.fhi + callee.net_fs[1])
        flow(ins, ins.pc + 1, _Abs(nd[0], nd[1], nf[0], nf[1], ()))

    # -- WCET -----------------------------------------------------------------

    def _wcet(self, instrs, back_edges, call_costs) -> int | None:
        """IPET-style bound: each reachable instruction weighted by the
        product of enclosing back-edge trip counts."""
        regions: list[tuple[int, int, int]] = []   # (lo_pc, hi_pc, trips)
        for src, tgt in set(back_edges):
            ins = instrs.get(src)
            trips = None
            if ins is not None and ins.name == "doloop":
                trips = self.loop_trips.get(int(ins.operand) - 1)
            if trips is None:
                return None
            regions.append((tgt, src, trips))
        total = 0
        for pc, ins in instrs.items():
            w = 1
            for lo, hi, trips in regions:
                if lo <= pc <= hi:
                    w *= trips
            cost = 1
            if pc in call_costs:
                callee = call_costs[pc]
                if callee is None:
                    return None
                cost += callee
            total += w * cost
        return total


# -- entry / program level ----------------------------------------------------


@dataclass
class EntryReport:
    """Absolute verdict for one task entry (pc + concrete start depths)."""

    pc: int
    function: str
    verdict: str
    diagnostics: list
    wcet: int | None
    max_ds: int           # peak data-stack depth (absolute)
    max_fs: int
    rs_need: int          # absolute return-stack requirement
    returns: bool


@dataclass
class ProgramReport:
    """Whole-program verdict: all entries plus spawned-task entries."""

    verdict: str
    entries: list
    diagnostics: list
    words: frozenset
    kinds: frozenset          # trace-JIT (tag, opcode) branch universe
    has_fios: bool
    wcet: int | None          # max over entries; None if any unbounded

    @property
    def errors(self) -> list:
        return [d for d in self.diagnostics if d.severity == "error"]


def analyze_entry(
    cs,
    pc: int,
    isa: ISA | None = None,
    vmcfg: VMConfig | None = None,
    *,
    dsp: int = 0,
    fsp: int = 0,
    rsp: int = 0,
    rs0: int = 0,
    fios_effects=None,
    symbols=None,
    _ctx: _Analyzer | None = None,
) -> EntryReport:
    """Verify one entry with concrete launch depths (``launch_task`` sets
    ``dsp = fsp = rsp = 0``; an in-VM ``task`` spawn sets ``rsp = 1`` with
    ``rs[0] = 0`` — the canonical ``end`` at cell 0)."""
    isa = isa or get_isa()
    vmcfg = vmcfg or VMConfig()
    ctx = _ctx or _Analyzer(np.asarray(cs), isa, vmcfg, fios_effects, symbols)
    fn = ctx.fn_name(pc)
    diags: list[Diagnostic] = []
    if not 0 <= pc < len(ctx.cs):
        diags.append(Diagnostic("error", pc, "entry", "entry pc out of bounds", fn))
        return EntryReport(pc, fn, ERROR, diags, None, dsp, fsp, rsp, False)
    summ = ctx.summary(pc)
    diags.extend(summ.diags)

    def site(s):
        return f" at pc {s[0]} ({s[1]})" if s else ""

    if summ.min_fall_ds > dsp:
        diags.append(Diagnostic(
            "error", pc, fn,
            f"data stack may underflow: needs {summ.min_fall_ds} cells at "
            f"entry, launched with {dsp}{site(summ._fall_ds_site)}", fn))
    if dsp + summ.max_rise_ds > vmcfg.ds_size:
        diags.append(Diagnostic(
            "error", pc, fn,
            f"data stack may overflow: peak {dsp + summ.max_rise_ds} > DS "
            f"{vmcfg.ds_size}{site(summ._rise_ds_site)}", fn))
    if summ.min_fall_fs > fsp:
        diags.append(Diagnostic(
            "error", pc, fn,
            f"FOR stack may underflow: needs {summ.min_fall_fs} at entry, "
            f"launched with {fsp}{site(summ._fall_fs_site)}", fn))
    if fsp + summ.max_rise_fs > vmcfg.fs_size:
        diags.append(Diagnostic(
            "error", pc, fn,
            f"FOR stack may overflow: peak {fsp + summ.max_rise_fs} > FS "
            f"{vmcfg.fs_size}{site(summ._rise_fs_site)}", fn))
    rs_need = rsp + summ.rs_rise
    if rs_need > vmcfg.rs_size:
        diags.append(Diagnostic(
            "error", pc, fn,
            f"return stack may overflow: needs {rs_need} > RS "
            f"{vmcfg.rs_size}", fn))
    if summ.returns:
        # A `ret` at static call depth 0 pops the launch continuation.
        if rsp == 0:
            diags.append(Diagnostic(
                "error", pc, fn,
                "return with empty return stack (EXC_STACK): entry was "
                "launched with rsp = 0 and a top-level ret is reachable",
                fn))
        elif not (rsp == 1 and rs0 == 0 and _cell_is_terminal(ctx, 0)):
            diags.append(Diagnostic(
                "warn", pc, fn,
                "top-level return continuation is dynamic (resumed "
                "mid-call?): not analyzed", fn))

    verdict = VERIFIED
    for d in diags:
        verdict = worst(verdict, ERROR if d.severity == "error" else FLAGGED)
    return EntryReport(
        pc, fn, verdict, diags, summ.wcet,
        dsp + summ.max_rise_ds, fsp + summ.max_rise_fs, rs_need, summ.returns,
    )


def _cell_is_terminal(ctx: _Analyzer, pc: int) -> bool:
    ins = ctx.decode(pc)
    return ins.is_op and ins.name in TERMINAL_WORDS


def analyze_program(
    cs,
    entries,
    isa: ISA | None = None,
    vmcfg: VMConfig | None = None,
    *,
    fios_effects=None,
    symbols=None,
) -> ProgramReport:
    """Verify a code segment from a set of task entries.

    ``entries`` is a list of pcs or ``(pc, dsp, fsp, rsp, rs0)`` tuples.
    Constant ``task`` spawn targets discovered during the walk are verified
    as additional entries (with the in-VM spawn register state).
    """
    isa = isa or get_isa()
    vmcfg = vmcfg or VMConfig()
    ctx = _Analyzer(np.asarray(cs), isa, vmcfg, fios_effects, symbols)
    todo = []
    for e in entries:
        todo.append(tuple(e) if isinstance(e, (tuple, list)) else (int(e), 0, 0, 0, 0))
    seen = set()
    reports: list[EntryReport] = []
    words: set = set()
    kinds: set = set()
    has_fios = False
    while todo:
        pc, dsp, fsp, rsp, rs0 = todo.pop(0)
        if pc in seen:
            continue
        seen.add(pc)
        rep = analyze_entry(
            ctx.cs, pc, isa, vmcfg, dsp=dsp, fsp=fsp, rsp=rsp, rs0=rs0,
            fios_effects=fios_effects, symbols=symbols, _ctx=ctx,
        )
        reports.append(rep)
        summ = ctx.summaries.get(pc)
        if summ is not None:
            words |= summ.words
            kinds |= summ.kinds
            has_fios = has_fios or summ.has_fios
            for spawn in sorted(summ.spawn_entries):
                todo.append((spawn, 0, 0, 1, 0))   # op_task register init
    verdict = VERIFIED
    diags: list[Diagnostic] = []
    dseen = set()
    wcet: int | None = 0
    for rep in reports:
        verdict = worst(verdict, rep.verdict)
        for d in rep.diagnostics:
            key = (d.severity, d.pc, d.message)
            if key not in dseen:
                dseen.add(key)
                diags.append(d)
        wcet = None if (wcet is None or rep.wcet is None) else max(wcet, rep.wcet)
    return ProgramReport(
        verdict, reports, diags, frozenset(words), frozenset(kinds),
        has_fios, wcet,
    )


def analyze_vm(vm, entries=None) -> ProgramReport:
    """Verify a host :class:`~repro_torch.core.vm.machine.REXAVM`'s current
    code segment from its live task entries (or explicit ``entries``), with
    the node's syscall arities and dictionary names feeding the analysis.
    The node's state is read on the host (``.cpu().numpy()``)."""
    from repro_torch.core.vm.spec import ST_FREE

    st = {f: getattr(vm.state, f).cpu().numpy()
          for f in ("cs", "tstatus", "pc", "dsp", "fsp", "rsp", "rs")}
    if entries is None:
        entries = []
        for t in range(len(st["tstatus"])):
            if int(st["tstatus"][t]) == ST_FREE:
                continue
            rsp = int(st["rsp"][t])
            rs0 = int(st["rs"][t, 0]) if rsp >= 1 else 0
            entries.append((int(st["pc"][t]), int(st["dsp"][t]), int(st["fsp"][t]),
                            rsp, rs0))
    effects = {
        e.num: (e.args, e.ret)
        for e in getattr(vm.fios, "entries", [])
        if e is not None
    }
    symbols = {
        n: e.addr for n, e in vm.compiler.dictionary.entries.items()
    }
    return analyze_program(
        st["cs"], entries, vm.isa, vm.cfg, fios_effects=effects, symbols=symbols,
    )


def analyze_source(text: str, vmcfg: VMConfig | None = None) -> ProgramReport:
    """Compile ``text`` on a scratch node and verify the resulting frame
    (launch-time register state, like ``REXAVM.load`` + ``launch``).

    The scratch node is built with ``device="cpu"``: the Auditor runs on
    the host before any device work, in the reference as here, and the
    node only compiles (it never runs a slice)."""
    from repro_torch.core.vm.machine import REXAVM

    vm = REXAVM(vmcfg or VMConfig(), device="cpu")
    frame = vm.load(text)
    return analyze_vm(vm, entries=[(frame.entry, 0, 0, 0, 0)])
