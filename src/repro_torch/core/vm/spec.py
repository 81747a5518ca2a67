"""REXA VM instruction-set "DB" and code generators (paper Fig. 1, §5.1, C10).

The PyTorch port's own copy of ``repro.core.vm.spec``: the port imports
nothing of the JAX package, and its ISA tables must equal the reference's
word for word (tests/test_torch_host.py checks that).

The ISA is declared as a word list; everything else — opcode numbering, the
dispatch table skeleton, the compiler's perfect-hash table (PHT, §3.9.1) and
linear-search table (LST, §3.9.2/Fig. 9), and the ISA documentation — is a
*derived artifact*.  Adding/removing a word regenerates all tables, exactly
like the paper's JSON + code-snippet generator flow (and, as the paper notes,
any change invalidates bytecode compatibility — which is why the compiler is
bundled with the VM).

Bytecode format (paper Def. 4, adapted to 32-bit cells — see DESIGN.md):
  cell & 0b11 == TAG_OP   : opcode = cell >> 2
  cell & 0b11 == TAG_LIT  : inline literal, payload = cell >> 2 (signed 30-bit)
  cell & 0b11 == TAG_CALL : call, payload = CS address of word body
  (full 32-bit literals use the ``dlit`` opcode + one raw cell; the paper's
  14/30-bit short/double literal split maps to TAG_LIT vs ``dlit``.)
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np

# --- Cell tags (2 LSB of each bytecode cell) -------------------------------
TAG_OP = 0
TAG_LIT = 1
TAG_CALL = 2
TAG_RESERVED = 3

PAYLOAD_BITS = 30
LIT_MIN = -(1 << (PAYLOAD_BITS - 1))
LIT_MAX = (1 << (PAYLOAD_BITS - 1)) - 1

# --- Address space ----------------------------------------------------------
# Cells 0..MEM_BASE-1 address the code segment (embedded frame data);
# cells >= MEM_BASE address the DIOS data memory (sample buffers etc.).
MEM_BASE = 1 << 20

# FIOS (host foreign functions) occupy opcodes >= FIOS_BASE.
FIOS_BASE = 192
MAX_FIOS = 62

# --- Exception ids (paper §3.8) ---------------------------------------------
EXC_TRAP = 1
EXC_STACK = 2
EXC_INTERRUPT = 3
EXC_IO = 4
EXC_TIMEOUT = 5
EXC_DIVBYZERO = 6
EXC_BOUNDS = 7
EXC_USER = 8
EXC_NAMES = {
    "trap": EXC_TRAP,
    "stack": EXC_STACK,
    "interrupt": EXC_INTERRUPT,
    "io": EXC_IO,
    "timeout": EXC_TIMEOUT,
    "divbyzero": EXC_DIVBYZERO,
    "bounds": EXC_BOUNDS,
    "user": EXC_USER,
}
NUM_EXC = 9

# --- VM status codes ---------------------------------------------------------
ST_RUN = 0        # running
ST_DONE = 1       # `end` reached (frame finished)
ST_HALT = 2       # `halt`
ST_ERR = 3        # unrecoverable error (no handler bound)
ST_IOWAIT = 4     # FIOS call pending host service (paper: leave loop round)
ST_SLEEP = 5      # suspended on timeout (sleep)
ST_EVENT = 6      # suspended on event (await / receive / in)
ST_YIELD = 7      # cooperative yield (scheduling point)
ST_FREE = 8       # task slot unused


@dataclass(frozen=True)
class Word:
    """One ISA word: the unit of the code-generator 'DB'."""

    name: str
    effect: str = ""          # stack effect comment, documentation artifact
    doc: str = ""
    category: str = "core"
    compile_only: bool = False  # handled by the compiler, no runtime opcode
    # Declared machine-readable stack effect (ds_in, ds_out, fs_in, fs_out):
    # cells popped/pushed on the data stack and frames consumed/produced on
    # the FOR stack.  This is the single source of truth for the runtime
    # stack pre-check (the batched interpreter and the vmloop kernel's
    # operand tables).  Back-filled from
    # STACK_EFFECTS below for every runtime word; ``None`` only for
    # compile-only words, which never reach the decoder.
    stack: tuple[int, int, int, int] | None = None

    @property
    def pops(self) -> int:
        return self.stack[0] if self.stack else 0

    @property
    def pushes(self) -> int:
        return self.stack[1] if self.stack else 0


# ---------------------------------------------------------------------------
# The word list (the "DB").  Order defines opcode numbering; the paper keeps
# opcodes consecutively numbered so the decoder lowers to a branch LUT.
# ---------------------------------------------------------------------------

WORDS: list[Word] = [
    # -- stack ---------------------------------------------------------------
    Word("nop", "( -- )", "no operation", "stack"),
    Word("dup", "( a -- a a )", "duplicate top", "stack"),
    Word("drop", "( a -- )", "drop top", "stack"),
    Word("swap", "( a b -- b a )", "swap top two", "stack"),
    Word("over", "( a b -- a b a )", "copy second", "stack"),
    Word("rot", "( a b c -- b c a )", "rotate third to top", "stack"),
    Word("nip", "( a b -- b )", "drop second", "stack"),
    Word("tuck", "( a b -- b a b )", "copy top below second", "stack"),
    Word("pick", "( ... n -- ... a_n )", "copy n-th from top", "stack"),
    Word("2dup", "( a b -- a b a b )", "duplicate pair", "stack"),
    Word("2drop", "( a b -- )", "drop pair", "stack"),
    Word("depth", "( -- n )", "data stack depth", "stack"),
    # -- arithmetic ----------------------------------------------------------
    Word("+", "( a b -- a+b )", "add", "arith"),
    Word("-", "( a b -- a-b )", "subtract", "arith"),
    Word("*", "( a b -- a*b )", "multiply (32-bit wrap)", "arith"),
    Word("/", "( a b -- a/b )", "divide toward zero; raises divbyzero", "arith"),
    Word("mod", "( a b -- a%b )", "remainder; raises divbyzero", "arith"),
    Word("*/", "( a b c -- a*b/c )", "scaled mul-div, 64-bit intermediate (fixed point)", "arith"),
    Word("negate", "( a -- -a )", "negate", "arith"),
    Word("abs", "( a -- |a| )", "absolute value", "arith"),
    Word("min", "( a b -- min )", "minimum", "arith"),
    Word("max", "( a b -- max )", "maximum", "arith"),
    Word("1+", "( a -- a+1 )", "increment", "arith"),
    Word("1-", "( a -- a-1 )", "decrement", "arith"),
    Word("2*", "( a -- a*2 )", "shift left 1", "arith"),
    Word("2/", "( a -- a/2 )", "arithmetic shift right 1", "arith"),
    # -- comparison (forth: true = -1, false = 0) -----------------------------
    Word("=", "( a b -- f )", "equal", "cmp"),
    Word("<>", "( a b -- f )", "not equal", "cmp"),
    Word("<", "( a b -- f )", "less", "cmp"),
    Word(">", "( a b -- f )", "greater", "cmp"),
    Word("<=", "( a b -- f )", "less or equal", "cmp"),
    Word(">=", "( a b -- f )", "greater or equal", "cmp"),
    Word("0=", "( a -- f )", "equals zero", "cmp"),
    Word("0<", "( a -- f )", "negative", "cmp"),
    Word("0>", "( a -- f )", "positive", "cmp"),
    # -- bitwise --------------------------------------------------------------
    Word("and", "( a b -- a&b )", "bitwise and", "bit"),
    Word("or", "( a b -- a|b )", "bitwise or", "bit"),
    Word("xor", "( a b -- a^b )", "bitwise xor", "bit"),
    Word("invert", "( a -- ~a )", "bitwise not", "bit"),
    Word("lshift", "( a n -- a<<n )", "shift left", "bit"),
    Word("rshift", "( a n -- a>>n )", "arithmetic shift right", "bit"),
    # -- memory (unified CS/DIOS address space) --------------------------------
    Word("@", "( addr -- v )", "fetch cell", "mem"),
    Word("!", "( v addr -- )", "store cell", "mem"),
    Word("+!", "( v addr -- )", "add to cell", "mem"),
    Word("get", "( n arr -- v )", "fetch n-th element of array (paper softcore stacks)", "mem"),
    Word("put", "( v n arr -- )", "store n-th element of array", "mem"),
    Word("push", "( v arr -- )", "softcore stack push (paper §3.2)", "mem"),
    Word("pop", "( arr -- v )", "softcore stack pop", "mem"),
    Word("fill", "( v arr -- )", "fill array with value", "mem"),
    Word("len", "( arr -- n )", "array length from header", "mem"),
    # -- control (mostly compiler-inserted hidden words) -----------------------
    Word("branch", "( -- )", "unconditional branch; next cell = CS addr", "ctl"),
    Word("0branch", "( f -- )", "branch if zero; next cell = CS addr", "ctl"),
    Word("ret", "( -- )", "return from word (;)", "ctl"),
    Word("exit", "( -- )", "early return from word", "ctl"),
    Word("exec", "( addr -- )", "call word by address ($ name exec)", "ctl"),
    Word("doinit", "( limit start -- )", "begin do-loop: push FS pair", "ctl"),
    Word("doloop", "( -- )", "step do-loop; next cell = loop start addr", "ctl"),
    Word("i", "( -- n )", "inner loop counter", "ctl"),
    Word("j", "( -- n )", "outer loop counter", "ctl"),
    Word("unloop", "( -- )", "drop FS pair (before exit)", "ctl"),
    Word("halt", "( -- )", "stop VM", "ctl"),
    Word("end", "( -- )", "end of code frame / task (paper §3.1)", "ctl"),
    # -- literals ---------------------------------------------------------------
    Word("dlit", "( -- v )", "full-width literal; next cell = raw value", "lit"),
    # -- io / printing ------------------------------------------------------------
    Word(".", "( v -- )", "print value to output ring", "io"),
    Word("emit", "( c -- )", "emit char", "io"),
    Word("cr", "( -- )", "newline", "io"),
    Word("prstr", "( -- )", "hidden: print inline string (len + chars follow)", "io"),
    Word("vecprint", "( arr -- )", "print array", "io"),
    Word("out", "( v -- )", "write to host stream (suspends: IO)", "io"),
    Word("in", "( -- v )", "read from host stream (suspends: IO)", "io"),
    Word("send", "( v dst -- )", "send value to node/link (suspends: IO)", "io"),
    Word("receive", "( -- src v )", "blocking receive (suspends: IO)", "io"),
    # -- tasks / scheduling (paper Def. 1, §3.3, Alg. 6) ---------------------------
    Word("yield", "( -- )", "cooperative scheduling point", "task"),
    Word("sleep", "( ms -- )", "suspend task for ms of virtual time", "task"),
    Word("await", "( ms value varaddr -- status )", "suspend until mem==value or timeout", "task"),
    Word("task", "( prio deadline addr -- taskid )", "spawn task at word address", "task"),
    Word("taskid", "( -- id )", "current task id", "task"),
    Word("ms", "( -- t )", "virtual time (ms)", "task"),
    Word("steps", "( -- n )", "executed instruction count (profiling, §6.2)", "task"),
    # -- exceptions (paper §3.8) ----------------------------------------------------
    Word("exception", "( handler exc -- )", "bind handler word to exception id", "exc"),
    Word("catch", "( -- exc|0 )", "set catch point; push pending exception", "exc"),
    Word("throw", "( exc -- )", "raise exception", "exc"),
    # -- fixed-point DSP scalars (paper §4.2, Tab. 4; x/y scale 1:1000) ---------------
    Word("sin", "( x -- y )", "fixed-point sine, scale 1000", "dsp"),
    Word("log", "( x -- y )", "fixed-point log10, x scale 10, y scale 1000", "dsp"),
    Word("sigmoid", "( x -- y )", "LUT sigmoid, scale 1000 (paper Alg. 2)", "dsp"),
    Word("relu", "( x -- y )", "fixed-point relu", "dsp"),
    Word("sqrt", "( x -- y )", "integer square root", "dsp"),
    Word("rnd", "( n -- r )", "LCG random in [0,n)", "dsp"),
    # -- vector / ANN ops (paper §4.3, Tab. 5, Eq. 4) ----------------------------------
    Word("vecload", "( src srcoff dst -- )", "copy src[srcoff:] into dst (len from dst header)", "vec"),
    Word("vecscale", "( src dst scalevec -- )", "elementwise scale: neg=shrink pos=expand", "vec"),
    Word("vecadd", "( a b dst scalevec -- )", "elementwise add w/ optional scaling (0=off)", "vec"),
    Word("vecmul", "( a b dst scalevec -- )", "elementwise mul w/ optional scaling", "vec"),
    Word("vecfold", "( in wgt out scalevec -- )", "matrix fold: out_j = sum_i in_i*w[i,j] (Eq. 4)", "vec"),
    Word("vecmap", "( src dst fn scalevec -- )", "map builtin activation over array", "vec"),
    Word("dotprod", "( a b -- lo )", "dot product (32-bit result)", "vec"),
    Word("vecmax", "( arr -- idx )", "argmax (classification readout)", "vec"),
    Word("hull", "( arr off len k -- )", "in-place rectify+low-pass hull (paper Tab. 4)", "vec"),
    Word("lowp", "( arr off len k -- )", "in-place IIR low-pass, k = pole scale/1000", "vec"),
    Word("highp", "( arr off len k -- )", "in-place IIR high-pass", "vec"),
]

# ---------------------------------------------------------------------------
# Declared stack effects: (ds_in, ds_out, fs_in, fs_out) per runtime word.
# Ground truth for the decoder pre-check (EXC_STACK — the paper's "enhanced
# error detection" at the architecture level) and for the static verifier.
# The interpreter and the vmloop kernel's operand tables both derive from
# this one table (see interp.STACK_NEEDS / ref.make_tables).
# ---------------------------------------------------------------------------

STACK_EFFECTS: dict[str, tuple[int, int, int, int]] = {
    "nop": (0, 0, 0, 0), "dup": (1, 2, 0, 0), "drop": (1, 0, 0, 0),
    "swap": (2, 2, 0, 0), "over": (2, 3, 0, 0), "rot": (3, 3, 0, 0),
    "nip": (2, 1, 0, 0), "tuck": (2, 3, 0, 0), "pick": (1, 1, 0, 0),
    "2dup": (2, 4, 0, 0), "2drop": (2, 0, 0, 0), "depth": (0, 1, 0, 0),
    "+": (2, 1, 0, 0), "-": (2, 1, 0, 0), "*": (2, 1, 0, 0),
    "/": (2, 1, 0, 0), "mod": (2, 1, 0, 0), "*/": (3, 1, 0, 0),
    "negate": (1, 1, 0, 0), "abs": (1, 1, 0, 0), "min": (2, 1, 0, 0),
    "max": (2, 1, 0, 0), "1+": (1, 1, 0, 0), "1-": (1, 1, 0, 0),
    "2*": (1, 1, 0, 0), "2/": (1, 1, 0, 0),
    "=": (2, 1, 0, 0), "<>": (2, 1, 0, 0), "<": (2, 1, 0, 0),
    ">": (2, 1, 0, 0), "<=": (2, 1, 0, 0), ">=": (2, 1, 0, 0),
    "0=": (1, 1, 0, 0), "0<": (1, 1, 0, 0), "0>": (1, 1, 0, 0),
    "and": (2, 1, 0, 0), "or": (2, 1, 0, 0), "xor": (2, 1, 0, 0),
    "invert": (1, 1, 0, 0), "lshift": (2, 1, 0, 0), "rshift": (2, 1, 0, 0),
    "@": (1, 1, 0, 0), "!": (2, 0, 0, 0), "+!": (2, 0, 0, 0),
    "get": (2, 1, 0, 0), "put": (3, 0, 0, 0), "push": (2, 0, 0, 0),
    "pop": (1, 1, 0, 0), "fill": (2, 0, 0, 0), "len": (1, 1, 0, 0),
    "branch": (0, 0, 0, 0), "0branch": (1, 0, 0, 0), "ret": (0, 0, 0, 0),
    "exit": (0, 0, 0, 0), "exec": (1, 0, 0, 0),
    "doinit": (2, 0, 0, 2), "doloop": (0, 0, 2, 2), "i": (0, 1, 1, 1),
    "j": (0, 1, 3, 3), "unloop": (0, 0, 2, 0),
    "halt": (0, 0, 0, 0), "end": (0, 0, 0, 0),
    "dlit": (0, 1, 0, 0),
    ".": (1, 0, 0, 0), "emit": (1, 0, 0, 0), "cr": (0, 0, 0, 0),
    "prstr": (0, 0, 0, 0), "vecprint": (1, 0, 0, 0),
    "out": (1, 0, 0, 0), "in": (0, 1, 0, 0), "send": (2, 0, 0, 0),
    "receive": (0, 2, 0, 0),
    "yield": (0, 0, 0, 0), "sleep": (1, 0, 0, 0), "await": (3, 0, 0, 0),
    "task": (3, 1, 0, 0), "taskid": (0, 1, 0, 0), "ms": (0, 1, 0, 0),
    "steps": (0, 1, 0, 0),
    "exception": (2, 0, 0, 0), "catch": (0, 1, 0, 0), "throw": (1, 0, 0, 0),
    "sin": (1, 1, 0, 0), "log": (1, 1, 0, 0), "sigmoid": (1, 1, 0, 0),
    "relu": (1, 1, 0, 0), "sqrt": (1, 1, 0, 0), "rnd": (1, 1, 0, 0),
    "vecload": (3, 0, 0, 0), "vecscale": (3, 0, 0, 0), "vecadd": (4, 0, 0, 0),
    "vecmul": (4, 0, 0, 0), "vecfold": (4, 0, 0, 0), "vecmap": (4, 0, 0, 0),
    "dotprod": (2, 1, 0, 0), "vecmax": (1, 1, 0, 0),
    "hull": (4, 0, 0, 0), "lowp": (4, 0, 0, 0), "highp": (4, 0, 0, 0),
}

if set(STACK_EFFECTS) != {w.name for w in WORDS}:
    _missing = {w.name for w in WORDS} - set(STACK_EFFECTS)
    _extra = set(STACK_EFFECTS) - {w.name for w in WORDS}
    raise RuntimeError(
        f"STACK_EFFECTS out of sync with WORDS: missing={_missing} extra={_extra}"
    )

# Back-fill the declared effect onto every runtime Word (opcode numbering
# is positional, so the rebuilt list preserves it exactly).
WORDS = [replace(w, stack=STACK_EFFECTS[w.name]) for w in WORDS]


def fios_stack_effect(args: int, ret: int) -> tuple[int, int, int, int]:
    """Declared effect of a FIOS/SVC opcode: pops ``args`` cells, pushes
    ``ret`` (0 or 1) on resume, no FOR-stack traffic."""
    return (int(args), int(ret), 0, 0)

# Compile-only words (consumed by the compiler; no opcode).
COMPILE_WORDS = [
    Word(":", compile_only=True, category="compile"),
    Word(";", compile_only=True, category="compile"),
    Word("if", compile_only=True, category="compile"),
    Word("else", compile_only=True, category="compile"),
    Word("endif", compile_only=True, category="compile"),
    Word("then", compile_only=True, category="compile"),   # alias of endif
    Word("do", compile_only=True, category="compile"),
    Word("loop", compile_only=True, category="compile"),
    Word("begin", compile_only=True, category="compile"),
    Word("until", compile_only=True, category="compile"),
    Word("while", compile_only=True, category="compile"),
    Word("repeat", compile_only=True, category="compile"),
    Word("again", compile_only=True, category="compile"),
    Word("var", compile_only=True, category="compile"),
    Word("array", compile_only=True, category="compile"),
    Word("const", compile_only=True, category="compile"),
    Word("import", compile_only=True, category="compile"),
    Word("export", compile_only=True, category="compile"),
    Word("$", compile_only=True, category="compile"),
    Word('."', compile_only=True, category="compile"),
    Word("(", compile_only=True, category="compile"),
]


# ---------------------------------------------------------------------------
# Derived artifacts ("code generation")
# ---------------------------------------------------------------------------

class ISA:
    """All derived tables for one word list — the generated part of the VM."""

    def __init__(self, words: list[Word] | None = None):
        self.words = list(words if words is not None else WORDS)
        if len(self.words) > FIOS_BASE:
            raise ValueError("word list exceeds FIOS_BASE opcode space")
        names = [w.name for w in self.words]
        if len(set(names)) != len(names):
            raise ValueError("duplicate word names in ISA spec")
        self.opcode: dict[str, int] = {w.name: i for i, w in enumerate(self.words)}
        self.name: dict[int, str] = {i: w.name for i, w in enumerate(self.words)}
        self.num_ops = len(self.words)
        # Builtin vecmap function ids (fn operand of vecmap).
        self.mapfn = {"sigmoid": 0, "relu": 1, "sin": 2, "log": 3, "sqrt": 4}

    # -- encoding helpers -----------------------------------------------------

    def enc_op(self, name: str) -> int:
        return (self.opcode[name] << 2) | TAG_OP

    def enc_opcode(self, code: int) -> int:
        return (code << 2) | TAG_OP

    def enc_lit(self, v: int) -> int:
        assert LIT_MIN <= v <= LIT_MAX, v
        cell = ((v & ((1 << PAYLOAD_BITS) - 1)) << 2) | TAG_LIT
        # Normalize to signed-int32 representation (the CS cell dtype).
        return cell - 0x100000000 if cell >= 0x80000000 else cell

    def enc_call(self, addr: int) -> int:
        assert 0 <= addr < (1 << PAYLOAD_BITS)
        return (addr << 2) | TAG_CALL

    def fits_short(self, v: int) -> bool:
        return LIT_MIN <= v <= LIT_MAX

    # -- generated documentation ------------------------------------------------

    def generate_doc(self) -> str:
        lines = ["# REXA VM ISA (generated)", ""]
        bycat: dict[str, list[Word]] = {}
        for w in self.words:
            bycat.setdefault(w.category, []).append(w)
        for cat, ws in bycat.items():
            lines.append(f"## {cat}")
            for w in ws:
                lines.append(f"- `{w.name:10s}` {w.effect:28s} op={self.opcode[w.name]:3d}  {w.doc}")
            lines.append("")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Perfect Hash Table (paper §3.9.1) — CHD-style displacement construction.
# ---------------------------------------------------------------------------

def _fnv(s: str, salt: int) -> int:
    h = 2166136261 ^ (salt * 2654435761 & 0xFFFFFFFF)
    for c in s.encode():
        h = ((h ^ c) * 16777619) & 0xFFFFFFFF
    return h


class PerfectHashTable:
    """Minimal perfect hash word->index with a string check table.

    The hash alone cannot reject non-words (paper: "a hash function cannot
    detect words that do not match"), so lookups verify against the stored
    string table — exactly the paper's PHT + string-check-table design.
    """

    def __init__(self, words: list[str]):
        self.n = len(words)
        self.m = self.n  # minimal
        self.words = list(words)
        self._build()

    def _build(self) -> None:
        n, m = self.n, self.m
        buckets: list[list[int]] = [[] for _ in range(m)]
        for idx, w in enumerate(self.words):
            buckets[_fnv(w, 0) % m].append(idx)
        order = sorted(range(m), key=lambda b: -len(buckets[b]))
        disp = [0] * m
        slot_of: list[int] = [-1] * m      # slot -> word index
        for b in order:
            items = buckets[b]
            if not items:
                continue
            d = 1
            while True:
                slots = [_fnv(self.words[i], d) % m for i in items]
                if len(set(slots)) == len(slots) and all(slot_of[s] == -1 for s in slots):
                    for i, s in zip(items, slots):
                        slot_of[s] = i
                    disp[b] = d
                    break
                d += 1
                if d > 100000:
                    raise RuntimeError("PHT construction failed")
        self.disp = disp
        self.slot_of = slot_of
        # String check table indexed by slot (paper's verification table).
        self.check = ["" if i < 0 else self.words[i] for i in slot_of]

    def lookup(self, word: str) -> int:
        """Return word index or -1."""
        if self.n == 0:
            return -1
        b = _fnv(word, 0) % self.m
        d = self.disp[b]
        if d == 0:
            return -1
        s = _fnv(word, d) % self.m
        if self.check[s] != word:   # mandatory string verification
            return -1
        return self.slot_of[s]

    def size_bytes(self) -> int:
        """Approximate storage per paper §3.9.1: disp table + string table."""
        return 4 * self.m + sum(len(w) + 1 for w in self.check)


# ---------------------------------------------------------------------------
# Linear Search Table (paper §3.9.2, Fig. 9): per-word-length character tries
# concatenated into one linear array of (char, branch|index) token slices.
# ---------------------------------------------------------------------------

_LST_NOTFOUND = 0xFFFF
_LST_LEAF = 0x8000


class LinearSearchTable:
    """Faithful LST: one sub-tree per word length; slices of 2-byte entries."""

    def __init__(self, words: list[str]):
        self.words = list(words)
        self._build()

    def _build(self) -> None:
        bylen: dict[int, list[int]] = {}
        for i, w in enumerate(self.words):
            bylen.setdefault(len(w), []).append(i)
        self.max_len = max(bylen) if bylen else 0
        # Header section: start slice address per word length (1..max_len).
        header_size = self.max_len + 1
        entries: list[tuple[int, int]] = []   # (char, value) pairs after header
        header = [_LST_NOTFOUND] * header_size

        def build_slice(indices: list[int], depth: int, length: int) -> int:
            """Emit the slice for these words at char position ``depth``;
            return its address (entry index)."""
            groups: dict[str, list[int]] = {}
            for i in indices:
                groups.setdefault(self.words[i][depth], []).append(i)
            addr = len(entries)
            # Reserve the slice (one entry per distinct char + terminator).
            slots = list(groups.items())
            for _ in slots:
                entries.append((0, 0))
            entries.append((0, _LST_NOTFOUND))  # slice terminator
            for k, (ch, idxs) in enumerate(slots):
                if depth == length - 1:
                    assert len(idxs) == 1, "duplicate word"
                    entries[addr + k] = (ord(ch), _LST_LEAF | idxs[0])
                else:
                    sub = build_slice(idxs, depth + 1, length)
                    entries[addr + k] = (ord(ch), sub)
            return addr

        for length, idxs in sorted(bylen.items()):
            header[length] = build_slice(idxs, 0, length)
        self.header = header
        self.entries = entries
        self.num_slices = sum(1 for e in entries if e[1] == _LST_NOTFOUND and e[0] == 0)

    def lookup(self, word: str) -> int:
        """Iterative FSM search, as in the paper's hardware implementation."""
        L = len(word)
        if L == 0 or L >= len(self.header):
            return -1
        slice_addr = self.header[L]
        if slice_addr == _LST_NOTFOUND:
            return -1
        for depth in range(L):
            ch = ord(word[depth])
            k = slice_addr
            found = None
            while True:
                c, v = self.entries[k]
                if c == 0 and v == _LST_NOTFOUND:
                    return -1    # slice exhausted
                if c == ch:
                    found = v
                    break
                k += 1
            if found & _LST_LEAF:
                return found & ~_LST_LEAF if depth == L - 1 else -1
            slice_addr = found
        return -1

    def size_bytes(self) -> int:
        return 2 * (len(self.header) + len(self.entries))


def default_isa() -> ISA:
    return ISA(WORDS)


# Singleton used across the package (regenerate by constructing ISA(custom)).
_DEFAULT: ISA | None = None


def get_isa() -> ISA:
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = default_isa()
    return _DEFAULT
