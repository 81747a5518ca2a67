"""JIT text-to-bytecode compiler (paper §3.9).

Design points reproduced from the paper:
  * token-level incremental compilation, no lexer/parser ASTs;
  * word lookup through a Perfect Hash Table (constant time, string-verified)
    or a Linear Search Table (Fig. 9) — both built from the ISA spec;
  * **in-place** compilation: source text occupies CS cells and is overwritten
    front-to-back by bytecode; the compiler asserts the paper's invariant that
    the bytecode write pointer never overtakes the text read pointer
    (§3.9: "an instruction word consists of at least one character...");
  * scalar variables and *initialized* arrays are embedded in-place (behind a
    hidden branch); *uninitialized* arrays are appended at the frame end;
  * ``end`` terminates the frame; exported words lock the frame.

The compiler is host-side Python (the VM's "full system mode"); the bytecode
runs on the device in the batched interpreter or the vmloop CUDA kernel.  It
is the PyTorch port's copy of ``repro.core.vm.compiler`` and must emit the
same bytecode cell for cell (tests/test_torch_host.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import functools

import numpy as np

from repro_torch.core.vm.frames import CodeFrame, Dictionary, FrameManager
from repro_torch.core.vm.ios import DiosRegistry, FiosRegistry
from repro_torch.core.vm.spec import (
    EXC_NAMES,
    ISA,
    LinearSearchTable,
    PerfectHashTable,
    TAG_LIT,
    get_isa,
)


class CompileError(Exception):
    """Compilation diagnostic with source mapping.

    Carries the offending token text, its character position in the frame
    source, and the frame name.  ``str()``
    stays message-first so existing ``pytest.raises(match=...)`` holds.
    """

    def __init__(
        self,
        message: str,
        *,
        token: str | None = None,
        pos: int | None = None,
        frame: str | None = None,
    ):
        super().__init__(message)
        self.message = message
        self.token = token
        self.pos = pos
        self.frame = frame

    def __str__(self) -> str:
        loc = []
        if self.token is not None:
            loc.append(f"token {self.token!r}")
        if self.pos is not None:
            loc.append(f"char {self.pos}")
        if self.frame is not None:
            loc.append(f"frame {self.frame!r}")
        return self.message + (f" [{', '.join(loc)}]" if loc else "")


# Token kinds.
T_WORD = 0
T_NUM = 1
T_STR = 2     # ." ..."
T_ARR = 3     # { v1 ... vn }


@dataclass
class Token:
    kind: int
    text: str
    value: object = None      # int for T_NUM, list[int] for T_ARR
    end_pos: int = 0          # char position one past the token (in-place budget)
    pos: int = 0              # char position of the token's first character


ALIASES = {
    "then": "endif",
    "read": "get",
    "<0": "0<",
    "=0": "0=",
    ">0": "0>",
    "not": "0=",
}


def tokenize(text: str) -> list[Token]:
    """Whitespace tokenizer with ``( comments )``, ``." strings"``, ``{ lists }``."""
    toks: list[Token] = []
    i, n = 0, len(text)

    def skip_ws(i: int) -> int:
        while i < n and text[i].isspace():
            i += 1
        return i

    while True:
        i = skip_ws(i)
        if i >= n:
            break
        if text[i] == "(":
            # Comment to matching ')' (paper comments are non-nesting).
            j = text.find(")", i + 1)
            if j < 0:
                raise CompileError("unterminated comment", token="(", pos=i)
            i = j + 1
            continue
        if text.startswith('."', i):
            j = text.find('"', i + 2)
            if j < 0:
                raise CompileError("unterminated string", token='."', pos=i)
            s = text[i + 2 : j]
            if s.startswith(" "):
                s = s[1:]
            toks.append(Token(T_STR, s, end_pos=j + 1, pos=i))
            i = j + 1
            continue
        if text[i] == "{":
            j = text.find("}", i + 1)
            if j < 0:
                raise CompileError("unterminated array literal", token="{", pos=i)
            vals = []
            for t in text[i + 1 : j].split():
                vals.append(parse_number(t))
                if vals[-1] is None:
                    raise CompileError(
                        f"bad array literal element {t!r}", token=t, pos=i
                    )
            toks.append(Token(T_ARR, text[i : j + 1], value=vals, end_pos=j + 1, pos=i))
            i = j + 1
            continue
        j = i
        while j < n and not text[j].isspace():
            j += 1
        w = text[i:j]
        num = parse_number(w)
        if num is not None:
            toks.append(Token(T_NUM, w, value=num, end_pos=j, pos=i))
        else:
            toks.append(Token(T_WORD, w, end_pos=j, pos=i))
        i = j
    return toks


def parse_number(tok: str):
    t = tok
    if t.endswith("l") and len(t) > 1:   # paper's double-word suffix
        t = t[:-1]
    neg = t.startswith("-")
    body = t[1:] if neg else t
    if not body:
        return None
    try:
        if body.lower().startswith("0x"):
            v = int(body, 16)
        elif body.isdigit():
            v = int(body)
        else:
            return None
    except ValueError:
        return None
    return -v if neg else v


# ---------------------------------------------------------------------------


@dataclass
class LocalSym:
    kind: str               # var | array | const | defer_array
    value: int = 0          # addr for var/array, value for const, len for defer
    relocs: list[int] = field(default_factory=list)


@functools.lru_cache(maxsize=8)
def _lookup_tables(names: tuple[str, ...]):
    """PHT + LST for one word list, built once and shared read-only by every
    compiler of that ISA (a fleet of thousands of nodes builds them once)."""
    return PerfectHashTable(list(names)), LinearSearchTable(list(names))


class Compiler:
    """Per-VM compiler instance bound to ISA + IOS registries (paper: the
    compiler is always bundled with the VM)."""

    def __init__(
        self,
        isa: ISA | None = None,
        fios: FiosRegistry | None = None,
        dios: DiosRegistry | None = None,
        lookup: str = "pht",
    ):
        self.isa = isa or get_isa()
        self.fios = fios or FiosRegistry()
        self.dios = dios or DiosRegistry(0)
        self.dictionary = Dictionary()
        self.pht, self.lst = _lookup_tables(tuple(w.name for w in self.isa.words))
        self.lookup_mode = lookup
        self.words_compiled = 0   # MCPS accounting (paper Tab. 9)
        self._cur_tok: Token | None = None        # diagnostics source map
        self._cur_frame_name: str | None = None

    # -- core word lookup (PHT or LST, equivalence tested) -------------------

    def core_opcode(self, name: str) -> int | None:
        if self.lookup_mode == "lst":
            idx = self.lst.lookup(name)
        else:
            idx = self.pht.lookup(name)
        return None if idx < 0 else idx

    # -- main entry -----------------------------------------------------------

    def compile_frame(
        self,
        text: str,
        cs: np.ndarray,
        frames: FrameManager,
        persistent: bool = False,
        name: str = "",
    ) -> CodeFrame:
        """Compile one code frame in place.  Returns the frame descriptor.

        Any ``CompileError`` escaping is annotated with the offending token
        text, its char position in ``text``, and the frame name.
        """
        self._cur_tok = None
        self._cur_frame_name = name or None
        try:
            return self._compile_frame(text, cs, frames, persistent, name)
        except CompileError as e:
            tok = self._cur_tok
            if e.frame is None:
                e.frame = self._cur_frame_name
            if tok is not None:
                if e.token is None:
                    e.token = tok.text
                if e.pos is None:
                    e.pos = tok.pos
            raise

    def _compile_frame(
        self,
        text: str,
        cs: np.ndarray,
        frames: FrameManager,
        persistent: bool = False,
        name: str = "",
    ) -> CodeFrame:
        toks = tokenize(text)
        frame = frames.allocate(max(len(text), 2))
        self._cur_frame_name = name or f"frame{frame.fid}"
        start = frame.start
        # Faithful in-place step: the source text is written into the CS...
        for k, ch in enumerate(text):
            cs[start + k] = ord(ch)
        # ...and overwritten front-to-back by the bytecode.
        out: list[int] = []

        def emit(cell: int) -> int:
            v = int(cell) & 0xFFFFFFFF
            if v >= 0x80000000:
                v -= 0x100000000
            out.append(v)
            return len(out) - 1

        def emit_lit(v: int) -> None:
            if self.isa.fits_short(v):
                emit(self.isa.enc_lit(v))
            else:
                emit(self.isa.enc_op("dlit"))
                emit(v)

        isa = self.isa
        locals_: dict[str, LocalSym] = {}
        ctl: list[tuple] = []          # control-flow stack
        pending_def: str | None = None
        def_branch_pos: int = -1
        exports: list[str] = []
        it = iter(range(len(toks)))

        def next_word(i: int, what: str) -> Token:
            if i + 1 >= len(toks):
                raise CompileError(f"{what}: missing operand")
            return toks[i + 1]

        def resolve_ref(name: str, pos_hint: int) -> None:
            """Compile a reference to ``name`` (locals, dict, FIOS, DIOS)."""
            if name in locals_:
                sym = locals_[name]
                if sym.kind == "const":
                    emit_lit(sym.value)
                elif sym.kind == "defer_array":
                    sym.relocs.append(emit(isa.enc_lit(0)))  # patched later
                else:
                    emit_lit(sym.value)
                return
            entry = self.dictionary.lookup(name)
            if entry is not None:
                emit(isa.enc_call(entry.addr))
                return
            fop = self.fios.opcode(name)
            if fop is not None:
                emit(isa.enc_opcode(fop))
                return
            daddr = self.dios.address(name)
            if daddr is not None:
                emit_lit(daddr)
                return
            raise CompileError(f"unknown word {name!r}")

        i = -1
        while i + 1 < len(toks):
            i += 1
            tok = toks[i]
            self._cur_tok = tok
            self.words_compiled += 1

            if tok.kind == T_NUM:
                emit_lit(tok.value)
            elif tok.kind == T_STR:
                if len(tok.text) > 64:
                    raise CompileError("string literal exceeds 64 chars")
                emit(isa.enc_op("prstr"))
                emit(len(tok.text))
                for ch in tok.text:
                    emit(ord(ch))
            elif tok.kind == T_ARR:
                raise CompileError("array literal outside `array` declaration")
            else:
                name = ALIASES.get(tok.text, tok.text)
                # ---- compile-time words ----
                if name == ":":
                    if pending_def is not None:
                        raise CompileError("nested definitions not allowed")
                    w = next_word(i, ":")
                    i += 1
                    emit(isa.enc_op("branch"))
                    def_branch_pos = emit(0)
                    pending_def = w.text
                    self.dictionary.define(w.text, start + len(out), frame.fid)
                elif name == ";":
                    if pending_def is None:
                        raise CompileError("; without :")
                    emit(isa.enc_op("ret"))
                    out[def_branch_pos] = start + len(out)
                    pending_def = None
                elif name == "if":
                    emit(isa.enc_op("0branch"))
                    ctl.append(("if", emit(0)))
                elif name == "else":
                    if not ctl or ctl[-1][0] != "if":
                        raise CompileError("else without if")
                    _, patch = ctl.pop()
                    emit(isa.enc_op("branch"))
                    ctl.append(("if", emit(0)))
                    out[patch] = start + len(out)
                elif name == "endif":
                    if not ctl or ctl[-1][0] != "if":
                        raise CompileError("endif without if")
                    _, patch = ctl.pop()
                    out[patch] = start + len(out)
                elif name == "do":
                    emit(isa.enc_op("doinit"))
                    ctl.append(("do", start + len(out)))
                elif name == "loop":
                    if not ctl or ctl[-1][0] != "do":
                        raise CompileError("loop without do")
                    _, top = ctl.pop()
                    emit(isa.enc_op("doloop"))
                    emit(top)
                elif name == "begin":
                    ctl.append(("begin", start + len(out), []))
                elif name == "until":
                    if not ctl or ctl[-1][0] != "begin":
                        raise CompileError("until without begin")
                    _, top, brk = ctl.pop()
                    emit(isa.enc_op("0branch"))
                    emit(top)
                    for p in brk:
                        out[p] = start + len(out)
                elif name == "again":
                    if not ctl or ctl[-1][0] != "begin":
                        raise CompileError("again without begin")
                    _, top, brk = ctl.pop()
                    emit(isa.enc_op("branch"))
                    emit(top)
                    for p in brk:
                        out[p] = start + len(out)
                elif name == "while":
                    if not ctl or ctl[-1][0] != "begin":
                        raise CompileError("while without begin")
                    emit(isa.enc_op("0branch"))
                    ctl[-1][2].append(emit(0))
                elif name == "repeat":
                    if not ctl or ctl[-1][0] != "begin":
                        raise CompileError("repeat without begin")
                    _, top, brk = ctl.pop()
                    emit(isa.enc_op("branch"))
                    emit(top)
                    for p in brk:
                        out[p] = start + len(out)
                elif name == "var":
                    w = next_word(i, "var")
                    i += 1
                    emit(isa.enc_op("branch"))
                    patch = emit(0)
                    addr = start + len(out)
                    emit(0)  # the cell itself
                    out[patch] = start + len(out)
                    locals_[w.text] = LocalSym("var", addr)
                elif name == "array":
                    w = next_word(i, "array")
                    i += 1
                    spec = next_word(i, "array size/init")
                    i += 1
                    if spec.kind == T_ARR:
                        vals = spec.value
                        emit(isa.enc_op("branch"))
                        patch = emit(0)
                        emit(len(vals))              # header
                        addr = start + len(out)
                        for v in vals:
                            emit(v)
                        out[patch] = start + len(out)
                        locals_[w.text] = LocalSym("array", addr)
                    elif spec.kind == T_NUM:
                        # Uninitialized: appended at frame end (paper §3.9).
                        locals_[w.text] = LocalSym("defer_array", spec.value)
                    else:
                        raise CompileError("array needs size or { init }")
                elif name == "const":
                    w = next_word(i, "const")
                    i += 1
                    v = next_word(i, "const value")
                    i += 1
                    if v.kind != T_NUM:
                        raise CompileError("const needs numeric value")
                    locals_[w.text] = LocalSym("const", v.value)
                elif name == "export":
                    w = next_word(i, "export")
                    i += 1
                    if self.dictionary.lookup(w.text) is None:
                        raise CompileError(f"export of unknown word {w.text!r}")
                    self.dictionary.export(w.text)
                    exports.append(w.text)
                    frame.locked = True
                elif name == "$":
                    w = next_word(i, "$")
                    i += 1
                    nm = w.text
                    if nm in isa.mapfn:
                        emit_lit(isa.mapfn[nm])
                    else:
                        entry = self.dictionary.lookup(nm)
                        if entry is None:
                            raise CompileError(f"$ of unknown word {nm!r}")
                        emit_lit(entry.addr)
                elif name == "import":
                    w = next_word(i, "import")
                    i += 1
                    if self.dictionary.lookup(w.text) is None and self.fios.opcode(w.text) is None:
                        raise CompileError(f"import failed: {w.text!r} not installed")
                elif name == "exception":
                    # `$ handler exception <exc>`: handler addr already on
                    # stack as literal; exc name resolves to its id literal,
                    # then the runtime `exception` op binds them.
                    w = next_word(i, "exception")
                    i += 1
                    if w.text not in EXC_NAMES:
                        raise CompileError(f"unknown exception {w.text!r}")
                    emit_lit(EXC_NAMES[w.text])
                    emit(isa.enc_op("exception"))
                else:
                    opc = self.core_opcode(name)
                    if opc is not None:
                        emit(isa.enc_opcode(opc))
                    else:
                        resolve_ref(name, tok.end_pos)

            # Paper invariant: in-place bytecode never overtakes the text.
            # (toks[i] is the last token consumed, including look-aheads.)
            consumed_end = toks[i].end_pos
            if len(out) > consumed_end + 1:
                raise CompileError(
                    f"in-place overflow at token {tok.text!r}: "
                    f"{len(out)} cells > {consumed_end + 1} chars"
                )

        if pending_def is not None:
            raise CompileError("unterminated definition")
        if ctl:
            raise CompileError(f"unterminated control structure {ctl[-1][0]}")

        # Ensure the frame terminates (paper: frame processing ends at `end`).
        if not out or out[-1] != isa.enc_op("end"):
            emit(isa.enc_op("end"))

        # Append deferred (uninitialized) arrays and patch references.
        for nm, sym in locals_.items():
            if sym.kind == "defer_array":
                emit(sym.value)                # header
                addr = start + len(out)
                for _ in range(sym.value):
                    emit(0)
                for pos in sym.relocs:
                    out[pos] = isa.enc_lit(addr)

        # Grow frame if bytecode + appended data exceeds the text allocation.
        if len(out) > frame.end - frame.start:
            frames.grow(frame, len(out) - (frame.end - frame.start))
        # Write bytecode (overwrites the text in place).
        cs[start : start + len(out)] = np.array(out, dtype=np.int64).astype(np.int32)
        # Zero the tail of the text region (beyond the compiled code).
        if start + len(out) < frame.end:
            cs[start + len(out) : frame.end] = 0
        frame.exports = exports
        frame.persistent = persistent
        return frame
