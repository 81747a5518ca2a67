"""Batched bytecode interpreter in PyTorch — paper §3.10 (Alg. 1) + Alg. 6.

The port's CPU semantics of the REXA VM and the tail of the vmloop kernel
(``repro_torch.kernels.vmloop``).  It is the counterpart of the reference's
``repro.core.vm.interp.Interpreter`` and reproduces it bit for bit: every op
body below transliterates the reference's body operation for operation,
int32 wraparound, index clamping and dropped out-of-range writes included.

Torch has no ``vmap`` over data-dependent control flow, so the interpreter
is written over a stacked (node-leading) state from the start: at each step
the live nodes are grouped by what their next instruction is (an opcode, a
literal, a call, a bad tag or pc, a failed stack pre-check), and each
group's body runs on its subset of rows with gathers and scatters indexed
by ``(row, current task)``.  One device-to-host read per step (the group
keys and sizes) drives the loop.  All functions update the state in place.

Index semantics: JAX clamps out-of-range gathers and drops out-of-range
scatters; torch raises on both.  Every index here is clamped explicitly,
and every write the reference drops is masked (the row's old value is
written back), so no write ever leaves its row.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch

from repro_torch.config import VMConfig
from repro_torch.core.fixedpoint import fplog10_t, fpsigmoid_t, fpsin_t, fpsqrt_t
from repro_torch.core.vm.spec import (
    EXC_BOUNDS,
    EXC_DIVBYZERO,
    EXC_STACK,
    EXC_TRAP,
    FIOS_BASE,
    ISA,
    MEM_BASE,
    NUM_EXC,
    STACK_EFFECTS,
    ST_DONE,
    ST_ERR,
    ST_EVENT,
    ST_FREE,
    ST_HALT,
    ST_IOWAIT,
    ST_RUN,
    ST_SLEEP,
    ST_YIELD,
    TAG_CALL,
    TAG_LIT,
    TAG_OP,
    get_isa,
)
from repro_torch.core.vm.vmstate import OUT_CHR, OUT_NUM

I32 = torch.int32
I32_MIN = -(2 ** 31)

STACK_NEEDS: dict[str, tuple[int, int, int, int]] = dict(STACK_EFFECTS)


def _fdiv(a, b):
    """Floor division on int32 tensors (jnp ``//``)."""
    return torch.div(a, b, rounding_mode="floor")


def truncdiv(a: torch.Tensor, b) -> torch.Tensor:
    """C-style division toward zero, as the reference's ``_truncdiv``:
    ``abs(a) // max(abs(b), 1)`` with a sign fix-up.  ``abs`` wraps at
    INT_MIN, so INT_MIN / 3 is 715827883, exactly as in the reference."""
    b = torch.as_tensor(b, dtype=I32, device=a.device)
    q = _fdiv(torch.abs(a), torch.clamp(torch.abs(b), min=1))
    return torch.where((a < 0) ^ (b < 0), -q, q)


def truncmod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a - truncdiv(a, b) * b


def muldiv(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a*b/c`` with a 64-bit intermediate, as the reference's ``_muldiv``:
    the low 32 bits of ``floor(|a|*|b| / C)`` with ``C = max(abs(c), 1)``
    taken in signed int32 (so c = INT_MIN gives C = 1), then the sign."""
    sign = (a < 0) ^ (b < 0) ^ (c < 0)
    mask32 = 0xFFFFFFFF
    A = torch.abs(a).long() & mask32
    B = torch.abs(b).long() & mask32
    C = torch.clamp(torch.abs(c), min=1).long()
    q = (_fdiv(A * B, C) & mask32).to(I32)
    return torch.where(sign, -q, q)


def bins_of(pc_ok: torch.Tensor, tag: torch.Tensor, payload: torch.Tensor,
            num_ops: int) -> torch.Tensor:
    """Per row, the retirement bin (``repro_torch.obs.metrics``) of the
    instruction fetched as ``(pc_ok, tag, payload)``: the opcode for tag 0
    (payload clipped to ``num_ops``, the fios/trap bin), ``num_ops + tag``
    for a literal or a call or a reserved tag, ``num_ops + 3`` for an
    invalid pc."""
    b = torch.where(tag == 0, torch.clamp(payload, 0, num_ops), num_ops + tag)
    return torch.where(pc_ok, b, num_ops + 3)


def _cmp(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x, -1, 0).to(I32)


class _Rows:
    """One group of nodes executing the same kind of instruction: the rows
    ``r`` of a stacked state and their current task ``t``.  The helpers
    mirror the reference interpreter's state helpers one to one."""

    def __init__(self, it: "Interpreter", S, r: torch.Tensor):
        self.it = it
        self.S = S
        self.r = r
        self.t = S.cur[r].long()

    # -- per-task scalar fields ------------------------------------------------

    def get(self, field: str) -> torch.Tensor:
        return getattr(self.S, field)[self.r, self.t]

    def set(self, field: str, v, where=None) -> None:
        x = getattr(self.S, field)
        x[self.r, self.t] = _rowval(v, x.dtype, self.r, where, x[self.r, self.t] if where is not None else None)

    def add(self, field: str, d) -> None:
        x = getattr(self.S, field)
        x[self.r, self.t] = x[self.r, self.t] + d

    # -- data / FOR stacks -------------------------------------------------------

    def dpeek(self, k: int = 1) -> torch.Tensor:
        DS = self.it.cfg.ds_size
        idx = torch.clamp(self.get("dsp") - k, 0, DS - 1).long()
        return self.S.ds[self.r, self.t, idx]

    def dpop(self, n: int) -> list[torch.Tensor]:
        DS = self.it.cfg.ds_size
        dsp = self.get("dsp")
        vals = [
            self.S.ds[self.r, self.t, torch.clamp(dsp - n + k, 0, DS - 1).long()]
            for k in range(n)
        ]
        self.set("dsp", dsp - n)
        return vals

    def dpush(self, v, where=None) -> None:
        DS = self.it.cfg.ds_size
        dsp = self.get("dsp")
        idx = torch.clamp(dsp, 0, DS - 1).long()
        old = self.S.ds[self.r, self.t, idx] if where is not None else None
        self.set("dsp", dsp + 1, where)
        self.S.ds[self.r, self.t, idx] = _rowval(v, I32, self.r, where, old)

    def fpush(self, v) -> None:
        FS = self.it.cfg.fs_size
        fsp = self.get("fsp")
        self.S.fs[self.r, self.t, torch.clamp(fsp, 0, FS - 1).long()] = v
        self.set("fsp", fsp + 1)

    def fpeek(self, k: int) -> torch.Tensor:
        FS = self.it.cfg.fs_size
        idx = torch.clamp(self.get("fsp") - k, 0, FS - 1).long()
        return self.S.fs[self.r, self.t, idx]

    # -- control -------------------------------------------------------------------

    def pc(self) -> torch.Tensor:
        return self.get("pc")

    def set_pc(self, v, where=None) -> None:
        self.set("pc", v, where)

    def raise_exc(self, code, where=None) -> None:
        p = self.get("pending_exc")
        hit = p == 0 if where is None else (p == 0) & where
        self.set("pending_exc", torch.where(hit, code, p))

    def set_status(self, s, where=None) -> None:
        self.set("tstatus", s, where)

    def cs_at(self, addr: torch.Tensor) -> torch.Tensor:
        CS = self.it.cfg.cs_size
        return self.S.cs[self.r, torch.clamp(addr, 0, CS - 1).long()]

    # -- unified CS/MEM addressing ---------------------------------------------------

    def addr_valid(self, addr: torch.Tensor) -> torch.Tensor:
        cfg = self.it.cfg
        in_cs = (addr >= 0) & (addr < cfg.cs_size)
        in_mem = (addr >= MEM_BASE) & (addr < MEM_BASE + cfg.mem_size)
        return in_cs | in_mem

    def mread(self, addr: torch.Tensor) -> torch.Tensor:
        cfg = self.it.cfg
        in_mem = addr >= MEM_BASE
        cs_v = self.S.cs[self.r, torch.clamp(addr, 0, cfg.cs_size - 1).long()]
        mem_v = self.S.mem[self.r, torch.clamp(addr - MEM_BASE, 0, cfg.mem_size - 1).long()]
        return torch.where(in_mem, mem_v, cs_v)

    def mwrite(self, addr: torch.Tensor, v: torch.Tensor, where=None) -> None:
        cfg = self.it.cfg
        in_mem = addr >= MEM_BASE
        w = torch.ones_like(in_mem) if where is None else where
        ci = torch.clamp(addr, 0, cfg.cs_size - 1).long()
        self.S.cs[self.r, ci] = torch.where(w & ~in_mem, v, self.S.cs[self.r, ci])
        mi = torch.clamp(addr - MEM_BASE, 0, cfg.mem_size - 1).long()
        self.S.mem[self.r, mi] = torch.where(w & in_mem, v, self.S.mem[self.r, mi])

    def vread(self, addr: torch.Tensor, window: int, length=None):
        """Gather ``window`` cells from addr; zero beyond the length (the
        array header at ``addr - 1`` unless given)."""
        cfg = self.it.cfg
        ln = self.mread(addr - 1) if length is None else length
        ln = torch.clamp(ln, 0, window)
        k = self.it.arange(window, addr.device)
        idx = addr[:, None] + k
        in_mem = (addr >= MEM_BASE)[:, None]
        r2 = self.r[:, None]
        cs_v = self.S.cs[r2, torch.clamp(idx, 0, cfg.cs_size - 1).long()]
        mem_v = self.S.mem[r2, torch.clamp(idx - MEM_BASE, 0, cfg.mem_size - 1).long()]
        vals = torch.where(in_mem, mem_v, cs_v)
        mask = k < ln[:, None]
        return torch.where(mask, vals, 0), ln, mask

    def vwrite(self, addr: torch.Tensor, vals: torch.Tensor, ln: torch.Tensor) -> None:
        cfg = self.it.cfg
        window = vals.shape[1]
        k = self.it.arange(window, addr.device)
        mask = k < ln[:, None]
        in_mem = (addr >= MEM_BASE)[:, None]
        idx = addr[:, None] + k
        _window_write(self.S.cs, self.r, torch.clamp(idx, 0, cfg.cs_size - 1).long(),
                      vals, mask & ~in_mem, cfg.cs_size - 1)
        _window_write(self.S.mem, self.r, torch.clamp(idx - MEM_BASE, 0, cfg.mem_size - 1).long(),
                      vals, mask & in_mem, cfg.mem_size - 1)

    # -- output ring ---------------------------------------------------------------

    def out_pairs(self, kinds: torch.Tensor, vals: torch.Tensor, n: torch.Tensor) -> None:
        """Write pairs ``(kinds[k], vals[k])`` for ``k < n`` at ring entries
        ``outp + k`` (the caller keeps ``outp + n <= OUTN``).  The whole
        row is rebuilt, so no two writes of a row can collide."""
        OUTN = self.it.cfg.out_ring_size
        window = vals.shape[1]
        p = self.S.outp[self.r]
        j = self.it.arange(2 * OUTN, p.device)
        kk = _fdiv(j, 2)[None, :] - p[:, None]
        inside = (kk >= 0) & (kk < n[:, None])
        kkc = torch.clamp(kk, 0, window - 1).long()
        val = torch.where((j % 2 == 0)[None, :], kinds.gather(1, kkc), vals.gather(1, kkc))
        self.S.out[self.r] = torch.where(inside, val, self.S.out[self.r])

    def out_write(self, kind: int, val: torch.Tensor) -> None:
        OUTN = self.it.cfg.out_ring_size
        p = self.S.outp[self.r]
        ok = p < OUTN
        kinds = torch.full_like(val, kind)[:, None]
        self.out_pairs(kinds, val[:, None], ok.to(I32))
        self.S.outp[self.r] = torch.where(ok, p + 1, p)

    def out_write_vec(self, vals: torch.Tensor, ln: torch.Tensor) -> None:
        OUTN = self.it.cfg.out_ring_size
        window = vals.shape[1]
        p = self.S.outp[self.r]
        n = torch.clamp(torch.minimum(ln, OUTN - p), 0, window)
        self.out_pairs(torch.full_like(vals, OUT_NUM), vals, n)
        self.S.outp[self.r] = torch.clamp(p + torch.clamp(ln, 0, window), max=OUTN)

    # -- scale vectors (paper Tab. 5) ------------------------------------------------

    def apply_scalevec(self, vals, ln, saddr):
        s_on = saddr != 0
        svals, _, _ = self.vread(torch.where(s_on, saddr, 1), self.it.cfg.max_vec, length=ln)
        return vscale(vals, svals, s_on[:, None])


def _rowval(v, dtype, r: torch.Tensor, where=None, old=None) -> torch.Tensor:
    """A per-row value ``v`` (a tensor, or a Python number for every row) of
    ``dtype`` for rows ``r``, taken only ``where`` holds (``old`` elsewhere).
    A Python number goes into the kernel as an argument (``torch.full``,
    ``torch.where``): building a device tensor from it would be a blocking
    host-to-device copy."""
    if isinstance(v, torch.Tensor):
        v = v.to(dtype)
    elif where is None:
        return torch.full(r.shape, v, dtype=dtype, device=r.device)
    return v if where is None else torch.where(where, v, old)


def vscale(vals, svals, s_on):
    expanded = vals * torch.where(svals > 0, svals, 1)
    divisor = torch.where(svals < 0, -svals, 1)
    reduced = torch.sign(vals) * _fdiv(torch.abs(vals), divisor)
    scaled = torch.where(svals > 0, expanded, torch.where(svals < 0, reduced, vals))
    return scaled if s_on is True else torch.where(s_on, scaled, vals)


def _window_write(field: torch.Tensor, r: torch.Tensor, c: torch.Tensor,
                  vals: torch.Tensor, mask: torch.Tensor, hi: int) -> None:
    """Write ``vals[k]`` at ``field[r, c[k]]`` where ``mask`` (a prefix of
    each row), the last write winning, as the reference's sequential
    scatter does.  ``c`` is a clamped, non-decreasing window of indices, so
    only the clamp ends ``0`` and ``hi`` repeat; every element of the window
    writes, the unmasked ones their old value and the repeated ends the
    value of their last masked writer, so colliding writes always agree."""
    r2 = r[:, None]
    old = field[r2, c]
    k = torch.arange(c.shape[1], device=c.device)

    def last(sel):
        kk = torch.where(sel, k, -1).amax(dim=1)
        return kk >= 0, vals.gather(1, torch.clamp(kk, min=0)[:, None])

    has_lo, v_lo = last(mask & (c == 0))
    has_hi, v_hi = last(mask & (c == hi))
    new = torch.where(mask, vals, old)
    new = torch.where((c == 0) & has_lo[:, None], v_lo, new)
    new = torch.where((c == hi) & has_hi[:, None], v_hi, new)
    field[r2, c] = new


# ---------------------------------------------------------------------------
# Op bodies: name -> fn(c: _Rows), each the reference body in torch
# ---------------------------------------------------------------------------

def _bodies(cfg: VMConfig, isa: ISA) -> dict[str, Callable[[_Rows], None]]:
    DS, RS = cfg.ds_size, cfg.rs_size
    MV = cfg.max_vec
    OUTN = cfg.out_ring_size
    B: dict[str, Callable[[_Rows], None]] = {}

    def bin_op(f):
        def op(c):
            a, b = c.dpop(2)
            c.dpush(f(a, b))
        return op

    def un_op(f):
        def op(c):
            (v,) = c.dpop(1)
            c.dpush(f(v))
        return op

    def cmp_op(f):
        return bin_op(lambda a, b: _cmp(f(a, b)))

    B["nop"] = lambda c: None
    B["dup"] = lambda c: c.dpush(c.dpeek(1))
    B["drop"] = lambda c: c.dpop(1)

    def op_swap(c):
        a, b = c.dpop(2)
        c.dpush(b)
        c.dpush(a)
    B["swap"] = op_swap
    B["over"] = lambda c: c.dpush(c.dpeek(2))

    def op_rot(c):
        a, b, d = c.dpop(3)
        c.dpush(b)
        c.dpush(d)
        c.dpush(a)
    B["rot"] = op_rot

    def op_nip(c):
        _, b = c.dpop(2)
        c.dpush(b)
    B["nip"] = op_nip

    def op_tuck(c):
        a, b = c.dpop(2)
        c.dpush(b)
        c.dpush(a)
        c.dpush(b)
    B["tuck"] = op_tuck

    def op_pick(c):
        (n,) = c.dpop(1)
        dsp = c.get("dsp")
        idx = torch.clamp(dsp - 1 - n, 0, DS - 1).long()
        bad = (n < 0) | (n >= dsp)
        c.dpush(c.S.ds[c.r, c.t, idx])
        c.raise_exc(EXC_STACK, bad)
    B["pick"] = op_pick

    def op_2dup(c):
        a, b = c.dpeek(2), c.dpeek(1)
        c.dpush(a)
        c.dpush(b)
    B["2dup"] = op_2dup
    B["2drop"] = lambda c: c.dpop(2)
    B["depth"] = lambda c: c.dpush(c.get("dsp"))

    B["+"] = bin_op(lambda a, b: a + b)
    B["-"] = bin_op(lambda a, b: a - b)
    B["*"] = bin_op(lambda a, b: a * b)

    def op_div(c):
        a, b = c.dpop(2)
        c.dpush(truncdiv(a, b))
        c.raise_exc(EXC_DIVBYZERO, b == 0)
    B["/"] = op_div

    def op_mod(c):
        a, b = c.dpop(2)
        c.dpush(truncmod(a, b))
        c.raise_exc(EXC_DIVBYZERO, b == 0)
    B["mod"] = op_mod

    def op_muldiv(c):
        a, b, d = c.dpop(3)
        c.dpush(muldiv(a, b, d))
        c.raise_exc(EXC_DIVBYZERO, d == 0)
    B["*/"] = op_muldiv

    B["negate"] = un_op(lambda v: -v)
    B["abs"] = un_op(torch.abs)
    B["min"] = bin_op(torch.minimum)
    B["max"] = bin_op(torch.maximum)
    B["1+"] = un_op(lambda v: v + 1)
    B["1-"] = un_op(lambda v: v - 1)
    B["2*"] = un_op(lambda v: v * 2)
    B["2/"] = un_op(lambda v: v >> 1)

    B["="] = cmp_op(lambda a, b: a == b)
    B["<>"] = cmp_op(lambda a, b: a != b)
    B["<"] = cmp_op(lambda a, b: a < b)
    B[">"] = cmp_op(lambda a, b: a > b)
    B["<="] = cmp_op(lambda a, b: a <= b)
    B[">="] = cmp_op(lambda a, b: a >= b)
    B["0="] = un_op(lambda v: _cmp(v == 0))
    B["0<"] = un_op(lambda v: _cmp(v < 0))
    B["0>"] = un_op(lambda v: _cmp(v > 0))

    B["and"] = bin_op(torch.bitwise_and)
    B["or"] = bin_op(torch.bitwise_or)
    B["xor"] = bin_op(torch.bitwise_xor)
    B["invert"] = un_op(torch.bitwise_not)
    B["lshift"] = bin_op(lambda a, n: a << (n & 31))
    B["rshift"] = bin_op(lambda a, n: a >> (n & 31))

    # memory --------------------------------------------------------------------

    def op_fetch(c):
        (addr,) = c.dpop(1)
        c.dpush(c.mread(addr))
        c.raise_exc(EXC_BOUNDS, ~c.addr_valid(addr))
    B["@"] = op_fetch

    def op_store(c):
        v, addr = c.dpop(2)
        c.mwrite(addr, v)
        c.raise_exc(EXC_BOUNDS, ~c.addr_valid(addr))
    B["!"] = op_store

    def op_addstore(c):
        v, addr = c.dpop(2)
        c.mwrite(addr, c.mread(addr) + v)
        c.raise_exc(EXC_BOUNDS, ~c.addr_valid(addr))
    B["+!"] = op_addstore

    def op_get(c):
        n, arr = c.dpop(2)
        ln = c.mread(arr - 1)
        bad = (n < 0) | (n >= ln)
        hi = torch.clamp(ln - 1, min=0)
        c.dpush(c.mread(arr + torch.minimum(torch.clamp(n, min=0), hi)))
        c.raise_exc(EXC_BOUNDS, bad)
    B["get"] = op_get

    def op_put(c):
        v, n, arr = c.dpop(3)
        ln = c.mread(arr - 1)
        bad = (n < 0) | (n >= ln)
        c.mwrite(arr + n, v, ~bad)
        c.raise_exc(EXC_BOUNDS, bad)
    B["put"] = op_put

    def op_push(c):
        v, arr = c.dpop(2)
        top = c.mread(arr)
        ln = c.mread(arr - 1)
        bad = top + 1 >= ln
        c.mwrite(arr + top + 1, v, ~bad)
        c.mwrite(arr, top + 1, ~bad)
        c.raise_exc(EXC_BOUNDS, bad)
    B["push"] = op_push

    def op_pop(c):
        (arr,) = c.dpop(1)
        top = c.mread(arr)
        bad = top <= 0
        v = c.mread(arr + torch.clamp(top, min=1))
        c.dpush(torch.where(bad, 0, v))
        c.mwrite(arr, top - 1, ~bad)
        c.raise_exc(EXC_BOUNDS, bad)
    B["pop"] = op_pop

    def op_fill(c):
        v, arr = c.dpop(2)
        _, ln, _ = c.vread(arr, MV)
        c.vwrite(arr, v[:, None].expand(-1, MV), ln)
    B["fill"] = op_fill

    def op_len(c):
        (arr,) = c.dpop(1)
        c.dpush(c.mread(arr - 1))
    B["len"] = op_len

    # control ---------------------------------------------------------------------

    B["branch"] = lambda c: c.set_pc(c.cs_at(c.pc()))

    def op_0branch(c):
        (f,) = c.dpop(1)
        pc = c.pc()
        c.set_pc(torch.where(f == 0, c.cs_at(pc), pc + 1))
    B["0branch"] = op_0branch

    def op_ret(c):
        rsp = c.get("rsp")
        under = rsp < 1
        addr = c.S.rs[c.r, c.t, torch.clamp(rsp - 1, 0, RS - 1).long()]
        c.set("rsp", rsp - 1)
        c.set_pc(addr)
        c.raise_exc(EXC_STACK, under)
        c.set_status(ST_ERR, under)
    B["ret"] = op_ret
    B["exit"] = op_ret

    def op_exec(c):
        (addr,) = c.dpop(1)
        rsp = c.get("rsp")
        over = rsp >= RS
        c.S.rs[c.r, c.t, torch.clamp(rsp, 0, RS - 1).long()] = c.pc()
        c.set("rsp", rsp + 1)
        c.set_pc(addr)
        c.raise_exc(EXC_STACK, over)
    B["exec"] = op_exec

    def op_doinit(c):
        limit, start = c.dpop(2)
        c.fpush(limit)
        c.fpush(start)
    B["doinit"] = op_doinit

    def op_doloop(c):
        FS = cfg.fs_size
        pc = c.pc()
        top_addr = c.cs_at(pc)
        fsp = c.get("fsp")
        limit = c.fpeek(2)
        ctr = c.fpeek(1) + 1
        done = ctr >= limit
        c.S.fs[c.r, c.t, torch.clamp(fsp - 1, 0, FS - 1).long()] = ctr
        c.set("fsp", fsp + torch.where(done, -2, 0))
        c.set_pc(torch.where(done, pc + 1, top_addr))
    B["doloop"] = op_doloop

    B["i"] = lambda c: c.dpush(c.fpeek(1))
    B["j"] = lambda c: c.dpush(c.fpeek(3))
    B["unloop"] = lambda c: c.add("fsp", -2)
    B["halt"] = lambda c: c.set_status(ST_HALT)
    B["end"] = lambda c: c.set_status(torch.where(c.t == 0, ST_DONE, ST_FREE))

    def op_dlit(c):
        pc = c.pc()
        c.dpush(c.cs_at(pc))
        c.set_pc(pc + 1)
    B["dlit"] = op_dlit

    # io / printing -----------------------------------------------------------------

    def op_print(c):
        (v,) = c.dpop(1)
        c.out_write(OUT_NUM, v)
    B["."] = op_print

    def op_emit(c):
        (v,) = c.dpop(1)
        c.out_write(OUT_CHR, v)
    B["emit"] = op_emit
    B["cr"] = lambda c: c.out_write(OUT_CHR, torch.full_like(c.r, 10, dtype=I32))

    MAXSTR = 64

    def op_prstr(c):
        pc = c.pc()
        ln = torch.clamp(c.cs_at(pc), 0, MAXSTR)
        k = c.it.arange(MAXSTR, pc.device)
        chars = c.S.cs[c.r[:, None], torch.clamp(pc[:, None] + 1 + k, 0, cfg.cs_size - 1).long()]
        p = c.S.outp[c.r]
        n = torch.clamp(torch.minimum(ln, OUTN - p), 0, MAXSTR)
        c.out_pairs(torch.full_like(chars, OUT_CHR), chars, n)
        c.S.outp[c.r] = torch.clamp(p + ln, max=OUTN)
        c.set_pc(pc + 1 + ln)
    B["prstr"] = op_prstr

    def op_vecprint(c):
        (arr,) = c.dpop(1)
        vals, ln, _ = c.vread(arr, MV)
        c.out_write_vec(vals, ln)
    B["vecprint"] = op_vecprint

    def make_io_suspend(name):
        opc = isa.opcode[name]

        def op(c):
            # Rewind pc so the host re-inspects the op; args stay on DS.
            c.set_pc(c.pc() - 1)
            c.set("io_op", opc)
            c.set_status(ST_IOWAIT)
        return op

    for _n in ("out", "in", "send", "receive"):
        B[_n] = make_io_suspend(_n)

    # tasks -------------------------------------------------------------------------

    B["yield"] = lambda c: c.set_status(ST_YIELD)

    def op_sleep(c):
        (ms_v,) = c.dpop(1)
        c.set("timeout", c.S.now[c.r] + ms_v)
        c.set_status(ST_SLEEP)
    B["sleep"] = op_sleep

    def op_await(c):
        ms_v, val, addr = c.dpop(3)
        c.set("timeout", c.S.now[c.r] + ms_v)
        c.set("ev_addr", addr)
        c.set("ev_val", val)
        c.set_status(ST_EVENT)
    B["await"] = op_await

    def op_task(c):
        S, r = c.S, c.r
        prio, deadline, addr = c.dpop(3)
        free = S.tstatus[r] == ST_FREE
        slot = free.to(I32).argmax(dim=1)
        sl = slot.long()
        found = free.gather(1, sl[:, None])[:, 0]

        def put(field, v):
            x = getattr(S, field)
            x[r, sl] = _rowval(v, x.dtype, r, found, x[r, sl])

        put("pc", addr)
        put("dsp", 0)
        # Return address 0 = the canonical `end` cell.
        S.rs[r, sl, 0] = torch.where(found, 0, S.rs[r, sl, 0])
        put("rsp", 1)
        put("fsp", 0)
        put("tstatus", ST_YIELD)
        put("prio", prio)
        put("deadline", deadline)
        for f in ("catch_pc", "catch_rsp", "pending_exc", "last_exc", "io_op"):
            put(f, 0)
        c.dpush(torch.where(found, slot, -1))
    B["task"] = op_task

    B["taskid"] = lambda c: c.dpush(c.S.cur[c.r])
    B["ms"] = lambda c: c.dpush(c.S.now[c.r])
    B["steps"] = lambda c: c.dpush(c.S.steps[c.r])

    # exceptions ----------------------------------------------------------------------

    def op_exception(c):
        handler, exc = c.dpop(2)
        c.S.handlers[c.r, torch.clamp(exc, 0, NUM_EXC - 1).long()] = handler
    B["exception"] = op_exception

    def op_catch(c):
        c.dpush(c.get("last_exc"))
        c.set("last_exc", 0)
        c.set("catch_pc", c.pc() - 1)
        c.set("catch_rsp", c.get("rsp"))
    B["catch"] = op_catch

    def op_throw(c):
        (exc,) = c.dpop(1)
        c.raise_exc(torch.clamp(exc, 1, NUM_EXC - 1))
    B["throw"] = op_throw

    # fixed-point DSP scalars -------------------------------------------------------------

    B["sin"] = un_op(fpsin_t)
    B["log"] = un_op(lambda v: fplog10_t(v) * 10)
    B["sigmoid"] = un_op(fpsigmoid_t)
    B["relu"] = un_op(lambda v: torch.clamp(v, min=0))
    B["sqrt"] = un_op(fpsqrt_t)

    def op_rnd(c):
        (n,) = c.dpop(1)
        rng = (c.S.rng[c.r] * 1664525 + 1013904223) & 0xFFFFFFFF
        c.S.rng[c.r] = rng
        rv = (rng >> 16).to(I32)
        c.dpush(torch.where(n > 0, torch.remainder(rv, torch.clamp(n, min=1)), 0))
    B["rnd"] = op_rnd

    # vector / ANN ops ----------------------------------------------------------------------

    def op_vecload(c):
        src, srcoff, dst = c.dpop(3)
        _, ln, _ = c.vread(dst, MV)
        vals, _, _ = c.vread(src + srcoff, MV, length=ln)
        c.vwrite(dst, vals, ln)
    B["vecload"] = op_vecload

    def op_vecscale(c):
        src, dst, saddr = c.dpop(3)
        _, ln, _ = c.vread(dst, MV)
        vals, _, _ = c.vread(src, MV, length=ln)
        svals, _, _ = c.vread(saddr, MV, length=ln)
        c.vwrite(dst, vscale(vals, svals, True), ln)
    B["vecscale"] = op_vecscale

    def make_eltwise(f):
        def op(c):
            a, b, dst, saddr = c.dpop(4)
            _, ln, _ = c.vread(dst, MV)
            av, _, _ = c.vread(a, MV, length=ln)
            bv, _, _ = c.vread(b, MV, length=ln)
            c.vwrite(dst, c.apply_scalevec(f(av, bv), ln, saddr), ln)
        return op

    B["vecadd"] = make_eltwise(lambda a, b: a + b)
    B["vecmul"] = make_eltwise(lambda a, b: a * b)

    def op_vecfold(c):
        inv, wgt, outv, saddr = c.dpop(4)
        iv, n, _ = c.vread(inv, MV)
        _, m, _ = c.vread(outv, MV)
        k = c.it.arange(MV, inv.device)
        ii, jj = k[:, None], k[None, :]
        flat = wgt[:, None, None] + ii * m[:, None, None] + jj       # (R, MV, MV)
        in_mem = (wgt >= MEM_BASE)[:, None, None]
        r3 = c.r[:, None, None]
        cs_w = c.S.cs[r3, torch.clamp(flat, 0, cfg.cs_size - 1).long()]
        mem_w = c.S.mem[r3, torch.clamp(flat - MEM_BASE, 0, cfg.mem_size - 1).long()]
        w = torch.where(in_mem, mem_w, cs_w)
        wmask = (ii < n[:, None, None]) & (jj < m[:, None, None])
        w = torch.where(wmask, w, 0)
        acc = (iv[:, :, None] * w).sum(dim=1).to(I32)     # int32 wraparound sum
        c.vwrite(outv, c.apply_scalevec(acc, m, saddr), m)
    B["vecfold"] = op_vecfold

    def op_vecmap(c):
        src, dst, fn, saddr = c.dpop(4)
        _, ln, _ = c.vread(dst, MV)
        vals, _, _ = c.vread(src, MV, length=ln)
        f = torch.clamp(fn, 0, 4)[:, None]
        mapped = torch.where(f == 0, fpsigmoid_t(vals),
                 torch.where(f == 1, torch.clamp(vals, min=0),
                 torch.where(f == 2, fpsin_t(vals),
                 torch.where(f == 3, fplog10_t(vals) * 10, fpsqrt_t(vals)))))
        c.vwrite(dst, c.apply_scalevec(mapped, ln, saddr), ln)
    B["vecmap"] = op_vecmap

    def op_dotprod(c):
        a, b = c.dpop(2)
        av, n, _ = c.vread(a, MV)
        bv, _, _ = c.vread(b, MV, length=n)
        c.dpush((av * bv).sum(dim=1).to(I32))
    B["dotprod"] = op_dotprod

    def op_vecmax(c):
        (arr,) = c.dpop(1)
        vals, _, mask = c.vread(arr, MV)
        vals = torch.where(mask, vals, I32_MIN)
        c.dpush(vals.argmax(dim=1).to(I32))
    B["vecmax"] = op_vecmax

    def iir_lowpass(vals, ln, k):
        """y_i = y_{i-1} + k*(x_i - y_{i-1})/1000, y_{-1} = x_0."""
        y = vals[:, 0]
        ys = []
        for i in range(MV):
            y2 = y + truncdiv(k * (vals[:, i] - y), 1000)
            y = torch.where(i < ln, y2, y)
            ys.append(y)
        return torch.stack(ys, dim=1)

    def make_filter(kind):
        def op(c):
            arr, off, ln_req, k = c.dpop(4)
            base = arr + off
            hdr_ln = c.mread(arr - 1)
            ln = torch.clamp(torch.minimum(ln_req, hdr_ln - off), 0, MV)
            vals, _, _ = c.vread(base, MV, length=ln)
            if kind == "hull":
                y = iir_lowpass(torch.abs(vals), ln, k)
            elif kind == "lowp":
                y = iir_lowpass(vals, ln, k)
            else:
                y = vals - iir_lowpass(vals, ln, k)
            c.vwrite(base, y, ln)
        return op

    B["hull"] = make_filter("hull")
    B["lowp"] = make_filter("lowp")
    B["highp"] = make_filter("highp")
    return B


# ---------------------------------------------------------------------------
# The interpreter
# ---------------------------------------------------------------------------

# Group keys beyond the opcodes 0..num_ops (num_ops = FIOS call or trap).
_K_LIT, _K_CALL, _K_TAGBAD, _K_PCBAD, _K_STACK, _K_BAIL, _K_IDLE = range(-7, 0)


class Interpreter:
    """Batched schedule/vmloop/run_slice for one (VMConfig, ISA) pair over
    stacked states on any device.  Every entry point updates ``S`` in
    place.

    ``elide_checks=True`` drops the per-step stack pre-check (the stack
    effect tested before dispatch) and the literal push's overflow test, as
    the reference's ``Interpreter(elide_checks=True)``.  It is sound only
    for programs the static verifier (``repro_torch.analysis``) proved
    EXC_STACK-free: every check inside a word's body (``pick`` bounds, the
    call/ret return-stack checks, division by zero, address bounds) stays,
    so a verified program runs byte for byte as with the checks.  On a
    program that did not verify the stack pointers may leave their stacks;
    every stack index is clamped into its row, so nothing raises or
    touches another node, and the vmloop kernel's checks-elided instance
    gives the same bytes (the reference's result there is undefined)."""

    def __init__(self, cfg: VMConfig, isa: ISA | None = None, elide_checks: bool = False):
        self.cfg = cfg
        self.isa = isa or get_isa()
        self.elide_checks = bool(elide_checks)
        self.num_ops = self.isa.num_ops
        B = _bodies(cfg, self.isa)
        self.bodies: list[Callable[[_Rows], None]] = []
        need = []
        for code in range(self.num_ops):
            nm = self.isa.name[code]
            if nm not in B:
                raise RuntimeError(f"opcode {nm!r} not implemented")
            self.bodies.append(B[nm])
            need.append(STACK_NEEDS.get(nm, (0, 0, 0, 0)))
        self.bodies.append(self._fios_or_trap)
        need.append((0, 0, 0, 0))
        self._needs_host = list(zip(*need))       # din, dout, fin, fout
        self._dev: dict = {}

    # -- per-device constants ----------------------------------------------------

    def arange(self, n: int, device) -> torch.Tensor:
        key = ("arange", n, str(device))
        if key not in self._dev:
            self._dev[key] = torch.arange(n, dtype=I32, device=device)
        return self._dev[key]

    def needs(self, device) -> torch.Tensor:
        """(4, num_ops + 1) int32: din, dout, fin, fout per opcode."""
        key = ("needs", str(device))
        if key not in self._dev:
            self._dev[key] = torch.tensor(self._needs_host, dtype=I32, device=device)
        return self._dev[key]

    # -- FIOS / trap ---------------------------------------------------------------

    def _fios_or_trap(self, c: _Rows) -> None:
        pc = c.pc() - 1
        opcode = c.cs_at(pc) >> 2
        is_fios = opcode >= FIOS_BASE
        c.set_pc(pc, is_fios)
        c.set("io_op", opcode, is_fios)
        c.set_status(ST_IOWAIT, is_fios)
        c.raise_exc(EXC_TRAP, ~is_fios)

    # -- fetch and classify ----------------------------------------------------------

    def _fetch(self, S):
        """Per node: (pc_ok, tag, payload) of the current task's next cell."""
        CS = self.cfg.cs_size
        cur = S.cur.long()[:, None]
        pc = S.pc.gather(1, cur)[:, 0]
        pc_ok = (pc >= 0) & (pc < CS)
        instr = S.cs.gather(1, torch.clamp(pc, 0, CS - 1).long()[:, None])[:, 0]
        return pc_ok, instr & 3, instr >> 2

    def running(self, S) -> torch.Tensor:
        return S.tstatus.gather(1, S.cur.long()[:, None])[:, 0] == ST_RUN

    def _stack_fault(self, S, din, dout, fin, fout) -> torch.Tensor:
        """(N,) bool: the stack pre-check fails for an instruction that pops
        ``din`` and pushes ``dout`` data cells (``fin``/``fout`` loop cells),
        per node or one for all."""
        cfg = self.cfg
        cur = S.cur.long()[:, None]
        dsp = S.dsp.gather(1, cur)[:, 0]
        fsp = S.fsp.gather(1, cur)[:, 0]
        under = (dsp < din) | (fsp < fin)
        over = (dsp - din + dout > cfg.ds_size) | (fsp - fin + fout > cfg.fs_size)
        return under | over

    def _keys(self, S, active, sup):
        """The group key of every node's next instruction (see _K_*)."""
        pc_ok, tag, payload = self._fetch(S)
        code = torch.clamp(payload, 0, self.num_ops)
        if self.elide_checks:
            key = code
        else:
            fault = self._stack_fault(S, *self.needs(S.pc.device)[:, code.long()])
            key = torch.where(fault, _K_STACK, code)
        key = torch.where(tag == 1, _K_LIT, torch.where(tag == 2, _K_CALL,
                          torch.where(tag == 3, _K_TAGBAD, key)))
        key = torch.where(pc_ok, key, _K_PCBAD)
        if sup is not None:
            ok = sup[code.long()] != 0
            key = torch.where(pc_ok & (tag == 0) & ~ok, _K_BAIL, key)
        return torch.where(active, key, _K_IDLE), pc_ok, tag, payload

    # -- one instruction per row -------------------------------------------------------

    def _step_group(self, S, key: int, r: torch.Tensor, payload) -> None:
        """One instruction of kind ``key`` on rows ``r``; ``payload`` is the
        fetched cells' payload per node ((N,) int32), or one Python int for
        every row."""
        c = _Rows(self, S, r)
        if isinstance(payload, torch.Tensor):
            payload = payload[r]
        if key == _K_PCBAD:
            c.raise_exc(EXC_TRAP)
            c.set_status(ST_ERR)
            return
        if key == _K_CALL:
            rsp = c.get("rsp")
            over = rsp >= self.cfg.rs_size
            pc = c.pc()
            ri = torch.clamp(rsp, 0, self.cfg.rs_size - 1).long()
            S.rs[r, c.t, ri] = torch.where(over, S.rs[r, c.t, ri], pc + 1)
            c.set("rsp", rsp + 1, ~over)
            c.set_pc(payload, ~over)
            c.raise_exc(EXC_STACK, over)
            return
        c.set_pc(c.pc() + 1)
        if key == _K_LIT:
            if self.elide_checks:
                c.dpush(payload)
            else:
                over = c.get("dsp") >= self.cfg.ds_size
                c.raise_exc(EXC_STACK, over)
                c.dpush(payload, ~over)
        elif key == _K_TAGBAD:
            c.raise_exc(EXC_TRAP)
        elif key == _K_STACK:
            c.raise_exc(EXC_STACK)
        else:
            self.bodies[key](c)

    def _finish(self, S, r: torch.Tensor) -> None:
        """Step count + exception dispatch (paper §3.8): align RS to the
        catch point, push it as the return address, enter the handler."""
        S.steps[r] = S.steps[r] + 1
        c = _Rows(self, S, r)
        pend = c.get("pending_exc")
        exc = pend > 0
        code = torch.clamp(pend, 0, NUM_EXC - 1)
        handler = S.handlers[r, code.long()]
        has = exc & (handler > 0)
        RS = self.cfg.rs_size
        crsp = torch.clamp(c.get("catch_rsp"), 0, RS - 1)
        ci = crsp.long()
        S.rs[r, c.t, ci] = torch.where(has, c.get("catch_pc"), S.rs[r, c.t, ci])
        c.set("rsp", crsp + 1, has)
        c.set("last_exc", code, exc)
        c.set("pending_exc", 0, exc)
        c.set_pc(handler, has)
        c.set_status(ST_ERR, exc & ~has)

    def static_step(self, tag: int, code: int) -> "StaticStep":
        """One instruction kind with its tag and (for an opcode) its op body
        fixed when it is built, the counterpart of the reference's
        ``make_static_step`` (the trace-JIT's specialized step,
        ``core/vm/trace.py``).  On any rows whose next cell has that tag and
        opcode, calling it equals ``vmloop(S, 1, active=rows)``: ``pc + 1``,
        the opcode's stack pre-check (unless elided), the body (a literal's
        push with its overflow test, a call's return-stack check, a
        reserved tag's trap), then the step count and exception dispatch.
        ``code`` is clipped to ``[0, num_ops]``: FIOS calls and
        out-of-range payloads take ``bodies[num_ops]``."""
        return StaticStep(self, tag, code)

    def vmloop(self, S, steps: int, active=None, budget=None, sup=None, hist=None):
        """Alg. 1: per node, run up to ``budget`` (default ``steps``)
        instructions of the current task while it stays ST_RUN, on the
        nodes in ``active`` (default all).

        With a claim mask ``sup`` a node stops *before* its first declined
        instruction.  Returns ``(n_exec, bailed, bail_op)``, each (N,)
        int32; ``bail_op`` is the declined opcode (``num_ops`` for FIOS and
        traps) or -1 where the node did not bail.

        ``hist``, an (N, num_ops + 4) int32 tensor, counts each retired
        instruction in its node's row, in its retirement bin (``bins_of``
        over the fetch); a declined instruction is not
        retired and not counted."""
        N = S.pc.shape[0]
        dev = S.pc.device
        n = torch.zeros(N, dtype=I32, device=dev)
        bailed = torch.zeros(N, dtype=torch.bool, device=dev)
        passes = None                   # with one budget, no node steps more than `steps` times
        if budget is None:
            budget = torch.full((N,), int(steps), dtype=I32, device=dev)
            passes = int(steps)
        live = self.running(S) & (n < budget)
        if active is not None:
            live = live & active
        rows = torch.arange(N, device=dev)
        while passes != 0:
            key, pc_ok, tag, payload = self._keys(S, live, sup)
            order = torch.argsort(key, stable=True)
            keys, counts = torch.unique_consecutive(key[order], return_counts=True)
            keys, counts = keys.tolist(), counts.tolist()       # the one sync
            if keys == [_K_IDLE]:
                break
            stepped = []
            if hist is not None:
                bins = bins_of(pc_ok, tag, payload, self.num_ops).long()
            for k, grp in zip(keys, torch.split(rows[order], counts)):
                if k == _K_IDLE:
                    continue
                if k == _K_BAIL:
                    bailed[grp] = True
                    continue
                self._step_group(S, k, grp, payload)
                stepped.append(grp)
                if hist is not None:
                    hist[grp, bins[grp]] += 1
            if stepped:
                grp = torch.cat(stepped)
                self._finish(S, grp)
                n[grp] = n[grp] + 1
            live = live & ~bailed & (n < budget) & self.running(S)
            if passes is not None:
                passes -= 1
        pc_ok, tag, payload = self._fetch(S)
        bail_op = torch.where(bailed, torch.clamp(payload, 0, self.num_ops), -1).to(I32)
        return n, bailed.to(I32), bail_op

    # -- scheduler (Alg. 6) -------------------------------------------------------------

    def _klass(self, S) -> torch.Tensor:
        """Each task's runnability class (Alg. 6): 3 an awaited event hit,
        2 a timeout reached, 1 ready, 0 none; (N, T) int32."""
        cfg = self.cfg
        ev = S.tstatus == ST_EVENT
        mem_v = S.mem.gather(1, torch.clamp(S.ev_addr - MEM_BASE, 0, cfg.mem_size - 1).long())
        cs_v = S.cs.gather(1, torch.clamp(S.ev_addr, 0, cfg.cs_size - 1).long())
        ev_hit = ev & (mem_v == S.ev_val) & (S.ev_addr >= MEM_BASE)
        ev_hit = ev_hit | (ev & (S.ev_addr < MEM_BASE) & (cs_v == S.ev_val))
        to_hit = ((S.tstatus == ST_SLEEP) | ev) & (S.now[:, None] >= S.timeout)
        ready = S.tstatus == ST_YIELD
        return torch.where(ev_hit, 3, torch.where(to_hit, 2, torch.where(ready, 1, 0))).to(I32)

    def _wake(self, S, klass: torch.Tensor, best: torch.Tensor) -> torch.Tensor:
        """Dispatch task ``best`` (N,) of each node whose class there is
        non-zero: make it current and ST_RUN; an await returns its status
        (0 = event, -1 = timeout; paper Ex. 1).  Returns ``found``."""
        kb = klass.gather(1, best[:, None])[:, 0]
        found = kb > 0
        was_event = S.tstatus.gather(1, best[:, None])[:, 0] == ST_EVENT
        rows = torch.arange(S.pc.shape[0], device=S.pc.device)
        S.cur.copy_(torch.where(found, best.to(I32), S.cur))
        S.tstatus[rows, best] = torch.where(found, ST_RUN, S.tstatus[rows, best])
        push = found & was_event & (kb >= 2)
        dsp = S.dsp[rows, best]
        di = torch.clamp(dsp, 0, self.cfg.ds_size - 1).long()
        v = torch.where(kb == 3, 0, -1).to(I32)
        S.ds[rows, best, di] = torch.where(push, v, S.ds[rows, best, di])
        S.dsp[rows, best] = torch.where(push, dsp + 1, dsp)
        return found

    def schedule(self, S) -> torch.Tensor:
        """Select each node's next task: IO events > timeouts > ready, the
        lowest index first.  Returns ``found`` (N,) bool."""
        T = self.cfg.max_tasks
        klass = self._klass(S)
        score = klass * T + (T - 1 - self.arange(T, S.pc.device))
        return self._wake(S, klass, score.argmax(dim=1))

    def schedule_prio(self, S) -> torch.Tensor:
        """The Executive's scheduler: the classes of ``schedule``, ties
        broken on (class, ``prio``, round-robin rotation ``(idx - cur - 1)
        mod T`` from the last-run task).  The maximum is taken in two
        stages, the class and then ``prio`` among that class's tasks (a
        full int32, never folded into one score), and the rotation, a
        permutation, makes the pick unique.  Returns ``found`` (N,) bool."""
        T = self.cfg.max_tasks
        klass = self._klass(S)
        rot = torch.remainder(self.arange(T, S.pc.device)[None, :] - S.cur[:, None] - 1, T)
        kmax = klass.amax(dim=1, keepdim=True)
        cand = klass == kmax
        pmax = torch.where(cand, S.prio, -(2 ** 31)).amax(dim=1, keepdim=True)
        cand = cand & (S.prio == pmax)
        return self._wake(S, klass, torch.where(cand, rot, T).argmin(dim=1))

    def preempt(self, S) -> None:
        """A task that exhausted its slice stays ready."""
        rows = torch.arange(S.pc.shape[0], device=S.pc.device)
        cur = S.cur.long()
        st = S.tstatus[rows, cur]
        S.tstatus[rows, cur] = torch.where(st == ST_RUN, ST_YIELD, st)

    def run_slice(self, S, steps: int) -> torch.Tensor:
        """schedule -> vmloop -> preempt (one Fig. 10 service round) on
        every node.  Returns ``found``."""
        found = self.schedule(S)
        self.vmloop(S, steps, active=found)
        self.preempt(S)
        return found

    def running_cur(self, S) -> torch.Tensor:
        """(N,) int32: 1 where the current task is still ST_RUN (a quantum
        that ends here is a preemption)."""
        rows = torch.arange(S.pc.shape[0], device=S.pc.device)
        return (S.tstatus[rows, S.cur.long()] == ST_RUN).to(I32)

    def run_slice_exec(self, S, steps: int):
        """One Executive micro-slice on every node: schedule_prio -> vmloop
        -> preempt.  Returns ``(found, switched, preempted)``, each (N,):
        ``switched`` 1 where the dispatcher picked another task than last
        ran, ``preempted`` 1 where the task was still ST_RUN at the end of
        the quantum."""
        prev = S.cur.clone()
        found = self.schedule_prio(S)
        switched = (found & (S.cur != prev)).to(I32)
        self.vmloop(S, steps, active=found)
        preempted = self.running_cur(S)
        self.preempt(S)
        return found, switched, preempted


class StaticStep:
    """``Interpreter.static_step(tag, code)``: ``step(S, rows, instr)``
    retires the instruction cell ``instr`` (of this kind) on ``rows``, in
    place.  ``groups(S, mask)`` and ``run(S, groups, instr)`` are the same
    call split at its one host synchronization: ``groups`` sorts the masked
    nodes into this kind's rows and, where the stack pre-check fails, the
    stack fault's, so that a caller holding a mask (the trace-JIT's guard)
    syncs once a step."""

    def __init__(self, it: Interpreter, tag: int, code: int):
        self.it = it
        if tag == TAG_OP:
            code = min(max(int(code), 0), it.num_ops)
            self.key = code
            self.need = None if it.elide_checks else tuple(n[code] for n in it._needs_host)
        else:
            self.key = {TAG_LIT: _K_LIT, TAG_CALL: _K_CALL}.get(tag, _K_TAGBAD)
            self.need = None

    def groups(self, S, mask: torch.Tensor) -> list:
        """``[(key, rows)]`` of the nodes in ``mask``, each non-empty; the one
        host sync of the step."""
        if self.need is None:
            rows = mask.nonzero().flatten()
            return [(self.key, rows)] if rows.numel() else []
        fault = self.it._stack_fault(S, *self.need)
        cls = torch.where(mask, fault.to(I32), 2)        # 0 steps, 1 stack fault, 2 idle
        order = torch.argsort(cls, stable=True)
        n_ok, n_fault = torch.stack([(cls == 0).sum(), (cls == 1).sum()]).tolist()
        out = [(self.key, order[:n_ok]), (_K_STACK, order[n_ok:n_ok + n_fault])]
        return [(k, r) for k, r in out if r.numel()]

    def run(self, S, groups: list, instr: int) -> None:
        payload = int(instr) >> 2
        for key, rows in groups:
            self.it._step_group(S, key, rows, payload)
        if groups:
            self.it._finish(S, torch.cat([rows for _, rows in groups]))

    def __call__(self, S, rows: torch.Tensor, instr: int) -> None:
        mask = torch.zeros(S.pc.shape[0], dtype=torch.bool, device=S.pc.device)
        mask[rows] = True
        self.run(S, self.groups(S, mask), instr)


@functools.lru_cache(maxsize=8)
def get_interpreter(cfg: VMConfig, elide_checks: bool = False) -> Interpreter:
    """The shared interpreter of one VMConfig (default ISA), with or
    without the stack checks."""
    return Interpreter(cfg, elide_checks=elide_checks)


def interp_for(cfg: VMConfig, isa: ISA | None = None, elide_checks: bool = False) -> Interpreter:
    """Shared per-config interpreter for the default ISA, a fresh one for a
    custom ISA; ``elide_checks`` as ``Interpreter``'s."""
    if isa is None or isa is get_isa():
        return get_interpreter(cfg, elide_checks)
    return Interpreter(cfg, isa, elide_checks=elide_checks)
