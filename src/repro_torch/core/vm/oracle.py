"""Plain-Python oracle interpreter (counterpart of ``repro.core.vm.oracle``).

The paper's headline property is *operationally equivalent* software and
hardware implementations of the same VM.  The batched interpreter and the
vmloop CUDA kernel play the "hardware" role and this plain-Python
implementation is the "software" reference: the tests hold it field for
field against the JAX package's Oracle and the port's other engines.

It works in place on a single state of host arrays: a ``VMState`` of CPU
tensors (through their ``.numpy()`` views, which share the tensors'
memory) or of numpy arrays.  Its ``/`` and ``mod`` are the reference
Oracle's own ``_truncdiv``/``_truncmod``: at INT_MIN they differ from the
interpreter and the kernel (INT_MIN / 3 is -715827882 here, 715827883
there), as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.config import VMConfig
from repro_torch.core.fixedpoint import fplog10, fpsigmoid, fpsin, fpsqrt
from repro_torch.core.vm.interp import STACK_NEEDS
from repro_torch.core.vm.spec import (
    EXC_BOUNDS,
    EXC_DIVBYZERO,
    EXC_STACK,
    EXC_TRAP,
    FIOS_BASE,
    ISA,
    MEM_BASE,
    NUM_EXC,
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
from repro_torch.core.vm.vmstate import OUT_CHR, OUT_NUM, VMState


def host_view(st):
    """The numpy view of a single state: CPU tensors become arrays that
    share their memory (so the Oracle's writes land in the tensors); numpy
    states pass through."""
    if isinstance(st.pc, torch.Tensor):
        return type(st)(*[x.numpy() for x in st])
    return st


def _i32(v: int) -> int:
    v &= 0xFFFFFFFF
    return v - 0x100000000 if v >= 0x80000000 else v


def _truncdiv(a: int, b: int) -> int:
    if b == 0:
        return _i32(abs(a))
    q = abs(a) // abs(b)
    return _i32(-q if (a < 0) != (b < 0) else q)


def _truncmod(a: int, b: int) -> int:
    if b == 0:
        return _i32(a)
    return _i32(a - _truncdiv(a, b) * b)


class StackError(Exception):
    pass


class Oracle:
    """Reference interpreter over a single host state, in place.

    ``schedule``, ``vmloop`` and ``run_slice`` take a ``VMState`` of CPU
    tensors or of numpy arrays and return it (with ``found`` where the
    reference does); ``step`` works on the numpy view."""

    def __init__(self, cfg: VMConfig, isa: ISA | None = None):
        self.cfg = cfg
        self.isa = isa or get_isa()
        self.num_ops = self.isa.num_ops
        self._needs = {}
        for code in range(self.num_ops):
            nm = self.isa.name[code]
            self._needs[code] = STACK_NEEDS.get(nm, (0, 0, 0, 0))
        self._ops = self._build_ops()
        # Optional tracer callback ``hook(pc, instr)`` invoked after every
        # successful in-bounds fetch, before the instruction executes (the
        # trace-JIT's recorder in the reference).
        self.trace_hook = None
        # Optional counter callback ``hook(pc_ok, instr)`` invoked once per
        # *retired* step — including the invalid-pc trap step, which retires
        # (bumps ``steps``) without a fetch; lets obs/metrics.py count every
        # bin the device engines count.
        self.step_hook = None

    # -- helpers operating on numpy state -------------------------------------

    def _raise(self, st: VMState, code: int) -> None:
        t = int(st.cur)
        if st.pending_exc[t] == 0:
            st.pending_exc[t] = code

    def _dpush(self, st, v):
        t = int(st.cur)
        st.ds[t, min(max(int(st.dsp[t]), 0), self.cfg.ds_size - 1)] = _i32(int(v))
        st.dsp[t] += 1

    def _dpop(self, st):
        t = int(st.cur)
        v = int(st.ds[t, max(int(st.dsp[t]) - 1, 0)])
        st.dsp[t] -= 1
        return v

    def _dpopn(self, st, n):
        t = int(st.cur)
        vals = tuple(int(st.ds[t, max(int(st.dsp[t]) - n + k, 0)]) for k in range(n))
        st.dsp[t] -= n
        return vals

    def _addr_valid(self, addr):
        CS, MEM = self.cfg.cs_size, self.cfg.mem_size
        return (0 <= addr < CS) or (MEM_BASE <= addr < MEM_BASE + MEM)

    def _mread(self, st, addr):
        if addr >= MEM_BASE:
            return int(st.mem[min(max(addr - MEM_BASE, 0), self.cfg.mem_size - 1)])
        return int(st.cs[min(max(addr, 0), self.cfg.cs_size - 1)])

    def _mwrite(self, st, addr, v):
        v = _i32(int(v))
        if addr >= MEM_BASE:
            idx = addr - MEM_BASE
            if 0 <= idx < self.cfg.mem_size:
                st.mem[idx] = v
        else:
            if 0 <= addr < self.cfg.cs_size:
                st.cs[addr] = v

    def _vread(self, st, addr, window, length=None):
        ln = self._mread(st, addr - 1) if length is None else length
        ln = min(max(int(ln), 0), window)
        vals = [self._mread(st, addr + k) if k < ln else 0 for k in range(window)]
        return vals, ln

    def _vwrite(self, st, addr, vals, ln):
        for k in range(min(int(ln), len(vals))):
            self._mwrite(st, addr + k, vals[k])

    def _out(self, st, kind, v):
        p = int(st.outp)
        if p < self.cfg.out_ring_size:
            st.out[2 * p] = kind
            st.out[2 * p + 1] = _i32(int(v))
            st.outp[...] = p + 1

    def _scale1(self, v, s):
        if s > 0:
            return _i32(v * s)
        if s < 0:
            q = abs(v) // (-s)
            return _i32(-q if v < 0 else q)
        return _i32(v)

    def _apply_scalevec(self, st, vals, ln, saddr):
        if saddr == 0:
            return vals
        svals, _ = self._vread(st, saddr, len(vals), length=ln)
        return [self._scale1(v, s) for v, s in zip(vals, svals)]

    def _iir_lowpass(self, vals, ln, k):
        y = vals[0] if vals else 0
        out = list(vals)
        for i in range(ln):
            y = _i32(y + _truncdiv(_i32(k * (vals[i] - y)), 1000))
            out[i] = y
        return out

    # -- opcode table ----------------------------------------------------------

    def _build_ops(self):
        cfg, isa = self.cfg, self.isa
        MV = cfg.max_vec
        O = {}

        def pc_next_cell(st):
            t = int(st.cur)
            return int(st.cs[min(max(int(st.pc[t]), 0), cfg.cs_size - 1)])

        def set_pc(st, pc):
            st.pc[int(st.cur)] = pc

        def cur_pc(st):
            return int(st.pc[int(st.cur)])

        O["nop"] = lambda st: None
        O["dup"] = lambda st: self._dpush(st, st.ds[int(st.cur), max(int(st.dsp[int(st.cur)]) - 1, 0)])

        def op_drop(st):
            self._dpop(st)
        O["drop"] = op_drop

        def op_swap(st):
            a, b = self._dpopn(st, 2)
            self._dpush(st, b)
            self._dpush(st, a)
        O["swap"] = op_swap

        def op_over(st):
            t = int(st.cur)
            self._dpush(st, st.ds[t, max(int(st.dsp[t]) - 2, 0)])
        O["over"] = op_over

        def op_rot(st):
            a, b, c = self._dpopn(st, 3)
            self._dpush(st, b)
            self._dpush(st, c)
            self._dpush(st, a)
        O["rot"] = op_rot

        def op_nip(st):
            a, b = self._dpopn(st, 2)
            self._dpush(st, b)
        O["nip"] = op_nip

        def op_tuck(st):
            a, b = self._dpopn(st, 2)
            self._dpush(st, b)
            self._dpush(st, a)
            self._dpush(st, b)
        O["tuck"] = op_tuck

        def op_pick(st):
            n = self._dpop(st)
            t = int(st.cur)
            if n < 0 or n >= int(st.dsp[t]):
                self._dpush(st, st.ds[t, min(max(int(st.dsp[t]) - 1 - n, 0), cfg.ds_size - 1)])
                self._raise(st, EXC_STACK)
            else:
                self._dpush(st, st.ds[t, int(st.dsp[t]) - 1 - n])
        O["pick"] = op_pick

        def op_2dup(st):
            t = int(st.cur)
            a = st.ds[t, max(int(st.dsp[t]) - 2, 0)]
            b = st.ds[t, max(int(st.dsp[t]) - 1, 0)]
            self._dpush(st, a)
            self._dpush(st, b)
        O["2dup"] = op_2dup

        def op_2drop(st):
            self._dpopn(st, 2)
        O["2drop"] = op_2drop

        O["depth"] = lambda st: self._dpush(st, st.dsp[int(st.cur)])

        def bin_op(f):
            def op(st):
                a, b = self._dpopn(st, 2)
                self._dpush(st, f(a, b))
            return op

        def un_op(f):
            def op(st):
                v = self._dpop(st)
                self._dpush(st, f(v))
            return op

        O["+"] = bin_op(lambda a, b: _i32(a + b))
        O["-"] = bin_op(lambda a, b: _i32(a - b))
        O["*"] = bin_op(lambda a, b: _i32(a * b))

        def op_div(st):
            a, b = self._dpopn(st, 2)
            self._dpush(st, _truncdiv(a, b))
            if b == 0:
                self._raise(st, EXC_DIVBYZERO)
        O["/"] = op_div

        def op_mod(st):
            a, b = self._dpopn(st, 2)
            self._dpush(st, _truncmod(a, b))
            if b == 0:
                self._raise(st, EXC_DIVBYZERO)
        O["mod"] = op_mod

        def op_muldiv(st):
            a, b, c = self._dpopn(st, 3)
            if c == 0:
                q = abs(a * b)
                self._dpush(st, _i32(-q if ((a < 0) != (b < 0)) else q))
                self._raise(st, EXC_DIVBYZERO)
            else:
                q = abs(a * b) // abs(c)
                neg = ((a < 0) != (b < 0)) != (c < 0)
                self._dpush(st, _i32(-q if neg else q))
        O["*/"] = op_muldiv

        O["negate"] = un_op(lambda v: _i32(-v))
        O["abs"] = un_op(lambda v: _i32(abs(v)))
        O["min"] = bin_op(min)
        O["max"] = bin_op(max)
        O["1+"] = un_op(lambda v: _i32(v + 1))
        O["1-"] = un_op(lambda v: _i32(v - 1))
        O["2*"] = un_op(lambda v: _i32(v * 2))
        O["2/"] = un_op(lambda v: v >> 1)

        for nm, f in [
            ("=", lambda a, b: a == b), ("<>", lambda a, b: a != b),
            ("<", lambda a, b: a < b), (">", lambda a, b: a > b),
            ("<=", lambda a, b: a <= b), (">=", lambda a, b: a >= b),
        ]:
            O[nm] = bin_op(lambda a, b, f=f: -1 if f(a, b) else 0)
        O["0="] = un_op(lambda v: -1 if v == 0 else 0)
        O["0<"] = un_op(lambda v: -1 if v < 0 else 0)
        O["0>"] = un_op(lambda v: -1 if v > 0 else 0)

        O["and"] = bin_op(lambda a, b: _i32(a & b))
        O["or"] = bin_op(lambda a, b: _i32(a | b))
        O["xor"] = bin_op(lambda a, b: _i32(a ^ b))
        O["invert"] = un_op(lambda v: _i32(~v))
        O["lshift"] = bin_op(lambda a, n: _i32(a << (n & 31)))
        O["rshift"] = bin_op(lambda a, n: _i32(a >> (n & 31)))

        def op_fetch(st):
            addr = self._dpop(st)
            self._dpush(st, self._mread(st, addr))
            if not self._addr_valid(addr):
                self._raise(st, EXC_BOUNDS)
        O["@"] = op_fetch

        def op_store(st):
            v, addr = self._dpopn(st, 2)
            self._mwrite(st, addr, v)
            if not self._addr_valid(addr):
                self._raise(st, EXC_BOUNDS)
        O["!"] = op_store

        def op_addstore(st):
            v, addr = self._dpopn(st, 2)
            self._mwrite(st, addr, self._mread(st, addr) + v)
            if not self._addr_valid(addr):
                self._raise(st, EXC_BOUNDS)
        O["+!"] = op_addstore

        def op_get(st):
            n, arr = self._dpopn(st, 2)
            ln = self._mread(st, arr - 1)
            if n < 0 or n >= ln:
                self._dpush(st, self._mread(st, arr + min(max(n, 0), max(ln - 1, 0))))
                self._raise(st, EXC_BOUNDS)
            else:
                self._dpush(st, self._mread(st, arr + n))
        O["get"] = op_get

        def op_put(st):
            v, n, arr = self._dpopn(st, 3)
            ln = self._mread(st, arr - 1)
            if n < 0 or n >= ln:
                self._raise(st, EXC_BOUNDS)
            else:
                self._mwrite(st, arr + n, v)
        O["put"] = op_put

        def op_push(st):
            v, arr = self._dpopn(st, 2)
            top = self._mread(st, arr)
            ln = self._mread(st, arr - 1)
            if top + 1 >= ln:
                self._raise(st, EXC_BOUNDS)
            else:
                self._mwrite(st, arr + top + 1, v)
                self._mwrite(st, arr, top + 1)
        O["push"] = op_push

        def op_pop(st):
            arr = self._dpop(st)
            top = self._mread(st, arr)
            if top <= 0:
                self._dpush(st, 0)
                self._raise(st, EXC_BOUNDS)
            else:
                self._dpush(st, self._mread(st, arr + top))
                self._mwrite(st, arr, top - 1)
        O["pop"] = op_pop

        def op_fill(st):
            v, arr = self._dpopn(st, 2)
            _, ln = self._vread(st, arr, MV)
            self._vwrite(st, arr, [v] * MV, ln)
        O["fill"] = op_fill

        def op_len(st):
            arr = self._dpop(st)
            self._dpush(st, self._mread(st, arr - 1))
        O["len"] = op_len

        def op_branch(st):
            set_pc(st, pc_next_cell(st))
        O["branch"] = op_branch

        def op_0branch(st):
            f = self._dpop(st)
            pc = cur_pc(st)
            set_pc(st, pc_next_cell(st) if f == 0 else pc + 1)
        O["0branch"] = op_0branch

        def op_ret(st):
            t = int(st.cur)
            if st.rsp[t] < 1:
                st.rsp[t] -= 1
                set_pc(st, int(st.rs[t, 0]))
                self._raise(st, EXC_STACK)
                st.tstatus[t] = ST_ERR
            else:
                st.rsp[t] -= 1
                set_pc(st, int(st.rs[t, int(st.rsp[t])]))
        O["ret"] = op_ret
        O["exit"] = op_ret

        def op_exec(st):
            addr = self._dpop(st)
            t = int(st.cur)
            if st.rsp[t] >= cfg.rs_size:
                st.rs[t, cfg.rs_size - 1] = cur_pc(st)
                st.rsp[t] += 1
                set_pc(st, addr)
                self._raise(st, EXC_STACK)
            else:
                st.rs[t, int(st.rsp[t])] = cur_pc(st)
                st.rsp[t] += 1
                set_pc(st, addr)
        O["exec"] = op_exec

        def op_doinit(st):
            limit, start_v = self._dpopn(st, 2)
            t = int(st.cur)
            st.fs[t, min(int(st.fsp[t]), cfg.fs_size - 1)] = limit
            st.fsp[t] += 1
            st.fs[t, min(int(st.fsp[t]), cfg.fs_size - 1)] = start_v
            st.fsp[t] += 1
        O["doinit"] = op_doinit

        def op_doloop(st):
            t = int(st.cur)
            pc = cur_pc(st)
            top_addr = pc_next_cell(st)
            limit = int(st.fs[t, max(int(st.fsp[t]) - 2, 0)])
            ctr = int(st.fs[t, max(int(st.fsp[t]) - 1, 0)]) + 1
            st.fs[t, max(int(st.fsp[t]) - 1, 0)] = _i32(ctr)
            if ctr >= limit:
                st.fsp[t] -= 2
                set_pc(st, pc + 1)
            else:
                set_pc(st, top_addr)
        O["doloop"] = op_doloop

        O["i"] = lambda st: self._dpush(st, st.fs[int(st.cur), max(int(st.fsp[int(st.cur)]) - 1, 0)])
        O["j"] = lambda st: self._dpush(st, st.fs[int(st.cur), max(int(st.fsp[int(st.cur)]) - 3, 0)])

        def op_unloop(st):
            st.fsp[int(st.cur)] -= 2
        O["unloop"] = op_unloop

        def op_halt(st):
            st.tstatus[int(st.cur)] = ST_HALT
        O["halt"] = op_halt

        def op_end(st):
            t = int(st.cur)
            st.tstatus[t] = ST_DONE if t == 0 else ST_FREE
        O["end"] = op_end

        def op_dlit(st):
            v = pc_next_cell(st)
            self._dpush(st, v)
            set_pc(st, cur_pc(st) + 1)
        O["dlit"] = op_dlit

        O["."] = lambda st: self._out(st, OUT_NUM, self._dpop(st))
        O["emit"] = lambda st: self._out(st, OUT_CHR, self._dpop(st))
        O["cr"] = lambda st: self._out(st, OUT_CHR, 10)

        def op_prstr(st):
            pc = cur_pc(st)
            ln = min(max(pc_next_cell(st), 0), 64)
            for k in range(ln):
                self._out(st, OUT_CHR, self._mread(st, pc + 1 + k))
            set_pc(st, pc + 1 + ln)
        O["prstr"] = op_prstr

        def op_vecprint(st):
            arr = self._dpop(st)
            vals, ln = self._vread(st, arr, MV)
            for k in range(ln):
                self._out(st, OUT_NUM, vals[k])
        O["vecprint"] = op_vecprint

        def make_io_suspend(name):
            opc = isa.opcode[name]
            def op(st):
                t = int(st.cur)
                set_pc(st, cur_pc(st) - 1)
                st.io_op[t] = opc
                st.tstatus[t] = ST_IOWAIT
            return op

        for _n in ("out", "in", "send", "receive"):
            O[_n] = make_io_suspend(_n)

        def op_yield(st):
            st.tstatus[int(st.cur)] = ST_YIELD
        O["yield"] = op_yield

        def op_sleep(st):
            ms_v = self._dpop(st)
            t = int(st.cur)
            st.timeout[t] = _i32(int(st.now) + ms_v)
            st.tstatus[t] = ST_SLEEP
        O["sleep"] = op_sleep

        def op_await(st):
            ms_v, val, addr = self._dpopn(st, 3)
            t = int(st.cur)
            st.timeout[t] = _i32(int(st.now) + ms_v)
            st.ev_addr[t] = addr
            st.ev_val[t] = val
            st.tstatus[t] = ST_EVENT
        O["await"] = op_await

        def op_task(st):
            prio, deadline, addr = self._dpopn(st, 3)
            free = np.where(np.asarray(st.tstatus) == ST_FREE)[0]
            if len(free) == 0:
                self._dpush(st, -1)
                return
            slot = int(free[0])
            st.pc[slot] = addr
            st.dsp[slot] = 0
            st.rs[slot, 0] = 0
            st.rsp[slot] = 1
            st.fsp[slot] = 0
            st.tstatus[slot] = ST_YIELD
            st.prio[slot] = prio
            st.deadline[slot] = deadline
            st.catch_pc[slot] = 0
            st.catch_rsp[slot] = 0
            st.pending_exc[slot] = 0
            st.last_exc[slot] = 0
            st.io_op[slot] = 0
            self._dpush(st, slot)
        O["task"] = op_task

        O["taskid"] = lambda st: self._dpush(st, st.cur)
        O["ms"] = lambda st: self._dpush(st, st.now)
        O["steps"] = lambda st: self._dpush(st, st.steps)

        def op_exception(st):
            handler, exc = self._dpopn(st, 2)
            st.handlers[min(max(exc, 0), NUM_EXC - 1)] = handler
        O["exception"] = op_exception

        def op_catch(st):
            # Catch point = the `catch` instruction itself (see interp.py).
            t = int(st.cur)
            self._dpush(st, st.last_exc[t])
            st.last_exc[t] = 0
            st.catch_pc[t] = cur_pc(st) - 1
            st.catch_rsp[t] = st.rsp[t]
        O["catch"] = op_catch

        def op_throw(st):
            exc = self._dpop(st)
            self._raise(st, min(max(exc, 1), NUM_EXC - 1))
        O["throw"] = op_throw

        O["sin"] = un_op(fpsin)
        O["log"] = un_op(lambda v: fplog10(v) * 10)
        O["sigmoid"] = un_op(fpsigmoid)
        O["relu"] = un_op(lambda v: max(v, 0))
        O["sqrt"] = un_op(fpsqrt)

        def op_rnd(st):
            n = self._dpop(st)
            rng = (int(st.rng) * 1664525 + 1013904223) & 0xFFFFFFFF
            st_rng = np.uint32(rng)
            r = rng >> 16
            self._dpush(st, r % n if n > 0 else 0)
            # st.rng is a 0-d array; assign via [...] to mutate in place.
            st.rng[...] = st_rng
        O["rnd"] = op_rnd

        def op_vecload(st):
            src, srcoff, dst = self._dpopn(st, 3)
            _, ln = self._vread(st, dst, MV)
            vals, _ = self._vread(st, src + srcoff, MV, length=ln)
            self._vwrite(st, dst, vals, ln)
        O["vecload"] = op_vecload

        def op_vecscale(st):
            src, dst, saddr = self._dpopn(st, 3)
            _, ln = self._vread(st, dst, MV)
            vals, _ = self._vread(st, src, MV, length=ln)
            svals, _ = self._vread(st, saddr, MV, length=ln)
            self._vwrite(st, dst, [self._scale1(v, s) for v, s in zip(vals, svals)], ln)
        O["vecscale"] = op_vecscale

        def make_eltwise(f):
            def op(st):
                a, b, dst, saddr = self._dpopn(st, 4)
                _, ln = self._vread(st, dst, MV)
                av, _ = self._vread(st, a, MV, length=ln)
                bv, _ = self._vread(st, b, MV, length=ln)
                r = [_i32(f(x, y)) for x, y in zip(av, bv)]
                r = self._apply_scalevec(st, r, ln, saddr)
                self._vwrite(st, dst, r, ln)
            return op

        O["vecadd"] = make_eltwise(lambda a, b: a + b)
        O["vecmul"] = make_eltwise(lambda a, b: a * b)

        def op_vecfold(st):
            inv, wgt, outv, saddr = self._dpopn(st, 4)
            iv, n = self._vread(st, inv, MV)
            _, m = self._vread(st, outv, MV)
            acc = []
            for jj in range(m):
                s = 0
                for ii in range(n):
                    s = _i32(s + _i32(iv[ii] * self._mread(st, wgt + ii * m + jj)))
                acc.append(s)
            acc = self._apply_scalevec(st, acc, m, saddr)
            self._vwrite(st, outv, acc, m)
        O["vecfold"] = op_vecfold

        def op_vecmap(st):
            src, dst, fn, saddr = self._dpopn(st, 4)
            _, ln = self._vread(st, dst, MV)
            vals, _ = self._vread(st, src, MV, length=ln)
            fns = [fpsigmoid, lambda v: max(v, 0), fpsin, lambda v: fplog10(v) * 10, fpsqrt]
            f = fns[min(max(fn, 0), 4)]
            mapped = [f(v) for v in vals]
            mapped = self._apply_scalevec(st, mapped, ln, saddr)
            self._vwrite(st, dst, mapped, ln)
        O["vecmap"] = op_vecmap

        def op_dotprod(st):
            a, b = self._dpopn(st, 2)
            av, n = self._vread(st, a, MV)
            bv, _ = self._vread(st, b, MV, length=n)
            s = 0
            for x, y in zip(av, bv):
                s = _i32(s + _i32(x * y))
            self._dpush(st, s)
        O["dotprod"] = op_dotprod

        def op_vecmax(st):
            arr = self._dpop(st)
            vals, ln = self._vread(st, arr, MV)
            if ln == 0:
                self._dpush(st, 0)
                return
            best = max(range(ln), key=lambda k: vals[k])
            self._dpush(st, best)
        O["vecmax"] = op_vecmax

        def make_filter(kind):
            def op(st):
                arr, off, ln_req, k = self._dpopn(st, 4)
                base = arr + off
                hdr_ln = self._mread(st, arr - 1)
                ln = min(max(min(ln_req, hdr_ln - off), 0), MV)
                vals, _ = self._vread(st, base, MV, length=ln)
                if kind == "hull":
                    y = self._iir_lowpass([abs(v) for v in vals], ln, k)
                elif kind == "lowp":
                    y = self._iir_lowpass(vals, ln, k)
                else:
                    low = self._iir_lowpass(vals, ln, k)
                    y = [_i32(v - l) for v, l in zip(vals, low)]
                self._vwrite(st, base, y, ln)
            return op

        O["hull"] = make_filter("hull")
        O["lowp"] = make_filter("lowp")
        O["highp"] = make_filter("highp")

        table = {}
        for code in range(self.num_ops):
            table[code] = O[self.isa.name[code]]
        return table

    # -- single instruction step -----------------------------------------------

    def step(self, st: VMState) -> None:
        self._step(host_view(st))

    def _step(self, st) -> None:
        cfg = self.cfg
        t = int(st.cur)
        pc = int(st.pc[t])
        if pc < 0 or pc >= cfg.cs_size:
            if self.step_hook is not None:
                self.step_hook(False, 0)
            self._raise(st, EXC_TRAP)
            st.tstatus[t] = ST_ERR
            st.steps[...] = int(st.steps) + 1
            self._dispatch_exc(st)
            return
        instr = int(st.cs[pc])
        if self.trace_hook is not None:
            self.trace_hook(pc, instr)
        if self.step_hook is not None:
            self.step_hook(True, instr)
        tag = instr & 3
        payload = instr >> 2  # arithmetic shift (numpy int32 -> python int)

        if tag == TAG_LIT:
            st.pc[t] = pc + 1
            if st.dsp[t] >= cfg.ds_size:
                self._raise(st, EXC_STACK)
            else:
                self._dpush(st, payload)
        elif tag == TAG_CALL:
            if st.rsp[t] >= cfg.rs_size:
                self._raise(st, EXC_STACK)
            else:
                st.rs[t, int(st.rsp[t])] = pc + 1
                st.rsp[t] += 1
                st.pc[t] = payload
        elif tag == TAG_OP:
            st.pc[t] = pc + 1
            opcode = payload
            if opcode >= self.num_ops:
                if opcode >= FIOS_BASE:
                    st.pc[t] = pc
                    st.io_op[t] = opcode
                    st.tstatus[t] = ST_IOWAIT
                else:
                    self._raise(st, EXC_TRAP)
            else:
                din, dout, fin, fout = self._needs[opcode]
                under = int(st.dsp[t]) < din or int(st.fsp[t]) < fin
                over = (
                    int(st.dsp[t]) - din + dout > cfg.ds_size
                    or int(st.fsp[t]) - fin + fout > cfg.fs_size
                )
                if under or over:
                    self._raise(st, EXC_STACK)
                else:
                    self._ops[opcode](st)
        else:
            st.pc[t] = pc + 1
            self._raise(st, EXC_TRAP)

        st.steps[...] = int(st.steps) + 1
        self._dispatch_exc(st)

    def _dispatch_exc(self, st: VMState) -> None:
        t = int(st.cur)
        exc = int(st.pending_exc[t])
        if exc <= 0:
            return
        code = min(max(exc, 0), NUM_EXC - 1)
        handler = int(st.handlers[code])
        st.last_exc[t] = code
        st.pending_exc[t] = 0
        if handler > 0:
            crsp = min(max(int(st.catch_rsp[t]), 0), self.cfg.rs_size - 1)
            st.rs[t, crsp] = int(st.catch_pc[t])
            st.rsp[t] = crsp + 1
            st.pc[t] = handler
        else:
            st.tstatus[t] = ST_ERR

    # -- vmloop + scheduler (mirror of interp.py) --------------------------------

    def vmloop(self, st: VMState, steps: int) -> VMState:
        v = host_view(st)
        n = 0
        while n < steps and v.tstatus[int(v.cur)] == ST_RUN:
            self._step(v)
            n += 1
        return st

    def schedule(self, st: VMState):
        return st, self._schedule(host_view(st))

    def _schedule(self, st) -> bool:
        T = self.cfg.max_tasks
        best, best_klass = -1, 0
        for i in range(T):
            s = int(st.tstatus[i])
            klass = 0
            if s == ST_EVENT and self._mread(st, int(st.ev_addr[i])) == int(st.ev_val[i]):
                klass = 3
            elif s in (ST_SLEEP, ST_EVENT) and int(st.now) >= int(st.timeout[i]):
                klass = 2
            elif s == ST_YIELD:
                klass = 1
            if klass > best_klass:
                best, best_klass = i, klass
        if best < 0:
            return False
        self._wake(st, best, best_klass)
        return True

    def _wake(self, st, best: int, best_klass: int) -> None:
        was_event = int(st.tstatus[best]) == ST_EVENT
        st.cur[...] = best
        st.tstatus[best] = ST_RUN
        if was_event:
            st.ds[best, min(int(st.dsp[best]), self.cfg.ds_size - 1)] = (
                0 if best_klass == 3 else -1
            )
            st.dsp[best] += 1

    def run_slice(self, st: VMState, steps: int):
        v = host_view(st)
        found = self._schedule(v)
        if found:
            self.vmloop(v, steps)
        if int(v.tstatus[int(v.cur)]) == ST_RUN:
            v.tstatus[int(v.cur)] = ST_YIELD
        return st, found

    # -- Executive scheduler (mirror of Interpreter.schedule_prio) ---------------

    def schedule_prio(self, st: VMState):
        """Lexicographic (class, prio, round-robin rotation) task pick."""
        return st, self._schedule_prio(host_view(st))

    def _schedule_prio(self, st) -> bool:
        T = self.cfg.max_tasks
        cur = int(st.cur)
        best, best_key, best_klass = -1, None, 0
        for i in range(T):
            s = int(st.tstatus[i])
            klass = 0
            if s == ST_EVENT and self._mread(st, int(st.ev_addr[i])) == int(st.ev_val[i]):
                klass = 3
            elif s in (ST_SLEEP, ST_EVENT) and int(st.now) >= int(st.timeout[i]):
                klass = 2
            elif s == ST_YIELD:
                klass = 1
            if klass == 0:
                continue
            rot = (i - cur - 1) % T
            key = (klass, int(st.prio[i]), -rot)
            if best < 0 or key > best_key:
                best, best_key, best_klass = i, key, klass
        if best < 0:
            return False
        self._wake(st, best, best_klass)
        return True

    def run_slice_exec(self, st: VMState, steps: int):
        """Executive micro-slice: returns (st, found, switched, preempted)."""
        v = host_view(st)
        prev = int(v.cur)
        found = self._schedule_prio(v)
        switched = 1 if (found and int(v.cur) != prev) else 0
        if found:
            self.vmloop(v, steps)
        preempted = 1 if int(v.tstatus[int(v.cur)]) == ST_RUN else 0
        if preempted:
            v.tstatus[int(v.cur)] = ST_YIELD
        return st, found, switched, preempted
