"""Inputs that hold the vmloop kernel against its plain version.

``sweep_programs(cfg)`` is the per-opcode sweep: every ISA word in at least
one program (the reference's sweep, ``tests/test_vm_pallas.py``, plus edge
values: INT_MIN and INT_MAX operands, divisor 0 and INT_MIN, shift counts
of 32 and more, addresses outside ``cs``/``mem``, vector writes across the
ends of ``cs``), and a FIOS call.  ``random_states`` makes node states of
random bytecode and random stacks from a seed.  ``chip_smoke.py`` runs
both through the CUDA kernel and the plain version on the card, and the
CPU tests run them through the CPU build of the kernel's header.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.config import VMConfig
from repro_torch.core.vm import vmstate as vms
from repro_torch.core.vm.spec import MEM_BASE, NUM_EXC, ST_FREE, ST_RUN, ST_YIELD, get_isa
from repro_torch.kernels.vmloop.ref import BAILOUT_WORDS, SUPPORTED_WORDS

I32_MIN, I32_MAX = -(2 ** 31), 2 ** 31 - 1

# word -> programs; keys cover the claimed and the declined words exactly.
SWEEP: dict[str, list[str]] = {
    "nop": ["nop halt"], "dup": ["5 dup halt"], "drop": ["5 6 drop halt"],
    "swap": ["1 2 swap halt"], "over": ["1 2 over halt"], "rot": ["1 2 3 rot halt"],
    "nip": ["1 2 nip halt"], "tuck": ["1 2 tuck halt"],
    "pick": ["10 20 30 1 pick halt", "5 99 pick halt", "1 2 -2147483648 pick halt"],
    "2dup": ["1 2 2dup halt"], "2drop": ["1 2 2drop halt"], "depth": ["1 2 depth halt"],
    "+": ["7 3 + halt", "2147483647 1 + halt"],
    "-": ["7 3 - halt", "-2147483648 1 - halt"],
    "*": ["7 3 * halt", "2147483647 3 * halt", "-2147483648 -1 * halt"],
    "/": ["7 -3 / halt", "1 0 / halt", "-2147483648 3 / halt", "-2147483648 -1 / halt",
          "5 -2147483648 / halt", "-2147483648 -2147483648 / halt"],
    "mod": ["7 3 mod halt", "1 0 mod halt", "-2147483648 3 mod halt", "-7 -2147483648 mod halt"],
    "*/": ["12345 678 1000 */ halt", "-12345 678 1000 */ halt", "7 5 0 */ halt",
           "7 5 -2147483648 */ halt", "-2147483648 -2147483648 1 */ halt",
           "2147483647 2147483647 3 */ halt", "-2147483648 2147483647 -7 */ halt"],
    "negate": ["5 negate halt", "-2147483648 negate halt"],
    "abs": ["-5 abs halt", "-2147483648 abs halt"],
    "min": ["3 9 min halt"], "max": ["3 9 max halt"],
    "1+": ["41 1+ halt", "2147483647 1+ halt"], "1-": ["41 1- halt", "-2147483648 1- halt"],
    "2*": ["21 2* halt", "1073741824 2* halt"], "2/": ["-7 2/ halt"],
    "=": ["3 3 = halt"], "<>": ["3 4 <> halt"], "<": ["3 4 < halt"], ">": ["3 4 > halt"],
    "<=": ["4 4 <= halt"], ">=": ["3 4 >= halt"], "0=": ["0 0= halt"], "0<": ["-2 0< halt"],
    "0>": ["2 0> halt"],
    "and": ["12 10 and halt"], "or": ["12 10 or halt"], "xor": ["12 10 xor halt"],
    "invert": ["12 invert halt"],
    "lshift": ["3 4 lshift halt", "1 40 lshift halt", "1 -1 lshift halt", "3 32 lshift halt"],
    "rshift": ["-16 2 rshift halt", "-8 33 rshift halt", "-2147483648 63 rshift halt"],
    "@": ["var x 7 x ! x @ halt", "9999999 @ halt", "-5 @ halt", "5000 @ halt",
          "2147483647 @ halt", "-2147483648 @ halt"],
    "!": ["var x 7 x ! halt", "7 -3 ! halt", "7 5000 ! halt", "7 1060000 ! halt",
          "7 1048580 ! halt"],
    "+!": ["var x 5 x ! 3 x +! x @ halt", "3 -1 +! halt"],
    "get": ["array a { 3 1 4 } 1 a get halt", "array a { 3 1 4 } 9 a get halt",
            "array a { 3 1 4 } -2147483648 a get halt"],
    "put": ["array a { 3 1 4 } 9 1 a put halt", "array a { 3 1 4 } 9 7 a put halt"],
    "push": ["array s 8 1 s push 2 s push halt"],
    "pop": ["array s 8 1 s push s pop halt", "array s 8 s pop halt"],
    "len": ["array a { 3 1 4 } a len halt"],
    "branch": ["0 if 1 else 2 endif halt"], "0branch": ["1 if 1 else 2 endif halt"],
    "ret": [": f 5 ; f halt"], "exit": [": f 1 exit 2 ; f halt"],
    "exec": [": f 7 ; $ f exec halt", "99999 exec halt"],
    "doinit": ["0 3 0 do i + loop halt"], "doloop": ["1 4 1 do i * loop halt"],
    "i": ["0 5 0 do i + loop halt"], "j": ["0 3 0 do 2 0 do j + loop loop halt"],
    "unloop": [": f 5 0 do i 2 >= if unloop 77 exit endif loop 99 ; f halt"],
    "halt": ["halt"], "end": ["1 2"], "dlit": ["1000000000 halt"],
    "yield": ["yield 1 halt"], "sleep": ["5 sleep 1 halt"], "await": ["50 1 2 await halt"],
    "taskid": ["taskid halt"], "ms": ["ms halt"], "steps": ["steps halt"],
    "exception": [": h 7 ; $ h exception user halt"],
    "catch": ["catch halt"],
    "throw": [": h 7 ; $ h exception user catch 0= if 8 throw endif halt", "3 throw halt"],
    ".": ["5 . halt"], "emit": ["65 emit halt"], "cr": ["cr halt"],
    "prstr": ['." hi" halt'], "vecprint": ["array a { 1 2 } a vecprint halt"],
    "out": ["7 out halt"], "in": ["in halt"], "send": ["7 1 send halt"],
    "receive": ["receive halt"],
    "sin": ["1571 sin halt", "-2147483648 sin halt"],
    "log": ["100 log halt", "2147483647 log halt"],
    "sigmoid": ["500 sigmoid halt", "-2147483648 sigmoid halt", "2500 sigmoid halt",
                "-5000 sigmoid halt"],
    "relu": ["-3 relu halt"], "sqrt": ["50000 sqrt halt", "2147483647 sqrt halt"],
    "fill": ["array a { 1 2 3 } 7 a fill halt", "7 -2 fill halt"],
    "vecload": ["array a { 1 2 3 } array b 3 a 0 b vecload halt",
                "array b 5 -3 0 b vecload halt",
                "10 {END4} ! 1 0 {END3} vecload halt"],
    "vecscale": ["array a { 100 -200 } array sc { -2 3 } array d 2 a d sc vecscale halt",
                 "array a { -2147483648 -200 } array sc { -2147483648 -1 } array d 2 a d sc vecscale halt"],
    "vecadd": ["array a { 1 2 3 } array b { 4 5 6 } array c 3 a b c 0 vecadd halt",
               "array a { 2147483647 2 } array b { 1 5 } array s { -2 2 } array c 2 a b c s vecadd halt"],
    "vecmul": ["array a { 1 2 3 } array b { 4 5 6 } array c 3 a b c 0 vecmul halt"],
    "vecfold": ["array x { 10 20 } array w { 1 2 3 4 5 6 } array y 3 x w y 0 vecfold halt",
                "array x { 1 2 3 } array y 3 x {END2} y 0 vecfold halt",
                "array x { 65536 65536 } array w { 65536 1 1 1 } array y 2 x w y 0 vecfold halt"],
    "vecmap": ["array a { 1 2 3 } array b 3 a b 1 0 vecmap halt",
               "array a { -2147483648 900 3000 } array b 3 a b 0 0 vecmap halt",
               "array a { 4 9 16 } array b 3 a b 4 0 vecmap halt"],
    "dotprod": ["array a { 1 2 3 } array b { 4 5 6 } a b dotprod halt"],
    "vecmax": ["array a { 3 1 4 1 5 } a vecmax halt", "array a { 0 } a vecmax halt"],
    "hull": ["array a { 1000 -500 250 0 } a 0 4 300 hull halt"],
    "lowp": ["array a { 1000 500 250 0 } a 0 4 300 lowp halt",
             "array a { 2147483647 -2147483648 7 } a 0 3 2147483647 lowp halt"],
    "highp": ["array a { 1000 500 250 0 } a 0 4 300 highp halt"],
    # declined words: the kernel must bail before them
    "task": [": w end ; 0 0 $ w task halt"],
    "rnd": ["7 rnd halt"],
}
FIOS_PROGRAM = "seven 1+ halt"          # a FIOS call (bails) after registering `seven`


def sweep_programs(cfg: VMConfig) -> list[tuple[str, str]]:
    """(word, program) pairs; a final ``("fios/trap", ...)`` pair calls a
    FIOS word named ``seven``."""
    subs = {"{END4}": str(cfg.cs_size - 4), "{END3}": str(cfg.cs_size - 3),
            "{END2}": str(cfg.cs_size - 2)}
    out = []
    for word, progs in SWEEP.items():
        for p in progs:
            for k, v in subs.items():
                p = p.replace(k, v)
            out.append((word, p))
    out.append(("fios/trap", FIOS_PROGRAM))
    return out


def check_sweep_covers_isa() -> None:
    names = {w.name for w in get_isa().words}
    if set(SWEEP) != names or set(SUPPORTED_WORDS) | set(BAILOUT_WORDS) != names:
        raise RuntimeError("the vmloop sweep must cover every ISA word")


def sweep_states(cfg: VMConfig, device) -> tuple[list[tuple[str, str]], object]:
    """Compile every sweep program into its own node and schedule each
    node's task (so it is ST_RUN).  Returns (pairs, stacked state)."""
    from repro_torch.core.vm.interp import interp_for
    from repro_torch.core.vm.machine import REXAVM

    pairs = sweep_programs(cfg)
    states = []
    for _, prog in pairs:
        vm = REXAVM(cfg, device="cpu")
        vm.svc_add("seven", lambda: 7, args=0, ret=1)
        vm.launch(vm.load(prog))
        states.append(vm.state)
    S = vms.to_device(vms.stack_states(states), device)
    interp_for(cfg).schedule(S)
    return pairs, S


_EDGE = np.array([0, 1, -1, 2, 3, 7, 31, 32, 33, 63, 64, 1000, -1000, I32_MIN, I32_MAX,
                  I32_MIN + 1, I32_MAX - 1, MEM_BASE, MEM_BASE + 5, MEM_BASE - 1], np.int64)


def random_states(cfg: VMConfig, n: int, seed: int, device):
    """``n`` nodes of random bytecode and random machine state, each with
    its current task ST_RUN.  Cells are mostly claimed opcodes, literals and
    calls; stack cells mix small numbers, addresses and int32 extremes."""
    rng = np.random.default_rng(seed)
    isa = get_isa()
    T, CS, MEM = cfg.max_tasks, cfg.cs_size, cfg.mem_size
    claimed = np.array([isa.opcode[w] for w in SUPPORTED_WORDS], np.int64)

    def values(shape):
        small = rng.integers(-64, 256, size=shape)
        edge = _EDGE[rng.integers(0, len(_EDGE), size=shape)]
        addr = rng.integers(0, CS, size=shape)
        wide = rng.integers(I32_MIN, I32_MAX, size=shape, endpoint=True)
        pick = rng.integers(0, 10, size=shape)
        v = np.where(pick < 5, small, np.where(pick < 7, addr, np.where(pick < 9, edge, wide)))
        return v

    def cells(shape):
        kind = rng.integers(0, 20, size=shape)
        op = claimed[rng.integers(0, len(claimed), size=shape)] << 2
        lit = (rng.integers(-100, 300, size=shape) << 2) | 1
        call = (rng.integers(0, CS, size=shape) << 2) | 2
        raw = values(shape)
        c = np.where(kind < 12, op, np.where(kind < 16, lit, np.where(kind < 17, call, raw)))
        return ((c + 2 ** 31) % 2 ** 32 - 2 ** 31).astype(np.int32)

    st = vms.init_state(cfg)
    fields = {}
    for f in vms.VMState._fields:
        x = getattr(st, f)
        fields[f] = np.broadcast_to(x.numpy(), (n,) + tuple(x.shape)).copy()
    fields["cs"] = cells((n, CS))
    fields["mem"] = values((n, MEM)).astype(np.int32)
    for f, size in (("ds", cfg.ds_size), ("rs", cfg.rs_size), ("fs", cfg.fs_size)):
        fields[f] = values((n, T, size)).astype(np.int32)
    fields["dsp"] = rng.integers(0, cfg.ds_size + 1, size=(n, T)).astype(np.int32)
    fields["rsp"] = rng.integers(0, cfg.rs_size + 1, size=(n, T)).astype(np.int32)
    fields["fsp"] = rng.integers(0, cfg.fs_size + 1, size=(n, T)).astype(np.int32)
    fields["pc"] = rng.integers(-2, CS + 2, size=(n, T)).astype(np.int32)
    fields["tstatus"] = rng.choice([ST_YIELD, ST_FREE], size=(n, T)).astype(np.int32)
    for f in ("timeout", "ev_addr", "ev_val", "catch_pc", "catch_rsp", "prio", "deadline"):
        fields[f] = rng.integers(0, CS, size=(n, T)).astype(np.int32)
    fields["pending_exc"] = np.zeros((n, T), np.int32)
    fields["last_exc"] = rng.integers(0, NUM_EXC, size=(n, T)).astype(np.int32)
    fields["handlers"] = np.where(rng.integers(0, 3, size=(n, NUM_EXC)) == 0,
                                  rng.integers(0, CS, size=(n, NUM_EXC)), 0).astype(np.int32)
    cur = rng.integers(0, T, size=n)
    fields["cur"] = cur.astype(np.int32)
    fields["tstatus"][np.arange(n), cur] = ST_RUN
    fields["now"] = rng.integers(0, 10 ** 6, size=n).astype(np.int32)
    fields["steps"] = rng.integers(0, 10 ** 6, size=n).astype(np.int32)
    fields["outp"] = rng.integers(0, cfg.out_ring_size + 1, size=n).astype(np.int32)
    fields["out"] = values((n, 2 * cfg.out_ring_size)).astype(np.int32)
    return vms.VMState(*[
        torch.as_tensor(np.ascontiguousarray(fields[f]), device=device) for f in vms.VMState._fields
    ])


def max_abs_diff(A, B) -> tuple[int, list[str]]:
    """Largest absolute difference over every field (0 = byte-identical)
    and the names of the fields that differ."""
    worst, bad = 0, []
    for f in A._fields:
        a, b = getattr(A, f), getattr(B, f)
        if not torch.equal(a, b):
            bad.append(f)
            worst = max(worst, int((a.long() - b.long()).abs().max()))
    return worst, bad
