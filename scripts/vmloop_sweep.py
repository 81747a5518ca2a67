"""Split the time of the vmloop kernel by its design points: build variants
of ``csrc/vmloop.cu`` and ``csrc/vmloop_core.h`` that each edit one design
point of the source as built (``VARIANTS``: text edits made here, so the
shipped source carries no switch), and time one launch of each at the
fleet cell (n 4096: ``chip_smoke.py``'s ring program, one slice of 256
steps), at the serve monitor's 64 nodes and at two one-program fleets
(``PROGRAMS``), in turns: the source as built, each variant, the variants
again in reverse order, the source as built.  Then the source as built at
1, 2, 4, 8, 16 and 32 nodes a block; with every budget 0 (launch and row
reads only) and 1; and a profiling build (the SM clock read around each
instruction's fetch and execution, summed per word in each thread's local
memory, which adds its own cycles) that prints the cycles each word takes.
Every variant computes the same function: each launch's state and outputs
are held equal to the built source's.  The variants:

  first_design   the design the kernel had before: state in device memory,
                 vector loops over the whole max_vec window, 32 nodes a
                 block (the op-body rewrites that every build shares are in);
  no_regs        the task's scalars read and written in device memory;
  no_live_cells  vector loops over the whole max_vec window;
  smem_tables    the packed opcode table copied into shared memory once a
                 block;
  outline        the long words (vector words, LUT scalars, prstr, vecprint)
                 called out of line;
  smem_stacks    the current task's three stacks copied whole into shared
                 memory by the node's thread at entry and back at exit
                 (1,792 B a node at the default VMConfig).

    python3 scripts/vmloop_sweep.py

Run from the root of a checkout on a machine with CUDA and nvcc.  Prints
the card, each build's ptxas lines (registers, stack frame, spills), one
JSON line per timing (the median launch of ``REPS``) and one summary line
per variant (the mean of its turns, ms a launch and ns per instruction of
the longest node).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Text edits of the two sources, (file, old, new); each `old` must occur once.
NO_REGS = [("vmloop_core.h",
            """    int32_t pc, dsp, rsp, fsp, tstatus, timeout, ev_addr, ev_val;
    int32_t catch_pc, catch_rsp, pending_exc, last_exc, io_op, steps, outp;
""",
            """    int32_t &pc, &dsp, &rsp, &fsp, &tstatus, &timeout, &ev_addr, &ev_val;
    int32_t &catch_pc, &catch_rsp, &pending_exc, &last_exc, &io_op, &steps, &outp;
""")]
NO_LIVE_CELLS = [("vmloop_core.h", old, new) for old, new in [
    ("        for (int32_t k = 0; k < ln; ++k) v[k] = s.ld(wadd(a, k));\n",
     "        for (int32_t k = 0; k < window; ++k) {\n"
     "            int32_t x = s.ld(wadd(a, k));\n"
     "            v[k] = k < ln ? x : 0;\n"
     "        }\n"),
    ("for (int32_t k = 0; k < ln; ++k) v[k] = vscale1(v[k], s[k]);",
     "for (int32_t k = 0; k < MV; ++k) v[k] = vscale1(v[k], s[k]);"),
    ("for (int32_t k = 0; k < ln; ++k) v1[k] = a0;", "for (int32_t k = 0; k < MV; ++k) v1[k] = a0;"),
    ("for (int32_t k = 0; k < ln; ++k) v1[k] = vscale1(v1[k], v2[k]);",
     "for (int32_t k = 0; k < MV; ++k) v1[k] = vscale1(v1[k], v2[k]);"),
    ("        for (int32_t k = 0; k < ln; ++k)\n            v1[k] = code == OP_VECADD",
     "        for (int32_t k = 0; k < MV; ++k)\n            v1[k] = code == OP_VECADD"),
    ("        for (int32_t j = 0; j < m; ++j) {", "        for (int32_t j = 0; j < MV; ++j) {"),
    ("for (int32_t i = 0; i < n; ++i) acc = wadd(acc, wmul(v1[i], w.ld(wadd(a1, i * m + j))));",
     "for (int32_t i = 0; i < (j < m ? n : 0); ++i) acc = wadd(acc, wmul(v1[i], w.ld(wadd(a1, i * m + j))));"),
    ("        for (int32_t k = 0; k < ln; ++k) {\n            int32_t x = v1[k];",
     "        for (int32_t k = 0; k < MV; ++k) {\n            int32_t x = v1[k];"),
    ("    for (int32_t k = 0; k < n; ++k) {\n        int32_t v = x.ld(wadd(a0, k));",
     "    for (int32_t k = 0; k < sp.MV; ++k) {\n        int32_t v = k < n ? x.ld(wadd(a0, k)) : I32_MIN;"),
]]
SMEM_TABLES = [
    ("vmloop.cu", "int32_t* bail_op) {\n"
     "    const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;\n",
     "int32_t* bail_op) {\n"
     "    __shared__ int32_t meta_s[NUM_OPS + 1];\n"
     "    for (int k = threadIdx.x; k <= NUM_OPS; k += blockDim.x) meta_s[k] = meta[k];\n"
     "    __syncthreads();\n"
     "    const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;\n"),
    ("vmloop.cu", "run_core(f, d, tb, meta, j,", "run_core(f, d, tb, meta_s, j,"),
]
OUTLINE = [("vmloop_core.h", f"RX_HD {sig}", f"__host__ __device__ __noinline__ {sig}")
           for sig in ("int32_t dsp_word(", "void vec_store_word(", "int32_t vec_reduce_word(",
                       "int32_t prstr_word(", "int32_t vecprint_word(")]
SMEM_STACKS = [
    ("vmloop_core.h", "        Vm vm(f, d, tb, r.node, it);\n",
     """        Vm vm(f, d, tb, r.node, it);
#ifdef __CUDA_ARCH__
        extern __shared__ int32_t stage_smem[];
        int32_t* const buf = stage_smem + threadIdx.x * (d.DS + d.RS + d.FS);
        int32_t* const rows[3] = {vm.ds, vm.rs, vm.fs};
        const int32_t at[3] = {0, d.DS, d.DS + d.RS}, size[3] = {d.DS, d.RS, d.FS};
        for (int s = 0; s < 3; ++s)
            for (int32_t k = 0; k < size[s]; ++k) buf[at[s] + k] = rows[s][k];
        vm.ds = buf; vm.rs = buf + at[1]; vm.fs = buf + at[2];
#endif
"""),
    ("vmloop_core.h", "        vm.store(f, r.node, it);\n",
     """        vm.store(f, r.node, it);
#ifdef __CUDA_ARCH__
        for (int s = 0; s < 3; ++s)
            for (int32_t k = 0; k < size[s]; ++k) rows[s][k] = buf[at[s] + k];
#endif
"""),
    ("vmloop.cu", "vmloop_kernel<<<grid, block, 0,",
     "vmloop_kernel<<<grid, block, 4 * block * (d.DS + d.RS + d.FS),"),
]
# Profile keys: the opcodes, then literals, calls, other cells, the fetch.
PROF_KEYS = 99 + 5
PROFILE = [
    ("vmloop_core.h", "namespace rexavm {\n",
     f"""#ifdef __CUDACC__
__device__ unsigned long long vmloop_prof[2][{PROF_KEYS}];
#endif
namespace rexavm {{
"""),
    ("vmloop_core.h",
     "        while (n < r.budget && vm.tstatus == ST_RUN) {\n            int32_t p = vm.pc;\n",
     f"""#ifdef __CUDA_ARCH__
        unsigned int cyc[{PROF_KEYS}] = {{}}, cnt[{PROF_KEYS}] = {{}};
#endif
        while (n < r.budget && vm.tstatus == ST_RUN) {{
#ifdef __CUDA_ARCH__
            unsigned int t0 = (unsigned int)clock();
#endif
            int32_t p = vm.pc;
"""),
    ("vmloop_core.h", "            vm.step(p, pc_ok, instr, m);\n",
     f"""#ifdef __CUDA_ARCH__
            unsigned int t1 = (unsigned int)clock();
            cyc[{PROF_KEYS} - 1] += t1 - t0; cnt[{PROF_KEYS} - 1] += 1;
            t0 = (unsigned int)clock();
#endif
            vm.step(p, pc_ok, instr, m);
#ifdef __CUDA_ARCH__
            const int key = !pc_ok ? NUM_OPS + 3 : (instr & 3) == 0 ? code
                            : (instr & 3) == 1 ? NUM_OPS + 1 : (instr & 3) == 2 ? NUM_OPS + 2
                            : NUM_OPS + 3;
            cyc[key] += (unsigned int)clock() - t0; cnt[key] += 1;
#endif
"""),
    ("vmloop_core.h", "        vm.store(f, r.node, it);\n",
     f"""        vm.store(f, r.node, it);
#ifdef __CUDA_ARCH__
        for (int k = 0; k < {PROF_KEYS}; ++k)
            if (cnt[k]) {{
                atomicAdd(&vmloop_prof[0][k], (unsigned long long)cyc[k]);
                atomicAdd(&vmloop_prof[1][k], (unsigned long long)cnt[k]);
            }}
#endif
"""),
    ("vmloop.cu", "extern \"C\" int vmloop_launch(",
     f"""// Copy the profile (cycles, then counts, {PROF_KEYS} keys each) to `out`
// and clear it.
extern "C" int vmloop_profile(unsigned long long* out) {{
    cudaError_t e = cudaMemcpyFromSymbol(out, vmloop_prof, sizeof(vmloop_prof));
    if (e != cudaSuccess) return static_cast<int>(e);
    unsigned long long zero[2][{PROF_KEYS}] = {{}};
    return static_cast<int>(cudaMemcpyToSymbol(vmloop_prof, zero, sizeof(zero)));
}}

extern "C" int vmloop_launch("""),
]
VARIANTS = {
    "first_design": NO_REGS + NO_LIVE_CELLS,
    "no_regs": NO_REGS,
    "no_live_cells": NO_LIVE_CELLS,
    "smem_tables": SMEM_TABLES,
    "outline": OUTLINE,
    "smem_stacks": SMEM_STACKS,
}
BLOCK_OF = {"first_design": 32}      # nodes a block where the rule's is not the variant's
BLOCKS = (1, 2, 4, 8, 16, 32)
# Two more fleets of 4096 nodes, one program each, that split the cost of
# an instruction: words from the big switch, and literals (decoded beside
# the fetch) with a few stack words.
PROGRAMS = {
    "n4096_scalar": "0 begin 1+ dup 1000000 >= until halt",
    "n4096_literal": "begin 1 2 3 4 5 6 7 8 2drop 2drop 2drop 2drop 0 until halt",
}
SPIN_CYCLES = 1_000_000
REPS = 10


def variant_library(kmod, name: str, edits):
    """The kernel's sources with ``edits`` applied, under
    ``build/vmloop_sweep/<name>/``, as a ``CudaLibrary``."""
    from repro_torch.kernels.nvcc import CudaLibrary

    text = {f: (kmod.CSRC / f).read_text() for f in ("vmloop.cu", "vmloop_core.h")}
    for f, old, new in edits:
        if text[f].count(old) != 1:
            sys.exit(f"{f} does not hold {old!r} once")
        text[f] = text[f].replace(old, new)
    d = Path(HERE) / "build" / "vmloop_sweep" / name
    d.mkdir(parents=True, exist_ok=True)
    for f, t in text.items():
        (d / f).write_text(t)
    return CudaLibrary(f"vmloop_{name}", d, "vmloop.cu", ("vmloop_core.h",), kmod.LIBRARY.bind)


def launch_ms(torch, kmod, S0, cfg, block=None, budget=None):
    """Median device ms of one launch over REPS launches after two
    warm-ups, the state restored and a spin kernel queued before each (the
    median, since a host stall between the start event and the launch
    lands in one launch's time); returns the last launch's state and
    n_exec too.  ``block`` overrides the wrapper's
    nodes a block for these launches."""
    from repro_torch.core.vm import vmstate as vms
    from repro_torch.kernels.vmloop.ref import core_of

    rule = kmod.nodes_per_block
    if block is not None:
        kmod.nodes_per_block = lambda rows, sms: block
    work = vms.clone(S0)
    core = core_of(work)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    try:
        for rep in range(REPS + 2):
            for a, b in zip(work, S0):
                a.copy_(b)
            torch.cuda._sleep(SPIN_CYCLES)
            start.record()
            n_exec = kmod.vmloop_call(core, cfg.steps_per_slice, cfg, budget=budget)[1]
            end.record()
            torch.cuda.synchronize()
            if rep >= 2:
                times.append(start.elapsed_time(end))
    finally:
        kmod.nodes_per_block = rule
    return sorted(times)[REPS // 2], work, n_exec


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false: this script needs a GPU")
    sys.path.insert(0, os.path.join(HERE, "src"))
    sys.path.insert(0, HERE)
    from chip_smoke import MONITOR_NODES, N_NODES, PROMPT_LEN, SERVE_BATCH, ann_program
    from repro_torch.config import VMConfig
    from repro_torch.core.vm import REXAVM, vmstate as vms
    from repro_torch.core.vm.interp import interp_for
    from repro_torch.kernels.vmloop import check, vmloop as kmod
    from repro_torch.serve import FleetServeMonitor

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    libs = {"built": kmod.LIBRARY,
            **{name: variant_library(kmod, name, edits) for name, edits in VARIANTS.items()}}
    prof = variant_library(kmod, "profile", PROFILE)
    with ThreadPoolExecutor(len(libs) + 1) as pool:
        list(pool.map(lambda lib: lib.build(), [*libs.values(), prof]))
    for name, lib in libs.items():
        lib.load()
        print(f"ptxas {name}: " + " | ".join(lib.ptxas_lines()), flush=True)

    dev = torch.device("cuda")
    cfg = VMConfig()
    nodes = [REXAVM(cfg, seed=1 + i, device=dev) for i in range(N_NODES)]
    for i, vm in enumerate(nodes):
        vm.launch(vm.load(ann_program(i, N_NODES)))
    mon = FleetServeMonitor(n=MONITOR_NODES, executor="cuda", device=dev)
    for node, frame in zip(mon.fleet.nodes, mon._frames):
        node.dios_write("stats", [PROMPT_LEN + 1, SERVE_BATCH * PROMPT_LEN, SERVE_BATCH])
        node.launch(frame)
    shapes = {}
    for key, states in ((f"n{N_NODES}", [vm.state for vm in nodes]),
                        (f"n{MONITOR_NODES}", [vm.state for vm in mon.fleet.nodes])):
        S0 = vms.to_device(vms.stack_states(states), dev)
        interp_for(cfg).schedule(S0)
        shapes[key] = S0
    for key, prog in PROGRAMS.items():
        vm = REXAVM(cfg, seed=1, device=dev)
        vm.launch(vm.load(prog))
        S0 = vms.to_device(vms.stack_states([vm.state] * N_NODES), dev)
        interp_for(cfg).schedule(S0)
        shapes[key] = S0
    del nodes, mon

    names = list(libs)
    runs: dict = {(name, key): [] for name in names for key in shapes}
    expect: dict = {}
    for name in names + list(reversed(names)):
        kmod.LIBRARY = libs[name]
        for key, S0 in shapes.items():
            ms, state, n_exec = launch_ms(torch, kmod, S0, cfg, block=BLOCK_OF.get(name))
            if key not in expect:
                expect[key] = (state, n_exec)
            elif (check.max_abs_diff(state, expect[key][0])[1]
                  or not torch.equal(n_exec, expect[key][1])):
                sys.exit(f"variant {name} at {key} differs from the source as built")
            runs[name, key].append(ms)
            print(json.dumps({"phase": "turn", "variant": name, "shape": key, "ms": ms,
                              "longest_node": int(n_exec.max())}), flush=True)
    kmod.LIBRARY = libs["built"]
    for name in names:
        rec = {"phase": "variant", "variant": name}
        for key in shapes:
            ms = sum(runs[name, key]) / len(runs[name, key])
            rec[key] = {"ms": ms, "ns_per_instruction": 1e6 * ms / int(expect[key][1].max())}
        print(json.dumps(rec), flush=True)
    for block in BLOCKS:
        rec = {"phase": "block", "block": block}
        for key, S0 in shapes.items():
            ms = sum(launch_ms(torch, kmod, S0, cfg, block=block)[0] for _ in range(2)) / 2
            rec[key] = {"ms": ms, "ns_per_instruction": 1e6 * ms / int(expect[key][1].max())}
        print(json.dumps(rec), flush=True)
    for key, S0 in shapes.items():
        rec = {"phase": "fixed", "shape": key}
        for b in (0, 1):
            budget = torch.full((S0.pc.shape[0],), b, dtype=torch.int32, device=dev)
            rec[f"budget{b}_ms"] = launch_ms(torch, kmod, S0, cfg, budget=budget)[0]
        print(json.dumps(rec), flush=True)
    profile(torch, kmod, prof, libs["built"], shapes, cfg)
    return 0


def profile(torch, kmod, lib, built, shapes, cfg) -> None:
    """One launch of the profiling build at each shape: per word, its
    cycles per execution, executions and share of all profiled cycles
    (the fetch and the bail check are the key "fetch")."""
    import ctypes

    from repro_torch.core.vm import vmstate as vms
    from repro_torch.core.vm.spec import get_isa
    from repro_torch.kernels.vmloop.ref import core_of

    isa = get_isa()
    names = [isa.name[k] for k in range(isa.num_ops)] + ["fios/trap", "literal", "call", "other",
                                                         "fetch"]
    read = lib.load().vmloop_profile
    read.argtypes = [ctypes.c_void_p]
    out = (ctypes.c_ulonglong * (2 * PROF_KEYS))()
    kmod.LIBRARY = lib
    for key, S0 in shapes.items():
        for rep in range(2):                   # the first launch warms up
            work = vms.clone(S0)
            if read(out) != 0:
                sys.exit("vmloop_profile failed")
            kmod.vmloop_call(core_of(work), cfg.steps_per_slice, cfg)
            torch.cuda.synchronize()
        if read(out) != 0:
            sys.exit("vmloop_profile failed")
        cyc, cnt = list(out[:PROF_KEYS]), list(out[PROF_KEYS:])
        total = sum(cyc) or 1
        top = sorted(range(PROF_KEYS), key=lambda k: -cyc[k])[:14]
        print(json.dumps({"phase": "profile", "shape": key, "cycles": total, "words": [
            {"word": names[k], "cycles_each": cyc[k] / max(cnt[k], 1), "count": cnt[k],
             "share": cyc[k] / total} for k in top if cnt[k]]}), flush=True)
    kmod.LIBRARY = built


if __name__ == "__main__":
    sys.exit(main())
