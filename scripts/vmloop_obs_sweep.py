"""Time vmloop's counting instance (``vmloop_call(..., obs=True)``) against
the other place its histogram could live, and beside the default instance.

The counting instance keeps each row's 103 retirement bins in its own
thread's cells of shared memory, zeroed at entry and copied out by the
thread itself at exit (``csrc/vmloop.cu`` ``vmloop_obs_kernel``).  The
variants, built here by text edits of that source (so the shipped source
carries no switch):

  global_rows   each thread zeroes and counts in its own row of ``op_hist``
                in device memory (through L1): no shared memory, no copy-out;
  block_copy    the bins in shared memory, copied out after a barrier by
                the whole block as one contiguous range (the first design).

Each is timed at the fleet cell (n 4096: ``chip_smoke.py``'s ring program,
one slice of 256 steps) and at the serve monitor's 64 nodes, in turns (the
default instance, the source as built, the variant; then the same in
reverse order; twice), each launch's state, n_exec/bailed/bail_op and
op_hist held equal to the built source's.

    python3 scripts/vmloop_obs_sweep.py

Run from the root of a checkout on a machine with CUDA and nvcc.  Prints
the card, each build's ptxas lines, one JSON line per timing (the median
launch of ``REPS``) and one summary line (the mean of the turns, ms a
launch and the ratio to the default instance).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BUILT = """    extern __shared__ int32_t hist_s[];
    const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (j >= n_rows) return;
    int32_t* mine = hist_s + threadIdx.x * NUM_BINS;
    for (int32_t k = 0; k < NUM_BINS; ++k) mine[k] = 0;
    run_core<true>(f, d, tb, meta, j, launch_row(rows, budget, n_nodes, steps, j, n_rows), n_exec,
                   bailed, bail_op, mine);
    int32_t* out = op_hist + j * NUM_BINS;
#pragma unroll
    for (int32_t k = 0; k < NUM_BINS; ++k) out[k] = mine[k];
"""
GLOBAL_ROWS = [("vmloop.cu", BUILT, """    const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (j >= n_rows) return;
    int32_t* mine = op_hist + j * NUM_BINS;
    for (int32_t k = 0; k < NUM_BINS; ++k) mine[k] = 0;
    run_core<true>(f, d, tb, meta, j, launch_row(rows, budget, n_nodes, steps, j, n_rows), n_exec,
                   bailed, bail_op, mine);
""")]
BLOCK_COPY = [("vmloop.cu", BUILT, """    extern __shared__ int32_t hist_s[];
    int32_t* mine = hist_s + threadIdx.x * NUM_BINS;
    for (int32_t k = 0; k < NUM_BINS; ++k) mine[k] = 0;
    const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x;
    const int64_t j = first + threadIdx.x;
    if (j < n_rows)
        run_core<true>(f, d, tb, meta, j, launch_row(rows, budget, n_nodes, steps, j, n_rows),
                       n_exec, bailed, bail_op, mine);
    __syncthreads();
    const int64_t cells = (n_rows - first < blockDim.x ? n_rows - first : blockDim.x) * NUM_BINS;
    for (int64_t c = threadIdx.x; c < cells; c += blockDim.x) op_hist[first * NUM_BINS + c] = hist_s[c];
""")]
VARIANTS = {"global_rows": GLOBAL_ROWS, "block_copy": BLOCK_COPY}
SPIN_CYCLES = 1_000_000
REPS = 10
TURNS = 2


def launch_ms(torch, kmod, S0, cfg, obs: bool):
    """Median device ms of one launch over REPS launches after two
    warm-ups, the state restored and a spin kernel queued before each;
    returns the last launch's state and outputs too."""
    from repro_torch.core.vm import vmstate as vms
    from repro_torch.kernels.vmloop.ref import core_of

    work = vms.clone(S0)
    core = core_of(work)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for rep in range(REPS + 2):
        for a, b in zip(work, S0):
            a.copy_(b)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        out = kmod.vmloop_call(core, cfg.steps_per_slice, cfg, obs=obs)[1:]
        end.record()
        torch.cuda.synchronize()
        if rep >= 2:
            times.append(start.elapsed_time(end))
    return sorted(times)[REPS // 2], work, out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false: this script needs a GPU")
    sys.path.insert(0, os.path.join(HERE, "src"))
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    from chip_smoke import MONITOR_NODES, N_NODES, PROMPT_LEN, SERVE_BATCH, ann_program
    from vmloop_sweep import variant_library
    from repro_torch.config import VMConfig
    from repro_torch.core.vm import REXAVM, vmstate as vms
    from repro_torch.core.vm.interp import interp_for
    from repro_torch.kernels.vmloop import check, vmloop as kmod
    from repro_torch.serve import FleetServeMonitor

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    libs = {"built": kmod.LIBRARY,
            **{name: variant_library(kmod, name, edits) for name, edits in VARIANTS.items()}}
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
    del nodes, mon

    points = [("default", "built", False)] + [(name, name, True) for name in libs]
    runs: dict = {(p, key): [] for p, _, _ in points for key in shapes}
    expect: dict = {}
    for _ in range(TURNS):
        for point, lib, obs in points + list(reversed(points)):
            kmod.LIBRARY = libs[lib]
            for key, S0 in shapes.items():
                ms, state, out = launch_ms(torch, kmod, S0, cfg, obs)
                if obs:
                    if key not in expect:
                        expect[key] = (state, out)
                    elif (check.max_abs_diff(state, expect[key][0])[1]
                          or not all(torch.equal(a, b) for a, b in zip(out, expect[key][1]))):
                        sys.exit(f"{point} at {key} differs from the source as built")
                runs[point, key].append(ms)
                print(json.dumps({"phase": "turn", "point": point, "shape": key, "ms": ms}),
                      flush=True)
    kmod.LIBRARY = libs["built"]
    for point, _, _ in points:
        rec = {"phase": "point", "point": point}
        for key in shapes:
            ms = sum(runs[point, key]) / len(runs[point, key])
            base = sum(runs["default", key]) / len(runs["default", key])
            rec[key] = {"ms": ms, "x_default": ms / base}
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
