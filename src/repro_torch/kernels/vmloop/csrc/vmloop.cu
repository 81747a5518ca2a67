// vmloop.cu — the REXAVM fleet's per-node interpreter loop as a CUDA kernel
// for Hopper (sm_90a).  It replaces the TPU kernel `vmloop_call` of the JAX
// package (src/repro/kernels/vmloop/vmloop.py:64, pl.pallas_call), which held
// one node's machine state in VMEM per grid program.
//
// Design: one thread per node (a launch row), blocks of 1-32 nodes, the
// count chosen by the wrapper from the rows and the SM count (vmloop.py
// nodes_per_block: 8 at the 4096-node fleet, about four blocks an SM, so
// that each SM interleaves several chains; one a block for a small fleet,
// which spreads over the SMs).  A node's instructions form one dependent
// chain (fetch -> decode -> stack effect -> next pc), so the design
// shortens that chain (vmloop_core.h):
//   * the current task's scalars (pc, dsp, rsp, fsp, status, steps, ...) in
//     registers, loaded once and stored back once;
//   * vector loops over the cells a word uses, not the whole max_vec window;
//   * the arithmetic words of one shape sharing one pop and push, which
//     keeps the dispatch short.
// The stacks, the code and the arrays stay in device memory (through L1),
// and the packed opcode table with them; the value LUTs go through the
// read-only path, `cs` does not, since programs store into their code
// segment.  scripts/vmloop_sweep.py builds the designs that were tried and
// dropped (stacks staged in shared memory, the opcode table in shared
// memory, the long words out of line) by editing this source, and times
// them beside it.
// Rows: an optional row list and per-row budget, so that the executor can
// resume only the nodes it handed back after a declined word.
//
// What bounds it: the per-instruction chain of each node, not bytes.  A
// launch moves a few MB (the cells it changes plus each node's code and
// arrays: ~1.3 us at 3.35 TB/s for 4096 nodes), while each node retires up
// to a slice of instructions that each wait on the one before: the cs fetch
// and the opcode table through L1, a tree of branches to the word's body,
// its stack cells through L1, the step count and the exception check.  A
// warp whose nodes take different words runs their bodies one after
// another, and a few warps an SM hide little of the latency, so the time is
// the longest node's chain.
//
// Contract (ref.run_core): per row, up to its budget of instructions; stop
// on the budget, a status change, or before the first declined opcode;
// write n_exec / bailed / bail_op per row.
//
// Two instances of one loop (vmloop_core.h run_core<OBS>): the default one,
// and the counting one (ref.run_core(obs=True), the reference's
// make_run_core(obs=True)), which also writes each row's retirement
// histogram, op_hist (n_rows, NUM_BINS) int32 in row order.  A row's 103
// bins are its own thread's cells in shared memory (dynamic, blockDim.x *
// NUM_BINS * 4 bytes; no atomics: each thread owns its row), zeroed by the
// thread at entry and copied out by it at exit (an unrolled loop of known
// length, no barrier).  Measured against the other designs
// (scripts/vmloop_obs_sweep.py, PERF.md): the row counted in device memory
// is 2-4% slower at 4096 nodes, a block-wide copy-out after a barrier 18%
// slower at 64 (one node a block).
#include <cuda_runtime.h>

#include "vmloop_core.h"

using namespace rexavm;

constexpr int MAX_BLOCK = 32;

// Thread t of block b runs launch row b * blockDim.x + t.
__global__ void __launch_bounds__(MAX_BLOCK)
vmloop_kernel(Fields f, Dims d, Tabs tb, const int32_t* meta, int32_t n_nodes, int32_t steps,
              const int32_t* rows, const int32_t* budget, int32_t n_rows, int32_t* n_exec,
              int32_t* bailed, int32_t* bail_op) {
    const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (j >= n_rows) return;
    run_core(f, d, tb, meta, j, launch_row(rows, budget, n_nodes, steps, j, n_rows), n_exec,
             bailed, bail_op);
}

// The counting instance: as vmloop_kernel, and each row's bins into
// op_hist (see the note at the top).
__global__ void __launch_bounds__(MAX_BLOCK)
vmloop_obs_kernel(Fields f, Dims d, Tabs tb, const int32_t* meta, int32_t n_nodes, int32_t steps,
                  const int32_t* rows, const int32_t* budget, int32_t n_rows, int32_t* n_exec,
                  int32_t* bailed, int32_t* bail_op, int32_t* op_hist) {
    extern __shared__ int32_t hist_s[];
    const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (j >= n_rows) return;
    int32_t* mine = hist_s + threadIdx.x * NUM_BINS;
    for (int32_t k = 0; k < NUM_BINS; ++k) mine[k] = 0;
    run_core<true>(f, d, tb, meta, j, launch_row(rows, budget, n_nodes, steps, j, n_rows), n_exec,
                   bailed, bail_op, mine);
    int32_t* out = op_hist + j * NUM_BINS;
#pragma unroll
    for (int32_t k = 0; k < NUM_BINS; ++k) out[k] = mine[k];
}

// The launch behind both C entries: unpacks the pointers, launches
// grid(n_rows / block) x block threads on `stream` (the counting instance
// when op_hist is not null) and returns cudaGetLastError().
static int launch(void* const* fields, void* const* tables, const void* meta,
                  const int32_t* dims, int32_t n_nodes, int32_t steps, const void* rows,
                  const void* budget, int32_t n_rows, void* n_exec, void* bailed, void* bail_op,
                  void* op_hist, void* stream, int32_t block) {
    if (block < 1 || block > MAX_BLOCK || n_rows < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    Fields f;
    int32_t** fp = reinterpret_cast<int32_t**>(&f);
    for (int k = 0; k < 24; ++k) fp[k] = static_cast<int32_t*>(fields[k]);
    Tabs tb;
    const int32_t** tp = reinterpret_cast<const int32_t**>(&tb);
    for (int k = 0; k < 9; ++k) tp[k] = static_cast<const int32_t*>(tables[k]);
    const Dims d{dims[0], dims[1], dims[2], dims[3], dims[4], dims[5], dims[6], dims[7]};
    const int grid = (n_rows + block - 1) / block;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int32_t* m = static_cast<const int32_t*>(meta);
    const int32_t* rw = static_cast<const int32_t*>(rows);
    const int32_t* bg = static_cast<const int32_t*>(budget);
    int32_t* ne = static_cast<int32_t*>(n_exec);
    int32_t* bl = static_cast<int32_t*>(bailed);
    int32_t* bo = static_cast<int32_t*>(bail_op);
    if (grid > 0 && op_hist == nullptr) {
        vmloop_kernel<<<grid, block, 0, s>>>(f, d, tb, m, n_nodes, steps, rw, bg, n_rows, ne, bl,
                                             bo);
    } else if (grid > 0) {
        const size_t smem = static_cast<size_t>(block) * NUM_BINS * sizeof(int32_t);
        vmloop_obs_kernel<<<grid, block, smem, s>>>(f, d, tb, m, n_nodes, steps, rw, bg, n_rows,
                                                    ne, bl, bo, static_cast<int32_t*>(op_hist));
    }
    return static_cast<int>(cudaGetLastError());
}

// Plain C interface for ctypes.  `fields` holds the 24 CoreState base
// pointers (ref.CORE_FIELDS order), `tables` the 9 table pointers
// (ref.Tables order), `meta` the packed opcode table (vmloop.py
// pack_meta), `dims` CS, MEM, T, DS, RS, FS, OUTN, MV (vmloop_core.h
// Dims).  `rows` and `budget` are (n_rows,) int32 or null (then row j is
// node j, and every row runs `steps`).  Launches on `stream` in blocks of
// `block` nodes and returns cudaGetLastError() (0 = launched).
extern "C" int vmloop_launch(void* const* fields, void* const* tables, const void* meta,
                             const int32_t* dims, int32_t n_nodes, int32_t steps,
                             const void* rows, const void* budget, int32_t n_rows, void* n_exec,
                             void* bailed, void* bail_op, void* stream, int32_t block) {
    return launch(fields, tables, meta, dims, n_nodes, steps, rows, budget, n_rows, n_exec,
                  bailed, bail_op, nullptr, stream, block);
}

// The counting instance: as vmloop_launch, and `op_hist` (n_rows, NUM_BINS)
// int32, written whole.
extern "C" int vmloop_obs_launch(void* const* fields, void* const* tables, const void* meta,
                                 const int32_t* dims, int32_t n_nodes, int32_t steps,
                                 const void* rows, const void* budget, int32_t n_rows,
                                 void* n_exec, void* bailed, void* bail_op, void* op_hist,
                                 void* stream, int32_t block) {
    if (op_hist == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    return launch(fields, tables, meta, dims, n_nodes, steps, rows, budget, n_rows, n_exec,
                  bailed, bail_op, op_hist, stream, block);
}
