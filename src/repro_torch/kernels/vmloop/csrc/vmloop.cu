// vmloop.cu — the REXAVM fleet's per-node interpreter loop as a CUDA kernel
// for Hopper (sm_90a).  It replaces the TPU kernel `vmloop_call` of the JAX
// package (src/repro/kernels/vmloop/vmloop.py, pl.pallas_call), which held
// one node's machine state in VMEM per grid program.
//
// Design: one thread per node.  The loop is scalar control flow over a
// 100-way switch with data-dependent trip counts, so there is nothing to
// vectorise across a node; nodes are independent, so they map to threads.
// The state stays in device memory as node-strided field arrays (the
// stacked VMState tensors themselves) and is updated IN PLACE: the kernel
// reads and writes only the cells its instructions touch, and no copy of a
// node (~49 KB at the default VMConfig, just over the 48 KB static
// shared-memory limit) is staged.
//
// What bounds it: the bytes the retired instructions read and write in
// device memory (a few cells each), with no reuse across threads; threads
// of a warp touch cells ~50 KB apart, so each access is its own memory
// transaction, and a warp whose nodes take different branches serialises
// them.  Staging a node in dynamic shared memory, or a warp per node, is
// work for a later change.
//
// Contract (ref.run_core): per node, up to `steps` instructions; stop on
// the budget, a status change, or before the first declined opcode; write
// n_exec / bailed / bail_op per node.
#include <cuda_runtime.h>

#include "vmloop_core.h"

using namespace rexavm;

__global__ void vmloop_kernel(Fields f, Dims d, Tabs tb, int32_t n_nodes, int32_t steps,
                              int32_t* n_exec, int32_t* bailed, int32_t* bail_op) {
    int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n_nodes) return;
    run_core(f, d, tb, i, steps, n_exec, bailed, bail_op);
}

// Plain C interface for ctypes.  `fields` holds the 24 CoreState base
// pointers (ref.CORE_FIELDS order), `tables` the 9 table pointers
// (ref.Tables order), `dims` CS, MEM, T, DS, RS, FS, OUTN, MV.  Launches on
// `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int vmloop_launch(void* const* fields, void* const* tables, const int32_t* dims,
                             int32_t n_nodes, int32_t steps, void* n_exec, void* bailed,
                             void* bail_op, void* stream, int32_t block) {
    Fields f;
    int32_t** fp = reinterpret_cast<int32_t**>(&f);
    for (int k = 0; k < 24; ++k) fp[k] = static_cast<int32_t*>(fields[k]);
    Tabs tb;
    const int32_t** tp = reinterpret_cast<const int32_t**>(&tb);
    for (int k = 0; k < 9; ++k) tp[k] = static_cast<const int32_t*>(tables[k]);
    Dims d{dims[0], dims[1], dims[2], dims[3], dims[4], dims[5], dims[6], dims[7]};
    int grid = (n_nodes + block - 1) / block;
    if (grid > 0) {
        vmloop_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
            f, d, tb, n_nodes, steps, static_cast<int32_t*>(n_exec),
            static_cast<int32_t*>(bailed), static_cast<int32_t*>(bail_op));
    }
    return static_cast<int>(cudaGetLastError());
}
