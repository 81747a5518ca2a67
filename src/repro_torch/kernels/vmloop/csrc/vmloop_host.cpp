// vmloop_host.cpp — the same per-node loop (vmloop_core.h) compiled for the
// CPU with g++, row after row.  It exists only so that the CUDA kernel's
// semantics can be checked without a GPU (tests/test_torch_vmloop.py builds
// it); the package never builds or loads it.
#include "vmloop_core.h"

using namespace rexavm;

// Arguments as vmloop_launch's (vmloop.cu), without the stream and block.
extern "C" int vmloop_host(void* const* fields, void* const* tables, const int32_t* meta,
                           const int32_t* dims, int32_t n_nodes, int32_t steps,
                           const int32_t* rows, const int32_t* budget, int32_t n_rows,
                           void* n_exec, void* bailed, void* bail_op) {
    Fields f;
    int32_t** fp = reinterpret_cast<int32_t**>(&f);
    for (int k = 0; k < 24; ++k) fp[k] = static_cast<int32_t*>(fields[k]);
    Tabs tb;
    const int32_t** tp = reinterpret_cast<const int32_t**>(&tb);
    for (int k = 0; k < 9; ++k) tp[k] = static_cast<const int32_t*>(tables[k]);
    const Dims d{dims[0], dims[1], dims[2], dims[3], dims[4], dims[5], dims[6], dims[7]};
    for (int64_t j = 0; j < n_rows; ++j)
        run_core(f, d, tb, meta, j, launch_row(rows, budget, n_nodes, steps, j, n_rows),
                 static_cast<int32_t*>(n_exec), static_cast<int32_t*>(bailed),
                 static_cast<int32_t*>(bail_op));
    return 0;
}

// The counting instance (run_core<true>): as vmloop_host, and `op_hist`
// (n_rows, NUM_BINS) int32, each row zeroed and then counted.
extern "C" int vmloop_host_obs(void* const* fields, void* const* tables, const int32_t* meta,
                               const int32_t* dims, int32_t n_nodes, int32_t steps,
                               const int32_t* rows, const int32_t* budget, int32_t n_rows,
                               void* n_exec, void* bailed, void* bail_op, void* op_hist) {
    Fields f;
    int32_t** fp = reinterpret_cast<int32_t**>(&f);
    for (int k = 0; k < 24; ++k) fp[k] = static_cast<int32_t*>(fields[k]);
    Tabs tb;
    const int32_t** tp = reinterpret_cast<const int32_t**>(&tb);
    for (int k = 0; k < 9; ++k) tp[k] = static_cast<const int32_t*>(tables[k]);
    const Dims d{dims[0], dims[1], dims[2], dims[3], dims[4], dims[5], dims[6], dims[7]};
    for (int64_t j = 0; j < n_rows; ++j) {
        int32_t* hist = static_cast<int32_t*>(op_hist) + j * NUM_BINS;
        for (int32_t k = 0; k < NUM_BINS; ++k) hist[k] = 0;
        run_core<true>(f, d, tb, meta, j, launch_row(rows, budget, n_nodes, steps, j, n_rows),
                       static_cast<int32_t*>(n_exec), static_cast<int32_t*>(bailed),
                       static_cast<int32_t*>(bail_op), hist);
    }
    return 0;
}
