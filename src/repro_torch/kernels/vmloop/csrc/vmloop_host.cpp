// vmloop_host.cpp — the same per-node loop (vmloop_core.h) compiled for the
// CPU with g++, row after row.  It exists only so that the CUDA kernel's
// semantics can be checked without a GPU (tests/test_torch_vmloop.py and
// tests/test_torch_analysis.py build it); the package never builds or
// loads it.
#include "vmloop_core.h"

using namespace rexavm;

// Every row through run_core<OBS, ELIDE>; with OBS each row's NUM_BINS
// cells of `op_hist` are zeroed and then counted.
template <bool OBS, bool ELIDE>
static int host_run(void* const* fields, void* const* tables, const int32_t* meta,
                    const int32_t* dims, int32_t n_nodes, int32_t steps, const int32_t* rows,
                    const int32_t* budget, int32_t n_rows, void* n_exec, void* bailed,
                    void* bail_op, void* op_hist) {
    Fields f;
    int32_t** fp = reinterpret_cast<int32_t**>(&f);
    for (int k = 0; k < 24; ++k) fp[k] = static_cast<int32_t*>(fields[k]);
    Tabs tb;
    const int32_t** tp = reinterpret_cast<const int32_t**>(&tb);
    for (int k = 0; k < 9; ++k) tp[k] = static_cast<const int32_t*>(tables[k]);
    const Dims d{dims[0], dims[1], dims[2], dims[3], dims[4], dims[5], dims[6], dims[7]};
    for (int64_t j = 0; j < n_rows; ++j) {
        int32_t* hist = nullptr;
        if (OBS) {
            hist = static_cast<int32_t*>(op_hist) + j * NUM_BINS;
            for (int32_t k = 0; k < NUM_BINS; ++k) hist[k] = 0;
        }
        run_core<OBS, ELIDE>(f, d, tb, meta, j, launch_row(rows, budget, n_nodes, steps, j, n_rows),
                             static_cast<int32_t*>(n_exec), static_cast<int32_t*>(bailed),
                             static_cast<int32_t*>(bail_op), hist);
    }
    return 0;
}

// Arguments as vmloop_launch's (vmloop.cu), without the stream and block.
extern "C" int vmloop_host(void* const* fields, void* const* tables, const int32_t* meta,
                           const int32_t* dims, int32_t n_nodes, int32_t steps,
                           const int32_t* rows, const int32_t* budget, int32_t n_rows,
                           void* n_exec, void* bailed, void* bail_op) {
    return host_run<false, false>(fields, tables, meta, dims, n_nodes, steps, rows, budget,
                                  n_rows, n_exec, bailed, bail_op, nullptr);
}

// The counting instance (run_core<true>): as vmloop_host, and `op_hist`
// (n_rows, NUM_BINS) int32, each row zeroed and then counted.
extern "C" int vmloop_host_obs(void* const* fields, void* const* tables, const int32_t* meta,
                               const int32_t* dims, int32_t n_nodes, int32_t steps,
                               const int32_t* rows, const int32_t* budget, int32_t n_rows,
                               void* n_exec, void* bailed, void* bail_op, void* op_hist) {
    return host_run<true, false>(fields, tables, meta, dims, n_nodes, steps, rows, budget,
                                 n_rows, n_exec, bailed, bail_op, op_hist);
}

// The checks-elided instance (run_core<false, true>): as vmloop_host.
extern "C" int vmloop_host_elide(void* const* fields, void* const* tables, const int32_t* meta,
                                 const int32_t* dims, int32_t n_nodes, int32_t steps,
                                 const int32_t* rows, const int32_t* budget, int32_t n_rows,
                                 void* n_exec, void* bailed, void* bail_op) {
    return host_run<false, true>(fields, tables, meta, dims, n_nodes, steps, rows, budget,
                                 n_rows, n_exec, bailed, bail_op, nullptr);
}
