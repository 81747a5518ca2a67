// lutact_host.cpp — the lut_sigmoid kernel's per-element body
// (lutact_core.h) compiled for the CPU with g++.  It exists only so that
// the kernel's integer semantics can be checked without a GPU
// (tests/test_torch_lutact.py); the package never builds or loads it.
#include "lutact_core.h"

extern "C" int lut_sigmoid_host(const int32_t* x, int32_t* out, const int32_t* lut,
                                long long n) {
    for (long long j = 0; j < n; ++j) out[j] = lutact::sigmoid_interp(x[j], lut);
    return 0;
}
