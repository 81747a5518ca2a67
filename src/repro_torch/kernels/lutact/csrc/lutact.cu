// lutact.cu — the interpolated int32 sigmoid (scale 1:1000) as a CUDA
// kernel for Hopper (sm_90a).  It replaces the TPU kernel `lut_sigmoid` of
// the JAX package (src/repro/kernels/lutact/lutact.py, pl.pallas_call),
// which gathered the LUT through one-hot products on the MXU because a TPU
// vector unit has no per-element gather.  A GPU thread has one: each block
// copies the 33-entry LUT into shared memory and every element reads its
// two entries from there.
//
// What bounds it on this card: the bytes, 4 read and 4 written per
// element, against a few dozen integer operations.  Each thread takes four
// elements as one 16-byte load and store where the tensor is 16-byte
// aligned (a scalar loop takes the tail), in a grid-stride loop.
//
// The arithmetic (lutact_core.h) is bit-exact with the reference over all
// of int32, INT_MIN included.
#include <cuda_runtime.h>

#include "lutact_core.h"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
lut_sigmoid_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out,
                   const int32_t* __restrict__ lut, long long n, int vec) {
    __shared__ int32_t tab[lutact::N + 1];
    if ((int)threadIdx.x < lutact::N + 1) tab[threadIdx.x] = lut[threadIdx.x];
    __syncthreads();
    const long long stride = (long long)gridDim.x * blockDim.x;
    long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    long long head = 0;
    if (vec) {
        const long long n4 = n / 4;
        const int4* x4 = reinterpret_cast<const int4*>(x);
        int4* o4 = reinterpret_cast<int4*>(out);
        for (long long j = tid; j < n4; j += stride) {
            int4 a = x4[j];
            a.x = lutact::sigmoid_interp(a.x, tab);
            a.y = lutact::sigmoid_interp(a.y, tab);
            a.z = lutact::sigmoid_interp(a.z, tab);
            a.w = lutact::sigmoid_interp(a.w, tab);
            o4[j] = a;
        }
        head = 4 * n4;
    }
    for (long long j = head + tid; j < n; j += stride) out[j] = lutact::sigmoid_interp(x[j], tab);
}

}  // namespace

// Plain C interface for ctypes: `n` contiguous int32 values of `x` into
// `out`; `lut` holds the 33 LUT entries on the device.  Launches on
// `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int lut_sigmoid_launch(const void* x, void* out, const void* lut, long long n,
                                  int max_blocks, void* stream) {
    if (n <= 0) return 0;
    const bool vec = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                     (reinterpret_cast<uintptr_t>(out) % 16 == 0);
    const long long items = vec ? (n + 3) / 4 : n;
    long long blocks = (items + THREADS - 1) / THREADS;
    if (blocks > max_blocks) blocks = max_blocks;
    lut_sigmoid_kernel<<<(int)blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(x), static_cast<int32_t*>(out),
        static_cast<const int32_t*>(lut), n, vec ? 1 : 0);
    return static_cast<int>(cudaGetLastError());
}
