// A CPU emulation of the part of the CUDA runtime that the flash attention
// kernels use, so that their sources (csrc/flashattn_tc.cu,
// csrc/flashattn_bwd.cu) build with g++ and run on the host in the tests
// (tests/test_torch_flash_emu.py).  The test rewrites each `extern
// __shared__` declaration and each `kernel<<<grid, block, smem,
// stream>>>(args)` launch into calls of `emu::`; everything else compiles
// as written.  Blocks run one after another; every thread of a block is a
// std::thread, `__syncthreads` a barrier of the block, and the warp-level
// operations (shuffles here, ldmatrix and mma.sync in flashattn_mma.cuh)
// exchange their operands through a per-warp buffer between two barriers
// of the warp.  Shared memory starts filled with 0xFF bytes (a bf16 NaN),
// so a read of anything the kernel did not write shows in its output.
#pragma once
#include <math.h>

#include <atomic>
#include <barrier>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(n) alignas(n)

struct dim3 {
    unsigned x, y, z;
    dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct uint4 {
    unsigned x, y, z, w;
};
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) { return {a, b, c, d}; }
struct float2 {
    float x, y;
};
typedef void* cudaStream_t;
enum cudaError_t {
    cudaSuccess = 0,
    cudaErrorInvalidValue = 1,
    cudaErrorInvalidConfiguration = 9,
    cudaErrorInvalidDevice = 101
};
enum cudaFuncAttribute {
    cudaFuncAttributeMaxDynamicSharedMemorySize,
    cudaFuncAttributePreferredSharedMemoryCarveout
};
constexpr int cudaSharedmemCarveoutMaxShared = 100;
inline cudaError_t cudaGetDevice(int* d) {
    *d = 0;
    return cudaSuccess;
}
template <class T>
cudaError_t cudaFuncSetAttribute(T, cudaFuncAttribute, int) {
    return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }

namespace emu {

struct Warp {
    std::barrier<> bar{32};
    uint64_t slot[32][8];
};

struct Block {
    std::barrier<> bar;
    unsigned char* smem;
    std::vector<Warp>* warps;
    explicit Block(int n) : bar(n) {}
};

inline thread_local dim3 tIdx, bIdx, gDim, bDim;
inline thread_local Block* blk = nullptr;
inline std::atomic<int> faults{0};   // misaligned shared-memory addresses seen

inline Warp& warp() { return (*blk->warps)[tIdx.x / 32]; }
inline int lane() { return static_cast<int>(tIdx.x % 32); }
inline void check(bool ok) {
    if (!ok) faults.fetch_add(1);
}

// kernel<<<grid, block, smem, stream>>>(args...), 1-D blocks of whole
// warps: the block's threads are made once and walk the grid together,
// with a barrier between blocks and shared memory refilled with 0xFF for
// each when the kernel has any.
template <class K, class... A>
void launch(K kern, dim3 grid, dim3 block, size_t smem, cudaStream_t, A... args) {
    const int n = static_cast<int>(block.x);
    Block b(n);
    std::vector<unsigned char> mem(smem + 64, 0xFF);
    b.smem = mem.data() + (64 - reinterpret_cast<uintptr_t>(mem.data()) % 64) % 64;
    std::vector<Warp> warps((n + 31) / 32);
    b.warps = &warps;
    std::vector<std::thread> threads;
    for (int t = 0; t < n; ++t)
        threads.emplace_back([&, t] {
            tIdx = dim3(t);
            gDim = grid;
            bDim = block;
            blk = &b;
            for (unsigned bz = 0; bz < grid.z; ++bz)
                for (unsigned by = 0; by < grid.y; ++by)
                    for (unsigned bx = 0; bx < grid.x; ++bx) {
                        bIdx = dim3(bx, by, bz);
                        kern(args...);
                        if (smem == 0) continue;   // nothing a block leaves for the next
                        b.bar.arrive_and_wait();
                        if (t == 0) memset(b.smem, 0xFF, smem);
                        b.bar.arrive_and_wait();
                    }
        });
    for (auto& th : threads) th.join();
}

}  // namespace emu

extern "C" int emu_faults() { return emu::faults.exchange(0); }

#define threadIdx (emu::tIdx)
#define blockIdx (emu::bIdx)
#define gridDim (emu::gDim)
#define blockDim (emu::bDim)

inline void __syncthreads() { emu::blk->bar.arrive_and_wait(); }

inline size_t __cvta_generic_to_shared(const void* p) {
    return static_cast<size_t>(static_cast<const unsigned char*>(p) - emu::blk->smem);
}

inline float __shfl_xor_sync(unsigned, float v, int off) {
    auto& w = emu::warp();
    const int l = emu::lane();
    uint32_t u;
    memcpy(&u, &v, 4);
    w.slot[l][0] = u;
    w.bar.arrive_and_wait();
    const uint32_t r = static_cast<uint32_t>(w.slot[l ^ off][0]);
    w.bar.arrive_and_wait();
    float f;
    memcpy(&f, &r, 4);
    return f;
}
