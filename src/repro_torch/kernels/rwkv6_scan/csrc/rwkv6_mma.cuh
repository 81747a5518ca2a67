// rwkv6_mma.cuh — the tensor-core helpers of rwkv6_scan's bf16 backward
// (rwkv6_scan_bwd.cu): flash attention's warp-level cp.async, ldmatrix and
// mma.sync m16n8k16 helpers, the bf16 halves of a 32-bit register as f32,
// and the exact split of an f32 into three bf16 parts that lets an f32
// operand through the bf16 tensor cores: hi + mid + lo = x (each part the
// bf16 rounding of what the parts before it leave, 8 bits each, so the 24
// bits of an f32 mantissa are all kept), so that a product with a bf16
// operand, summed over the three parts in f32, is f32 arithmetic up to the
// order of the sums.
#pragma once

#include "../../flashattn/csrc/flashattn_mma.cuh"

namespace {

// The bf16 in the low / high half of a register as f32 (exact).
__device__ __forceinline__ float bf_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf_hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

struct Split3 {
    uint32_t h, m, l;                    // two bf16 each: the pair's hi, mid and lo parts
};

// (x0, x1) as three bf16 pairs, x0 in each low half (the lower column).
__device__ __forceinline__ Split3 split3(float x0, float x1) {
    const uint32_t h = pack_bf16(x0, x1);
    const float r0 = x0 - bf_lo(h), r1 = x1 - bf_hi(h);
    const uint32_t m = pack_bf16(r0, r1);
    return {h, m, pack_bf16(r0 - bf_lo(m), r1 - bf_hi(m))};
}

}  // namespace
