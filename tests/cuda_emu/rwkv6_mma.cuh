// The helpers of csrc/rwkv6_mma.cuh (rwkv6_scan's bf16 backward) for the
// CPU emulation: flash attention's emulated cp.async, ldmatrix and mma.sync
// (flashattn_mma.cuh of this directory), and the same bf16 unpacking and
// three-way split, bit for bit (the split is f32 subtraction and
// round-to-nearest-even bf16 conversion, as on the card).
#pragma once
#include "flashattn_mma.cuh"

namespace {

inline float emu_u2f(uint32_t u) {
    float f;
    memcpy(&f, &u, 4);
    return f;
}
inline float bf_lo(uint32_t u) { return emu_u2f(u << 16); }
inline float bf_hi(uint32_t u) { return emu_u2f(u & 0xffff0000u); }

struct Split3 {
    uint32_t h, m, l;
};

inline Split3 split3(float x0, float x1) {
    const uint32_t h = pack_bf16(x0, x1);
    const float r0 = x0 - bf_lo(h), r1 = x1 - bf_hi(h);
    const uint32_t m = pack_bf16(r0, r1);
    return {h, m, pack_bf16(r0 - bf_lo(m), r1 - bf_hi(m))};
}

}  // namespace
