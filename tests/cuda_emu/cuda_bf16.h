// bf16 for the CPU emulation (see cuda_runtime.h): round to nearest even.
#pragma once
#include <cstdint>
#include <cstring>

struct __nv_bfloat16 {
    uint16_t x;
};
struct __nv_bfloat162 {
    __nv_bfloat16 x, y;
};

inline uint16_t emu_f2bf(float f) {
    uint32_t u;
    memcpy(&u, &f, 4);
    if ((u & 0x7fffffffu) > 0x7f800000u) return 0x7fc0;
    u += 0x7fffu + ((u >> 16) & 1u);
    return static_cast<uint16_t>(u >> 16);
}
inline float emu_bf2f(uint16_t h) {
    const uint32_t u = static_cast<uint32_t>(h) << 16;
    float f;
    memcpy(&f, &u, 4);
    return f;
}
inline float __bfloat162float(__nv_bfloat16 b) { return emu_bf2f(b.x); }
inline __nv_bfloat16 __float2bfloat16(float f) { return {emu_f2bf(f)}; }
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) {
    return {{emu_f2bf(a)}, {emu_f2bf(b)}};
}
