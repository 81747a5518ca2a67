// The helpers of csrc/flashattn_mma.cuh for the CPU emulation (see
// cuda_runtime.h): copies are synchronous, ldmatrix and mma.sync gather
// their operands from the warp's 32 lanes by the fragment layouts of the
// PTX ISA (m8n8 .b16 matrices; m16n8k16 bf16 A, B and C fragments).
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

inline uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

inline void cp_async16(uint32_t dst, const void* src, bool in) {
    emu::check(dst % 16 == 0);
    unsigned char* d = emu::blk->smem + dst;
    if (in)
        memcpy(d, src, 16);
    else
        memset(d, 0, 16);
}
inline void cp_async4(uint32_t dst, const void* src, bool in) {
    emu::check(dst % 4 == 0);
    unsigned char* d = emu::blk->smem + dst;
    if (in)
        memcpy(d, src, 4);
    else
        memset(d, 0, 4);
}
inline void cp_async_commit() {}
inline void cp_async_wait_all() {}

inline const uint16_t* emu_row(uint64_t addr) {
    return reinterpret_cast<const uint16_t*>(emu::blk->smem + addr);
}

// Matrix i of an x4 takes its 8 row addresses from lanes 8 i .. 8 i + 7;
// lane l receives row l / 4, columns 2 (l % 4) and 2 (l % 4) + 1 (plain),
// or rows 2 (l % 4) and 2 (l % 4) + 1 of column l / 4 (.trans).
inline void ldsm(uint32_t (&r)[4], uint32_t addr, bool trans) {
    auto& w = emu::warp();
    const int l = emu::lane();
    emu::check(addr % 16 == 0);
    w.slot[l][0] = addr;
    w.bar.arrive_and_wait();
    for (int i = 0; i < 4; ++i) {
        if (trans) {
            const uint16_t lo = emu_row(w.slot[8 * i + 2 * (l % 4)][0])[l / 4];
            const uint16_t hi = emu_row(w.slot[8 * i + 2 * (l % 4) + 1][0])[l / 4];
            r[i] = lo | (static_cast<uint32_t>(hi) << 16);
        } else {
            const uint16_t* row = emu_row(w.slot[8 * i + l / 4][0]);
            r[i] = row[2 * (l % 4)] | (static_cast<uint32_t>(row[2 * (l % 4) + 1]) << 16);
        }
    }
    w.bar.arrive_and_wait();
}
inline void ldsm_x4(uint32_t (&r)[4], uint32_t addr) { ldsm(r, addr, false); }
inline void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) { ldsm(r, addr, true); }

inline float emu_half(uint64_t reg, int k) {
    return emu_bf2f(static_cast<uint16_t>(k % 2 ? (reg >> 16) & 0xffff : reg & 0xffff));
}

// d += a * b: A (16 x 16) element (r, k) is in register (k >= 8) * 2 + (r
// >= 8) of lane (r % 8) * 4 + (k % 8) / 2; B (16 x 8) element (k, c) in
// register k >= 8 of lane c * 4 + (k % 8) / 2; lane l holds C elements
// (l / 4 + 8 (e >= 2), 2 (l % 4) + e % 2).
inline void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
    auto& w = emu::warp();
    const int l = emu::lane();
    for (int i = 0; i < 4; ++i) w.slot[l][i] = a[i];
    w.slot[l][4] = b0;
    w.slot[l][5] = b1;
    w.bar.arrive_and_wait();
    float out[4];
    for (int e = 0; e < 4; ++e) {
        const int r = l / 4 + (e >= 2 ? 8 : 0), c = 2 * (l % 4) + (e & 1);
        float acc = d[e];
        for (int k = 0; k < 16; ++k)
            acc += emu_half(w.slot[(r % 8) * 4 + (k % 8) / 2][(k >= 8) * 2 + (r >= 8)], k) *
                   emu_half(w.slot[c * 4 + (k % 8) / 2][4 + (k >= 8)], k);
        out[e] = acc;
    }
    w.bar.arrive_and_wait();
    for (int e = 0; e < 4; ++e) d[e] = out[e];
}

inline float ex2(float x) { return exp2f(x); }

inline uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    uint32_t u;
    memcpy(&u, &v, 4);
    return u;
}

}  // namespace
