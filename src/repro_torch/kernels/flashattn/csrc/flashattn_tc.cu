// flashattn_tc.cu — forward flash attention (causal and sliding window,
// GQA) in bf16 on Hopper's tensor cores (sm_90a).  It replaces the TPU
// kernel `flash_attention` of the JAX package
// (src/repro/kernels/flashattn/flashattn.py:97, pl.pallas_call at :117) for
// bf16 inputs; f32 inputs keep the FP32-pipe kernel of flashattn.cu.
//
// What bounds it on this card: the operations.  At the prefill's shapes
// (S = 8192, head_dim 80, a 4096-key window) every q/k/v byte meets
// thousands of multiply-adds, so the time of the bytes is far below that of
// the arithmetic; the tensor cores' 989 TFLOP/s in bf16 are the bound.
//
// Design (the FlashAttention-2 forward on warp-level tensor-core ops, whose
// helpers it shares with the backward through flashattn_mma.cuh):
//   * one block of 8 warps per (batch, head, 128-query tile), 16 rows a
//     warp: each K/V tile brought into shared memory serves 128 rows.  Two
//     blocks share an SM (<= 128 registers a thread at HD_PAD <= 80; ptxas
//     spills a few bytes there, and without the cap, one block an SM, the
//     kernel ran slower).  The query tiles are launched heaviest
//     first (the last tiles of a causal sequence see the most keys), the
//     heads of one KV group side by side so their K/V tiles meet in L2;
//   * the query tile goes once through shared memory into registers as
//     mma A fragments (ldmatrix.x4) and stays there for the key loop;
//   * K and V tiles of 64 keys stay bf16 in a ring of two shared-memory
//     stages, filled by 16-byte cp.async.cg copies.  One barrier a tile:
//     past it the tile has landed for every warp and every warp is done
//     with the other stage, so the next tile is issued into it there and
//     is in flight while this one is computed.  Rows are padded to HD_PAD + 8
//     values, an odd number of 16-byte units, so ldmatrix is free of bank
//     conflicts; the padding columns hd..HD_PAD are zeroed once, and rows
//     past Sq or Sk are zero-filled by the copies;
//   * S = Q K^T with mma.sync.m16n8k16 (bf16 x bf16 -> f32), K's B
//     fragments by ldmatrix;
//   * the online softmax runs in f32 on the C fragments in registers: the
//     row max and sum across the four lanes of a quad by shuffles,
//     scale * log2(e) folded into one multiply before ex2.  Masks (causal,
//     window, k_pos < Sk, the reference's -1e30) are applied only on tiles
//     that cross the diagonal, the window's edge or Sk; tiles wholly
//     outside the window or past the causal frontier are never visited;
//   * P V: the f32 C fragments of P are rounded to bf16 (the reference's
//     p.astype(v.dtype)) and repacked in registers as A fragments, with no
//     trip through shared memory; the row sum l adds the unrounded f32 p,
//     as the reference does.  V's B fragments come by ldmatrix.trans, and
//     O accumulates in f32 registers;
//   * the epilogue divides by max(l, 1e-30), rounds to bf16 and writes
//     through the caller's strides.  The training path's forward (the
//     caller passes `lse`) runs a second instance of each HD_PAD, LSE =
//     true, which also writes each row's log-sum-exp of its scaled scores,
//     (m + log2 l) ln 2, for the backward of flashattn_bwd.cu.  The serve
//     path's instance (LSE = false) has no such code: compiled into the
//     one kernel, the epilogue's few extra registers made ptxas spill more
//     at HD_PAD 80 and the serve forward ran 15% slower there.
// As in the reference, a row whose first visited tile holds no key it may
// see takes p = 1 on every masked key there and washes that out at its
// next tile (alpha = exp(-1e30 - m) = 0); a row that sees no key at all
// (it cannot occur in causal self-attention) gets an unspecified value.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

#include "flashattn_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int BQ = 16 * WARPS;         // query rows per block, 16 per warp
constexpr int BKV = 64;                // keys per tile
constexpr int NT = BKV / 8;            // n8 tiles of S per key tile
constexpr int STAGES = 2;              // K/V ring
constexpr float NEG_INF = -1e30f;      // the reference's mask value
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct Strides {
    long long b, h, s;                 // element strides; head_dim is contiguous
};

template <int HD_PAD>
struct Tile {
    static constexpr int LD = HD_PAD + 8;      // smem row stride (bf16): odd count of 16 B
    static constexpr int CH = HD_PAD / 8;      // 16-byte chunks in a row
    static constexpr int KS = HD_PAD / 16;     // k16 steps of Q K^T; n16 pairs of O
    static constexpr int ROWS = BQ + 2 * STAGES * BKV;
    static constexpr size_t SMEM = static_cast<size_t>(ROWS) * LD * sizeof(bf16);
};

// Rows start..start+NROWS-1 (those < limit; the rest zero-filled) of a
// (S, hd) slab with row stride `ld_g` into the NROWS x LD bf16 tile at
// shared byte address `dst`.  Columns hd..HD_PAD are left alone.
template <int HD_PAD, int NROWS>
__device__ __forceinline__ void load_rows(uint32_t dst, const bf16* src, long long ld_g, int start,
                                          int limit, int hd, int tid) {
    using T = Tile<HD_PAD>;
#pragma unroll
    for (int it = 0; it < (NROWS * T::CH + THREADS - 1) / THREADS; ++it) {
        const int i = tid + it * THREADS;
        const int r = i / T::CH, c = i % T::CH;
        if ((NROWS * T::CH % THREADS == 0 || i < NROWS * T::CH) && c * 8 < hd) {
            const int s = start + r;
            const bool in = s < limit;
            cp_async16(dst + (r * T::LD + c * 8) * sizeof(bf16), in ? src + s * ld_g + c * 8 : src, in);
        }
    }
}

// Each row's log-sum-exp of its scaled scores, (m + log2 l) ln 2, by the
// quad's first lane.
__device__ __forceinline__ void write_lse(float* lse, int b, int h, int H, int Sq, int row0,
                                          int row1, int tig, float m0, float m1, float lc0,
                                          float lc1) {
    if (tig == 0) {
        float* lb = lse + (static_cast<long long>(b) * H + h) * Sq;
        if (row0 < Sq) lb[row0] = (m0 + log2f(lc0)) * LN2;
        if (row1 < Sq) lb[row1] = (m1 + log2f(lc1)) * LN2;
    }
}

// Where the LSE instance writes lse: after the O store, when O's registers
// are free, at HD_PAD 80 (before it ptxas spilled 88 B there against the
// serve instance's 12 B, and the forward ran 1.16x the serve one's time);
// before it at HD_PAD 64 and below, where the other order spilled more
// and ran slower (measured with scripts/flash_fwd_lse_check.py).
template <int HD_PAD>
constexpr bool LSE_AFTER_O = HD_PAD > 64;

template <int HD_PAD, bool LSE>
__global__ void __launch_bounds__(THREADS, HD_PAD <= 80 ? 2 : 1)
flash_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ out, float* __restrict__ lse,
                Strides sq, Strides sk, Strides sv, Strides so, int B, int H, int KV, int Sq, int Sk,
                int hd, int causal, int window, float scale_log2) {
    using T = Tile<HD_PAD>;
    constexpr int LD = T::LD, KS = T::KS;
    constexpr uint32_t STAGE_BYTES = BKV * LD * sizeof(bf16);
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* Qs = reinterpret_cast<bf16*>(smem_raw);     // [BQ][LD]
    bf16* Ks = Qs + BQ * LD;                           // [STAGES][BKV][LD]
    bf16* Vs = Ks + STAGES * BKV * LD;                 // [STAGES][BKV][LD]

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, tig = lane & 3;           // the mma fragments' row and column pair
    const int bh = blockIdx.x % (B * H);
    const int h = bh % H, b = bh / H;
    const int nq = (Sq + BQ - 1) / BQ;
    const int q_start = (nq - 1 - static_cast<int>(blockIdx.x / (B * H))) * BQ;
    const int kvh = h / (H / KV);

    const bf16* qb = q + b * sq.b + h * sq.h;
    const bf16* kb = k + b * sk.b + kvh * sk.h;
    const bf16* vb = v + b * sv.b + kvh * sv.h;

    // The padding columns hd..HD_PAD (hd is a multiple of 8, so one 16-byte
    // chunk) of every row of Q, K and V; no copy ever writes them.
    if (hd < HD_PAD)
        for (int r = tid; r < T::ROWS; r += THREADS)
            *reinterpret_cast<uint4*>(Qs + r * LD + hd) = make_uint4(0u, 0u, 0u, 0u);

    // The key tiles holding a key that some row of this block may see.
    const int q_last = min(q_start + BQ, Sq) - 1;
    int kt_lo = 0, kt_hi = (Sk + BKV - 1) / BKV;
    if (window > 0) kt_lo = max(0, q_start - window + 1) / BKV;
    if (causal) kt_hi = min(kt_hi, q_last / BKV + 1);

    const uint32_t qs = smem_u32(Qs), ks = smem_u32(Ks), vs = smem_u32(Vs);
    load_rows<HD_PAD, BQ>(qs, qb, sq.s, q_start, Sq, hd, tid);
    if (kt_lo < kt_hi) {
        load_rows<HD_PAD, BKV>(ks, kb, sk.s, kt_lo * BKV, Sk, hd, tid);
        load_rows<HD_PAD, BKV>(vs, vb, sv.s, kt_lo * BKV, Sk, hd, tid);
    }
    cp_async_commit();

    // Shared-memory byte addresses of this lane's ldmatrix rows; each
    // fragment below adds a constant.  Q (A, x4): rows lane % 16, columns
    // 8 * (lane / 16).  K (B of S, x4 = two n8 key tiles x k16): keys
    // lane % 8 + 8 * (lane / 16), columns 8 * (lane / 8 % 2).  V (B of O,
    // x4.trans = k16 keys x two n8 column tiles): keys lane % 8 + 8 *
    // (lane / 8 % 2), columns 8 * (lane / 16).
    constexpr uint32_t E = sizeof(bf16);
    const uint32_t q_lane = qs + ((16 * warp + (lane & 15)) * LD + (lane >> 4) * 8) * E;
    const uint32_t k_lane = ks + (((lane & 7) + (lane >> 4) * 8) * LD + ((lane >> 3) & 1) * 8) * E;
    const uint32_t v_lane = vs + (((lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8) * E;
    const int wq = q_start + 16 * warp;                // this warp's first row
    const int row0 = wq + g, row1 = row0 + 8;          // the rows of c0/c1 and c2/c3
    uint32_t qa[KS][4];
    float o[2 * KS][4];
#pragma unroll
    for (int n = 0; n < 2 * KS; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
    float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;   // per row; l per lane until the end

    for (int kt = kt_lo; kt < kt_hi; ++kt) {
        const int stage = (kt - kt_lo) & 1;
        cp_async_wait_all();                         // this tile (and Q) has landed ...
        __syncthreads();                               // ... for every warp, and all are done
        if (kt + 1 < kt_hi) {                          // with the other stage: refill it
            const int nxt = stage ^ 1;
            load_rows<HD_PAD, BKV>(ks + nxt * STAGE_BYTES, kb, sk.s, (kt + 1) * BKV, Sk, hd, tid);
            load_rows<HD_PAD, BKV>(vs + nxt * STAGE_BYTES, vb, sv.s, (kt + 1) * BKV, Sk, hd, tid);
            cp_async_commit();
        }
        if (kt == kt_lo) {
#pragma unroll
            for (int kk = 0; kk < KS; ++kk) ldsm_x4(qa[kk], q_lane + kk * 16 * E);
        }
        const uint32_t kl = k_lane + stage * STAGE_BYTES, vl = v_lane + stage * STAGE_BYTES;

        // S = Q K^T for the warp's 16 rows x 64 keys.
        float s[NT][4];
#pragma unroll
        for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
            for (int np = 0; np < NT / 2; ++np) {
                uint32_t bk[4];
                ldsm_x4(bk, kl + (np * 16 * LD + kk * 16) * E);
                mma(s[2 * np], qa[kk], bk[0], bk[1]);
                mma(s[2 * np + 1], qa[kk], bk[2], bk[3]);
            }
        }

        // Online softmax in the log2 domain.
        const int k_start = kt * BKV;
        const bool edge = k_start + BKV > Sk || (causal && k_start + BKV - 1 > wq) ||
                          (window > 0 && wq + 15 - k_start >= window);
        float mx0 = m0, mx1 = m1;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                float x = s[j][e] * scale_log2;
                if (edge) {
                    const int key = k_start + 8 * j + 2 * tig + (e & 1);
                    const int row = e < 2 ? row0 : row1;
                    const bool ok = key < Sk && (!causal || row >= key) &&
                                    (window <= 0 || row - key < window);
                    x = ok ? x : NEG_INF;
                }
                s[j][e] = x;
            }
            mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
            mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
        }
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
        const float alpha0 = ex2(m0 - mx0), alpha1 = ex2(m1 - mx1);
        m0 = mx0;
        m1 = mx1;
        float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
            s[j][0] = ex2(s[j][0] - m0);
            s[j][1] = ex2(s[j][1] - m0);
            s[j][2] = ex2(s[j][2] - m1);
            s[j][3] = ex2(s[j][3] - m1);
            rs0 += s[j][0] + s[j][1];
            rs1 += s[j][2] + s[j][3];
        }
        l0 = l0 * alpha0 + rs0;
        l1 = l1 * alpha1 + rs1;
#pragma unroll
        for (int n = 0; n < 2 * KS; ++n) {
            o[n][0] *= alpha0;
            o[n][1] *= alpha0;
            o[n][2] *= alpha1;
            o[n][3] *= alpha1;
        }

        // O += bf16(P) V: two adjacent n8 C tiles of P are one k16 A fragment.
#pragma unroll
        for (int kk = 0; kk < NT / 2; ++kk) {
            const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                    pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                    pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                    pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
            for (int dp = 0; dp < KS; ++dp) {
                uint32_t bv[4];
                ldsm_x4_t(bv, vl + (kk * 16 * LD + dp * 16) * E);
                mma(o[2 * dp], pa, bv[0], bv[1]);
                mma(o[2 * dp + 1], pa, bv[2], bv[3]);
            }
        }
    }
    cp_async_wait_all();                             // a block with no key tile loaded Q

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float lc0 = fmaxf(l0, 1e-30f), lc1 = fmaxf(l1, 1e-30f);
    if constexpr (LSE && !LSE_AFTER_O<HD_PAD>)
        write_lse(lse, b, h, H, Sq, row0, row1, tig, m0, m1, lc0, lc1);
    bf16* ob = out + b * so.b + h * so.h;
#pragma unroll
    for (int n = 0; n < 2 * KS; ++n) {
        const int col = 8 * n + 2 * tig;
        if (col < hd) {
            if (row0 < Sq)
                *reinterpret_cast<__nv_bfloat162*>(ob + row0 * so.s + col) =
                    __floats2bfloat162_rn(o[n][0] / lc0, o[n][1] / lc0);
            if (row1 < Sq)
                *reinterpret_cast<__nv_bfloat162*>(ob + row1 * so.s + col) =
                    __floats2bfloat162_rn(o[n][2] / lc1, o[n][3] / lc1);
        }
    }
    if constexpr (LSE && LSE_AFTER_O<HD_PAD>)
        write_lse(lse, b, h, H, Sq, row0, row1, tig, m0, m1, lc0, lc1);
}

template <int HD_PAD, bool LSE>
int go(const void* q, const void* k, const void* v, void* out, float* lse, const Strides* st,
       int B, int H, int KV, int Sq, int Sk, int hd, int causal, int window, float scale_log2,
       cudaStream_t stream) {
    auto kern = flash_tc_kernel<HD_PAD, LSE>;
    constexpr size_t smem = Tile<HD_PAD>::SMEM;
    static unsigned long long opted_in = 0;        // one bit a device, once per instance
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
    if (!(opted_in >> dev & 1ULL)) {
        e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
        if (e == cudaSuccess)
            e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                                     cudaSharedmemCarveoutMaxShared);
        if (e != cudaSuccess) return static_cast<int>(e);
        opted_in |= 1ULL << dev;
    }
    const long long blocks = static_cast<long long>((Sq + BQ - 1) / BQ) * B * H;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
    kern<<<static_cast<unsigned>(blocks), THREADS, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<bf16*>(out), lse, st[0], st[1], st[2], st[3], B, H, KV, Sq, Sk, hd, causal,
        window, scale_log2);
    return 0;
}

}  // namespace

// Plain C interface for ctypes.  bf16 q (B, H, Sq, hd), k and v (B, KV, Sk,
// hd), out like q, each with its last dimension contiguous; `strides` holds
// the b, h, s element strides of q, k, v and out (12 values).  hd a
// multiple of 8 up to 128, every pointer 16-byte aligned and every stride
// a multiple of 8 (the 16-byte copies need it: the wrapper pads and copies
// operands that are not); `hd_pad` the instance the caller chose, which
// must be roundup(hd, 16); H % KV == 0; window <= 0 for none; `scale` is
// 1/sqrt of the true head_dim; `lse`, when not NULL, receives each row's
// log-sum-exp (B, H, Sq) f32.  Launches on `stream` and returns the CUDA
// error (0 = launched); cudaErrorInvalidValue for operands it does not take.
extern "C" int flash_attention_tc_launch(const void* q, const void* k, const void* v, void* out,
                                         void* lse, const long long* strides, int B, int H,
                                         int KV, int Sq, int Sk, int hd, int hd_pad, int causal,
                                         int window, float scale, void* stream) {
    const int invalid = static_cast<int>(cudaErrorInvalidValue);
    if (hd < 8 || hd > 128 || hd % 8 != 0 || KV < 1 || H % KV != 0) return invalid;
    if (hd_pad != (hd + 15) / 16 * 16) return invalid;
    for (const void* p : {q, k, v, static_cast<const void*>(out)})
        if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return invalid;
    for (int i = 0; i < 12; ++i)
        if (strides[i] % 8 != 0) return invalid;
    Strides st[4];
    for (int i = 0; i < 4; ++i) st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    int err = 0;
    if (B > 0 && H > 0 && Sq > 0) {
        const float c = scale * LOG2E;
#define FLASH_TC_GO(P)                                                                      \
    (lse != nullptr ? go<P, true>(q, k, v, out, static_cast<float*>(lse), st, B, H, KV, Sq, Sk, \
                                  hd, causal, window, c, s)                                     \
                    : go<P, false>(q, k, v, out, nullptr, st, B, H, KV, Sq, Sk, hd, causal,    \
                                   window, c, s))
        switch (hd_pad) {
            case 16: err = FLASH_TC_GO(16); break;
            case 32: err = FLASH_TC_GO(32); break;
            case 48: err = FLASH_TC_GO(48); break;
            case 64: err = FLASH_TC_GO(64); break;
            case 80: err = FLASH_TC_GO(80); break;
            case 96: err = FLASH_TC_GO(96); break;
            case 112: err = FLASH_TC_GO(112); break;
            case 128: err = FLASH_TC_GO(128); break;
            default: return invalid;
        }
#undef FLASH_TC_GO
    }
    if (err != 0) return err;
    return static_cast<int>(cudaGetLastError());
}
