// flashattn_bwd.cu — the backward pass of flash attention (causal and
// sliding window, GQA) as CUDA kernels for Hopper (sm_90a): bf16 operands
// on the tensor cores, f32 operands on the FP32 pipes.
//
// It replaces no TPU kernel: the JAX package has no backward Pallas kernel
// and no custom_vjp, and trains through `jax.grad` of its blocked attention
// (src/repro/models/attention.py:42-130).  This computes that gradient for
// the forward kernels of flashattn_tc.cu and flashattn.cu, which write each
// row's log-sum-exp `lse` for it, so that the port's training path runs on
// a kernel of its own where the CUDA forward would otherwise refuse inputs
// that require grad.
//
// What bounds it on this card: the operations.  Per visible (query, key)
// pair the two kernels below do 7 * head_dim multiply-adds (S and dP in
// each, dV and dK in one, dQ in the other) on bytes each read many times.
// For bf16 those run on the tensor cores (989 TFLOP/s); the bound the
// callers state is 2.5 times the forward's products (S, dP, dV, dK, dQ
// once each), so this split design does 1.4 times the products of its
// bound, the price of recomputing S and dP in both kernels instead of
// summing dQ with atomics.  For f32 they run on the FP32 pipes
// (67 TFLOP/s): tensor-core TF32 would keep about three decimal digits.
//
// Three launches a call (Sq == Sk, the training path's only case):
//   1. rowdot: D = rowsum(dO * O) in f32, one warp a row;
//   2. dK/dV: one block per (batch, KV head, key tile).  The K and V tiles
//      stay in shared memory while the block walks the group's query
//      heads and, for each, the query tiles the mask admits (from the
//      diagonal on for causal, up to the window's reach).  Each tile
//      recomputes S^T = K Q^T and dP^T = V dO^T, P^T = exp(S^T * scale -
//      lse), dS^T = P^T * (dP^T - D), and adds P^T dO to dV and dS^T Q to
//      dK.  The group's heads are summed in the block, so dK and dV need
//      no atomics and are the same bits on every run;
//   3. dQ: one block per (batch, head, query tile), heaviest tiles first,
//      walking the key tiles of the forward's range: dS as above, then
//      dQ += dS K.  dQ and dK take the softmax scale at the end.
// The mask (causal, window, k < S, q < S) gives P = dS = 0 where the
// forward's mask gave -1e30.
//
// bf16 design (dkdv_tc_kernel, dq_tc_kernel): the warp-level tensor-core
// ops of the forward (flashattn_mma.cuh), eight warps a block, one block
// an SM.
//   * dK/dV: 128 keys a block, 16 a warp.  K and V stay bf16 in shared
//     memory and are read as mma A fragments (ldmatrix) at each query
//     tile; Q, dO, lse and D come 64 queries at a time through a ring of
//     two shared-memory stages, filled by cp.async (16-byte copies of the
//     rows, 4-byte ones of lse and D, whose rows need not be aligned).
//     One barrier a tile: past it the tile has landed and every warp is
//     done with the other stage, which is then refilled.  S^T and dP^T
//     take Q's and dO's B fragments by ldmatrix; P^T and dS^T are computed
//     in f32 registers on the C fragments, rounded to bf16 and repacked in
//     registers as the A fragments of dV += P^T dO and dK += dS^T Q, whose
//     B fragments come by ldmatrix.trans; dK and dV accumulate in f32
//     registers (head_dim of them a thread).  Key tiles are launched in
//     order, so under causal the tiles that see the most queries go first;
//   * dQ: 128 queries a block, 16 a warp, laid out as the forward: Q and
//     dO go once through shared memory into registers as A fragments, lse
//     and D of the lane's two rows stay in registers, and K and V stream
//     through the two-stage ring 64 keys at a time.  S = Q K^T and dP =
//     dO V^T by mma, dS in registers, then dQ += dS K with dS repacked as
//     A fragments and K's B fragments by ldmatrix.trans;
//   * a warp skips a tile in which none of its (query, key) pairs is
//     visible, and masks only tiles that cross the diagonal, the window's
//     edge or S.  Rows are padded to HD_PAD + 8 values, an odd number of
//     16-byte units, so ldmatrix is free of bank conflicts; the columns
//     hd..HD_PAD are zeroed once, rows past S are zero-filled by the
//     copies.
// f32 design (dkdv_kernel, dq_kernel): 64-key and 64-query tiles of 256
// threads, operands in f32 in shared memory, each thread a 4 x 4 micro-tile
// of S and dP and 4 rows x head_dim / 16 columns of its accumulators.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

#include "flashattn_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float LOG2E = 1.4426950408889634f;

struct Strides {
    long long b, h, s;                 // element strides; head_dim is contiguous
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

// ---------------------------------------------------------------------------
// rowdot: D = rowsum(dO * O), both dtypes
// ---------------------------------------------------------------------------

constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
rowdot_kernel(const T* __restrict__ dout, const T* __restrict__ out, Strides sdo, Strides so,
              float* __restrict__ D, int H, int S, int hd, long long rows) {
    const long long r = static_cast<long long>(blockIdx.x) * (THREADS / 32) + threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    if (r >= rows) return;                     // whole warps
    const int s = static_cast<int>(r % S);
    const long long bh = r / S;
    const int h = static_cast<int>(bh % H), b = static_cast<int>(bh / H);
    const T* a = dout + b * sdo.b + h * sdo.h + s * sdo.s;
    const T* o = out + b * so.b + h * so.h + s * so.s;
    float acc = 0.f;
    for (int d = lane; d < hd; d += 32) acc = fmaf(to_f(a[d]), to_f(o[d]), acc);
#pragma unroll
    for (int off = 16; off; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) D[r] = acc;
}

template <typename T>
int launch_rowdot(const void* dout, const void* out, const Strides& sdo, const Strides& so,
                  float* D, int B, int H, int S, int hd, cudaStream_t stream) {
    const long long rows = static_cast<long long>(B) * H * S;
    const long long blocks = (rows + THREADS / 32 - 1) / (THREADS / 32);
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
    rowdot_kernel<T><<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
        static_cast<const T*>(dout), static_cast<const T*>(out), sdo, so, D, H, S, hd, rows);
    return 0;
}

// Raises the kernel's dynamic shared memory limit to `smem`, once a device
// (one bit a device in `opted_in`).
template <typename K>
int opt_in(K kern, size_t smem, unsigned long long& opted_in) {
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
    return 0;
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int TC_WARPS = 8;
constexpr int TC_THREADS = 32 * TC_WARPS;
constexpr int STAGES = 2;              // Q/dO (dK/dV) and K/V (dQ) rings
constexpr int ROWS = 16 * TC_WARPS;    // keys (dK/dV) or queries (dQ) a block, 16 a warp
constexpr int BQ_TC = 64;              // queries a step of the dK/dV kernel
constexpr int BK_TC = 64;              // keys a step of the dQ kernel

template <int HD_PAD>
struct TcTile {
    static constexpr int LD = HD_PAD + 8;      // smem row stride (bf16): odd count of 16 B
    static constexpr int CH = HD_PAD / 8;      // 16-byte chunks in a row
    static constexpr int KS = HD_PAD / 16;     // k16 steps over head_dim; n16 pairs of it
    // dK/dV: K, V [ROWS][LD]; Q, dO [STAGES][BQ_TC][LD]; lse, D [STAGES][BQ_TC] f32
    static constexpr size_t DKDV_SMEM =
        static_cast<size_t>(2 * ROWS + 2 * STAGES * BQ_TC) * LD * sizeof(bf16) +
        2 * STAGES * BQ_TC * sizeof(float);
    // dQ: Q, dO [ROWS][LD]; K, V [STAGES][BK_TC][LD]
    static constexpr size_t DQ_SMEM =
        static_cast<size_t>(2 * ROWS + 2 * STAGES * BK_TC) * LD * sizeof(bf16);
};

// Rows start..start+NROWS-1 (those < limit; the rest zero-filled) of a
// (S, hd) slab with row stride `ld_g` into the NROWS x LD bf16 tile at
// shared byte address `dst`.  Columns hd..HD_PAD are left alone.
template <int HD_PAD, int NROWS>
__device__ __forceinline__ void tc_rows(uint32_t dst, const bf16* src, long long ld_g, int start,
                                        int limit, int hd, int tid) {
    using T = TcTile<HD_PAD>;
    constexpr int N = NROWS * T::CH;
#pragma unroll
    for (int it = 0; it < (N + TC_THREADS - 1) / TC_THREADS; ++it) {
        const int i = tid + it * TC_THREADS;
        const int r = i / T::CH, c = i % T::CH;
        if ((N % TC_THREADS == 0 || i < N) && c * 8 < hd) {
            const int s = start + r;
            const bool in = s < limit;
            cp_async16(dst + (r * T::LD + c * 8) * sizeof(bf16), in ? src + s * ld_g + c * 8 : src,
                       in);
        }
    }
}

// Values start..start+N-1 (zero at and past `limit`) of an f32 row into
// shared memory at byte address `dst`.
template <int N>
__device__ __forceinline__ void tc_floats(uint32_t dst, const float* src, int start, int limit,
                                          int tid) {
    for (int i = tid; i < N; i += TC_THREADS) {
        const bool in = start + i < limit;
        cp_async4(dst + i * sizeof(float), in ? src + start + i : src, in);
    }
}

// P (masked) and dS = P * (dP - D) of one C fragment element, in place:
// s holds the raw score on entry and P on exit, dp holds dP and then dS.
__device__ __forceinline__ void p_ds(float& s, float& dp, float scale_log2, float lse_log2,
                                     float d, bool ok) {
    const float p = ok ? ex2(fmaf(s, scale_log2, -lse_log2)) : 0.f;
    s = p;
    dp = p * (dp - d);
}

// The A fragment (16 x k16) of two adjacent n8 C tiles, rounded to bf16.
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], const float (&c0)[4], const float (&c1)[4]) {
    a[0] = pack_bf16(c0[0], c0[1]);
    a[1] = pack_bf16(c0[2], c0[3]);
    a[2] = pack_bf16(c1[0], c1[1]);
    a[3] = pack_bf16(c1[2], c1[3]);
}

template <int HD_PAD>
__global__ void __launch_bounds__(TC_THREADS, 1)
dkdv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
               const bf16* __restrict__ dout, const float* __restrict__ lse,
               const float* __restrict__ D, bf16* __restrict__ dk, bf16* __restrict__ dv,
               Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdk, Strides sdv, int B,
               int H, int KV, int S, int hd, int causal, int window, float scale,
               float scale_log2) {
    using T = TcTile<HD_PAD>;
    constexpr int LD = T::LD, KS = T::KS, BQ = BQ_TC, NT = BQ / 8;
    constexpr uint32_t E = sizeof(bf16);
    constexpr uint32_t STAGE_BYTES = BQ * LD * E, STAGE_F = BQ * sizeof(float);
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* Ks = reinterpret_cast<bf16*>(smem_raw);      // [ROWS][LD]
    bf16* Vs = Ks + ROWS * LD;                          // [ROWS][LD]
    bf16* Qs = Vs + ROWS * LD;                          // [STAGES][BQ][LD]
    bf16* dOs = Qs + STAGES * BQ * LD;                  // [STAGES][BQ][LD]
    float* lse_s = reinterpret_cast<float*>(dOs + STAGES * BQ * LD);   // [STAGES][BQ]
    float* D_s = lse_s + STAGES * BQ;                   // [STAGES][BQ]

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, tig = lane & 3;            // the mma fragments' row and column pair
    const int bkv = blockIdx.x % (B * KV);
    const int kvh = bkv % KV, b = bkv / KV;
    const int k0 = static_cast<int>(blockIdx.x / (B * KV)) * ROWS;
    const int G = H / KV;

    // The padding columns hd..HD_PAD (one 16-byte chunk) of every row.
    if (hd < HD_PAD)
        for (int r = tid; r < 2 * ROWS + 2 * STAGES * BQ; r += TC_THREADS)
            *reinterpret_cast<uint4*>(Ks + r * LD + hd) = make_uint4(0u, 0u, 0u, 0u);

    // The query tiles holding a row that sees some key of this block; the
    // block walks (head, query tile) pairs, head-major.
    const int k_last = min(k0 + ROWS, S) - 1;
    const int q_lo = causal ? k0 : 0;
    const int q_hi = window > 0 ? min(S, k_last + window) : S;
    const int qt_lo = q_lo / BQ, nq = (q_hi + BQ - 1) / BQ - qt_lo;
    const int steps = G * nq;

    const uint32_t ks = smem_u32(Ks), vs = smem_u32(Vs), qs = smem_u32(Qs), dos = smem_u32(dOs);
    const uint32_t ls = smem_u32(lse_s), dls = smem_u32(D_s);
    tc_rows<HD_PAD, ROWS>(ks, k + b * sk.b + kvh * sk.h, sk.s, k0, S, hd, tid);
    tc_rows<HD_PAD, ROWS>(vs, v + b * sv.b + kvh * sv.h, sv.s, k0, S, hd, tid);
    auto stage_in = [&](int i, int st) {              // step i's Q, dO, lse and D into stage st
        const int h = kvh * G + i / nq, q0 = (qt_lo + i % nq) * BQ;
        const long long row0 = (static_cast<long long>(b) * H + h) * S;
        tc_rows<HD_PAD, BQ>(qs + st * STAGE_BYTES, q + b * sq.b + h * sq.h, sq.s, q0, S, hd, tid);
        tc_rows<HD_PAD, BQ>(dos + st * STAGE_BYTES, dout + b * sdo.b + h * sdo.h, sdo.s, q0, S,
                            hd, tid);
        tc_floats<BQ>(ls + st * STAGE_F, lse + row0, q0, S, tid);
        tc_floats<BQ>(dls + st * STAGE_F, D + row0, q0, S, tid);
    };
    stage_in(0, 0);
    cp_async_commit();

    // Shared-memory byte offsets of this lane's ldmatrix rows.  K and V (A
    // of S^T and dP^T, x4): keys 16 * warp + lane % 16, columns 8 * (lane /
    // 16).  Q and dO (B of S^T and dP^T, x4 = two n8 query tiles x k16):
    // queries lane % 8 + 8 * (lane / 16), columns 8 * (lane / 8 % 2).  Q and
    // dO (B of dK and dV, x4.trans = k16 queries x two n8 column tiles):
    // queries lane % 8 + 8 * (lane / 8 % 2), columns 8 * (lane / 16).
    const uint32_t a_off = ((16 * warp + (lane & 15)) * LD + (lane >> 4) * 8) * E;
    const uint32_t b_off = (((lane & 7) + (lane >> 4) * 8) * LD + ((lane >> 3) & 1) * 8) * E;
    const uint32_t t_off = (((lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8) * E;
    const int kw = k0 + 16 * warp;                      // this warp's first key
    const int key0 = kw + g, key1 = key0 + 8;           // the keys of c0/c1 and c2/c3

    float dka[2 * KS][4], dva[2 * KS][4];
#pragma unroll
    for (int n = 0; n < 2 * KS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

    for (int i = 0; i < steps; ++i) {
        const int st = i & 1;
        cp_async_wait_all();                           // this step's tiles (and K, V) have landed ...
        __syncthreads();                               // ... for every warp, and all are done
        if (i + 1 < steps) {                           // with the other stage: refill it
            stage_in(i + 1, st ^ 1);
            cp_async_commit();
        }
        const int q0 = (qt_lo + i % nq) * BQ;
        if (kw >= S || (causal && q0 + BQ - 1 < kw) || (window > 0 && q0 - (kw + 15) >= window))
            continue;                                  // no visible pair for this warp
        const uint32_t qst = qs + st * STAGE_BYTES, dost = dos + st * STAGE_BYTES;

        // S^T = K Q^T and dP^T = V dO^T for the warp's 16 keys x 64 queries.
        float s[NT][4], dp[NT][4];
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
            uint32_t ka[4], va[4];
            ldsm_x4(ka, ks + a_off + kk * 16 * E);
            ldsm_x4(va, vs + a_off + kk * 16 * E);
#pragma unroll
            for (int np = 0; np < NT / 2; ++np) {
                uint32_t bq[4], bo[4];
                ldsm_x4(bq, qst + b_off + (np * 16 * LD + kk * 16) * E);
                mma(s[2 * np], ka, bq[0], bq[1]);
                mma(s[2 * np + 1], ka, bq[2], bq[3]);
                ldsm_x4(bo, dost + b_off + (np * 16 * LD + kk * 16) * E);
                mma(dp[2 * np], va, bo[0], bo[1]);
                mma(dp[2 * np + 1], va, bo[2], bo[3]);
            }
        }

        // P^T and dS^T in place; element e of n8 tile j is key e < 2 ? key0
        // : key1 and query q0 + 8 j + 2 tig + (e & 1).
        const bool edge = (causal && q0 < kw + 15) || (window > 0 && q0 + BQ - 1 - kw >= window) ||
                          q0 + BQ > S || kw + 16 > S;
        const float* lt = lse_s + st * BQ;
        const float* dt = D_s + st * BQ;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
            const int c = 8 * j + 2 * tig;
            const float2 l2 = *reinterpret_cast<const float2*>(lt + c);
            const float2 d2 = *reinterpret_cast<const float2*>(dt + c);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                bool ok = true;
                if (edge) {
                    const int qp = q0 + c + (e & 1), kp = e < 2 ? key0 : key1;
                    ok = qp < S && kp < S && (!causal || qp >= kp) &&
                         (window <= 0 || qp - kp < window);
                }
                p_ds(s[j][e], dp[j][e], scale_log2, (e & 1 ? l2.y : l2.x) * LOG2E,
                     e & 1 ? d2.y : d2.x, ok);
            }
        }

        // dV += bf16(P^T) dO and dK += bf16(dS^T) Q.
#pragma unroll
        for (int kk = 0; kk < NT / 2; ++kk) {
            uint32_t pa[4], da[4];
            a_frag(pa, s[2 * kk], s[2 * kk + 1]);
            a_frag(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
            for (int d = 0; d < KS; ++d) {
                uint32_t bo[4], bq[4];
                ldsm_x4_t(bo, dost + t_off + (kk * 16 * LD + d * 16) * E);
                mma(dva[2 * d], pa, bo[0], bo[1]);
                mma(dva[2 * d + 1], pa, bo[2], bo[3]);
                ldsm_x4_t(bq, qst + t_off + (kk * 16 * LD + d * 16) * E);
                mma(dka[2 * d], da, bq[0], bq[1]);
                mma(dka[2 * d + 1], da, bq[2], bq[3]);
            }
        }
    }
    cp_async_wait_all();                             // a warp that skipped every step

    bf16* dkb = dk + b * sdk.b + kvh * sdk.h;
    bf16* dvb = dv + b * sdv.b + kvh * sdv.h;
#pragma unroll
    for (int n = 0; n < 2 * KS; ++n) {
        const int col = 8 * n + 2 * tig;
        if (col < hd) {
            if (key0 < S) {
                *reinterpret_cast<__nv_bfloat162*>(dkb + key0 * sdk.s + col) =
                    __floats2bfloat162_rn(dka[n][0] * scale, dka[n][1] * scale);
                *reinterpret_cast<__nv_bfloat162*>(dvb + key0 * sdv.s + col) =
                    __floats2bfloat162_rn(dva[n][0], dva[n][1]);
            }
            if (key1 < S) {
                *reinterpret_cast<__nv_bfloat162*>(dkb + key1 * sdk.s + col) =
                    __floats2bfloat162_rn(dka[n][2] * scale, dka[n][3] * scale);
                *reinterpret_cast<__nv_bfloat162*>(dvb + key1 * sdv.s + col) =
                    __floats2bfloat162_rn(dva[n][2], dva[n][3]);
            }
        }
    }
}

template <int HD_PAD>
__global__ void __launch_bounds__(TC_THREADS, 1)
dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
             const bf16* __restrict__ dout, const float* __restrict__ lse,
             const float* __restrict__ D, bf16* __restrict__ dq, Strides sq, Strides sk,
             Strides sv, Strides sdo, Strides sdq, int B, int H, int KV, int S, int hd,
             int causal, int window, float scale, float scale_log2) {
    using T = TcTile<HD_PAD>;
    constexpr int LD = T::LD, KS = T::KS, BK = BK_TC, NT = BK / 8;
    constexpr uint32_t E = sizeof(bf16);
    constexpr uint32_t STAGE_BYTES = BK * LD * E;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* Qs = reinterpret_cast<bf16*>(smem_raw);      // [ROWS][LD]
    bf16* dOs = Qs + ROWS * LD;                         // [ROWS][LD]
    bf16* Ks = dOs + ROWS * LD;                         // [STAGES][BK][LD]
    bf16* Vs = Ks + STAGES * BK * LD;                   // [STAGES][BK][LD]

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, tig = lane & 3;
    const int bh = blockIdx.x % (B * H);
    const int h = bh % H, b = bh / H;
    const int nqt = (S + ROWS - 1) / ROWS;
    const int q_start = (nqt - 1 - static_cast<int>(blockIdx.x / (B * H))) * ROWS;  // heaviest first
    const int kvh = h / (H / KV);

    if (hd < HD_PAD)
        for (int r = tid; r < 2 * ROWS + 2 * STAGES * BK; r += TC_THREADS)
            *reinterpret_cast<uint4*>(Qs + r * LD + hd) = make_uint4(0u, 0u, 0u, 0u);

    // The key tiles holding a key that some row of this block may see.
    const int q_last = min(q_start + ROWS, S) - 1;
    int kt_lo = 0, kt_hi = (S + BK - 1) / BK;
    if (window > 0) kt_lo = max(0, q_start - window + 1) / BK;
    if (causal) kt_hi = min(kt_hi, q_last / BK + 1);

    const bf16* kb = k + b * sk.b + kvh * sk.h;
    const bf16* vb = v + b * sv.b + kvh * sv.h;
    const uint32_t qs = smem_u32(Qs), dos = smem_u32(dOs), ks = smem_u32(Ks), vs = smem_u32(Vs);
    tc_rows<HD_PAD, ROWS>(qs, q + b * sq.b + h * sq.h, sq.s, q_start, S, hd, tid);
    tc_rows<HD_PAD, ROWS>(dos, dout + b * sdo.b + h * sdo.h, sdo.s, q_start, S, hd, tid);
    if (kt_lo < kt_hi) {
        tc_rows<HD_PAD, BK>(ks, kb, sk.s, kt_lo * BK, S, hd, tid);
        tc_rows<HD_PAD, BK>(vs, vb, sv.s, kt_lo * BK, S, hd, tid);
    }
    cp_async_commit();

    // Q and dO (A, x4): rows 16 * warp + lane % 16, columns 8 * (lane /
    // 16).  K and V (B of S and dP, x4): keys lane % 8 + 8 * (lane / 16),
    // columns 8 * (lane / 8 % 2).  K (B of dQ, x4.trans): keys lane % 8 + 8
    // * (lane / 8 % 2), columns 8 * (lane / 16).
    const uint32_t a_off = ((16 * warp + (lane & 15)) * LD + (lane >> 4) * 8) * E;
    const uint32_t b_off = (((lane & 7) + (lane >> 4) * 8) * LD + ((lane >> 3) & 1) * 8) * E;
    const uint32_t t_off = (((lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8) * E;
    const int wq = q_start + 16 * warp;                // this warp's first row
    const int row0 = wq + g, row1 = row0 + 8;          // the rows of c0/c1 and c2/c3
    const long long base = (static_cast<long long>(b) * H + h) * S;
    const float l0 = row0 < S ? lse[base + row0] * LOG2E : 0.f;
    const float l1 = row1 < S ? lse[base + row1] * LOG2E : 0.f;
    const float d0 = row0 < S ? D[base + row0] : 0.f;
    const float d1 = row1 < S ? D[base + row1] : 0.f;
    uint32_t qa[KS][4], oa[KS][4];
    float dqa[2 * KS][4];
#pragma unroll
    for (int n = 0; n < 2 * KS; ++n) dqa[n][0] = dqa[n][1] = dqa[n][2] = dqa[n][3] = 0.f;

    for (int kt = kt_lo; kt < kt_hi; ++kt) {
        const int st = (kt - kt_lo) & 1;
        cp_async_wait_all();
        __syncthreads();
        if (kt + 1 < kt_hi) {
            tc_rows<HD_PAD, BK>(ks + (st ^ 1) * STAGE_BYTES, kb, sk.s, (kt + 1) * BK, S, hd, tid);
            tc_rows<HD_PAD, BK>(vs + (st ^ 1) * STAGE_BYTES, vb, sv.s, (kt + 1) * BK, S, hd, tid);
            cp_async_commit();
        }
        if (kt == kt_lo) {
#pragma unroll
            for (int kk = 0; kk < KS; ++kk) {
                ldsm_x4(qa[kk], qs + a_off + kk * 16 * E);
                ldsm_x4(oa[kk], dos + a_off + kk * 16 * E);
            }
        }
        const int k_start = kt * BK;
        if (wq >= S || (causal && k_start > wq + 15) ||
            (window > 0 && wq - (k_start + BK - 1) >= window))
            continue;                                  // no visible pair for this warp
        const uint32_t kst = ks + st * STAGE_BYTES, vst = vs + st * STAGE_BYTES;

        // S = Q K^T and dP = dO V^T for the warp's 16 rows x 64 keys.
        float s[NT][4], dp[NT][4];
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
            for (int np = 0; np < NT / 2; ++np) {
                uint32_t bk[4], bv[4];
                ldsm_x4(bk, kst + b_off + (np * 16 * LD + kk * 16) * E);
                mma(s[2 * np], qa[kk], bk[0], bk[1]);
                mma(s[2 * np + 1], qa[kk], bk[2], bk[3]);
                ldsm_x4(bv, vst + b_off + (np * 16 * LD + kk * 16) * E);
                mma(dp[2 * np], oa[kk], bv[0], bv[1]);
                mma(dp[2 * np + 1], oa[kk], bv[2], bv[3]);
            }
        }

        // P and dS in place; element e of n8 tile j is row e < 2 ? row0 :
        // row1 and key k_start + 8 j + 2 tig + (e & 1).
        const bool edge = k_start + BK > S || (causal && k_start + BK - 1 > wq) ||
                          (window > 0 && wq + 15 - k_start >= window);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                bool ok = true;
                if (edge) {
                    const int key = k_start + 8 * j + 2 * tig + (e & 1);
                    const int row = e < 2 ? row0 : row1;
                    ok = key < S && (!causal || row >= key) && (window <= 0 || row - key < window);
                }
                p_ds(s[j][e], dp[j][e], scale_log2, e < 2 ? l0 : l1, e < 2 ? d0 : d1, ok);
            }
        }

        // dQ += bf16(dS) K.
#pragma unroll
        for (int kk = 0; kk < NT / 2; ++kk) {
            uint32_t da[4];
            a_frag(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
            for (int d = 0; d < KS; ++d) {
                uint32_t bk[4];
                ldsm_x4_t(bk, kst + t_off + (kk * 16 * LD + d * 16) * E);
                mma(dqa[2 * d], da, bk[0], bk[1]);
                mma(dqa[2 * d + 1], da, bk[2], bk[3]);
            }
        }
    }
    cp_async_wait_all();                             // a block with no key tile loaded Q and dO

    bf16* dqb = dq + b * sdq.b + h * sdq.h;
#pragma unroll
    for (int n = 0; n < 2 * KS; ++n) {
        const int col = 8 * n + 2 * tig;
        if (col < hd) {
            if (row0 < S)
                *reinterpret_cast<__nv_bfloat162*>(dqb + row0 * sdq.s + col) =
                    __floats2bfloat162_rn(dqa[n][0] * scale, dqa[n][1] * scale);
            if (row1 < S)
                *reinterpret_cast<__nv_bfloat162*>(dqb + row1 * sdq.s + col) =
                    __floats2bfloat162_rn(dqa[n][2] * scale, dqa[n][3] * scale);
        }
    }
}

// st: q, k, v, out, dout, dq, dk, dv.
template <int HD_PAD>
int go_tc(const void* const* p, const Strides* st, int B, int H, int KV, int S, int hd,
          int causal, int window, float scale, cudaStream_t stream) {
    using T = TcTile<HD_PAD>;
    auto dkdv = dkdv_tc_kernel<HD_PAD>;
    auto dqk = dq_tc_kernel<HD_PAD>;
    static unsigned long long dkdv_in = 0, dq_in = 0;
    int err = opt_in(dkdv, T::DKDV_SMEM, dkdv_in);
    if (err == 0) err = opt_in(dqk, T::DQ_SMEM, dq_in);
    if (err != 0) return err;
    const long long nkt = (S + ROWS - 1) / ROWS;
    const long long dkdv_blocks = nkt * B * KV, dq_blocks = nkt * B * H;
    if (dq_blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
    const bf16* q = static_cast<const bf16*>(p[0]);
    const bf16* k = static_cast<const bf16*>(p[1]);
    const bf16* v = static_cast<const bf16*>(p[2]);
    const bf16* dout = static_cast<const bf16*>(p[4]);
    const float* lse = static_cast<const float*>(p[5]);
    float* D = static_cast<float*>(const_cast<void*>(p[6]));
    err = launch_rowdot<bf16>(dout, p[3], st[4], st[3], D, B, H, S, hd, stream);
    if (err != 0) return err;
    const float scale_log2 = scale * LOG2E;
    dkdv<<<static_cast<unsigned>(dkdv_blocks), TC_THREADS, T::DKDV_SMEM, stream>>>(
        q, k, v, dout, lse, D, static_cast<bf16*>(const_cast<void*>(p[8])),
        static_cast<bf16*>(const_cast<void*>(p[9])), st[0], st[1], st[2], st[4], st[6], st[7], B,
        H, KV, S, hd, causal, window, scale, scale_log2);
    dqk<<<static_cast<unsigned>(dq_blocks), TC_THREADS, T::DQ_SMEM, stream>>>(
        q, k, v, dout, lse, D, static_cast<bf16*>(const_cast<void*>(p[7])), st[0], st[1], st[2],
        st[4], st[5], B, H, KV, S, hd, causal, window, scale, scale_log2);
    return 0;
}

// ---------------------------------------------------------------------------
// f32 on the FP32 pipes
// ---------------------------------------------------------------------------

constexpr int TX = 16;                 // threads along keys (or columns)
constexpr int BQ = 64;                 // query rows per tile
constexpr int BK = 64;                 // keys per tile
constexpr int MI = BQ / (THREADS / TX);  // query rows a thread scores (4)
constexpr int MJ = BK / TX;            // keys a thread scores (4)
constexpr int PLD = BK + 1;            // row stride of the P and dS tiles

template <int HD_PAD>
struct Shape {
    static constexpr int LD = HD_PAD + 1;      // odd row stride (floats)
    static constexpr int NC = HD_PAD / TX;     // columns a thread accumulates
    static constexpr size_t DKDV_SMEM =
        (static_cast<size_t>(2 * BK + 2 * BQ) * LD + 2 * BQ * PLD + 2 * BQ) * sizeof(float);
    static constexpr size_t DQ_SMEM =
        (static_cast<size_t>(2 * BK + 2 * BQ) * LD + BQ * PLD + 2 * BQ) * sizeof(float);
};

// Rows start..start+R-1 (zero at and past `limit`) and columns 0..HD_PAD-1
// (zero past hd) of a (S, hd) slab with row stride ld_g.
template <int HD_PAD, int R>
__device__ __forceinline__ void load_tile(float* dst, const float* src, long long ld_g, int start,
                                          int limit, int hd) {
    constexpr int LD = Shape<HD_PAD>::LD;
    for (int i = threadIdx.x; i < R * HD_PAD; i += THREADS) {
        const int r = i / HD_PAD, d = i % HD_PAD;
        const int s = start + r;
        dst[r * LD + d] = (s < limit && d < hd) ? src[s * ld_g + d] : 0.f;
    }
}

__device__ __forceinline__ void load_rows(float* dst, const float* src, int start, int limit) {
    for (int i = threadIdx.x; i < BQ; i += THREADS) dst[i] = start + i < limit ? src[start + i] : 0.f;
}

// P and dS of this thread's 4 x 4 micro-tile: query rows q0 + ty + 16 i,
// keys k0 + tx + 16 j.
template <int HD_PAD>
__device__ __forceinline__ void scores(const float* Qs, const float* dOs, const float* Ks,
                                       const float* Vs, const float* lse_s, const float* D_s,
                                       int q0, int k0, int S, int causal, int window, float scale,
                                       float (&p)[MI][MJ], float (&ds)[MI][MJ]) {
    constexpr int LD = Shape<HD_PAD>::LD;
    const int ty = threadIdx.x / TX, tx = threadIdx.x % TX;
    float s[MI][MJ], dp[MI][MJ];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < MJ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD_PAD; ++d) {
        float qa[MI], oa[MI], kb[MJ], vb[MJ];
#pragma unroll
        for (int i = 0; i < MI; ++i) {
            qa[i] = Qs[(ty + 16 * i) * LD + d];
            oa[i] = dOs[(ty + 16 * i) * LD + d];
        }
#pragma unroll
        for (int j = 0; j < MJ; ++j) {
            kb[j] = Ks[(tx + TX * j) * LD + d];
            vb[j] = Vs[(tx + TX * j) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
            for (int j = 0; j < MJ; ++j) {
                s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
                dp[i][j] = fmaf(oa[i], vb[j], dp[i][j]);
            }
    }
#pragma unroll
    for (int i = 0; i < MI; ++i) {
        const int r = ty + 16 * i, qp = q0 + r;
#pragma unroll
        for (int j = 0; j < MJ; ++j) {
            const int kp = k0 + tx + TX * j;
            const bool ok = qp < S && kp < S && (!causal || kp <= qp) &&
                            (window <= 0 || qp - kp < window);
            const float pij = ok ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
            p[i][j] = pij;
            ds[i][j] = pij * (dp[i][j] - D_s[r]);
        }
    }
}

template <int HD_PAD>
__global__ void __launch_bounds__(THREADS)
dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
            const float* __restrict__ dout, const float* __restrict__ lse,
            const float* __restrict__ D, float* __restrict__ dk, float* __restrict__ dv,
            Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdk, Strides sdv, int H,
            int KV, int S, int hd, int causal, int window, float scale) {
    using Sh = Shape<HD_PAD>;
    constexpr int LD = Sh::LD, NC = Sh::NC;
    extern __shared__ float smem[];
    float* Ks = smem;                          // [BK][LD]
    float* Vs = Ks + BK * LD;                  // [BK][LD]
    float* Qs = Vs + BK * LD;                  // [BQ][LD]
    float* dOs = Qs + BQ * LD;                 // [BQ][LD]
    float* Ps = dOs + BQ * LD;                 // [BQ][PLD]
    float* dSs = Ps + BQ * PLD;                // [BQ][PLD]
    float* lse_s = dSs + BQ * PLD;             // [BQ]
    float* D_s = lse_s + BQ;                   // [BQ]

    const int ty = threadIdx.x / TX, tx = threadIdx.x % TX;
    const int k0 = blockIdx.x * BK, kvh = blockIdx.y, b = blockIdx.z;
    const int G = H / KV;
    load_tile<HD_PAD, BK>(Ks, k + b * sk.b + kvh * sk.h, sk.s, k0, S, hd);
    load_tile<HD_PAD, BK>(Vs, v + b * sv.b + kvh * sv.h, sv.s, k0, S, hd);

    // The query tiles holding a row that sees some key of this tile.
    const int k_last = min(k0 + BK, S) - 1;
    const int q_lo = causal ? k0 : 0;
    const int q_hi = window > 0 ? min(S, k_last + window) : S;
    const int qt_lo = q_lo / BQ, qt_hi = (q_hi + BQ - 1) / BQ;

    float acc_k[MJ][NC], acc_v[MJ][NC];
#pragma unroll
    for (int i = 0; i < MJ; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

    for (int g = 0; g < G; ++g) {
        const int h = kvh * G + g;
        const float* qb = q + b * sq.b + h * sq.h;
        const float* ob = dout + b * sdo.b + h * sdo.h;
        const long long row0 = (static_cast<long long>(b) * H + h) * S;
        for (int qt = qt_lo; qt < qt_hi; ++qt) {
            const int q0 = qt * BQ;
            __syncthreads();                   // K/V are in; the last tile's reads are done
            load_tile<HD_PAD, BQ>(Qs, qb, sq.s, q0, S, hd);
            load_tile<HD_PAD, BQ>(dOs, ob, sdo.s, q0, S, hd);
            load_rows(lse_s, lse + row0, q0, S);
            load_rows(D_s, D + row0, q0, S);
            __syncthreads();

            float p[MI][MJ], ds[MI][MJ];
            scores<HD_PAD>(Qs, dOs, Ks, Vs, lse_s, D_s, q0, k0, S, causal, window, scale, p, ds);
#pragma unroll
            for (int i = 0; i < MI; ++i)
#pragma unroll
                for (int j = 0; j < MJ; ++j) {
                    Ps[(ty + 16 * i) * PLD + tx + TX * j] = p[i][j];
                    dSs[(ty + 16 * i) * PLD + tx + TX * j] = ds[i][j];
                }
            __syncthreads();

            // dV += P^T dO and dK += dS^T Q for key rows ty + 16 i.
#pragma unroll 4
            for (int r = 0; r < BQ; ++r) {
                float pk[MJ], sk_[MJ], o[NC], qv[NC];
#pragma unroll
                for (int i = 0; i < MJ; ++i) {
                    pk[i] = Ps[r * PLD + ty + 16 * i];
                    sk_[i] = dSs[r * PLD + ty + 16 * i];
                }
#pragma unroll
                for (int c = 0; c < NC; ++c) {
                    o[c] = dOs[r * LD + tx + TX * c];
                    qv[c] = Qs[r * LD + tx + TX * c];
                }
#pragma unroll
                for (int i = 0; i < MJ; ++i)
#pragma unroll
                    for (int c = 0; c < NC; ++c) {
                        acc_v[i][c] = fmaf(pk[i], o[c], acc_v[i][c]);
                        acc_k[i][c] = fmaf(sk_[i], qv[c], acc_k[i][c]);
                    }
            }
        }
    }

    float* dkb = dk + b * sdk.b + kvh * sdk.h;
    float* dvb = dv + b * sdv.b + kvh * sdv.h;
#pragma unroll
    for (int i = 0; i < MJ; ++i) {
        const int key = k0 + ty + 16 * i;
        if (key >= S) continue;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
            const int col = tx + TX * c;
            if (col < hd) {
                dkb[key * sdk.s + col] = acc_k[i][c] * scale;
                dvb[key * sdv.s + col] = acc_v[i][c];
            }
        }
    }
}

template <int HD_PAD>
__global__ void __launch_bounds__(THREADS)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
          const float* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ D, float* __restrict__ dq, Strides sq, Strides sk, Strides sv,
          Strides sdo, Strides sdq, int H, int KV, int S, int hd, int causal, int window,
          float scale) {
    using Sh = Shape<HD_PAD>;
    constexpr int LD = Sh::LD, NC = Sh::NC;
    extern __shared__ float smem[];
    float* Qs = smem;                          // [BQ][LD]
    float* dOs = Qs + BQ * LD;                 // [BQ][LD]
    float* Ks = dOs + BQ * LD;                 // [BK][LD]
    float* Vs = Ks + BK * LD;                  // [BK][LD]
    float* dSs = Vs + BK * LD;                 // [BQ][PLD]
    float* lse_s = dSs + BQ * PLD;             // [BQ]
    float* D_s = lse_s + BQ;                   // [BQ]

    const int ty = threadIdx.x / TX, tx = threadIdx.x % TX;
    const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // heaviest tiles first
    const int h = blockIdx.y, b = blockIdx.z;
    const int kvh = h / (H / KV);
    const long long row0 = (static_cast<long long>(b) * H + h) * S;
    load_tile<HD_PAD, BQ>(Qs, q + b * sq.b + h * sq.h, sq.s, q0, S, hd);
    load_tile<HD_PAD, BQ>(dOs, dout + b * sdo.b + h * sdo.h, sdo.s, q0, S, hd);
    load_rows(lse_s, lse + row0, q0, S);
    load_rows(D_s, D + row0, q0, S);
    const float* kb = k + b * sk.b + kvh * sk.h;
    const float* vb = v + b * sv.b + kvh * sv.h;

    // The key tiles holding a key that some row of this tile may see.
    const int q_last = min(q0 + BQ, S) - 1;
    int kt_lo = 0, kt_hi = (S + BK - 1) / BK;
    if (window > 0) kt_lo = max(0, q0 - window + 1) / BK;
    if (causal) kt_hi = min(kt_hi, q_last / BK + 1);

    float acc[MI][NC];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;

    for (int kt = kt_lo; kt < kt_hi; ++kt) {
        const int k0 = kt * BK;
        __syncthreads();                       // Q is in; the last tile's reads are done
        load_tile<HD_PAD, BK>(Ks, kb, sk.s, k0, S, hd);
        load_tile<HD_PAD, BK>(Vs, vb, sv.s, k0, S, hd);
        __syncthreads();

        float p[MI][MJ], ds[MI][MJ];
        scores<HD_PAD>(Qs, dOs, Ks, Vs, lse_s, D_s, q0, k0, S, causal, window, scale, p, ds);
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
            for (int j = 0; j < MJ; ++j) dSs[(ty + 16 * i) * PLD + tx + TX * j] = ds[i][j];
        __syncthreads();

        // dQ += dS K for query rows ty + 16 i.
#pragma unroll 4
        for (int j = 0; j < BK; ++j) {
            float a[MI], kv[NC];
#pragma unroll
            for (int i = 0; i < MI; ++i) a[i] = dSs[(ty + 16 * i) * PLD + j];
#pragma unroll
            for (int c = 0; c < NC; ++c) kv[c] = Ks[j * LD + tx + TX * c];
#pragma unroll
            for (int i = 0; i < MI; ++i)
#pragma unroll
                for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(a[i], kv[c], acc[i][c]);
        }
    }

    float* dqb = dq + b * sdq.b + h * sdq.h;
#pragma unroll
    for (int i = 0; i < MI; ++i) {
        const int row = q0 + ty + 16 * i;
        if (row >= S) continue;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
            const int col = tx + TX * c;
            if (col < hd) dqb[row * sdq.s + col] = acc[i][c] * scale;
        }
    }
}

// st: q, k, v, out, dout, dq, dk, dv.
template <int HD_PAD>
int go_f32(const void* const* p, const Strides* st, int B, int H, int KV, int S, int hd,
           int causal, int window, float scale, cudaStream_t stream) {
    using Sh = Shape<HD_PAD>;
    auto dkdv = dkdv_kernel<HD_PAD>;
    auto dqk = dq_kernel<HD_PAD>;
    static unsigned long long dkdv_in = 0, dq_in = 0;
    int err = opt_in(dkdv, Sh::DKDV_SMEM, dkdv_in);
    if (err == 0) err = opt_in(dqk, Sh::DQ_SMEM, dq_in);
    if (err != 0) return err;
    const float* q = static_cast<const float*>(p[0]);
    const float* k = static_cast<const float*>(p[1]);
    const float* v = static_cast<const float*>(p[2]);
    const float* dout = static_cast<const float*>(p[4]);
    const float* lse = static_cast<const float*>(p[5]);
    float* D = static_cast<float*>(const_cast<void*>(p[6]));
    err = launch_rowdot<float>(dout, p[3], st[4], st[3], D, B, H, S, hd, stream);
    if (err != 0) return err;
    const int nt = (S + BK - 1) / BK;
    dkdv<<<dim3(nt, KV, B), THREADS, Sh::DKDV_SMEM, stream>>>(
        q, k, v, dout, lse, D, static_cast<float*>(const_cast<void*>(p[8])),
        static_cast<float*>(const_cast<void*>(p[9])), st[0], st[1], st[2], st[4], st[6], st[7], H,
        KV, S, hd, causal, window, scale);
    dqk<<<dim3(nt, H, B), THREADS, Sh::DQ_SMEM, stream>>>(
        q, k, v, dout, lse, D, static_cast<float*>(const_cast<void*>(p[7])), st[0], st[1], st[2],
        st[4], st[5], H, KV, S, hd, causal, window, scale);
    return 0;
}

void unpack(const long long* strides, Strides (&st)[8]) {
    for (int i = 0; i < 8; ++i)
        st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
}

}  // namespace

// Plain C interface for ctypes, two entries of one argument list: q, out,
// dout, dq (B, H, S, hd); k, v, dk, dv (B, KV, S, hd), each with its last
// dimension contiguous; `strides` holds the b, h, s element strides of q,
// k, v, out, dout, dq, dk and dv (24 values).  lse (B, H, S) f32 as the
// forward wrote it, D an f32 scratch of B * H * S values.  H % KV == 0,
// window <= 0 for none, scale = 1/sqrt of the true head_dim.  Each
// launches its three kernels on `stream` and returns the CUDA error
// (0 = launched); cudaErrorInvalidValue for operands it does not take.
//
// flash_attention_bwd_launch: f32 operands, hd <= 128.
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* out, const void* dout, const void* lse,
                                          void* D, void* dq, void* dk, void* dv,
                                          const long long* strides, int B, int H, int KV, int S,
                                          int hd, int causal, int window, float scale,
                                          void* stream) {
    if (hd < 1 || hd > 128 || KV < 1 || H % KV != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    Strides st[8];
    unpack(strides, st);
    const void* p[10] = {q, k, v, out, dout, lse, D, dq, dk, dv};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    int err = 0;
    if (B > 0 && H > 0 && S > 0) {
#define BWD_F32(P) go_f32<P>(p, st, B, H, KV, S, hd, causal, window, scale, s)
        switch ((hd + 15) / 16 * 16) {
            case 16: err = BWD_F32(16); break;
            case 32: err = BWD_F32(32); break;
            case 48: err = BWD_F32(48); break;
            case 64: err = BWD_F32(64); break;
            case 80: err = BWD_F32(80); break;
            case 96: err = BWD_F32(96); break;
            case 112: err = BWD_F32(112); break;
            default: err = BWD_F32(128); break;
        }
#undef BWD_F32
    }
    if (err != 0) return err;
    return static_cast<int>(cudaGetLastError());
}

// flash_attention_bwd_tc_launch: bf16 operands on the tensor cores; hd a
// multiple of 8 up to 128, `hd_pad` the instance the caller chose, which
// must be roundup(hd, 16); every pointer but lse's and D's 16-byte aligned
// and every stride a multiple of 8 (the 16-byte copies need it: the
// wrapper pads and copies operands that are not).
extern "C" int flash_attention_bwd_tc_launch(const void* q, const void* k, const void* v,
                                             const void* out, const void* dout, const void* lse,
                                             void* D, void* dq, void* dk, void* dv,
                                             const long long* strides, int B, int H, int KV,
                                             int S, int hd, int hd_pad, int causal, int window,
                                             float scale, void* stream) {
    const int invalid = static_cast<int>(cudaErrorInvalidValue);
    if (hd < 8 || hd > 128 || hd % 8 != 0 || KV < 1 || H % KV != 0) return invalid;
    if (hd_pad != (hd + 15) / 16 * 16) return invalid;
    for (const void* ptr : {q, k, v, out, dout, static_cast<const void*>(dq),
                            static_cast<const void*>(dk), static_cast<const void*>(dv)})
        if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return invalid;
    for (int i = 0; i < 24; ++i)
        if (strides[i] % 8 != 0) return invalid;
    Strides st[8];
    unpack(strides, st);
    const void* p[10] = {q, k, v, out, dout, lse, D, dq, dk, dv};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    int err = 0;
    if (B > 0 && H > 0 && S > 0) {
#define BWD_TC(P) go_tc<P>(p, st, B, H, KV, S, hd, causal, window, scale, s)
        switch (hd_pad) {
            case 16: err = BWD_TC(16); break;
            case 32: err = BWD_TC(32); break;
            case 48: err = BWD_TC(48); break;
            case 64: err = BWD_TC(64); break;
            case 80: err = BWD_TC(80); break;
            case 96: err = BWD_TC(96); break;
            case 112: err = BWD_TC(112); break;
            case 128: err = BWD_TC(128); break;
            default: return invalid;
        }
#undef BWD_TC
    }
    if (err != 0) return err;
    return static_cast<int>(cudaGetLastError());
}
