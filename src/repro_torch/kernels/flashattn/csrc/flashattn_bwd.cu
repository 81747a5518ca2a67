// flashattn_bwd.cu — the backward pass of flash attention (causal and
// sliding window, GQA) as CUDA kernels for Hopper (sm_90a), in float32
// arithmetic for bf16 or f32 operands.
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
// pair it does 7 * head_dim multiply-adds (S and dP in both kernels below,
// dV and dK in one, dQ in the other) on every byte it reads many times; in
// this first design they run on the FP32 pipes (67 TFLOP/s), not on the
// tensor cores.
//
// Design, three launches (Sq == Sk, the training path's only case):
//   1. rowdot: D = rowsum(dO * O) in f32, one warp a row;
//   2. dkdv: one block of 256 threads per (batch, KV head, 64-key tile).
//      The K and V tiles stay in shared memory while the block walks the
//      group's query heads and, for each, the 64-query tiles the mask
//      admits (from the diagonal on for causal, up to the window's reach).
//      Each tile recomputes S = Q K^T and dP = dO V^T (each thread a 4 x 4
//      micro-tile of both), P = exp(S * scale - lse), dS = P * (dP - D),
//      and adds P^T dO to dV and dS^T Q to dK in f32 registers (each thread
//      4 key rows x head_dim / 16 columns).  The group's heads are summed
//      in the block, so dK and dV need no atomics and are deterministic;
//   3. dq: one block per (batch, head, 64-query tile), heaviest tiles
//      first, walking the key tiles of the forward's range: dS as above,
//      then dQ += dS K.  dQ and dK take the softmax scale at the end.
// Operands are read through the caller's strides (head_dim contiguous) and
// converted to f32 in shared memory, rows padded to an odd stride; rows
// past S and columns past head_dim are zero, and the mask (causal,
// window, k < S) gives P = dS = 0 where the forward's mask gave -1e30.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;
constexpr int TX = 16;                 // threads along keys (or columns)
constexpr int BQ = 64;                 // query rows per tile
constexpr int BK = 64;                 // keys per tile
constexpr int MI = BQ / (THREADS / TX);  // query rows a thread scores (4)
constexpr int MJ = BK / TX;            // keys a thread scores (4)
constexpr int PLD = BK + 1;            // row stride of the P and dS tiles

struct Strides {
    long long b, h, s;                 // element strides; head_dim is contiguous
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }

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
// (zero past hd) of a (S, hd) slab with row stride ld_g, as f32.
template <typename T, int HD_PAD, int R>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long long ld_g, int start,
                                          int limit, int hd) {
    constexpr int LD = Shape<HD_PAD>::LD;
    for (int i = threadIdx.x; i < R * HD_PAD; i += THREADS) {
        const int r = i / HD_PAD, d = i % HD_PAD;
        const int s = start + r;
        dst[r * LD + d] = (s < limit && d < hd) ? to_f(src[s * ld_g + d]) : 0.f;
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

template <typename T, int HD_PAD>
__global__ void __launch_bounds__(THREADS)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ D,
            T* __restrict__ dk, T* __restrict__ dv, Strides sq, Strides sk, Strides sv,
            Strides sdo, Strides sdk, Strides sdv, int H, int KV, int S, int hd, int causal,
            int window, float scale) {
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
    load_tile<T, HD_PAD, BK>(Ks, k + b * sk.b + kvh * sk.h, sk.s, k0, S, hd);
    load_tile<T, HD_PAD, BK>(Vs, v + b * sv.b + kvh * sv.h, sv.s, k0, S, hd);

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
        const T* qb = q + b * sq.b + h * sq.h;
        const T* ob = dout + b * sdo.b + h * sdo.h;
        const long long row0 = (static_cast<long long>(b) * H + h) * S;
        for (int qt = qt_lo; qt < qt_hi; ++qt) {
            const int q0 = qt * BQ;
            __syncthreads();                   // K/V are in; the last tile's reads are done
            load_tile<T, HD_PAD, BQ>(Qs, qb, sq.s, q0, S, hd);
            load_tile<T, HD_PAD, BQ>(dOs, ob, sdo.s, q0, S, hd);
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

    T* dkb = dk + b * sdk.b + kvh * sdk.h;
    T* dvb = dv + b * sdv.b + kvh * sdv.h;
#pragma unroll
    for (int i = 0; i < MJ; ++i) {
        const int key = k0 + ty + 16 * i;
        if (key >= S) continue;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
            const int col = tx + TX * c;
            if (col < hd) {
                dkb[key * sdk.s + col] = from_f<T>(acc_k[i][c] * scale);
                dvb[key * sdv.s + col] = from_f<T>(acc_v[i][c]);
            }
        }
    }
}

template <typename T, int HD_PAD>
__global__ void __launch_bounds__(THREADS)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ D,
          T* __restrict__ dq, Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdq, int H,
          int KV, int S, int hd, int causal, int window, float scale) {
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
    load_tile<T, HD_PAD, BQ>(Qs, q + b * sq.b + h * sq.h, sq.s, q0, S, hd);
    load_tile<T, HD_PAD, BQ>(dOs, dout + b * sdo.b + h * sdo.h, sdo.s, q0, S, hd);
    load_rows(lse_s, lse + row0, q0, S);
    load_rows(D_s, D + row0, q0, S);
    const T* kb = k + b * sk.b + kvh * sk.h;
    const T* vb = v + b * sv.b + kvh * sv.h;

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
        load_tile<T, HD_PAD, BK>(Ks, kb, sk.s, k0, S, hd);
        load_tile<T, HD_PAD, BK>(Vs, vb, sv.s, k0, S, hd);
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

    T* dqb = dq + b * sdq.b + h * sdq.h;
#pragma unroll
    for (int i = 0; i < MI; ++i) {
        const int row = q0 + ty + 16 * i;
        if (row >= S) continue;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
            const int col = tx + TX * c;
            if (col < hd) dqb[row * sdq.s + col] = from_f<T>(acc[i][c] * scale);
        }
    }
}

// st: q, k, v, out, dout, dq, dk, dv.
template <typename T, int HD_PAD>
int go(const void* q, const void* k, const void* v, const void* out, const void* dout,
       const float* lse, float* D, void* dq, void* dk, void* dv, const Strides* st, int B, int H,
       int KV, int S, int hd, int causal, int window, float scale, cudaStream_t stream) {
    using Sh = Shape<HD_PAD>;
    auto dkdv = dkdv_kernel<T, HD_PAD>;
    auto dqk = dq_kernel<T, HD_PAD>;
    cudaError_t e = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(Sh::DKDV_SMEM));
    if (e == cudaSuccess)
        e = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(Sh::DQ_SMEM));
    if (e != cudaSuccess) return static_cast<int>(e);
    const T* qt = static_cast<const T*>(q);
    const T* kt = static_cast<const T*>(k);
    const T* vt = static_cast<const T*>(v);
    const T* dot = static_cast<const T*>(dout);
    const long long rows = static_cast<long long>(B) * H * S;
    const long long row_blocks = (rows + THREADS / 32 - 1) / (THREADS / 32);
    if (row_blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
    rowdot_kernel<T><<<static_cast<unsigned>(row_blocks), THREADS, 0, stream>>>(
        dot, static_cast<const T*>(out), st[4], st[3], D, H, S, hd, rows);
    const int nt = (S + BK - 1) / BK;
    dkdv<<<dim3(nt, KV, B), THREADS, Sh::DKDV_SMEM, stream>>>(
        qt, kt, vt, dot, lse, D, static_cast<T*>(dk), static_cast<T*>(dv), st[0], st[1], st[2],
        st[4], st[6], st[7], H, KV, S, hd, causal, window, scale);
    dqk<<<dim3(nt, H, B), THREADS, Sh::DQ_SMEM, stream>>>(
        qt, kt, vt, dot, lse, D, static_cast<T*>(dq), st[0], st[1], st[2], st[4], st[5], H, KV, S,
        hd, causal, window, scale);
    return 0;
}

template <typename T>
int dispatch(const void* const* p, const Strides* st, int B, int H, int KV, int S, int hd,
             int causal, int window, float scale, cudaStream_t stream) {
    const float* lse = static_cast<const float*>(p[5]);
    float* D = static_cast<float*>(const_cast<void*>(p[6]));
#define BWD_GO(P) go<T, P>(p[0], p[1], p[2], p[3], p[4], lse, D, const_cast<void*>(p[7]), \
                           const_cast<void*>(p[8]), const_cast<void*>(p[9]), st, B, H, KV, S, hd, \
                           causal, window, scale, stream)
    switch ((hd + 15) / 16 * 16) {
        case 16: return BWD_GO(16);
        case 32: return BWD_GO(32);
        case 48: return BWD_GO(48);
        case 64: return BWD_GO(64);
        case 80: return BWD_GO(80);
        case 96: return BWD_GO(96);
        case 112: return BWD_GO(112);
        default: return BWD_GO(128);
    }
#undef BWD_GO
}

}  // namespace

// Plain C interface for ctypes.  q, out, dout, dq (B, H, S, hd); k, v, dk,
// dv (B, KV, S, hd); all of one dtype (`dtype` 0: float32, 1: bf16), each
// with its last dimension contiguous; `strides` holds the b, h, s element
// strides of q, k, v, out, dout, dq, dk and dv (24 values).  lse (B, H, S)
// f32 as the forward wrote it, D an f32 scratch of B * H * S values.
// hd <= 128, H % KV == 0, window <= 0 for none, scale = 1/sqrt(hd).
// Launches the three kernels on `stream` and returns the CUDA error
// (0 = launched).
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* out, const void* dout, const void* lse,
                                          void* D, void* dq, void* dk, void* dv,
                                          const long long* strides, int B, int H, int KV, int S,
                                          int hd, int causal, int window, int dtype, float scale,
                                          void* stream) {
    if (hd < 1 || hd > 128 || KV < 1 || H % KV != 0 || (dtype != 0 && dtype != 1))
        return static_cast<int>(cudaErrorInvalidValue);
    Strides st[8];
    for (int i = 0; i < 8; ++i)
        st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
    const void* p[10] = {q, k, v, out, dout, lse, D, dq, dk, dv};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    int err = 0;
    if (B > 0 && H > 0 && S > 0)
        err = dtype == 0 ? dispatch<float>(p, st, B, H, KV, S, hd, causal, window, scale, s)
                         : dispatch<bf16>(p, st, B, H, KV, S, hd, causal, window, scale, s);
    if (err != 0) return err;
    return static_cast<int>(cudaGetLastError());
}
