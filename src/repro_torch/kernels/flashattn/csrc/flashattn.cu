// flashattn.cu — forward flash attention (causal and sliding window, GQA)
// in float32 as a CUDA kernel for Hopper (sm_90a).  It replaces the TPU
// kernel `flash_attention` of the JAX package
// (src/repro/kernels/flashattn/flashattn.py, pl.pallas_call) for f32
// inputs, whose grid walked the key blocks of one query block in order on
// one core, carrying the online-softmax state in VMEM scratch.  bf16
// inputs go to the tensor-core kernel of flashattn_tc.cu.
//
// What bounds it on this card: the operations.  At the prefill's shapes
// (S = 8192, head_dim 80, a 4096-key window) every q/k/v byte is used by
// thousands of multiply-adds, so the bytes are far below the time of the
// arithmetic.  In f32 that arithmetic runs on the FP32 pipes (67 TFLOP/s):
// TF32 tensor-core products would keep only about three decimal digits.
//
// Design: one block of 256 threads per (batch, head, 64-query tile), four
// threads to a query row.  A loop over 64-key tiles takes the place of the
// TPU's sequential grid axis; it starts at the first tile inside the
// window and stops after the causal frontier, so tiles wholly outside
// either are never touched.  K and V tiles go through shared memory (rows
// padded to an odd stride so the threads of a warp hit distinct banks);
// each thread scores 16 keys of its row, the row's four threads agree on
// the maximum and the sum with shuffles, and the online-softmax state (m,
// l and the row's output slice) stays in f32 registers.  GQA reads KV head
// h / (H / KV) in place, and ragged edges of Sq and Sk are masked rather
// than padded.  A row that sees no key at all (it cannot occur in causal
// self-attention) gets an unspecified value, as in the reference.  When the
// caller passes `lse` (the training path's forward), each row's
// log-sum-exp of its scaled scores, m + log l, is written for the backward
// of flashattn_bwd.cu.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BQ = 64;                 // query rows per block
constexpr int BKV = 64;                // keys per tile
constexpr int TPR = 4;                 // threads per query row
constexpr int THREADS = BQ * TPR;
constexpr int KPT = BKV / TPR;         // keys scored per thread per tile
constexpr int PLD = BKV + 1;           // row stride of the P tile
constexpr float NEG_INF = -1e30f;      // the reference's mask value

struct Strides {
    long long b, h, s;                 // element strides; head_dim is contiguous
};

__device__ __forceinline__ float to_f(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

__host__ __device__ constexpr int odd(int x) { return x | 1; }

__host__ __device__ constexpr size_t smem_floats(int hd) {
    return static_cast<size_t>(BQ) * odd(hd) + static_cast<size_t>(BKV) * odd(hd) +
           static_cast<size_t>(BKV) * hd + static_cast<size_t>(BQ) * PLD;
}

// DPT: output dims per thread, >= ceil(hd / 4).
template <typename T, int DPT>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ out, float* __restrict__ lse, Strides sq, Strides sk, Strides sv,
             Strides so,
             int H, int KV, int Sq, int Sk, int hd, int causal, int window, float scale) {
    extern __shared__ float smem[];
    const int ld = odd(hd);
    float* Qs = smem;                  // [BQ][ld]
    float* Ks = Qs + BQ * ld;          // [BKV][ld]
    float* Vs = Ks + BKV * ld;         // [BKV][hd]
    float* Ps = Vs + BKV * hd;         // [BQ][PLD]

    const int tid = threadIdx.x;
    const int row = tid / TPR, t = tid % TPR;
    const int h = blockIdx.y, b = blockIdx.z;
    const int kvh = h / (H / KV);
    const int q_start = blockIdx.x * BQ;
    const int q_pos = q_start + row;

    const T* qb = q + b * sq.b + h * sq.h;
    const T* kb = k + b * sk.b + kvh * sk.h;
    const T* vb = v + b * sv.b + kvh * sv.h;

    for (int i = tid; i < BQ * hd; i += THREADS) {
        const int r = i / hd, d = i % hd;
        const int s = q_start + r;
        Qs[r * ld + d] = s < Sq ? to_f(qb[s * sq.s + d]) : 0.f;
    }

    // The key tiles holding a key that some row of this block may see.
    const int q_last = min(q_start + BQ, Sq) - 1;
    int kt_lo = 0, kt_hi = (Sk + BKV - 1) / BKV;
    if (window > 0) kt_lo = max(0, q_start - window + 1) / BKV;
    if (causal) kt_hi = min(kt_hi, q_last / BKV + 1);

    float m = NEG_INF, l = 0.f;
    float acc[DPT];
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] = 0.f;

    for (int kt = kt_lo; kt < kt_hi; ++kt) {
        const int k_start = kt * BKV;
        __syncthreads();               // Q is in; the last tile's K/V reads are done
        for (int i = tid; i < BKV * hd; i += THREADS) {
            const int j = i / hd, d = i % hd;
            const int s = k_start + j;
            const bool in = s < Sk;
            Ks[j * ld + d] = in ? to_f(kb[s * sk.s + d]) : 0.f;
            Vs[j * hd + d] = in ? to_f(vb[s * sv.s + d]) : 0.f;
        }
        __syncthreads();

        float sc[KPT];
#pragma unroll
        for (int i = 0; i < KPT; ++i) sc[i] = 0.f;
        for (int d = 0; d < hd; ++d) {
            const float qd = Qs[row * ld + d];
#pragma unroll
            for (int i = 0; i < KPT; ++i) sc[i] = fmaf(qd, Ks[(t + TPR * i) * ld + d], sc[i]);
        }
        float mt = NEG_INF;
#pragma unroll
        for (int i = 0; i < KPT; ++i) {
            const int kp = k_start + t + TPR * i;
            const bool ok = kp < Sk && (!causal || q_pos >= kp) && (window <= 0 || q_pos - kp < window);
            sc[i] = ok ? sc[i] * scale : NEG_INF;
            mt = fmaxf(mt, sc[i]);
        }
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
        const float m_new = fmaxf(m, mt);
        const float alpha = expf(m - m_new);
        float ls = 0.f;
#pragma unroll
        for (int i = 0; i < KPT; ++i) {
            const float p = expf(sc[i] - m_new);
            ls += p;
            Ps[row * PLD + t + TPR * i] = to_f(from_f<T>(p));
        }
        ls += __shfl_xor_sync(0xffffffffu, ls, 1);
        ls += __shfl_xor_sync(0xffffffffu, ls, 2);
        l = l * alpha + ls;
        m = m_new;
        __syncwarp();                  // the row's P is written by its own four lanes
#pragma unroll
        for (int i = 0; i < DPT; ++i) acc[i] *= alpha;
        for (int j = 0; j < BKV; ++j) {
            const float p = Ps[row * PLD + j];
            const float* vr = Vs + j * hd;
#pragma unroll
            for (int i = 0; i < DPT; ++i) {
                const int d = t + TPR * i;
                if (d < hd) acc[i] = fmaf(p, vr[d], acc[i]);
            }
        }
    }

    if (q_pos < Sq) {
        const float lc = fmaxf(l, 1e-30f);
        T* ob = out + b * so.b + h * so.h + q_pos * so.s;
#pragma unroll
        for (int i = 0; i < DPT; ++i) {
            const int d = t + TPR * i;
            if (d < hd) ob[d] = from_f<T>(acc[i] / lc);
        }
        // The row's log-sum-exp of its scaled scores, for the backward.
        if (lse != nullptr && t == 0)
            lse[(static_cast<long long>(b) * H + h) * Sq + q_pos] = m + logf(lc);
    }
}

template <typename T, int DPT>
int go(const void* q, const void* k, const void* v, void* out, float* lse, const Strides* st,
       int B, int H, int KV, int Sq, int Sk, int hd, int causal, int window, float scale,
       cudaStream_t stream) {
    auto kern = flash_kernel<T, DPT>;
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem_floats(4 * DPT) * sizeof(float)));
    if (e != cudaSuccess) return static_cast<int>(e);
    dim3 grid((Sq + BQ - 1) / BQ, H, B);
    kern<<<grid, THREADS, smem_floats(hd) * sizeof(float), stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(out), lse, st[0], st[1], st[2], st[3], H, KV, Sq, Sk, hd, causal, window,
        scale);
    return 0;
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, float* lse,
             const Strides* st, int B, int H, int KV, int Sq, int Sk, int hd, int causal,
             int window, float scale, cudaStream_t stream) {
    const int dpt = (hd + TPR - 1) / TPR;
#define FLASH_GO(N) go<T, N>(q, k, v, out, lse, st, B, H, KV, Sq, Sk, hd, causal, window, scale, \
                             stream)
    if (dpt <= 8) return FLASH_GO(8);
    if (dpt <= 16) return FLASH_GO(16);
    if (dpt <= 20) return FLASH_GO(20);
    if (dpt <= 24) return FLASH_GO(24);
    return FLASH_GO(32);
#undef FLASH_GO
}

}  // namespace

// Plain C interface for ctypes.  float32 q (B, H, Sq, hd), k and v (B, KV,
// Sk, hd), out like q, each with its last dimension contiguous; `strides`
// holds the b, h, s element strides of q, k, v and out (12 values).
// `lse`, when not NULL, receives each row's log-sum-exp (B, H, Sq) f32.
// hd <= 128, H % KV == 0, window <= 0 for none.  Launches on `stream` and
// returns the CUDA error (0 = launched).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      void* lse, const long long* strides, int B, int H, int KV,
                                      int Sq, int Sk, int hd, int causal, int window, float scale,
                                      void* stream) {
    if (hd < 1 || hd > 128 || KV < 1 || H % KV != 0) return static_cast<int>(cudaErrorInvalidValue);
    Strides st[4];
    for (int i = 0; i < 4; ++i) st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    int err = 0;
    if (B > 0 && H > 0 && Sq > 0)
        err = dispatch<float>(q, k, v, out, static_cast<float*>(lse), st, B, H, KV, Sq, Sk, hd,
                              causal, window, scale, s);
    if (err != 0) return err;
    return static_cast<int>(cudaGetLastError());
}
