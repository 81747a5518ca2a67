// rwkv6_scan.cu — the RWKV6 WKV recurrence (chunked linear attention with
// data-dependent decay) as a CUDA kernel for Hopper (sm_90a).  It replaces
// the TPU kernel `rwkv6_scan` of the JAX package
// (src/repro/kernels/rwkv6_scan/rwkv6_scan.py, pl.pallas_call), whose grid
// walked the chunks of one (batch, head) in order on one core and carried
// the (K, K) f32 state in VMEM scratch from one grid step to the next.
//
// Design: one block of 256 threads per (batch, head).  Blocks run in no
// order on a GPU, so a loop over the chunks inside the block takes the
// place of the TPU's sequential grid axis, and the state stays in shared
// memory for the whole sequence.  Per chunk of L = min(chunk, S) steps the
// block stages r, k, v and logw in shared memory as f32 (rows padded to
// K + 1 floats, so the lanes of a warp that read one column of different
// rows hit distinct banks) and computes what the reference computes:
//
//   cum_in = cumsum(logw) over the chunk, cum_ex = cum_in - logw
//   A[t,i] = sum_k r[t,k] k[i,k] exp(clip(cum_ex[t,k] - cum_in[i,k], -60, 0))   (t > i only)
//   out    = (r exp(cum_ex)) @ S0 + A @ v + (sum_k r u k) v
//   S1     = S0 exp(total)[:, None] + (k exp(clip(total - cum_in, -60, 0)))^T @ v
//
// clipping exactly where the reference clips; `out` is rounded to r's type
// once, at the end.  The masked terms (t <= i) are never computed.  Every
// sum runs in f32 on the FP32 pipes.  The block reads its state once
// before the first chunk and writes it once after the last, so the new
// state may be written over the old one (s1 == s0): the model's decode
// step updates its recurrent cache in place that way.
//
// What bounds it on this card: at the prefill's shapes (B 1, H 64,
// S 8192, K 64) the operations — about 1.1 G exponentials on the special
// function units and 15 GFLOP of f32 products — weigh more than the
// ~0.4 GB it must move.  At decode (S = 1) the bytes do, mostly the two
// (K, K) f32 states per (batch, head).  This first version uses one block
// per (batch, head): 64 blocks on 132 SMs at the prefill shape, each with
// ~116 KB of shared memory.  Splitting the state's value columns across
// blocks, and the exponentials across more threads, is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;

struct Strides {
    long long b, h, s;                 // element strides; K is contiguous
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
    return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float clip60(float x) { return fminf(fmaxf(x, -60.0f), 0.0f); }

size_t smem_bytes(int L, int K) {
    const size_t KP = K + 1;
    return sizeof(float) * (static_cast<size_t>(K) * K + 4 * L * KP + static_cast<size_t>(L) * K +
                            static_cast<size_t>(L) * L + L + K);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
rwkv6_scan_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                  const float* __restrict__ logw, const float* __restrict__ u,
                  const float* s0, T* __restrict__ out, float* s1,
                  Strides sr, Strides sk, Strides sv, Strides sw, Strides so,
                  int H, int S, int K, int L) {
    extern __shared__ float smem[];
    const int KP = K + 1;
    float* St = smem;                  // [K][K]  the carried state
    float* Rs = St + K * K;            // [L][KP] r, then r * exp(cum_ex)
    float* Ks = Rs + L * KP;           // [L][KP] k, then k_dec
    float* Ci = Ks + L * KP;           // [L][KP] cum_in
    float* Ce = Ci + L * KP;           // [L][KP] logw, then cum_ex
    float* Vs = Ce + L * KP;           // [L][K]  v
    float* As = Vs + L * K;            // [L][L]  A (t > i)
    float* Bs = As + L * L;            // [L]     the bonus sum_k r u k
    float* Us = Bs + L;                // [K]     u of this head

    const int tid = threadIdx.x;
    const int h = blockIdx.x, b = blockIdx.y;
    const long long st = (static_cast<long long>(b) * H + h) * K * K;
    const T* rp = r + b * sr.b + h * sr.h;
    const T* kp = k + b * sk.b + h * sk.h;
    const T* vp = v + b * sv.b + h * sv.h;
    const float* wp = logw + b * sw.b + h * sw.h;
    T* op = out + b * so.b + h * so.h;

    for (int e = tid; e < K * K; e += THREADS) St[e] = s0[st + e];
    for (int e = tid; e < K; e += THREADS) Us[e] = u[h * K + e];
    const float* tot = Ci + (L - 1) * KP;       // cum_in of the chunk's last step

    for (int c0 = 0; c0 < S; c0 += L) {
        __syncthreads();               // the previous chunk's readers are done
        for (int e = tid; e < L * K; e += THREADS) {
            const int t = e / K, j = e % K;
            const long long s = c0 + t;
            Rs[t * KP + j] = to_f(rp[s * sr.s + j]);
            Ks[t * KP + j] = to_f(kp[s * sk.s + j]);
            Vs[t * K + j] = to_f(vp[s * sv.s + j]);
            Ce[t * KP + j] = wp[s * sw.s + j];
        }
        __syncthreads();
        for (int j = tid; j < K; j += THREADS) {          // cumsum down each column
            float acc = 0.0f;
            for (int t = 0; t < L; ++t) {
                const float lw = Ce[t * KP + j];
                acc += lw;
                Ci[t * KP + j] = acc;
                Ce[t * KP + j] = acc - lw;
            }
        }
        __syncthreads();
        for (int e = tid; e < L * L; e += THREADS) {      // A, below the diagonal
            const int t = e / L, i = e % L;
            float a = 0.0f;
            if (t > i) {
                const float* rt = Rs + t * KP;
                const float* ce = Ce + t * KP;
                const float* ki = Ks + i * KP;
                const float* ci = Ci + i * KP;
                for (int j = 0; j < K; ++j) a += rt[j] * ki[j] * expf(clip60(ce[j] - ci[j]));
            }
            As[e] = a;
        }
        for (int t = tid; t < L; t += THREADS) {          // the bonus diagonal
            float a = 0.0f;
            for (int j = 0; j < K; ++j) a += Rs[t * KP + j] * Us[j] * Ks[t * KP + j];
            Bs[t] = a;
        }
        __syncthreads();
        for (int e = tid; e < L * K; e += THREADS) {      // r_dec and k_dec in place
            const int t = e / K, j = e % K;
            Rs[t * KP + j] *= expf(Ce[t * KP + j]);
            Ks[t * KP + j] *= expf(clip60(tot[j] - Ci[t * KP + j]));
        }
        __syncthreads();
        for (int e = tid; e < L * K; e += THREADS) {      // out
            const int t = e / K, j = e % K;
            float inter = 0.0f, intra = 0.0f;
            for (int q = 0; q < K; ++q) inter += Rs[t * KP + q] * St[q * K + j];
            for (int i = 0; i < t; ++i) intra += As[t * L + i] * Vs[i * K + j];
            op[(c0 + t) * so.s + j] = from_f<T>(inter + intra + Bs[t] * Vs[t * K + j]);
        }
        __syncthreads();
        for (int e = tid; e < K * K; e += THREADS) {      // the state update
            const int q = e / K, j = e % K;
            float acc = 0.0f;
            for (int i = 0; i < L; ++i) acc += Ks[i * KP + q] * Vs[i * K + j];
            St[e] = St[e] * expf(tot[q]) + acc;
        }
    }
    // Each thread wrote exactly the state elements it now stores.
    for (int e = tid; e < K * K; e += THREADS) s1[st + e] = St[e];
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* logw, const void* u,
           const void* s0, void* out, void* s1, const long long* strides, int B, int H, int S,
           int K, int L, cudaStream_t stream) {
    static bool opted_in = false;
    const size_t bytes = smem_bytes(L, K);
    if (!opted_in) {
        cudaError_t e = cudaFuncSetAttribute(rwkv6_scan_kernel<T>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem_bytes(64, 64)));
        if (e != cudaSuccess) return static_cast<int>(e);
        opted_in = true;
    }
    const Strides sr{strides[0], strides[1], strides[2]}, sk{strides[3], strides[4], strides[5]},
        sv{strides[6], strides[7], strides[8]}, sw{strides[9], strides[10], strides[11]},
        so{strides[12], strides[13], strides[14]};
    rwkv6_scan_kernel<T><<<dim3(H, B), THREADS, bytes, stream>>>(
        static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const float*>(logw), static_cast<const float*>(u),
        static_cast<const float*>(s0), static_cast<T*>(out), static_cast<float*>(s1), sr, sk, sv,
        sw, so, H, S, K, L);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes.  r, k, v (dtype 0 = f32, 1 = bf16) and
// logw (f32) are (B, H, S, K) with K contiguous and the (b, h, s) element
// strides of r, k, v, logw and out in `strides` (15 values); u is (H, K)
// f32, s0 and s1 (B, H, K, K) f32 contiguous (s1 may be s0).  K <= 64,
// L <= 64, S % L == 0.  Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
extern "C" int rwkv6_scan_launch(const void* r, const void* k, const void* v, const void* logw,
                                 const void* u, const void* s0, void* out, void* s1,
                                 const long long* strides, int B, int H, int S, int K, int L,
                                 int dtype, void* stream) {
    if (K < 1 || K > 64 || L < 1 || L > 64 || S % L != 0) return static_cast<int>(cudaErrorInvalidValue);
    if (B == 0 || H == 0 || S == 0) return 0;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return launch<float>(r, k, v, logw, u, s0, out, s1, strides, B, H, S, K, L, st);
    if (dtype == 1)
        return launch<__nv_bfloat16>(r, k, v, logw, u, s0, out, s1, strides, B, H, S, K, L, st);
    return static_cast<int>(cudaErrorInvalidValue);
}
