// rwkv6_scan_bwd.cu — the backward of the RWKV6 WKV recurrence as CUDA
// kernels for Hopper (sm_90a).  The JAX package has no backward kernel: it
// trains by `jax.grad` of its plain scan (src/repro/models/rwkv6.py:83,
// `chunked_wkv`).  These kernels compute that gradient from the forward's
// saved chunk start states, in two passes (the plain version of each is in
// ../ref.py: `chunk_dstates_ref`, `chunk_grads_ref`).  In a chunk of
// L = min(chunk, S) steps, with a_t = cum_in[t], e_t = cum_ex[t] = a_t - w_t
// (w = logw), S the state the chunk starts from, G the gradient arriving at
// its end, D[t,i] = v_i . dO_t, P[t,i] = exp(clip(e_t - a_i, -60, 0)) and
// kdec_i = exp(clip(a_{L-1} - a_i, -60, 0)):
//
//   G_prev = exp(a_{L-1})[:, None] G + sum_t (r_t exp(e_t))^T dO_t
//   dr_t   = exp(e_t) (S dO_t) + sum_{i<t} k_i P[t,i] D[t,i] + u k_t D[t,t]
//   dk_i   = sum_{t>i} r_t P[t,i] D[t,i] + r_i u D[i,i] + kdec_i (G v_i)
//   dv_i   = sum_{t>i} A[t,i] dO_t + bonus_i dO_i + (k_i kdec_i)^T G
//   du     = sum_t r_t k_t D[t,t]                 (a share per (batch, chunk))
//   dlogw_s = sum_{t>=s} da_t + sum_{t>s} de_t     (within the chunk)
//
// with the exponents' gradients de_t = r_t (dr_t - u k_t D[t,t]), da_i =
// -k_i (dk_i - r_i u D[i,i]) and, at the chunk's last step, da_{L-1} +=
// exp(a_{L-1}) sum_j S[:, j] G[:, j] + sum_i k_i kdec_i (G v_i).  A and the
// bonus are the forward's.  Every sum runs in f32; dr, dk, dv are rounded
// to the inputs' type once, at the end.
//
// * `rwkv6_dstate_kernel`, grid (state-row tiles of 16, H, B), 256 threads:
//   the mirror of the forward's state pass.  Row q of G_prev needs only
//   column q of r and logw, exp(a_{L-1}[q]) and all of dO, so each block
//   carries a (16, K) slice of its (batch, head)'s gradient in registers
//   (4 cells a thread) and walks the chunks from the last to the first.  It
//   stores the gradient arriving at each chunk's end into an f32 scratch of
//   the forward scratch's shape (B, H, n_c, Kp, Kp) and the gradient of the
//   first chunk's start state into ds0.  Its bound is the chain of n_c
//   chunks, as the forward's.
// * `rwkv6_grad_kernel`, grid (n_c, H, B), one block of 512 threads per
//   chunk, all independent.  It stages the chunk's r, k, v, logw and dO, its
//   start state and its end gradient in shared memory as f32 (rows padded to
//   65 floats, so lanes walking a column hit distinct banks), scans logw in
//   log2 units (each exponential one exp2f, the clip at -60 log2(e)), forms
//   D, S dO, G v and the bonus (a thread four outputs, sharing each
//   broadcast load), then A (one thread a pair (t, i), summing over the key
//   index) and dv (a thread four columns), then the pairwise pass that feeds
//   dr and dk from one exponential each: a lane owns key column q and two
//   tiles of 4 keys i (tiles g and 15 - g of the chunk's 16, so the eight
//   lanes of a column share the triangle's work evenly) and keeps their k,
//   a_i and dk sums in registers; for each query t the eight lanes' dr sums
//   meet by three shuffles.  Last the exponents' gradients are summed
//   backwards down each column into dlogw.  No atomics: du's share of each
//   (batch, chunk) goes to its own row, which the wrapper sums in a fixed
//   order, so the gradients are deterministic.  185 KB of shared memory: one
//   block of 16 warps an SM.
//
// This design computes the pairwise exponentials twice (once for A, once
// for dr and dk), and keeps to FP32 FMAs and shared memory; its bound is
// the exponentials computed once, at the SFU rate.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;             // threads of a dstate block
constexpr int GT = 512;                  // threads of a gradient block
constexpr int MAXD = 64;                 // L and K at most
constexpr int LANES = GT / MAXD;         // lanes of a key column in the pairwise pass
constexpr int TILE = MAXD / (2 * LANES); // keys in each of a lane's two tiles
constexpr int PITCH = MAXD + 1;          // floats a row of the gradient pass's arrays
constexpr int RT = 16;                   // state rows one dstate block carries
constexpr int RTP = RT + 1;              // pitch of its r and logw columns
constexpr float LOG2E = 1.4426950408889634f;
constexpr float CLIP2 = -86.56170245333781f;   // the clip at -60, in log2 units

struct Strides {
    long long b, h, s;                   // element strides; K is contiguous
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
    return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float clip2(float x) { return fminf(fmaxf(x, CLIP2), 0.0f); }

constexpr size_t dstate_smem_bytes() {
    return sizeof(float) * (2 * MAXD * RTP + MAXD * PITCH + RT * RT + RT);
}
constexpr int GRAD_ARRAYS = 11;
constexpr size_t grad_smem_bytes() {
    return sizeof(float) * (GRAD_ARRAYS * MAXD * PITCH + LANES * MAXD + 3 * MAXD);
}

// The dstate pass: block (row tile, h, b) carries gradient rows [q0, q0 +
// 16) of its (b, h) — all K columns, thread (row qq = tid / 16, columns
// 4 (tid % 16) .. + 3) — through the chunks from the last to the first.
// Per chunk c: store the gradient arriving at its end; stage r and logw
// columns [q0, q0 + 16) and all of dO; scan logw down each column (thread
// (column sc, segment of 4 rows)); then G <- exp(a_{L-1}) G + sum_t
// (r exp(e))^T dO.
template <typename T>
__global__ void __launch_bounds__(THREADS)
rwkv6_dstate_kernel(const T* __restrict__ r, const float* __restrict__ logw,
                    const T* __restrict__ dout, const float* __restrict__ ds1,
                    float* __restrict__ dscratch, float* __restrict__ ds0, Strides sr, Strides sw,
                    Strides so, int H, int S, int K, int L, int Kp) {
    extern __shared__ float smem[];
    float* rd = smem;                    // [L][RTP] r, then r exp(cum_ex)
    float* cw = rd + MAXD * RTP;         // [L][RTP] logw (log2 units)
    float* ds = cw + MAXD * RTP;         // [L][PITCH] dO
    float* part = ds + MAXD * PITCH;     // [16 segments][RT] the scan's segment sums
    float* dec = part + RT * RT;         // [RT] exp(a_{L-1})

    const int tid = threadIdx.x;
    const int q0 = blockIdx.x * RT, h = blockIdx.y, b = blockIdx.z;
    const int nq = min(RT, K - q0), nc = S / L;
    const long long bh = static_cast<long long>(b) * H + h;
    const T* rp = r + b * sr.b + h * sr.h;
    const float* wp = logw + b * sw.b + h * sw.h;
    const T* op = dout + b * so.b + h * so.h;
    float* scr = dscratch + bh * nc * Kp * Kp;

    const int qq = tid >> 4, j0 = 4 * (tid & 15), q = q0 + qq;
    float g[4];
#pragma unroll
    for (int y = 0; y < 4; ++y)
        g[y] = (qq < nq && j0 + y < K) ? ds1[bh * K * K + q * K + j0 + y] : 0.0f;
    const int sc = tid & (RT - 1), seg = tid >> 4;

    for (int c = nc - 1; c >= 0; --c) {
        if (qq < nq) {
#pragma unroll
            for (int y = 0; y < 4; ++y)
                if (j0 + y < K) scr[static_cast<long long>(c) * Kp * Kp + q * Kp + j0 + y] = g[y];
        }
        const long long row0 = static_cast<long long>(c) * L;
        __syncthreads();                 // the previous chunk's readers are done
        for (int e = tid; e < L * RT; e += THREADS) {
            const int t = e / RT, x = e % RT;
            const bool in = x < nq;
            rd[t * RTP + x] = in ? to_f(rp[(row0 + t) * sr.s + q0 + x]) : 0.0f;
            cw[t * RTP + x] = in ? wp[(row0 + t) * sw.s + q0 + x] * LOG2E : 0.0f;
        }
        for (int e = tid; e < L * K; e += THREADS) {
            const int t = e / K, j = e % K;
            ds[t * PITCH + j] = to_f(op[(row0 + t) * so.s + j]);
        }
        __syncthreads();
        float pre[4], lw[4];
        float acc = 0.0f;
#pragma unroll
        for (int x = 0; x < 4; ++x) {
            const int t = 4 * seg + x;
            lw[x] = t < L ? cw[t * RTP + sc] : 0.0f;
            acc += lw[x];
            pre[x] = acc;
        }
        part[seg * RT + sc] = acc;
        __syncthreads();
        float off = 0.0f;
        for (int s2 = 0; s2 < seg; ++s2) off += part[s2 * RT + sc];
#pragma unroll
        for (int x = 0; x < 4; ++x) {
            const int t = 4 * seg + x;
            if (t < L) {
                rd[t * RTP + sc] *= exp2f(off + pre[x] - lw[x]);
                if (t == L - 1) dec[sc] = exp2f(off + pre[x]);
            }
        }
        __syncthreads();
        if (qq < nq) {
            float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            for (int t = 0; t < L; ++t) {
                const float rv = rd[t * RTP + qq];
#pragma unroll
                for (int y = 0; y < 4; ++y) a[y] += rv * ds[t * PITCH + j0 + y];
            }
            const float d = dec[qq];
#pragma unroll
            for (int y = 0; y < 4; ++y)
                if (j0 + y < K) g[y] = g[y] * d + a[y];
        }
    }
    if (qq < nq) {
#pragma unroll
        for (int y = 0; y < 4; ++y)
            if (j0 + y < K) ds0[bh * K * K + q * K + j0 + y] = g[y];
    }
}

// Pair n of the strict lower triangle, row-major: row t > column i.
__device__ __forceinline__ void pair_of(int n, int& t, int& i) {
    int x = static_cast<int>((sqrtf(8.0f * n + 1.0f) + 1.0f) * 0.5f);
    while (x * (x - 1) / 2 > n) --x;
    while ((x + 1) * x / 2 <= n) ++x;
    t = x;
    i = n - x * (x - 1) / 2;
}

// The gradient pass: block (c, h, b) computes chunk c of (b, h) from the
// state it starts from (`states`) and the gradient at its end
// (`dscratch`).  Arrays in shared memory, f32, [row][PITCH]:
//   R   r [t][q]                 KS  k [i][q]
//   VS  v [i][j], then k kdec    CE  cum_ex [t][q] (log2 units)
//   CI  logw, then cum_in        DO  dO [t][j], then de [t][q]
//   SS  S [q][j], then A [t][i], then da [i][q]
//   GS  G [q][j]                 DD  D [t][i], i <= t
//   SD  S dO [t][q]              GV  G v [i][q]
template <typename T>
__global__ void __launch_bounds__(GT, 1)
rwkv6_grad_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                  const float* __restrict__ logw, const float* __restrict__ u,
                  const float* __restrict__ states, const T* __restrict__ dout,
                  const float* __restrict__ dscratch, T* __restrict__ dr, T* __restrict__ dk,
                  T* __restrict__ dv, float* __restrict__ dw, float* __restrict__ du_part,
                  Strides sr, Strides sk, Strides sv, Strides sw, Strides so, Strides sdr,
                  Strides sdk, Strides sdv, Strides sdw, int H, int K, int L, int Kp, int nc) {
    extern __shared__ float smem[];
    constexpr int A_ = MAXD * PITCH;
    float* R = smem;
    float* KS = R + A_;
    float* VS = KS + A_;
    float* CE = VS + A_;
    float* CI = CE + A_;
    float* DO = CI + A_;
    float* SS = DO + A_;
    float* GS = SS + A_;
    float* DD = GS + A_;
    float* SD = DD + A_;
    float* GV = SD + A_;
    float* part = GV + A_;               // [LANES][MAXD] the scans' segment sums
    float* us = part + LANES * MAXD;     // [MAXD] u of this head
    float* bon = us + MAXD;              // [MAXD] the bonus sum_q r u k of each row
    float* last = bon + MAXD;            // [MAXD] sum_j S[q][j] G[q][j]

    const int tid = threadIdx.x;
    const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const long long row0 = static_cast<long long>(c) * L;
    const long long bh = static_cast<long long>(b) * H + h;
    const long long soff = (bh * nc + c) * Kp * Kp;

    // 0. stage the chunk
    for (int e = tid; e < L * K; e += GT) {
        const int t = e / K, j = e % K;
        const long long s = row0 + t;
        R[t * PITCH + j] = to_f(r[b * sr.b + h * sr.h + s * sr.s + j]);
        KS[t * PITCH + j] = to_f(k[b * sk.b + h * sk.h + s * sk.s + j]);
        VS[t * PITCH + j] = to_f(v[b * sv.b + h * sv.h + s * sv.s + j]);
        CI[t * PITCH + j] = logw[b * sw.b + h * sw.h + s * sw.s + j] * LOG2E;
        DO[t * PITCH + j] = to_f(dout[b * so.b + h * so.h + s * so.s + j]);
    }
    for (int e = tid; e < K * K; e += GT) {
        const int q = e / K, j = e % K;
        SS[q * PITCH + j] = states[soff + q * Kp + j];
        GS[q * PITCH + j] = dscratch[soff + q * Kp + j];
    }
    if (tid < K) us[tid] = u[h * K + tid];
    __syncthreads();

    // 1. cum_in and cum_ex down each column: thread (column, segment of SEG rows)
    constexpr int SEG = MAXD / LANES;
    {
        const int q = tid & (MAXD - 1), seg = tid / MAXD;
        float lw[SEG], pre[SEG];
        float acc = 0.0f;
#pragma unroll
        for (int x = 0; x < SEG; ++x) {
            const int t = SEG * seg + x;
            lw[x] = (q < K && t < L) ? CI[t * PITCH + q] : 0.0f;
            acc += lw[x];
            pre[x] = acc;
        }
        part[seg * MAXD + q] = acc;
        __syncthreads();
        float off = 0.0f;
        for (int s2 = 0; s2 < seg; ++s2) off += part[s2 * MAXD + q];
        if (q < K) {
#pragma unroll
            for (int x = 0; x < SEG; ++x) {
                const int t = SEG * seg + x;
                if (t < L) {
                    CI[t * PITCH + q] = off + pre[x];
                    CE[t * PITCH + q] = off + pre[x] - lw[x];
                }
            }
        }
    }
    __syncthreads();

    // 2. D (i <= t), S dO, G v, sum_j S G and the bonus; a thread takes
    // four outputs of one row t (rows vary along the warp, so the four
    // shared operands are broadcast)
    const int L4 = (L + 3) / 4, K4 = (K + 3) / 4;
    for (int e = tid; e < L * L4; e += GT) {
        const int t = e % L, i0 = 4 * (e / L);
        if (i0 > t) continue;
        float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int j = 0; j < K; ++j) {
            const float d = DO[t * PITCH + j];
#pragma unroll
            for (int x = 0; x < 4; ++x) a[x] += VS[(i0 + x) * PITCH + j] * d;
        }
#pragma unroll
        for (int x = 0; x < 4; ++x)
            if (i0 + x <= t) DD[t * PITCH + i0 + x] = a[x];
    }
    for (int e = tid; e < L * K4; e += GT) {
        const int t = e % L, q0 = 4 * (e / L);
        float a[4] = {0.0f, 0.0f, 0.0f, 0.0f}, bsum[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int j = 0; j < K; ++j) {
            const float d = DO[t * PITCH + j], vv = VS[t * PITCH + j];
#pragma unroll
            for (int x = 0; x < 4; ++x) {
                a[x] += SS[(q0 + x) * PITCH + j] * d;
                bsum[x] += GS[(q0 + x) * PITCH + j] * vv;
            }
        }
#pragma unroll
        for (int x = 0; x < 4; ++x) {
            if (q0 + x >= K) continue;
            SD[t * PITCH + q0 + x] = a[x];
            GV[t * PITCH + q0 + x] = bsum[x];
        }
    }
    if (tid < K) {
        float a = 0.0f;
        for (int j = 0; j < K; ++j) a += SS[tid * PITCH + j] * GS[tid * PITCH + j];
        last[tid] = a;
    } else if (tid >= MAXD && tid - MAXD < L) {
        const int t = tid - MAXD;
        float a = 0.0f;
        for (int q = 0; q < K; ++q) a += R[t * PITCH + q] * us[q] * KS[t * PITCH + q];
        bon[t] = a;
    }
    __syncthreads();

    // 3. A over the strict lower triangle (over S), and k kdec (over v)
    const int npairs = L * (L - 1) / 2;
    for (int n = tid; n < npairs; n += GT) {
        int t, i;
        pair_of(n, t, i);
        float a = 0.0f;
        for (int q = 0; q < K; ++q)
            a += R[t * PITCH + q] * KS[i * PITCH + q] *
                 exp2f(clip2(CE[t * PITCH + q] - CI[i * PITCH + q]));
        SS[t * PITCH + i] = a;
    }
    for (int e = tid; e < L * K; e += GT) {
        const int i = e / K, q = e % K;
        VS[i * PITCH + q] =
            KS[i * PITCH + q] * exp2f(clip2(CI[(L - 1) * PITCH + q] - CI[i * PITCH + q]));
    }
    __syncthreads();

    // 4. dv (a thread four columns j of one row i; rows vary along the
    // warp), and this (batch, chunk)'s share of du
    for (int e = tid; e < L * K4; e += GT) {
        const int i = e % L, j0 = 4 * (e / L);
        float a[4];
#pragma unroll
        for (int x = 0; x < 4; ++x) a[x] = bon[i] * DO[i * PITCH + j0 + x];
        for (int t = i + 1; t < L; ++t) {
            const float at = SS[t * PITCH + i];
#pragma unroll
            for (int x = 0; x < 4; ++x) a[x] += at * DO[t * PITCH + j0 + x];
        }
        for (int q = 0; q < K; ++q) {
            const float kk = VS[i * PITCH + q];
#pragma unroll
            for (int x = 0; x < 4; ++x) a[x] += kk * GS[q * PITCH + j0 + x];
        }
#pragma unroll
        for (int x = 0; x < 4; ++x)
            if (j0 + x < K) dv[b * sdv.b + h * sdv.h + (row0 + i) * sdv.s + j0 + x] = from_f<T>(a[x]);
    }
    if (tid < K) {
        float a = 0.0f;
        for (int t = 0; t < L; ++t) a += R[t * PITCH + tid] * KS[t * PITCH + tid] * DD[t * PITCH + t];
        du_part[((static_cast<long long>(b) * nc + c) * H + h) * K + tid] = a;
    }
    __syncthreads();

    // 5. the pairs again, for dr and dk: lane (q, g) keeps k, a_i and the dk
    // sums of keys i in tiles g and 2 LANES - 1 - g; the LANES lanes of a
    // column sum each query's dr by shuffles
    {
        const int lane = tid & 31, g = lane & (LANES - 1);
        const int q = (32 / LANES) * (tid >> 5) + lane / LANES;
        const bool col = q < K;
        const int m[2] = {g, 2 * LANES - 1 - g};
        float ka[2][TILE], ca[2][TILE], dka[2][TILE];
#pragma unroll
        for (int s = 0; s < 2; ++s)
#pragma unroll
            for (int y = 0; y < TILE; ++y) {
                const int i = TILE * m[s] + y;
                const bool in = col && i < L;
                ka[s][y] = in ? KS[i * PITCH + q] : 0.0f;
                ca[s][y] = in ? CI[i * PITCH + q] : 0.0f;
                dka[s][y] = 0.0f;
            }
        const float uq = col ? us[q] : 0.0f;
        for (int t = 0; t < L; ++t) {
            const float et = col ? CE[t * PITCH + q] : 0.0f;
            const float rt = col ? R[t * PITCH + q] : 0.0f;
            float acc = 0.0f;
#pragma unroll
            for (int s = 0; s < 2; ++s) {
                if (TILE * m[s] >= t) continue;
#pragma unroll
                for (int y = 0; y < TILE; ++y) {
                    const int i = TILE * m[s] + y;
                    if (i < t) {
                        const float w = exp2f(clip2(et - ca[s][y])) * DD[t * PITCH + i];
                        acc += ka[s][y] * w;
                        dka[s][y] += rt * w;
                    }
                }
            }
#pragma unroll
            for (int o = 1; o < LANES; o <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
            if (g == 0 && col) {
                const float inter = exp2f(et) * SD[t * PITCH + q];
                DO[t * PITCH + q] = rt * (inter + acc);
                dr[b * sdr.b + h * sdr.h + (row0 + t) * sdr.s + q] =
                    from_f<T>(inter + acc + uq * KS[t * PITCH + q] * DD[t * PITCH + t]);
            }
        }
        if (col) {
            const float alast = CI[(L - 1) * PITCH + q];
#pragma unroll
            for (int s = 0; s < 2; ++s)
#pragma unroll
                for (int y = 0; y < TILE; ++y) {
                    const int i = TILE * m[s] + y;
                    if (i >= L) continue;
                    const float kg = exp2f(clip2(alast - ca[s][y])) * GV[i * PITCH + q];
                    dk[b * sdk.b + h * sdk.h + (row0 + i) * sdk.s + q] =
                        from_f<T>(dka[s][y] + R[i * PITCH + q] * uq * DD[i * PITCH + i] + kg);
                    SS[i * PITCH + q] = -ka[s][y] * (dka[s][y] + kg);
                }
        }
    }
    __syncthreads();

    // 6. the last step's exponent also scales the state's decay and every
    // state update
    if (tid < K) {
        float a = exp2f(CI[(L - 1) * PITCH + tid]) * last[tid];
        for (int i = 0; i < L; ++i) a += VS[i * PITCH + tid] * GV[i * PITCH + tid];
        SS[(L - 1) * PITCH + tid] += a;
    }
    __syncthreads();

    // 7. dlogw_s = sum_{t>=s} (da_t + de_t) - de_s, up each column:
    // thread (column, segment of SEG rows)
    {
        const int q = tid & (MAXD - 1), seg = tid / MAXD;
        float rev[SEG];
        float acc = 0.0f;
#pragma unroll
        for (int x = SEG - 1; x >= 0; --x) {
            const int t = SEG * seg + x;
            if (q < K && t < L) acc += SS[t * PITCH + q] + DO[t * PITCH + q];
            rev[x] = acc;
        }
        part[seg * MAXD + q] = acc;
        __syncthreads();
        float off = 0.0f;
        for (int s2 = seg + 1; s2 < LANES; ++s2) off += part[s2 * MAXD + q];
        if (q < K) {
#pragma unroll
            for (int x = 0; x < SEG; ++x) {
                const int t = SEG * seg + x;
                if (t < L)
                    dw[b * sdw.b + h * sdw.h + (row0 + t) * sdw.s + q] =
                        off + rev[x] - DO[t * PITCH + q];
            }
        }
    }
}

// Opts `kern` into `smem` bytes of dynamic shared memory on the current
// device, once a device (one bit a device in `opted_in`).
template <typename Kern>
int opt_in(Kern kern, size_t smem, unsigned long long& opted_in) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
    if (!(opted_in >> dev & 1ULL)) {
        e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
        opted_in |= 1ULL << dev;
    }
    return 0;
}

template <typename T>
int launch_bwd(void* const* p, const long long* st, int B, int H, int S, int K, int L,
               cudaStream_t stream) {
    static unsigned long long opted_in = 0;
    const int err = opt_in(rwkv6_grad_kernel<T>, grad_smem_bytes(), opted_in);
    if (err != 0) return err;
    Strides s[9];
    for (int x = 0; x < 9; ++x) s[x] = Strides{st[3 * x], st[3 * x + 1], st[3 * x + 2]};
    const int Kp = (K + 3) & ~3, nc = S / L;
    const T* r = static_cast<const T*>(p[0]);
    const T* dout = static_cast<const T*>(p[6]);
    float* dscratch = static_cast<float*>(p[14]);
    rwkv6_dstate_kernel<T><<<dim3((K + RT - 1) / RT, H, B), THREADS, dstate_smem_bytes(), stream>>>(
        r, static_cast<const float*>(p[3]), dout, static_cast<const float*>(p[7]), dscratch,
        static_cast<float*>(p[13]), s[0], s[3], s[4], H, S, K, L, Kp);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    rwkv6_grad_kernel<T><<<dim3(nc, H, B), GT, grad_smem_bytes(), stream>>>(
        r, static_cast<const T*>(p[1]), static_cast<const T*>(p[2]),
        static_cast<const float*>(p[3]), static_cast<const float*>(p[4]),
        static_cast<const float*>(p[5]), dout, dscratch, static_cast<T*>(p[8]),
        static_cast<T*>(p[9]), static_cast<T*>(p[10]), static_cast<float*>(p[11]),
        static_cast<float*>(p[12]), s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], H, K, L,
        Kp, nc);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes.  Inputs: r, k, v (dtype 0 = f32, 1 = bf16),
// logw (f32) and dout (r's dtype), (B, H, S, K) with K contiguous; u (H, K)
// f32; states (B, H, S / L, Kp, Kp) f32, the state each chunk starts from
// (Kp = K rounded up to a multiple of 4); ds1 (B, H, K, K) f32, the
// gradient of the last state.  Outputs: dr, dk, dv (r's dtype) and dw (f32),
// (B, H, S, K) with K contiguous; du_part (B, S / L, H, K) f32, each (batch,
// chunk)'s share of du; ds0 (B, H, K, K) f32; dscratch, the states' shape,
// receives the gradient arriving at each chunk's end.  `strides` holds the
// (b, h, s) element strides of r, k, v, logw, dout, dr, dk, dv and dw (27
// values).  K <= 64, L <= 64, S % L == 0.  Launches the two kernels on
// `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int rwkv6_scan_bwd_launch(const void* r, const void* k, const void* v,
                                     const void* logw, const void* u, const void* states,
                                     const void* dout, const void* ds1, void* dr, void* dk,
                                     void* dv, void* dw, void* du_part, void* ds0,
                                     void* dscratch, const long long* strides, int B, int H,
                                     int S, int K, int L, int dtype, void* stream) {
    if (K < 1 || K > 64 || L < 1 || L > 64 || S % L != 0) return static_cast<int>(cudaErrorInvalidValue);
    if (B == 0 || H == 0 || S == 0) return 0;
    void* const p[15] = {const_cast<void*>(r), const_cast<void*>(k), const_cast<void*>(v),
                         const_cast<void*>(logw), const_cast<void*>(u), const_cast<void*>(states),
                         const_cast<void*>(dout), const_cast<void*>(ds1), dr, dk, dv, dw,
                         du_part, ds0, dscratch};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return launch_bwd<float>(p, strides, B, H, S, K, L, st);
    if (dtype == 1) return launch_bwd<__nv_bfloat16>(p, strides, B, H, S, K, L, st);
    return static_cast<int>(cudaErrorInvalidValue);
}
