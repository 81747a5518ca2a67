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
// to the inputs' type once, at the end.  Both instances launch two kernels
// a call, a dstate pass over the chunks in reverse and then a gradient pass
// with one block a chunk, and use no atomics: du's share of each (batch,
// chunk) goes to its own row, which the wrapper sums in a fixed order, so
// the gradients are the same bits on every run.
//
// What bounds it on this card: the pairwise part, 2 L(L-1)/2 K terms a
// chunk, each an exponential (the SFU, 16 an SM a clock) and 8 f32
// operations (the FP32 pipes); the matmul-shaped products (D, S dO, G v,
// A^T dO, (k kdec)^T G and the dstate update), which the bf16 instance runs
// on the tensor cores; and the bytes, each input and gradient once.
//
// bf16 (the training path): `rwkv6_dstate_tc_kernel`, `rwkv6_grad_tc_kernel`.
// * The matmul-shaped products run on the tensor cores (mma.sync m16n8k16,
//   bf16 in, f32 accumulators; ldmatrix from padded tiles, rows of 144
//   bytes so that the eight rows of an 8x8 matrix hit distinct banks).  A
//   product of two bf16 inputs (D = dO v^T) is exact as it stands; an f32
//   operand (S, G, A, r exp(e), k kdec) goes in as three bf16 parts
//   (rwkv6_mma.cuh `split3`), three products with a bf16 operand, six (hi
//   hi, hi mid, mid hi, hi lo, mid mid, lo hi) for (k kdec)^T G, whose two
//   operands are f32.  No operand is rounded to one bf16 and nothing runs
//   in TF32: dlogw sums them with cancellation down each column.
// * r, k, v, dO, logw, and the chunk's S and G (f32) are staged by
//   cp.async, 16 bytes a thread (plain loads where K or a stride is not a
//   multiple of 16 bytes); the products read S and G from shared memory.
// * `rwkv6_dstate_tc_kernel`, grid (H, B), 256 threads, two blocks an SM:
//   the (b, h)'s 64 x 64 carried gradient lives in the mma accumulators of
//   eight warps.  Each chunk: its r, logw and dO land by cp.async while the
//   chunk before is computed (two buffers); the block stores the gradient
//   at the chunk's end, scans logw down each column, writes r exp(cum_ex)
//   split in three as bf16 tiles, scales the accumulators by exp(a_{L-1})
//   and adds (r exp(e))^T dO on the tensor cores.  dO is read once a (b, h).
// * `rwkv6_grad_tc_kernel`, grid (n_c, H, B), 512 threads, 108 KB of shared
//   memory and 64 registers: two blocks (32 warps) an SM.  Phases, each
//   after a barrier: stage; scan logw into cum_in as [q][t + 1] (so that
//   cum_ex[t] = cum_in[t - 1] is the same array at t) and transpose r and k
//   ([q][t], bf16); A over the pairs (warps 0-14 a 4x4 (t, i) tile and a
//   quarter of the key columns each lane, the quarters summed by a
//   reduce-scatter of twelve shuffles; warp 15 the diagonal tiles and the
//   bonus) while S lands; dv = A'^T dO + (k kdec)^T G; D = dO v^T (i < t, as
//   [i][t]) and S dO; the pairwise pass for dr and dk: lane (column q, g)
//   owns keys g, g + 8, ..., g + 56 (their k, a_i and dk sums in registers,
//   the triangle's work even across lanes within a ninth) and takes queries
//   four at a time, so that its four dr sums meet across the eight lanes of
//   the column by one reduce-scatter of four shuffles; G v and the dk
//   epilogue; last dlogw up each column.  The pairwise exponentials are
//   computed twice (A; dr and dk): fusing them would split one of the three
//   sums (over q, i or t) across warps.
//
// f32: `rwkv6_dstate_kernel`, `rwkv6_grad_kernel`, on the FP32 pipes (a
// tensor-core TF32 product keeps about three decimal digits):
//
// * `rwkv6_dstate_kernel`, grid (state-row tiles of 16, H, B), 256 threads:
//   the mirror of the forward's state pass.  Row q of G_prev needs only
//   column q of r and logw, exp(a_{L-1}[q]) and all of dO, so each block
//   carries a (16, K) slice of its (batch, head)'s gradient in registers
//   (4 cells a thread) and walks the chunks from the last to the first.  It
//   stores the gradient arriving at each chunk's end into an f32 scratch of
//   the forward scratch's shape (B, H, n_c, Kp, Kp) and the gradient of the
//   first chunk's start state into ds0.
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
//   backwards down each column into dlogw.  185 KB of shared memory: one
//   block of 16 warps an SM.  This was the bf16 design too before the
//   tensor-core kernels above (`scripts/rwkv6_bwd_sweep.py --baseline` times
//   it from an older checkout).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "rwkv6_mma.cuh"

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
__global__ void __launch_bounds__(THREADS)
rwkv6_dstate_kernel(const float* __restrict__ r, const float* __restrict__ logw,
                    const float* __restrict__ dout, const float* __restrict__ ds1,
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
    const float* rp = r + b * sr.b + h * sr.h;
    const float* wp = logw + b * sw.b + h * sw.h;
    const float* op = dout + b * so.b + h * so.h;
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
            rd[t * RTP + x] = in ? rp[(row0 + t) * sr.s + q0 + x] : 0.0f;
            cw[t * RTP + x] = in ? wp[(row0 + t) * sw.s + q0 + x] * LOG2E : 0.0f;
        }
        for (int e = tid; e < L * K; e += THREADS) {
            const int t = e / K, j = e % K;
            ds[t * PITCH + j] = op[(row0 + t) * so.s + j];
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
__global__ void __launch_bounds__(GT, 1)
rwkv6_grad_kernel(const float* __restrict__ r, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ logw,
                  const float* __restrict__ u, const float* __restrict__ states,
                  const float* __restrict__ dout, const float* __restrict__ dscratch,
                  float* __restrict__ dr, float* __restrict__ dk, float* __restrict__ dv,
                  float* __restrict__ dw, float* __restrict__ du_part,
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
        R[t * PITCH + j] = r[b * sr.b + h * sr.h + s * sr.s + j];
        KS[t * PITCH + j] = k[b * sk.b + h * sk.h + s * sk.s + j];
        VS[t * PITCH + j] = v[b * sv.b + h * sv.h + s * sv.s + j];
        CI[t * PITCH + j] = logw[b * sw.b + h * sw.h + s * sw.s + j] * LOG2E;
        DO[t * PITCH + j] = dout[b * so.b + h * so.h + s * so.s + j];
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
            if (j0 + x < K) dv[b * sdv.b + h * sdv.h + (row0 + i) * sdv.s + j0 + x] = a[x];
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
                    inter + acc + uq * KS[t * PITCH + q] * DD[t * PITCH + t];
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
                        dka[s][y] + R[i * PITCH + q] * uq * DD[i * PITCH + i] + kg;
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
// device, once a device (one bit a device in `opted_in`).  With
// `carveout`, it also asks for the largest shared-memory carveout, so that
// two such blocks share an SM.
template <typename Kern>
int opt_in(Kern kern, size_t smem, unsigned long long& opted_in, bool carveout = false) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
    if (!(opted_in >> dev & 1ULL)) {
        e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
        if (e == cudaSuccess && carveout)
            e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                                     cudaSharedmemCarveoutMaxShared);
        if (e != cudaSuccess) return static_cast<int>(e);
        opted_in |= 1ULL << dev;
    }
    return 0;
}

// One bit a device for each kernel's opt-in: the bf16 gradient and dstate
// kernels, then the f32 gradient kernel.
unsigned long long opted[3] = {0, 0, 0};

// The f32 call: the FP32-pipe dstate pass, then the gradient pass.
int launch_bwd_f32(void* const* p, const long long* st, int B, int H, int S, int K, int L,
                   cudaStream_t stream) {
    const int err = opt_in(rwkv6_grad_kernel, grad_smem_bytes(), opted[2]);
    if (err != 0) return err;
    Strides s[9];
    for (int x = 0; x < 9; ++x) s[x] = Strides{st[3 * x], st[3 * x + 1], st[3 * x + 2]};
    const int Kp = (K + 3) & ~3, nc = S / L;
    const float* r = static_cast<const float*>(p[0]);
    const float* dout = static_cast<const float*>(p[6]);
    float* dscratch = static_cast<float*>(p[14]);
    rwkv6_dstate_kernel<<<dim3((K + RT - 1) / RT, H, B), THREADS, dstate_smem_bytes(), stream>>>(
        r, static_cast<const float*>(p[3]), dout, static_cast<const float*>(p[7]), dscratch,
        static_cast<float*>(p[13]), s[0], s[3], s[4], H, S, K, L, Kp);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    rwkv6_grad_kernel<<<dim3(nc, H, B), GT, grad_smem_bytes(), stream>>>(
        r, static_cast<const float*>(p[1]), static_cast<const float*>(p[2]),
        static_cast<const float*>(p[3]), static_cast<const float*>(p[4]),
        static_cast<const float*>(p[5]), dout, dscratch, static_cast<float*>(p[8]),
        static_cast<float*>(p[9]), static_cast<float*>(p[10]), static_cast<float*>(p[11]),
        static_cast<float*>(p[12]), s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], H, K, L,
        Kp, nc);
    return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core design
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int TC_ST = 256;                 // threads of a bf16 dstate block
constexpr int TC_GT = 512;                 // threads of a bf16 gradient block
constexpr int BP = MAXD + 8;               // bf16 pitch of a [row][col] tile: 144-byte rows
constexpr int FP = MAXD + 4;               // f32 pitch: 272-byte rows
constexpr int TP = MAXD + 4;               // bf16 pitch of r and k transposed, [q][t]
constexpr int TILE_B = MAXD * BP * 2;      // bytes of a bf16 tile
constexpr int TILE_F = MAXD * FP * 4;      // bytes of an f32 array
constexpr int TILE_T = MAXD * TP * 2;      // bytes of a transposed bf16 array
constexpr unsigned FULL = 0xffffffffu;

// The dstate block's shared memory (bytes): two buffers of a chunk's r,
// dO and logw; r exp(cum_ex) in three bf16 parts,
// [q][t]; exp(a_{L-1}); the scan's segment sums.
constexpr int D_BUF = 2 * TILE_B + TILE_F;
constexpr int D_RD = 2 * D_BUF;
constexpr int D_DEC = D_RD + 3 * TILE_B;
constexpr int D_PART = D_DEC + 256;
constexpr int D_BYTES = D_PART + 1024;     // 100,608: two blocks an SM

// The gradient block's shared memory (bytes).  The staging area holds r,
// k and logw as they land, then A' (A with the bonus on its diagonal) and
// S, then D^T and X1 (S dO, then de), then X2 (the dk sums, then da) where
// D^T was.
constexpr int SP = MAXD + 8;               // f32 pitch of S: 288-byte rows
constexpr int G_DO = 0;                    // dO bf16 [t][BP]
constexpr int G_V = G_DO + TILE_B;         // v bf16 [i][BP]
constexpr int G_AT = G_V + TILE_B;         // f32 [q][FP]: 0, then cum_in[t] at t + 1 (log2
                                           // units), so cum_ex[t] = cum_in[t - 1] at t
constexpr int G_GS = G_AT + TILE_F;        // G f32 [q][FP], the gradient at the chunk's end
constexpr int G_RT = G_GS + TILE_F;        // r bf16 [q][TP]
constexpr int G_KT = G_RT + TILE_T;        // k bf16 [q][TP]
constexpr int G_U = G_KT + TILE_T;         // u f32 [64]
constexpr int G_LAST = G_U + 256;          // sum_j S[q][j] G[q][j] f32 [64]
constexpr int G_DD = G_LAST + 256;         // D[t][t] f32 [64]
constexpr int G_CS = G_DD + 256;           // sum_i k kdec (G v) by row tile, f32 [4][64]
constexpr int G_PART = G_CS + 1024;        // the scans' segment sums f32 [8][64]
constexpr int G_STAGE = G_PART + 2048;
constexpr int G_RB = G_STAGE;              // r bf16 [t][BP]            (staging)
constexpr int G_KB = G_RB + TILE_B;        // k bf16 [t][BP]            (staging)
constexpr int G_LW = G_KB + TILE_B;        // logw f32 [t][FP]          (staging)
constexpr int G_A = G_STAGE;               // A' f32 [t][FP]
constexpr int G_DT = G_STAGE;              // D^T f32 [i][FP] (i < t), then X2 [i][FP]
constexpr int G_X1 = G_STAGE + TILE_F;     // X1 f32 [t][FP]
constexpr int G_S = G_X1;                  // S f32 [q][SP], from the A pass until X1
constexpr int G_BYTES = G_LW + TILE_F;     // 110,336: two blocks an SM
static_assert(G_S + MAXD * SP * 4 <= G_BYTES, "S lies in the staging area");

__device__ __forceinline__ void unpack4(float (&o)[4], uint2 u) {
    o[0] = bf_lo(u.x);
    o[1] = bf_hi(u.x);
    o[2] = bf_lo(u.y);
    o[3] = bf_hi(u.y);
}
__device__ __forceinline__ float sel4(const float (&v)[4], int x) {
    return x == 0 ? v[0] : x == 1 ? v[1] : x == 2 ? v[2] : v[3];
}
__device__ __forceinline__ float bf_at(const uint16_t* p, int i) {
    return bf_lo(static_cast<uint32_t>(p[i]));
}

// The dstate pass, bf16: block (h, b) carries the (b, h)'s 64 x 64
// gradient in the mma accumulators: warp w the rows 16 (w % 4) .. + 15 and
// the NT = 4 n8 tiles of columns from 8 NT (w / 4).  Chunks in reverse;
// chunk c - 1 lands by cp.async while chunk c is computed.
__global__ void __launch_bounds__(TC_ST, 2)
rwkv6_dstate_tc_kernel(const bf16* __restrict__ r, const float* __restrict__ logw,
                       const bf16* __restrict__ dout, const float* __restrict__ ds1,
                       float* __restrict__ dscratch, float* __restrict__ ds0, Strides sr,
                       Strides sw, Strides so, int H, int S, int K, int L, int Kp, bool vec) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    constexpr int NT = 4;
    const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
    const int gr = lane >> 2, gc = 2 * (lane & 3);       // the fragments' row and column pair
    const int h = blockIdx.x, b = blockIdx.y;
    const int nc = S / L, mt = w & 3, nt0 = (w >> 2) * NT;
    const long long bh = static_cast<long long>(b) * H + h;
    const bf16* rp = r + b * sr.b + h * sr.h;
    const float* wp = logw + b * sw.b + h * sw.h;
    const bf16* op = dout + b * so.b + h * so.h;
    float* dec = reinterpret_cast<float*>(smem_raw + D_DEC);
    float* part = reinterpret_cast<float*>(smem_raw + D_PART);

    // zeros past L and K
    auto stage = [&](int c, int buf) {
        unsigned char* base = smem_raw + buf * D_BUF;
        bf16* rs = reinterpret_cast<bf16*>(base);
        bf16* os = reinterpret_cast<bf16*>(base + TILE_B);
        float* ws = reinterpret_cast<float*>(base + 2 * TILE_B);
        const long long row0 = static_cast<long long>(c) * L;
        if (vec) {
            for (int e = tid; e < MAXD * 8; e += TC_ST) {
                const int t = e >> 3, p = 8 * (e & 7);
                const bool in = t < L && p < K;
                cp_async16(smem_u32(rs + t * BP + p), in ? rp + (row0 + t) * sr.s + p : rp, in);
                cp_async16(smem_u32(os + t * BP + p), in ? op + (row0 + t) * so.s + p : op, in);
            }
            for (int e = tid; e < MAXD * 16; e += TC_ST) {
                const int t = e >> 4, p = 4 * (e & 15);
                const bool in = t < L && p < K;
                cp_async16(smem_u32(ws + t * FP + p), in ? wp + (row0 + t) * sw.s + p : wp, in);
            }
        } else {
            const bf16 zero = __float2bfloat16_rn(0.0f);
            for (int e = tid; e < MAXD * MAXD; e += TC_ST) {
                const int t = e >> 6, q = e & 63;
                const bool in = t < L && q < K;
                rs[t * BP + q] = in ? rp[(row0 + t) * sr.s + q] : zero;
                os[t * BP + q] = in ? op[(row0 + t) * so.s + q] : zero;
                ws[t * FP + q] = in ? wp[(row0 + t) * sw.s + q] : 0.0f;
            }
        }
    };

    float acc[NT][4];
#pragma unroll
    for (int s = 0; s < NT; ++s)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int q = 16 * mt + gr + 8 * (e >> 1), j = 8 * (nt0 + s) + gc + (e & 1);
            acc[s][e] = q < K && j < K ? ds1[bh * K * K + q * K + j] : 0.0f;
        }
    stage(nc - 1, 0);
    cp_async_commit();
    const uint32_t rd = smem_u32(smem_raw + D_RD);
    const int sq = tid & 63, seg = tid >> 6;            // the scan: column sq, rows 16 seg ..
    for (int c = nc - 1, it = 0; c >= 0; --c, ++it) {
        const int buf = it & 1;
        cp_async_wait_all();                 // chunk c has landed ...
        __syncthreads();                     // ... for every thread, and all are done with chunk c + 1
        if (c > 0) stage(c - 1, buf ^ 1);
        cp_async_commit();
        float* scr = dscratch + (bh * nc + c) * Kp * Kp;
#pragma unroll
        for (int s = 0; s < NT; ++s)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int q = 16 * mt + gr + 8 * (e >> 1), j = 8 * (nt0 + s) + gc + (e & 1);
                if (q < K && j < K) scr[q * Kp + j] = acc[s][e];
            }

        // cum_ex down column sq (exclusive sums of logw, log2 units), then
        // r exp(cum_ex) in three bf16 parts, [q][t]
        const unsigned char* base = smem_raw + buf * D_BUF;
        const bf16* rs = reinterpret_cast<const bf16*>(base);
        const float* ws = reinterpret_cast<const float*>(base + 2 * TILE_B);
        float ex[16];
        float run = 0.0f;
#pragma unroll
        for (int x = 0; x < 16; ++x) {
            ex[x] = run;
            run += ws[(16 * seg + x) * FP + sq] * LOG2E;
        }
        part[seg * MAXD + sq] = run;
        __syncthreads();
        float off = 0.0f;
        for (int s2 = 0; s2 < seg; ++s2) off += part[s2 * MAXD + sq];
        uint32_t ph[8], pm[8], pl[8];
#pragma unroll
        for (int x = 0; x < 16; x += 2) {
            const int t = 16 * seg + x;
            const Split3 sp = split3(__bfloat162float(rs[t * BP + sq]) * ex2(off + ex[x]),
                                     __bfloat162float(rs[(t + 1) * BP + sq]) * ex2(off + ex[x + 1]));
            ph[x / 2] = sp.h;
            pm[x / 2] = sp.m;
            pl[x / 2] = sp.l;
        }
        uint4* dst = reinterpret_cast<uint4*>(smem_raw + D_RD + (sq * BP + 16 * seg) * 2);
        constexpr int TU = TILE_B / 16;      // a tile in uint4
        dst[0] = uint4{ph[0], ph[1], ph[2], ph[3]};
        dst[1] = uint4{ph[4], ph[5], ph[6], ph[7]};
        dst[TU] = uint4{pm[0], pm[1], pm[2], pm[3]};
        dst[TU + 1] = uint4{pm[4], pm[5], pm[6], pm[7]};
        dst[2 * TU] = uint4{pl[0], pl[1], pl[2], pl[3]};
        dst[2 * TU + 1] = uint4{pl[4], pl[5], pl[6], pl[7]};
        if (seg == 0)                        // rows past L add nothing: a_{L-1} is the column's sum
            dec[sq] = ex2(part[sq] + part[MAXD + sq] + part[2 * MAXD + sq] + part[3 * MAXD + sq]);
        __syncthreads();

        // G <- exp(a_{L-1}) G + (r exp(cum_ex))^T dO
        const float d0 = dec[16 * mt + gr], d1 = dec[16 * mt + gr + 8];
#pragma unroll
        for (int s = 0; s < NT; ++s)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[s][e] *= e < 2 ? d0 : d1;
        const uint32_t os = smem_u32(base + TILE_B);
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
            if (16 * ks >= L) break;
            uint32_t ah[4], am[4], al[4];
            const uint32_t a_at = rd + ((16 * mt + (lane & 15)) * BP + 16 * ks + (lane >> 4) * 8) * 2;
            ldsm_x4(ah, a_at);
            ldsm_x4(am, a_at + TILE_B);
            ldsm_x4(al, a_at + 2 * TILE_B);
#pragma unroll
            for (int p = 0; p < NT / 2; ++p) {
                uint32_t bb[4];
                ldsm_x4_t(bb, os + ((16 * ks + (lane & 7) + ((lane >> 3) & 1) * 8) * BP +
                                    8 * (nt0 + 2 * p) + (lane >> 4) * 8) * 2);
#pragma unroll
                for (int y = 0; y < 2; ++y) {
                    mma(acc[2 * p + y], al, bb[2 * y], bb[2 * y + 1]);
                    mma(acc[2 * p + y], am, bb[2 * y], bb[2 * y + 1]);
                    mma(acc[2 * p + y], ah, bb[2 * y], bb[2 * y + 1]);
                }
            }
        }
    }
#pragma unroll
    for (int s = 0; s < NT; ++s)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int q = 16 * mt + gr + 8 * (e >> 1), j = 8 * (nt0 + s) + gc + (e & 1);
            if (q < K && j < K) ds0[bh * K * K + q * K + j] = acc[s][e];
        }
}

// The gradient pass, bf16: block (c, h, b) computes chunk c of (b, h) from
// the state it starts from (`states`) and the gradient at its end
// (`dscratch`), in the phases of the note at the top, each after a barrier.
__global__ void __launch_bounds__(TC_GT, 2)
rwkv6_grad_tc_kernel(const bf16* __restrict__ r, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const float* __restrict__ logw,
                     const float* __restrict__ u, const float* __restrict__ states,
                     const bf16* __restrict__ dout, const float* __restrict__ dscratch,
                     bf16* __restrict__ dr, bf16* __restrict__ dk, bf16* __restrict__ dv,
                     float* __restrict__ dw, float* __restrict__ du_part, Strides sr, Strides sk,
                     Strides sv, Strides sw, Strides so, Strides sdr, Strides sdk, Strides sdv,
                     Strides sdw, int H, int K, int L, int Kp, int nc, bool vec) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* DOs = reinterpret_cast<bf16*>(smem_raw + G_DO);
    bf16* Vs = reinterpret_cast<bf16*>(smem_raw + G_V);
    float* AT = reinterpret_cast<float*>(smem_raw + G_AT);
    float* GS = reinterpret_cast<float*>(smem_raw + G_GS);
    uint16_t* RT = reinterpret_cast<uint16_t*>(smem_raw + G_RT);
    uint16_t* KT = reinterpret_cast<uint16_t*>(smem_raw + G_KT);
    float* us = reinterpret_cast<float*>(smem_raw + G_U);
    float* last = reinterpret_cast<float*>(smem_raw + G_LAST);
    float* Dd = reinterpret_cast<float*>(smem_raw + G_DD);
    float* cs = reinterpret_cast<float*>(smem_raw + G_CS);
    float* part = reinterpret_cast<float*>(smem_raw + G_PART);
    bf16* RB = reinterpret_cast<bf16*>(smem_raw + G_RB);
    bf16* KB = reinterpret_cast<bf16*>(smem_raw + G_KB);
    float* LW = reinterpret_cast<float*>(smem_raw + G_LW);
    float* Ap = reinterpret_cast<float*>(smem_raw + G_A);
    float* DT = reinterpret_cast<float*>(smem_raw + G_DT);
    float* X1 = reinterpret_cast<float*>(smem_raw + G_X1);
    float* SS = reinterpret_cast<float*>(smem_raw + G_S);
    float* X2 = DT;

    const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
    const int gr = lane >> 2, gc = 2 * (lane & 3);       // the fragments' row and column pair
    const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const long long row0 = static_cast<long long>(c) * L;
    const long long bh = static_cast<long long>(b) * H + h;
    const float* Sg = states + (bh * nc + c) * Kp * Kp;
    const float* Gg = dscratch + (bh * nc + c) * Kp * Kp;
    // a K x K f32 matrix of pitch Kp into shared memory at pitch `pitch`,
    // zeros past K: 16-byte copies when K % 4 == 0, else plain loads
    auto stage_kk = [&](float* dst, const float* src, int pitch) {
        if (K % 4 == 0) {
            for (int e = tid; e < MAXD * 16; e += TC_GT) {
                const int q = e >> 4, p = 4 * (e & 15);
                const bool in = q < K && p < K;
                cp_async16(smem_u32(dst + q * pitch + p), in ? src + q * Kp + p : src, in);
            }
        } else {
            for (int e = tid; e < MAXD * MAXD; e += TC_GT) {
                const int q = e >> 6, j = e & 63;
                dst[q * pitch + j] = q < K && j < K ? src[q * Kp + j] : 0.0f;
            }
        }
    };

    // 0. stage the chunk: r, k, v, dO (bf16), logw and G (f32), zeros past L and K
    {
        const bf16* rp = r + b * sr.b + h * sr.h + row0 * sr.s;
        const bf16* kp = k + b * sk.b + h * sk.h + row0 * sk.s;
        const bf16* vp = v + b * sv.b + h * sv.h + row0 * sv.s;
        const bf16* op = dout + b * so.b + h * so.h + row0 * so.s;
        const float* wp = logw + b * sw.b + h * sw.h + row0 * sw.s;
        if (vec) {
            const int t = tid >> 3, p = 8 * (tid & 7);   // a 16-byte piece a thread and array
            const bool in = t < L && p < K;
            cp_async16(smem_u32(RB + t * BP + p), in ? rp + t * sr.s + p : rp, in);
            cp_async16(smem_u32(KB + t * BP + p), in ? kp + t * sk.s + p : kp, in);
            cp_async16(smem_u32(Vs + t * BP + p), in ? vp + t * sv.s + p : vp, in);
            cp_async16(smem_u32(DOs + t * BP + p), in ? op + t * so.s + p : op, in);
#pragma unroll
            for (int x = 0; x < 2; ++x) {
                const int e = tid + x * TC_GT, tw = e >> 4, pw = 4 * (e & 15);
                const bool iw = tw < L && pw < K;
                cp_async16(smem_u32(LW + tw * FP + pw), iw ? wp + tw * sw.s + pw : wp, iw);
            }
        } else {
            const bf16 zero = __float2bfloat16_rn(0.0f);
            for (int e = tid; e < MAXD * MAXD; e += TC_GT) {
                const int t = e >> 6, q = e & 63;
                const bool in = t < L && q < K;
                RB[t * BP + q] = in ? rp[t * sr.s + q] : zero;
                KB[t * BP + q] = in ? kp[t * sk.s + q] : zero;
                Vs[t * BP + q] = in ? vp[t * sv.s + q] : zero;
                DOs[t * BP + q] = in ? op[t * so.s + q] : zero;
                LW[t * FP + q] = in ? wp[t * sw.s + q] : 0.0f;
            }
        }
        stage_kk(GS, Gg, FP);
        cp_async_commit();
        if (tid < MAXD) us[tid] = tid < K ? u[h * K + tid] : 0.0f;
        cp_async_wait_all();
        __syncthreads();
    }

    // 1. cum_in down each column (thread (q, 8 rows)) as [q][t + 1]; r and
    // k transposed to [q][t]
    {
        const int q = tid & 63, seg = tid >> 6;
        float lw[8], pre[8];
        float acc = 0.0f;
#pragma unroll
        for (int x = 0; x < 8; ++x) {
            lw[x] = LW[(8 * seg + x) * FP + q] * LOG2E;
            acc += lw[x];
            pre[x] = acc;
        }
        part[seg * MAXD + q] = acc;
        const int t = tid >> 3, p = 8 * (tid & 7);
        const uint4 rv = *reinterpret_cast<const uint4*>(RB + t * BP + p);
        const uint4 kv = *reinterpret_cast<const uint4*>(KB + t * BP + p);
        const uint32_t rw[4] = {rv.x, rv.y, rv.z, rv.w}, kw[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
        for (int y = 0; y < 4; ++y) {
            RT[(p + 2 * y) * TP + t] = static_cast<uint16_t>(rw[y] & 0xffffu);
            RT[(p + 2 * y + 1) * TP + t] = static_cast<uint16_t>(rw[y] >> 16);
            KT[(p + 2 * y) * TP + t] = static_cast<uint16_t>(kw[y] & 0xffffu);
            KT[(p + 2 * y + 1) * TP + t] = static_cast<uint16_t>(kw[y] >> 16);
        }
        __syncthreads();
        float off = 0.0f;
        for (int s2 = 0; s2 < seg; ++s2) off += part[s2 * MAXD + q];
#pragma unroll
        for (int x = 0; x < 8; ++x) AT[q * FP + 8 * seg + x + 1] = off + pre[x];
        if (seg == 0) AT[q * FP] = 0.0f;
        __syncthreads();
    }
    stage_kk(SS, Sg, SP);                    // lands during the A pass and dv
    cp_async_commit();

    // 2. A' (t >= i): warps 0-14 the 120 4x4 tiles below the diagonal, a
    // lane a tile and a quarter of the key columns; warp 15 the 16 diagonal
    // tiles (t > i within them) and the bonus, a lane a tile and half
    {
        if (w < 15) {
            int tb, ib;
            pair_of(8 * w + (lane & 7), tb, ib);
            const int z = lane >> 3;
            float acc[16];
#pragma unroll
            for (int x = 0; x < 16; ++x) acc[x] = 0.0f;
            if (4 * tb < L) {
                const int q1 = min(16 * z + 16, K);
                for (int q = 16 * z; q < q1; ++q) {
                    const float4 e4 = *reinterpret_cast<const float4*>(AT + q * FP + 4 * tb);
                    const float4 a4 = *reinterpret_cast<const float4*>(AT + q * FP + 4 * ib);
                    const float ee[4] = {e4.x, e4.y, e4.z, e4.w},
                                aa[4] = {a4.y, a4.z, a4.w, AT[q * FP + 4 * ib + 4]};
                    float re[4], ke[4];
                    unpack4(re, *reinterpret_cast<const uint2*>(RT + q * TP + 4 * tb));
                    unpack4(ke, *reinterpret_cast<const uint2*>(KT + q * TP + 4 * ib));
#pragma unroll
                    for (int x = 0; x < 4; ++x)
#pragma unroll
                        for (int y = 0; y < 4; ++y)
                            acc[4 * x + y] =
                                fmaf(re[x] * ke[y], ex2(clip2(ee[x] - aa[y])), acc[4 * x + y]);
                }
            }
            // the quarters' sums: a reduce-scatter over lanes ^ 16 and ^ 8
            const int h1 = (lane >> 4) & 1, h0 = (lane >> 3) & 1;
            float v8[8], v4[4];
#pragma unroll
            for (int m = 0; m < 8; ++m) {
                const float keep = h1 ? acc[8 + m] : acc[m], send = h1 ? acc[m] : acc[8 + m];
                v8[m] = keep + __shfl_xor_sync(FULL, send, 16);
            }
#pragma unroll
            for (int m = 0; m < 4; ++m) {
                const float keep = h0 ? v8[4 + m] : v8[m], send = h0 ? v8[m] : v8[4 + m];
                v4[m] = keep + __shfl_xor_sync(FULL, send, 8);
            }
            *reinterpret_cast<float4*>(Ap + (4 * tb + 2 * h1 + h0) * FP + 4 * ib) =
                float4{v4[0], v4[1], v4[2], v4[3]};
        } else {
            const int d = lane & 15, hz = lane >> 4;
            float acc[10];
#pragma unroll
            for (int x = 0; x < 10; ++x) acc[x] = 0.0f;
            if (4 * d < L) {
                const int q1 = min(32 * hz + 32, K);
                for (int q = 32 * hz; q < q1; ++q) {
                    const float4 e4 = *reinterpret_cast<const float4*>(AT + q * FP + 4 * d);
                    const float ee[4] = {e4.x, e4.y, e4.z, e4.w},
                                aa[4] = {e4.y, e4.z, e4.w, AT[q * FP + 4 * d + 4]};
                    float re[4], ke[4];
                    unpack4(re, *reinterpret_cast<const uint2*>(RT + q * TP + 4 * d));
                    unpack4(ke, *reinterpret_cast<const uint2*>(KT + q * TP + 4 * d));
                    int n = 0;
#pragma unroll
                    for (int x = 1; x < 4; ++x)
#pragma unroll
                        for (int y = 0; y < x; ++y, ++n)
                            acc[n] = fmaf(re[x] * ke[y], ex2(clip2(ee[x] - aa[y])), acc[n]);
                    const float uq = us[q];
#pragma unroll
                    for (int x = 0; x < 4; ++x) acc[6 + x] = fmaf(re[x] * uq, ke[x], acc[6 + x]);
                }
            }
#pragma unroll
            for (int x = 0; x < 10; ++x) acc[x] += __shfl_xor_sync(FULL, acc[x], 16);
            if (hz == 0) {
                float* blk = Ap + 4 * d * FP + 4 * d;          // A'[4 d + x][4 d + y]
                int n = 0;
#pragma unroll
                for (int x = 1; x < 4; ++x)
#pragma unroll
                    for (int y = 0; y < x; ++y, ++n) blk[x * FP + y] = acc[n];
#pragma unroll
                for (int x = 0; x < 4; ++x) blk[x * FP + x] = acc[6 + x];
            }
        }
        __syncthreads();
    }

    // 3. dv = A'^T dO + (k kdec)^T G: warp (row tile i, 16 columns j)
    {
        const int mi = w >> 2, i0 = 16 * mi, n0 = 16 * (w & 3);
        float acc[2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
        const uint32_t dos = smem_u32(DOs);
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
            if (ks < mi || 16 * ks >= L) continue;       // t >= i, t < L
            uint32_t ah[4], am[4], al[4];
#pragma unroll
            for (int rr = 0; rr < 4; ++rr) {
                const int i = i0 + gr + 8 * (rr & 1), t = 16 * ks + gc + 8 * (rr >> 1);
                const Split3 sp = split3(t >= i && t < L ? Ap[t * FP + i] : 0.0f,
                                         t + 1 >= i && t + 1 < L ? Ap[(t + 1) * FP + i] : 0.0f);
                ah[rr] = sp.h;
                am[rr] = sp.m;
                al[rr] = sp.l;
            }
            uint32_t bb[4];
            ldsm_x4_t(bb, dos + ((16 * ks + (lane & 7) + ((lane >> 3) & 1) * 8) * BP + n0 +
                                 (lane >> 4) * 8) * 2);
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
                mma(acc[nt], al, bb[2 * nt], bb[2 * nt + 1]);
                mma(acc[nt], am, bb[2 * nt], bb[2 * nt + 1]);
                mma(acc[nt], ah, bb[2 * nt], bb[2 * nt + 1]);
            }
        }
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
            if (16 * ks >= K) continue;
            uint32_t ah[4], am[4], al[4];
#pragma unroll
            for (int rr = 0; rr < 4; ++rr) {
                const int i = i0 + gr + 8 * (rr & 1), q = 16 * ks + gc + 8 * (rr >> 1);
                const float* aq = AT + q * FP;
                const Split3 sp = split3(
                    bf_at(KT, q * TP + i) * ex2(clip2(aq[L] - aq[i + 1])),
                    bf_at(KT, (q + 1) * TP + i) * ex2(clip2(aq[FP + L] - aq[FP + i + 1])));
                ah[rr] = sp.h;
                am[rr] = sp.m;
                al[rr] = sp.l;
            }
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
                const float* gq = GS + (16 * ks + gc) * FP + n0 + 8 * nt + gr;   // G[q][j]
                const Split3 b0 = split3(gq[0], gq[FP]);
                const Split3 b1 = split3(gq[8 * FP], gq[9 * FP]);
                mma(acc[nt], al, b0.h, b1.h);
                mma(acc[nt], am, b0.m, b1.m);
                mma(acc[nt], ah, b0.l, b1.l);
                mma(acc[nt], am, b0.h, b1.h);
                mma(acc[nt], ah, b0.m, b1.m);
                mma(acc[nt], ah, b0.h, b1.h);
            }
        }
        bf16* dvp = dv + b * sdv.b + h * sdv.h + row0 * sdv.s;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int i = i0 + gr + 8 * (e >> 1), j = n0 + 8 * nt + gc + (e & 1);
                if (i < L && j < K) dvp[i * sdv.s + j] = __float2bfloat16_rn(acc[nt][e]);
            }
        cp_async_wait_all();                 // S has landed ...
        __syncthreads();                     // ... and A' is read
    }

    // 4. D = dO v^T (i < t, as D^T [i][t]; D[t][t] apart) and X1 = S dO,
    // warp (row tile t, 16 columns i or q); sum_j S G in the warps of tile 0
    {
        const int mt = w >> 2, t0 = 16 * mt, c0 = 16 * (w & 3);
        const bool lower = (w & 3) <= mt;
        float dd[2][4], sd[2][4], sg[2] = {0.0f, 0.0f};
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) dd[nt][e] = sd[nt][e] = 0.0f;
        const uint32_t dos = smem_u32(DOs), vs = smem_u32(Vs);
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
            if (16 * ks >= K) continue;
            uint32_t a[4];
            ldsm_x4(a, dos + ((t0 + (lane & 15)) * BP + 16 * ks + (lane >> 4) * 8) * 2);
            if (lower) {
                uint32_t bb[4];
                ldsm_x4(bb, vs + ((c0 + (lane & 7) + (lane >> 4) * 8) * BP + 16 * ks +
                                  ((lane >> 3) & 1) * 8) * 2);
                mma(dd[0], a, bb[0], bb[1]);
                mma(dd[1], a, bb[2], bb[3]);
            }
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
                const int q = c0 + 8 * nt + gr, j = 16 * ks + gc;
                const float2 s0 = *reinterpret_cast<const float2*>(SS + q * SP + j);
                const float2 s1 = *reinterpret_cast<const float2*>(SS + q * SP + j + 8);
                const Split3 b0 = split3(s0.x, s0.y), b1 = split3(s1.x, s1.y);
                mma(sd[nt], a, b0.l, b1.l);
                mma(sd[nt], a, b0.m, b1.m);
                mma(sd[nt], a, b0.h, b1.h);
                if (mt == 0) {
                    const float2 g0 = *reinterpret_cast<const float2*>(GS + q * FP + j);
                    const float2 g1 = *reinterpret_cast<const float2*>(GS + q * FP + j + 8);
                    sg[nt] += s0.x * g0.x + s0.y * g0.y + s1.x * g1.x + s1.y * g1.y;
                }
            }
        }
        if (mt == 0) {
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
                float x = sg[nt] + __shfl_xor_sync(FULL, sg[nt], 1);
                x += __shfl_xor_sync(FULL, x, 2);
                if ((lane & 3) == 0) last[c0 + 8 * nt + gr] = x;
            }
        }
        __syncthreads();                     // S is read; X1 takes its place
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int t = t0 + gr + 8 * (e >> 1), col = c0 + 8 * nt + gc + (e & 1);
                const float d = lower ? dd[nt][e] : 0.0f;
                DT[col * FP + t] = col < t ? d : 0.0f;
                if (col == t) Dd[t] = d;
                X1[t * FP + col] = sd[nt][e];
            }
        __syncthreads();
    }

    // 5. the pairs for dr and dk: lane (column q, g) owns keys g + 8 n; four
    // queries at a time, their dr sums met by a reduce-scatter over the
    // column's eight lanes; then dr and de (into X1)
    {
        const int q = 4 * w + (lane >> 3), g = lane & 7;
        const float* eq = AT + q * FP;            // cum_ex[t] at t
        const uint16_t* rq = RT + q * TP;
        const uint16_t* kq = KT + q * TP;
        float kn[8], an[8], dkn[8];
#pragma unroll
        for (int n = 0; n < 8; ++n) {
            kn[n] = bf_at(kq, g + 8 * n);
            an[n] = eq[g + 8 * n + 1];
            dkn[n] = 0.0f;
        }
        const float uq = us[q];
        const int b2 = (g >> 2) & 1, b1 = (g >> 1) & 1, xo = 2 * b2 + b1;
        bf16* drp = dr + b * sdr.b + h * sdr.h + row0 * sdr.s + q;
        for (int t0 = 0; t0 < L; t0 += 4) {
            const float4 e4 = *reinterpret_cast<const float4*>(eq + t0);
            const float ee[4] = {e4.x, e4.y, e4.z, e4.w};
            float re[4];
            unpack4(re, *reinterpret_cast<const uint2*>(rq + t0));
            float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
            for (int n = 0; n < 8; ++n) {
                if (8 * n >= t0 + 3) break;      // no key g + 8 n below these queries
                const float4 d4 = *reinterpret_cast<const float4*>(DT + (g + 8 * n) * FP + t0);
                const float dd[4] = {d4.x, d4.y, d4.z, d4.w};   // 0 where i >= t
#pragma unroll
                for (int x = 0; x < 4; ++x) {
                    const float wv = ex2(clip2(ee[x] - an[n])) * dd[x];
                    acc[x] = fmaf(kn[n], wv, acc[x]);
                    dkn[n] = fmaf(re[x], wv, dkn[n]);
                }
            }
            float k0 = b2 ? acc[2] : acc[0], k1 = b2 ? acc[3] : acc[1];
            k0 += __shfl_xor_sync(FULL, b2 ? acc[0] : acc[2], 4);
            k1 += __shfl_xor_sync(FULL, b2 ? acc[1] : acc[3], 4);
            float sum = b1 ? k1 : k0;
            sum += __shfl_xor_sync(FULL, b1 ? k0 : k1, 2);
            sum += __shfl_xor_sync(FULL, sum, 1);
            const int t = t0 + xo;
            if (!(g & 1) && t < L && q < K) {
                const float inter = ex2(sel4(ee, xo)) * X1[t * FP + q];
                drp[t * sdr.s] = __float2bfloat16_rn(inter + sum + uq * bf_at(kq, t) * Dd[t]);
                X1[t * FP + q] = sel4(re, xo) * (inter + sum);
            }
        }
        __syncthreads();                     // D^T is read; X2 takes its place
#pragma unroll
        for (int n = 0; n < 8; ++n) X2[(g + 8 * n) * FP + q] = dkn[n];
        __syncthreads();
    }

    // 6. G v, then dk and da (into X2) and each row tile's sum_i k kdec (G v)
    {
        const int mi = w >> 2, i0 = 16 * mi, c0 = 16 * (w & 3);
        float gv[2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) gv[nt][e] = 0.0f;
        const uint32_t vs = smem_u32(Vs);
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
            if (16 * ks >= K) continue;
            uint32_t a[4];
            ldsm_x4(a, vs + ((i0 + (lane & 15)) * BP + 16 * ks + (lane >> 4) * 8) * 2);
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
                const float* gq = GS + (c0 + 8 * nt + gr) * FP + 16 * ks + gc;   // G[q][j]
                const float2 g0 = *reinterpret_cast<const float2*>(gq);
                const float2 g1 = *reinterpret_cast<const float2*>(gq + 8);
                const Split3 b0 = split3(g0.x, g0.y), b1 = split3(g1.x, g1.y);
                mma(gv[nt], a, b0.l, b1.l);
                mma(gv[nt], a, b0.m, b1.m);
                mma(gv[nt], a, b0.h, b1.h);
            }
        }
        bf16* dkp = dk + b * sdk.b + h * sdk.h + row0 * sdk.s;
        float col[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int i = i0 + gr + 8 * (e >> 1), q = c0 + 8 * nt + gc + (e & 1);
                if (i < L && q < K) {
                    const float kg = ex2(clip2(AT[q * FP + L] - AT[q * FP + i + 1])) * gv[nt][e];
                    const float pair = X2[i * FP + q], ki = bf_at(KT, q * TP + i);
                    dkp[i * sdk.s + q] =
                        __float2bfloat16_rn(pair + bf_at(RT, q * TP + i) * us[q] * Dd[i] + kg);
                    X2[i * FP + q] = -ki * (pair + kg);
                    col[nt][e & 1] += ki * kg;
                }
            }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int y = 0; y < 2; ++y) {
                float s = col[nt][y] + __shfl_xor_sync(FULL, col[nt][y], 4);
                s += __shfl_xor_sync(FULL, s, 8);
                s += __shfl_xor_sync(FULL, s, 16);
                if (lane < 4) cs[mi * MAXD + c0 + 8 * nt + 2 * lane + y] = s;
            }
        __syncthreads();
    }

    // 7. the last step's exponent also scales the state's decay and every
    // state update; du's share of this (batch, chunk)
    if (tid < K) {
        float a = ex2(AT[tid * FP + L]) * last[tid];
        for (int m = 0; m < 4; ++m) a += cs[m * MAXD + tid];
        X2[(L - 1) * FP + tid] += a;
    } else if (tid >= MAXD && tid - MAXD < K) {
        const int q = tid - MAXD;
        float a = 0.0f;
        for (int t = 0; t < L; ++t) a += bf_at(RT, q * TP + t) * bf_at(KT, q * TP + t) * Dd[t];
        du_part[((static_cast<long long>(b) * nc + c) * H + h) * K + q] = a;
    }
    __syncthreads();

    // 8. dlogw_s = sum_{t>=s} (da_t + de_t) - de_s, up each column
    {
        const int q = tid & 63, seg = tid >> 6;
        float rev[8];
        float acc = 0.0f;
#pragma unroll
        for (int x = 7; x >= 0; --x) {
            const int t = 8 * seg + x;
            if (q < K && t < L) acc += X2[t * FP + q] + X1[t * FP + q];
            rev[x] = acc;
        }
        part[seg * MAXD + q] = acc;
        __syncthreads();
        float off = 0.0f;
        for (int s2 = seg + 1; s2 < 8; ++s2) off += part[s2 * MAXD + q];
        if (q < K) {
            float* dwp = dw + b * sdw.b + h * sdw.h + row0 * sdw.s + q;
#pragma unroll
            for (int x = 0; x < 8; ++x) {
                const int t = 8 * seg + x;
                if (t < L) dwp[t * sdw.s] = off + rev[x] - X1[t * FP + q];
            }
        }
    }
}

bool aligned16(const void* p, const Strides& s, long long elt) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (s.b * elt) % 16 == 0 &&
           (s.h * elt) % 16 == 0 && (s.s * elt) % 16 == 0;
}

int opt_in_tc() {
    const int err = opt_in(rwkv6_grad_tc_kernel, G_BYTES, opted[0], true);
    return err != 0 ? err : opt_in(rwkv6_dstate_tc_kernel, D_BYTES, opted[1], true);
}

// The bf16 call: the tensor-core dstate pass, then the gradient pass.
int launch_bwd_tc(void* const* p, const long long* st, int B, int H, int S, int K, int L,
                  cudaStream_t stream) {
    const int err = opt_in_tc();
    if (err != 0) return err;
    Strides s[9];
    for (int x = 0; x < 9; ++x) s[x] = Strides{st[3 * x], st[3 * x + 1], st[3 * x + 2]};
    const int Kp = (K + 3) & ~3, nc = S / L;
    const bool vec = K % 8 == 0 && aligned16(p[0], s[0], 2) && aligned16(p[1], s[1], 2) &&
                     aligned16(p[2], s[2], 2) && aligned16(p[6], s[4], 2) &&
                     aligned16(p[3], s[3], 4);
    const bf16* r = static_cast<const bf16*>(p[0]);
    const bf16* dout = static_cast<const bf16*>(p[6]);
    const float* logw = static_cast<const float*>(p[3]);
    const float* ds1 = static_cast<const float*>(p[7]);
    float* dscratch = static_cast<float*>(p[14]);
    float* ds0 = static_cast<float*>(p[13]);
    rwkv6_dstate_tc_kernel<<<dim3(H, B), TC_ST, D_BYTES, stream>>>(
        r, logw, dout, ds1, dscratch, ds0, s[0], s[3], s[4], H, S, K, L, Kp, vec);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    rwkv6_grad_tc_kernel<<<dim3(nc, H, B), TC_GT, G_BYTES, stream>>>(
        r, static_cast<const bf16*>(p[1]), static_cast<const bf16*>(p[2]), logw,
        static_cast<const float*>(p[4]), static_cast<const float*>(p[5]), dout, dscratch,
        static_cast<bf16*>(p[8]), static_cast<bf16*>(p[9]), static_cast<bf16*>(p[10]),
        static_cast<float*>(p[11]), static_cast<float*>(p[12]), s[0], s[1], s[2], s[3], s[4],
        s[5], s[6], s[7], s[8], H, K, L, Kp, nc, vec);
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
// values).  K <= 64, L <= 64, S % L == 0.  bf16 runs the tensor-core
// kernels, f32 the FP32-pipe ones.  Launches the two kernels on `stream`
// and returns cudaGetLastError() (0 = launched).
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
    if (dtype == 0) return launch_bwd_f32(p, strides, B, H, S, K, L, st);
    if (dtype == 1) return launch_bwd_tc(p, strides, B, H, S, K, L, st);
    return static_cast<int>(cudaErrorInvalidValue);
}

// Resident blocks an SM on the current device, from the occupancy API
// after each kernel's opt-in: blocks[0] the bf16 gradient kernel, [1] the
// bf16 dstate kernel, [2] the f32 gradient kernel, [3] the f32 dstate
// kernel.  Returns 0 or a CUDA error.
extern "C" int rwkv6_scan_bwd_occupancy(int* blocks) {
    int err = opt_in_tc();
    if (err == 0) err = opt_in(rwkv6_grad_kernel, grad_smem_bytes(), opted[2]);
    if (err != 0) return err;
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks[0], rwkv6_grad_tc_kernel,
                                                                  TC_GT, G_BYTES);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks[1], rwkv6_dstate_tc_kernel,
                                                          TC_ST, D_BYTES);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks[2], rwkv6_grad_kernel, GT,
                                                          grad_smem_bytes());
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks[3], rwkv6_dstate_kernel,
                                                          THREADS, dstate_smem_bytes());
    return static_cast<int>(e);
}
