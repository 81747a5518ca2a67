// rwkv6_scan.cu — the RWKV6 WKV recurrence (chunked linear attention with
// data-dependent decay) as CUDA kernels for Hopper (sm_90a).  They replace
// the TPU kernel `rwkv6_scan` of the JAX package
// (src/repro/kernels/rwkv6_scan/rwkv6_scan.py:85, pl.pallas_call at :103),
// whose grid walked the chunks of one (batch, head) in order on one core
// and carried the (K, K) f32 state in VMEM scratch from one grid step to
// the next.
//
// Per chunk of L = min(chunk, S) steps every kernel here computes what the
// reference computes:
//
//   cum_in = cumsum(logw) over the chunk, cum_ex = cum_in - logw
//   A[t,i] = sum_k r[t,k] k[i,k] exp(clip(cum_ex[t,k] - cum_in[i,k], -60, 0))   (t > i only)
//   out    = (r exp(cum_ex)) @ S0 + A @ v + (sum_k r u k) v
//   S1     = S0 exp(total)[:, None] + (k exp(clip(total - cum_in, -60, 0)))^T @ v
//
// clipping exactly where the reference clips; `out` is rounded to r's type
// once, at the end; every sum runs in f32.  Four kernels, three routes
// (the wrapper's `route` picks):
//
// * The decode step (S = 1): `rwkv6_decode_kernel`.  At L = 1 the formulas
//   above reduce exactly (cum_ex = 0, total = cum_in = logw, clip(0) = 0):
//
//     out[j]  = sum_q r[q] S0[q,j] + (sum_q r[q] u[q] k[q]) v[j]
//     S1[q,j] = S0[q,j] exp(logw[q]) + k[q] v[j]
//
//   Its bound is bytes: the two (K, K) f32 states of every (batch, head),
//   16.8 of the 17.2 MB at B 8, H 64, K 64 (5.1 us at 3.35 TB/s).  Column
//   j of S1 and out[j] need only column j of the state and the 64-long
//   vectors, so the state's columns are split into tiles of DKC = 16, one
//   tile a block of DWARPS = 2 warps (2,048 blocks of 64 threads at that
//   shape, 63 registers a thread: one wave, ~16 blocks an SM).  A lane
//   holds 4 columns of DRPT = 4 consecutive rows in registers, loaded as
//   16-byte vectors; every load of its state cells and of its slice of r,
//   k, logw, u and v is issued before the first use and there is no
//   shared-memory copy of the state and no barrier before the stores, so
//   each SM keeps its ~64 KB of state in flight at once.  exp(logw[q]) is
//   taken once per row a lane holds; the new state is stored as soon as
//   it is computed; out[j] and the bonus are summed over the lane's rows,
//   then over the tile's rows by shuffles and one small shared-memory
//   step across its two warps.  It is launched as a programmatic
//   dependent: `griddepcontrol.wait` comes before the first load of any
//   operand, because the previous launch on the stream may be the writer
//   of this launch's state (the model's decode step updates each layer's
//   cache in place, and the timing loops chain launches); only index
//   arithmetic precedes it.  It does not trigger its own dependents early
//   (`griddepcontrol.launch_dependents`): their blocks, placed while it
//   runs, cost more than they saved.  DKC, DWARPS and both choices were
//   timed against the other tiles and designs by
//   `scripts/rwkv6_scan_sweep.py --part decode`.  Each lane reads exactly
//   the state cells it writes, and no other lane reads them, so s1 may be
//   s0.
//
// * One chunk of 1 < S <= chunk: `rwkv6_scan_kernel`, one
//   block of 256 threads per (batch, head).  A loop over the chunks inside
//   the block takes the place of the TPU's sequential grid axis; the state
//   stays in shared memory, read once before the first chunk and written
//   once after the last, so s1 may be s0 (the decode step updates its
//   cache in place).  r, k, v and logw are staged as f32 in rows padded to
//   K + 1 floats, so lanes reading one column of different rows hit
//   distinct banks.  At decode the bytes bound it, mostly the two (K, K)
//   f32 states per (batch, head).
//
// * Two or more chunks (the prefill): a state pass, then an output pass.
//   - `rwkv6_state_kernel`, grid (state-row tiles of 16, H, B): the rows
//     of the (K, K) state update independently, and row q needs only
//     column q of k_dec and exp(total[q]), so each block carries a (16, K)
//     slice of its (batch, head)'s state in registers and computes a
//     quarter of the decay terms, none twice.  It walks the chunks in
//     order, two barriers a chunk: the scan of chunk c + 1
//     (cum_in, total, k_dec) is pipelined beside the update of chunk c,
//     S <- S exp(total)[:, None] + k_dec^T v, done as 4 x 4 register tiles.
//     It writes the state each chunk *starts* from into an f32 scratch
//     (B, H, n_c, Kp, Kp) and the last state into s1.  A ring of three
//     cp.async stages brings the next chunks' k and logw columns and v in
//     while chunk c is computed.  256 blocks at the
//     prefill shape (B 1, H 64, K 64), two an SM; its bound is the chain
//     of 128 chunks, not bytes or operations.
//   - `rwkv6_chunk_out_kernel`, grid (n_c, H, B), one block per chunk, all
//     independent (8,192 at the prefill shape), reads its chunk's start
//     state from the scratch (never s0, so s1 may be s0) and computes
//     cum_in/cum_ex, A below the diagonal, the bonus and out.  A is
//     register-tiled: a lane owns a 4 x 4 tile of (t, i) pairs and a
//     quarter of the k index, so one 16-byte shared-memory load serves
//     four exponentials; the quarters meet by a reduce-scatter of shuffles.
//     Its bound is the special-function units: ~1.06 G exponentials at the
//     prefill shape, at 16 a clock per SM.  Each exponential also costs
//     five FP32/ALU instructions (the difference, the two-sided clip, r*k,
//     the fma), which run beside the SFU.  The sums are taken in log2
//     units, so each exponential is one ex2.approx and the clip sits at
//     -60 log2(e).  73.5 KB of shared memory a block: three blocks, 24
//     warps, an SM.
//
// Why not the tensor cores: the state is held to 1e-4 relative, which TF32
// (10 mantissa bits) cannot give, and A is not a matrix product — each of
// its terms has its own exponential — so its fused multiply-adds belong on
// the FP32 pipes beside the SFU that bounds the pass.
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

// Opts `kern` into `smem` bytes of dynamic shared memory on the current
// device (and, with `carveout`, the largest shared-memory carveout), once a
// device (one bit a device in `opted_in`).
template <typename Kern>
int opt_in(Kern kern, size_t smem, bool carveout, unsigned long long& opted_in) {
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

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* logw, const void* u,
           const void* s0, void* out, void* s1, const long long* strides, int B, int H, int S,
           int K, int L, cudaStream_t stream) {
    static unsigned long long opted_in = 0;
    const size_t bytes = smem_bytes(L, K);
    const int err = opt_in(rwkv6_scan_kernel<T>, smem_bytes(64, 64), false, opted_in);
    if (err != 0) return err;
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

// ---------------------------------------------------------------------------
// Two or more chunks: the state pass, then the output pass
// ---------------------------------------------------------------------------

constexpr int CT = 256;                  // threads of a chunked kernel's block
constexpr int MAXD = 64;                 // L and K at most
constexpr int RT = 16;                   // state rows one state-pass block carries
constexpr int TP = 72;                   // pitch (floats) of the output pass's arrays
constexpr float LOG2E = 1.4426950408889634f;
constexpr float CLIP2 = -86.56170245333781f;   // the clip at -60, in log2 units

__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}
__device__ __forceinline__ float clip2(float x) { return fminf(fmaxf(x, CLIP2), 0.0f); }

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// Four consecutive values in shared memory (16-byte aligned for f32, 8 for
// bf16), as f32.
__device__ __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p + 2));
    return make_float4(a.x, a.y, b.x, b.y);
}

// The state pass's stage of one chunk: the block's RT columns of k and of
// logw and all K columns of v, L rows each, in the inputs' own types.  The
// pitches keep rows 16-byte aligned for cp.async and put rows 4 apart (the
// scan's segments) and 4-row tiles (the update's) on distinct banks.
template <typename T>
__host__ __device__ constexpr int ksp() { return sizeof(T) == 2 ? 24 : 20; }   // k tile pitch
constexpr int WSP = 20;                  // logw tile pitch (floats)
constexpr int KDP = 24;                  // pitch (floats) of the state pass's k_dec
constexpr int VFP = 68;                  // pitch (floats) of its f32 copy of v
template <typename T>
__host__ __device__ constexpr size_t stage_bytes() {
    return MAXD * (ksp<T>() * sizeof(T) + WSP * sizeof(float) + MAXD * sizeof(T));
}
constexpr int NST = 3;                   // stages in the state pass's ring
template <typename T>
__host__ __device__ constexpr size_t state_smem_bytes() {
    return NST * stage_bytes<T>() + sizeof(float) * (MAXD * KDP + MAXD * VFP + RT * RT + RT);
}
__host__ __device__ constexpr size_t out_smem_bytes() {
    return sizeof(float) * (4 * MAXD * TP + 4 * MAXD + MAXD + MAXD);
}

// Copies chunk rows [row0, row0 + L) into `stage`: k and logw columns
// [q0, q0 + nq), v columns [0, K).  By 16-byte cp.async when every row and
// base is 16-byte aligned and each row's pieces are a power of two
// (`async_ok`), else by plain loads.
template <typename T>
__device__ __forceinline__ void stage_chunk(char* stage, const T* kp, const T* vp, const float* wp,
                                            const Strides& sk, const Strides& sv, const Strides& sw,
                                            long long row0, int K, int L, int q0, int nq,
                                            bool async_ok, int tid) {
    constexpr int KSP = ksp<T>();
    T* kst = reinterpret_cast<T*>(stage);
    float* wst = reinterpret_cast<float*>(stage + MAXD * KSP * sizeof(T));
    T* vst = reinterpret_cast<T*>(stage + MAXD * (KSP * sizeof(T) + WSP * sizeof(float)));
    if (async_ok) {
        constexpr int EK = 16 / sizeof(T);
        const int lk = 31 - __clz(nq / EK), lw = 31 - __clz(nq / 4), lv = 31 - __clz(K / EK);
        for (int e = tid; e < (L << lk); e += CT) {
            const int t = e >> lk, p = e & ((1 << lk) - 1);
            cp_async16(kst + t * KSP + p * EK, kp + (row0 + t) * sk.s + q0 + p * EK);
        }
        for (int e = tid; e < (L << lw); e += CT) {
            const int t = e >> lw, p = e & ((1 << lw) - 1);
            cp_async16(wst + t * WSP + p * 4, wp + (row0 + t) * sw.s + q0 + p * 4);
        }
        for (int e = tid; e < (L << lv); e += CT) {
            const int t = e >> lv, p = e & ((1 << lv) - 1);
            cp_async16(vst + t * MAXD + p * EK, vp + (row0 + t) * sv.s + p * EK);
        }
    } else {
        for (int e = tid; e < L * nq; e += CT) {
            const int t = e / nq, x = e % nq;
            kst[t * KSP + x] = kp[(row0 + t) * sk.s + q0 + x];
            wst[t * WSP + x] = wp[(row0 + t) * sw.s + q0 + x];
        }
        for (int e = tid; e < L * K; e += CT) {
            const int t = e / K, j = e % K;
            vst[t * MAXD + j] = vp[(row0 + t) * sv.s + j];
        }
    }
}

// The state pass: block (row tile, h, b) carries state rows [q0, q0 + 16)
// of its (b, h) — all K columns — through the chunks in order.  Rows of the
// state update independently, and a row q needs only column q of k_dec and
// exp(total[q]), so no block repeats another's exponentials.  Per chunk c,
// between two barriers:
//   P  the segment sums of chunk c + 1's logw (thread: column, 4 rows),
//      beside the update of chunk c: S <- S exp(total) + k_dec^T v, a lane
//      summing one quarter (i = iq mod 4) of a 4 x 4 tile of (row, column),
//      then a reduce-scatter that leaves lane iq with tile row iq, which it
//      keeps in registers across chunks; first the state chunk c starts
//      from goes to the scratch;
//   Q  chunk c + 1's cum_in (log2 units; summed in one order everywhere, so
//      total equals cum_in of the last row), k_dec = k exp(clip(total -
//      cum_in)), exp(total), and v in f32.
// Writes the last state into s1; reads s0 only before it writes s1, and
// each thread reads exactly the s0 elements it writes, so s1 may be s0.
template <typename T>
__global__ void __launch_bounds__(CT, 2)
rwkv6_state_kernel(const T* __restrict__ k, const T* __restrict__ v,
                   const float* __restrict__ logw, const float* s0, float* __restrict__ scratch,
                   float* s1, Strides sk, Strides sv, Strides sw, int H, int S, int K, int L,
                   int Kp, bool async_ok) {
    extern __shared__ __align__(16) char sm[];
    constexpr int KSP = ksp<T>();
    constexpr size_t STAGE = stage_bytes<T>();
    float* kdec = reinterpret_cast<float*>(sm + NST * STAGE);    // [L][KDP], columns q - q0
    float* vf = kdec + MAXD * KDP;                                // [L][VFP] v in f32
    float* part = vf + MAXD * VFP;                                // [16 segments][RT]
    float* dec = part + RT * RT;                                  // [RT] exp(total)

    const int tid = threadIdx.x, lane = tid & 31;
    const int q0 = blockIdx.x * RT, h = blockIdx.y, b = blockIdx.z;
    const int nq = min(RT, K - q0), nc = S / L;
    const T* kp = k + b * sk.b + h * sk.h;
    const T* vp = v + b * sv.b + h * sv.h;
    const float* wp = logw + b * sw.b + h * sw.h;
    const long long bh = static_cast<long long>(b) * H + h;
    float* scr = scratch + bh * nc * Kp * Kp;

    // the update's tile: rows 4 qt .. + 3 of the block's, columns c0 .. c0 + 3;
    // this lane keeps row q = q0 + 4 qt + iq
    const int iq = lane & 3, qt = (tid >> 2) & 3, c0 = 4 * (tid >> 4);
    const int qr = 4 * qt + iq, q = q0 + qr;
    const bool owner = q < Kp && c0 < Kp;
    float st[4];
#pragma unroll
    for (int y = 0; y < 4; ++y)
        st[y] = (q < K && c0 + y < K) ? s0[bh * K * K + q * K + c0 + y] : 0.0f;
    // the scan: column sc of the block's, rows 4 seg .. 4 seg + 3
    const int sc = tid & (RT - 1), seg = tid >> 4;
    const bool col_in = q0 + sc < K;
    float pre[4];

    for (int p = 0; p < NST - 1; ++p) {
        if (p < nc)
            stage_chunk<T>(sm + p * STAGE, kp, vp, wp, sk, sv, sw, static_cast<long long>(p) * L,
                           K, L, q0, nq, async_ok, tid);
        cp_async_commit();
    }
    for (int c = -1; c < nc; ++c) {
        if (c >= 0) {
            const int nx = c + NST - 1;
            if (nx < nc)
                stage_chunk<T>(sm + (nx % NST) * STAGE, kp, vp, wp, sk, sv, sw,
                               static_cast<long long>(nx) * L, K, L, q0, nq, async_ok, tid);
            cp_async_commit();
        }
        cp_async_wait<NST - 2>();
        __syncthreads();                // chunk c + 1 has landed; Q of chunk c is done
        const char* nxt = sm + ((c + 1) % NST) * STAGE;
        // P: chunk c + 1's segment sums
        if (c + 1 < nc) {
            const float* wst = reinterpret_cast<const float*>(nxt + MAXD * KSP * sizeof(T));
            float acc = 0.0f;
#pragma unroll
            for (int x = 0; x < 4; ++x) {
                const int t = 4 * seg + x;
                acc += (col_in && t < L) ? wst[t * WSP + sc] * LOG2E : 0.0f;
                pre[x] = acc;
            }
            part[seg * RT + sc] = acc;
        }
        // P: the update of chunk c
        if (c >= 0) {
            float acc[16];
#pragma unroll
            for (int e = 0; e < 16; ++e) acc[e] = 0.0f;
#pragma unroll 4
            for (int i = iq; i < L; i += 4) {
                const float4 k4 = load4(kdec + i * KDP + 4 * qt), v4 = load4(vf + i * VFP + c0);
                const float kv[4] = {k4.x, k4.y, k4.z, k4.w}, vv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
                for (int x = 0; x < 4; ++x)
#pragma unroll
                    for (int y = 0; y < 4; ++y) acc[4 * x + y] = fmaf(kv[x], vv[y], acc[4 * x + y]);
            }
            // reduce-scatter over the four lanes: lane iq keeps tile row iq
            float half[8], mine[4];
#pragma unroll
            for (int e = 0; e < 8; ++e) {
                const float send = (iq & 2) ? acc[e] : acc[8 + e];
                half[e] = ((iq & 2) ? acc[8 + e] : acc[e]) + __shfl_xor_sync(0xffffffffu, send, 2);
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float send = (iq & 1) ? half[e] : half[4 + e];
                mine[e] = ((iq & 1) ? half[4 + e] : half[e]) + __shfl_xor_sync(0xffffffffu, send, 1);
            }
            if (owner) {
                *reinterpret_cast<float4*>(scr + static_cast<long long>(c) * Kp * Kp + q * Kp + c0) =
                    make_float4(st[0], st[1], st[2], st[3]);
                const float dq = dec[qr];
#pragma unroll
                for (int y = 0; y < 4; ++y) st[y] = st[y] * dq + mine[y];
            }
        }
        __syncthreads();                // the segment sums are in; k_dec, v, dec are free
        // Q: chunk c + 1's cum_in, k_dec, exp(total) and v in f32
        if (c + 1 < nc) {
            const T* kst = reinterpret_cast<const T*>(nxt);
            const T* vst = reinterpret_cast<const T*>(nxt + MAXD * (KSP * sizeof(T) + WSP * sizeof(float)));
            float off = 0.0f, tot = 0.0f;
#pragma unroll
            for (int s2 = 0; s2 < RT; ++s2) {
                const float ps = part[s2 * RT + sc];
                if (s2 < seg) off += ps;
                tot += ps;
            }
#pragma unroll
            for (int x = 0; x < 4; ++x) {
                const int t = 4 * seg + x;
                if (t < L) {
                    const float kv = col_in ? to_f(kst[t * KSP + sc]) : 0.0f;
                    kdec[t * KDP + sc] = kv * ex2(clip2(tot - (off + pre[x])));
                }
            }
            if (seg == 0) dec[sc] = ex2(tot);
            const int vrow = tid >> 2, v0 = 16 * (tid & 3);   // columns past K read as zero
            if (vrow < L) {
#pragma unroll
                for (int x = 0; x < 16; x += 4) {
                    const int j = v0 + x;
                    const float4 v4 = j < K ? load4(vst + vrow * MAXD + j)
                                            : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
                    *reinterpret_cast<float4*>(vf + vrow * VFP + j) =
                        make_float4(v4.x, j + 1 < K ? v4.y : 0.0f, j + 2 < K ? v4.z : 0.0f,
                                    j + 3 < K ? v4.w : 0.0f);
                }
            }
        }
    }
    if (q < K) {
#pragma unroll
        for (int y = 0; y < 4; ++y)
            if (c0 + y < K) s1[bh * K * K + q * K + c0 + y] = st[y];
    }
}

// Tile T of the lower triangle (diagonal included) of the (Lp/4)^2 grid of
// 4 x 4 tiles, row-major: row tile a, column tile bb <= a.
__device__ __forceinline__ void tile_of(int T, int& a, int& bb) {
    int x = static_cast<int>((sqrtf(8.0f * T + 1.0f) - 1.0f) * 0.5f);
    while ((x + 1) * (x + 2) / 2 <= T) ++x;
    while (x * (x + 1) / 2 > T) --x;
    a = x;
    bb = T - x * (x + 1) / 2;
}

// A over tile T, this lane taking the k index = jq mod 4 (lanes l, l ^ 8,
// l ^ 16, l ^ 24 take the four quarters): the sums of r[4a+x] k[4bb+y]
// exp2(clip(ce[4a+x] - ci[4bb+y])) over k, reduce-scattered over the four
// lanes so that this one returns tile row x = jq in res[y].  Every lane
// of the warp must call it; zero for T >= ntiles.
__device__ __forceinline__ void tile_row(const float* rT, const float* kT, const float* ceT,
                                         const float* ciT, int T, int ntiles, int Kp, int jq,
                                         float (&res)[4]) {
    float acc[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[e] = 0.0f;
    if (T < ntiles) {
        int a, bb;
        tile_of(T, a, bb);
        const float* rr = rT + 4 * a;
        const float* ce = ceT + 4 * a;
        const float* kk = kT + 4 * bb;
        const float* ci = ciT + 4 * bb;
#pragma unroll 2
        for (int j = jq; j < Kp; j += 4) {
            const float4 r4 = load4(rr + j * TP), e4 = load4(ce + j * TP);
            const float4 k4 = load4(kk + j * TP), c4 = load4(ci + j * TP);
            const float rv[4] = {r4.x, r4.y, r4.z, r4.w}, ev[4] = {e4.x, e4.y, e4.z, e4.w};
            const float kv[4] = {k4.x, k4.y, k4.z, k4.w}, cv[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
            for (int x = 0; x < 4; ++x)
#pragma unroll
                for (int y = 0; y < 4; ++y)
                    acc[4 * x + y] = fmaf(rv[x] * kv[y], ex2(clip2(ev[x] - cv[y])), acc[4 * x + y]);
        }
    }
    float half[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
        const float send = (jq & 2) ? acc[e] : acc[8 + e];
        half[e] = ((jq & 2) ? acc[8 + e] : acc[e]) + __shfl_xor_sync(0xffffffffu, send, 16);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
        const float send = (jq & 1) ? half[e] : half[4 + e];
        res[e] = ((jq & 1) ? half[4 + e] : half[e]) + __shfl_xor_sync(0xffffffffu, send, 8);
    }
}

// Stores row t = 4a + jq of tile T of A into A^T [i][t] (pitch TP), zero
// where t <= i.
__device__ __forceinline__ void store_row(float* AT, int T, int ntiles, int jq,
                                          const float (&res)[4]) {
    if (T >= ntiles) return;
    int a, bb;
    tile_of(T, a, bb);
    const int t = 4 * a + jq;
#pragma unroll
    for (int y = 0; y < 4; ++y) {
        const int i = 4 * bb + y;
        AT[i * TP + t] = t > i ? res[y] : 0.0f;
    }
}

// The output pass: block (c, h, b) computes chunk c of (b, h) from the
// state it starts from (scratch).  Arrays in shared memory, f32, pitch TP:
//   X0  r^T [k][t], then r_dec^T
//   X1  k^T [k][i], then A^T [i][t]
//   X2  logw^T, then cum_ex^T [k][t] (log2 units), then v [i][k]
//   X3  cum_in^T [k][i] (log2 units), then the start state [q][k]
// Rows t in [L, Lp) and columns k in [K, Kp) hold zeros.
template <typename T>
__global__ void __launch_bounds__(CT, 3)
rwkv6_chunk_out_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                       const float* __restrict__ logw, const float* __restrict__ u,
                       const float* __restrict__ scratch, T* __restrict__ out, Strides sr,
                       Strides sk, Strides sv, Strides sw, Strides so, int H, int K, int L,
                       int Kp, int nc) {
    extern __shared__ __align__(16) float fs[];
    float* X0 = fs;
    float* X1 = X0 + MAXD * TP;
    float* X2 = X1 + MAXD * TP;
    float* X3 = X2 + MAXD * TP;
    float* part = X3 + MAXD * TP;       // [4][MAXD] segment sums of the scan
    float* bonus = part + 4 * MAXD;     // [MAXD] sum_k r u k of each row
    float* us = bonus + MAXD;           // [MAXD] u of this head

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int Lp = (L + 3) & ~3;
    const long long row0 = static_cast<long long>(c) * L;
    const T* rp = r + b * sr.b + h * sr.h + row0 * sr.s;
    const T* kp = k + b * sk.b + h * sk.h + row0 * sk.s;
    const T* vp = v + b * sv.b + h * sv.h + row0 * sv.s;
    const float* wp = logw + b * sw.b + h * sw.h + row0 * sw.s;
    T* op = out + b * so.b + h * so.h + row0 * so.s;

    // 0. r, k and logw (log2 units), transposed; thread: row lt, columns lj + 4 it
    const int lt = 8 * warp + (lane & 7), lj = lane >> 3;
    const bool row_in = lt < Lp, row_real = lt < L;
    {
        float rr[MAXD / 4], kk[MAXD / 4], ww[MAXD / 4];
#pragma unroll
        for (int it = 0; it < MAXD / 4; ++it) {
            const int j = 4 * it + lj;
            const bool in = row_real && j < K;
            rr[it] = in ? to_f(rp[lt * sr.s + j]) : 0.0f;
            kk[it] = in ? to_f(kp[lt * sk.s + j]) : 0.0f;
            ww[it] = in ? wp[lt * sw.s + j] * LOG2E : 0.0f;
        }
#pragma unroll
        for (int it = 0; it < MAXD / 4; ++it) {
            const int j = 4 * it + lj;
            if (row_in && j < Kp) {
                X0[j * TP + lt] = rr[it];
                X1[j * TP + lt] = kk[it];
                X2[j * TP + lt] = ww[it];
            }
        }
    }
    if (tid < Kp) us[tid] = tid < K ? u[h * K + tid] : 0.0f;
    __syncthreads();

    // 1. the bonus of each row; each (column sj, segment of 16 rows): the
    // inclusive prefix of logw
    if (tid < Lp) {
        float a = 0.0f;
        for (int j = 0; j < Kp; ++j) a = fmaf(X0[j * TP + tid] * us[j], X1[j * TP + tid], a);
        bonus[tid] = a;
    }
    const int sj = tid & (MAXD - 1), seg = tid >> 6;
    float lw[16], pre[16];
    if (sj < Kp) {
#pragma unroll
        for (int x = 0; x < 16; x += 4) {
            const float4 w4 = seg * 16 + x < Lp ? load4(X2 + sj * TP + seg * 16 + x)
                                                : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            lw[x] = w4.x;
            lw[x + 1] = w4.y;
            lw[x + 2] = w4.z;
            lw[x + 3] = w4.w;
        }
        float acc = 0.0f;
#pragma unroll
        for (int x = 0; x < 16; ++x) {
            acc += lw[x];
            pre[x] = acc;
        }
        part[seg * MAXD + sj] = acc;
    }
    __syncthreads();
    // 2. cum_in, and cum_ex = cum_in - logw in place of logw
    if (sj < Kp) {
        float off = 0.0f;
        for (int s2 = 0; s2 < seg; ++s2) off += part[s2 * MAXD + sj];
#pragma unroll
        for (int x = 0; x < 16; x += 4) {
            if (seg * 16 + x < Lp) {
                const float4 ci = make_float4(off + pre[x], off + pre[x + 1], off + pre[x + 2],
                                              off + pre[x + 3]);
                *reinterpret_cast<float4*>(X3 + sj * TP + seg * 16 + x) = ci;
                *reinterpret_cast<float4*>(X2 + sj * TP + seg * 16 + x) =
                    make_float4(ci.x - lw[x], ci.y - lw[x + 1], ci.z - lw[x + 2], ci.w - lw[x + 3]);
            }
        }
    }
    __syncthreads();

    // 3. A below the diagonal, by groups of 8 tiles, one a warp at a time
    // (the 136 tiles of L = 64 make 17 groups: warp w takes groups w, w + 8
    // and w + 16); a lane keeps one tile row of each, until X1 is free
    const int nt = Lp >> 2, ntiles = nt * (nt + 1) / 2, ngroups = (ntiles + 7) >> 3;
    const int jq = lane >> 3, m = lane & 7;
    float res[3][4];
#pragma unroll
    for (int g = 0; g < 3; ++g)
        if (warp + 8 * g < ngroups)
            tile_row(X0, X1, X2, X3, 8 * (warp + 8 * g) + m, ntiles, Kp, jq, res[g]);
    __syncthreads();                    // k^T and cum_in^T are read for the last time

    // 4. fetch the start state; store A^T over k^T; r_dec = r exp(cum_ex)
    {
        const float* sp = scratch + ((static_cast<long long>(b) * H + h) * nc + c) * Kp * Kp;
        const int pr = Kp / 4;
        for (int e = tid; e < Kp * pr; e += CT) {
            const int q = e / pr, p = e % pr;
            cp_async16(X3 + q * TP + 4 * p, sp + q * Kp + 4 * p);
        }
        cp_async_commit();
    }
#pragma unroll
    for (int g = 0; g < 3; ++g)
        if (warp + 8 * g < ngroups) store_row(X1, 8 * (warp + 8 * g) + m, ntiles, jq, res[g]);
    float vr[MAXD / 4];
#pragma unroll
    for (int it = 0; it < MAXD / 4; ++it) {
        const int j = 4 * it + lj;
        vr[it] = (row_real && j < K) ? to_f(vp[lt * sv.s + j]) : 0.0f;
    }
#pragma unroll 4
    for (int it = 0; it < MAXD / 4; ++it) {
        const int j = 4 * it + lj;
        if (row_in && j < Kp) X0[j * TP + lt] *= ex2(X2[j * TP + lt]);
    }
    __syncthreads();                    // cum_ex^T is read for the last time
#pragma unroll
    for (int it = 0; it < MAXD / 4; ++it) {
        const int j = 4 * it + lj;
        if (row_in && j < Kp) X2[lt * TP + j] = vr[it];
    }
    cp_async_wait<0>();
    __syncthreads();

    // 5. out = r_dec @ S + A @ v + bonus v; thread: rows t0..t0+3, columns j0..j0+3
    const int t0 = 4 * (tid >> 4), j0 = 4 * (tid & 15);
    if (t0 < Lp && j0 < Kp) {
        float inter[16], intra[16];
#pragma unroll
        for (int e = 0; e < 16; ++e) inter[e] = intra[e] = 0.0f;
        for (int q = 0; q < Kp; ++q) {
            const float4 a4 = load4(X0 + q * TP + t0), s4 = load4(X3 + q * TP + j0);
            const float av[4] = {a4.x, a4.y, a4.z, a4.w}, sv4[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
            for (int x = 0; x < 4; ++x)
#pragma unroll
                for (int y = 0; y < 4; ++y) inter[4 * x + y] = fmaf(av[x], sv4[y], inter[4 * x + y]);
        }
        const int iend = min(t0 + 3, Lp);          // i < t <= t0 + 3
        for (int i = 0; i < iend; ++i) {
            const float4 a4 = load4(X1 + i * TP + t0), v4 = load4(X2 + i * TP + j0);
            const float av[4] = {a4.x, a4.y, a4.z, a4.w}, vv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
            for (int x = 0; x < 4; ++x)
#pragma unroll
                for (int y = 0; y < 4; ++y) intra[4 * x + y] = fmaf(av[x], vv[y], intra[4 * x + y]);
        }
#pragma unroll
        for (int x = 0; x < 4; ++x) {
            const int t = t0 + x;
            if (t >= L) continue;
            const float bn = bonus[t];
            const float4 v4 = load4(X2 + t * TP + j0);
            const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
            for (int y = 0; y < 4; ++y)
                if (j0 + y < K)
                    op[t * so.s + j0 + y] = from_f<T>(inter[4 * x + y] + intra[4 * x + y] + bn * vv[y]);
        }
    }
}

bool aligned16(const void* p, const long long* st, size_t elt) {
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
    for (int i = 0; i < 3; ++i)
        if ((st[i] * static_cast<long long>(elt)) % 16) return false;
    return true;
}

template <typename T>
int launch_chunked(const void* r, const void* k, const void* v, const void* logw, const void* u,
                   const void* s0, void* out, void* s1, void* scratch, const long long* strides,
                   int B, int H, int S, int K, int L, cudaStream_t stream) {
    static unsigned long long state_in = 0, out_in = 0;
    int err = opt_in(rwkv6_state_kernel<T>, state_smem_bytes<T>(), true, state_in);
    if (err == 0) err = opt_in(rwkv6_chunk_out_kernel<T>, out_smem_bytes(), true, out_in);
    if (err != 0) return err;
    const Strides sr{strides[0], strides[1], strides[2]}, sk{strides[3], strides[4], strides[5]},
        sv{strides[6], strides[7], strides[8]}, sw{strides[9], strides[10], strides[11]},
        so{strides[12], strides[13], strides[14]};
    const int Kp = (K + 3) & ~3, nc = S / L;
    // 16-byte copies of whole rows, in a power of two of pieces a row
    const bool async_ok = (K & (K - 1)) == 0 && K * sizeof(T) >= 16 &&
                          aligned16(k, strides + 3, sizeof(T)) &&
                          aligned16(v, strides + 6, sizeof(T)) &&
                          aligned16(logw, strides + 9, sizeof(float));
    rwkv6_state_kernel<T><<<dim3((Kp + RT - 1) / RT, H, B), CT, state_smem_bytes<T>(), stream>>>(
        static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const float*>(logw),
        static_cast<const float*>(s0), static_cast<float*>(scratch), static_cast<float*>(s1), sk,
        sv, sw, H, S, K, L, Kp, async_ok);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    rwkv6_chunk_out_kernel<T><<<dim3(nc, H, B), CT, out_smem_bytes(), stream>>>(
        static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const float*>(logw), static_cast<const float*>(u),
        static_cast<const float*>(scratch), static_cast<T*>(out), sr, sk, sv, sw, so, H, K, L, Kp,
        nc);
    return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The decode step: S = 1
// ---------------------------------------------------------------------------

constexpr int DKC = 16;                  // state columns a tile (a block)
constexpr int DWARPS = 2;                // warps a tile
constexpr int DCG = DKC / 4;             // lanes across a tile's columns, 4 columns each
constexpr int DRW = 32 / DCG;            // row groups a warp
constexpr int DRPT = MAXD / (DRW * DWARPS);   // consecutive state rows a lane holds
static_assert(DKC % 4 == 0 && 32 % DCG == 0 && MAXD % (DRW * DWARPS) == 0 && DRPT >= 1,
              "a decode tile must split into whole lanes and rows");

// Block (column tile, h, b): columns [j0, j0 + 4) of rows [q0, q0 + DRPT)
// in each lane, lane = column group + DCG * row group, so a warp's load of
// one of its rows reads DRW runs of 4 * DCG contiguous floats.  `vec`: K is
// a multiple of 4 and s0, s1 are 16-byte aligned (state rows as float4).
template <typename T>
__global__ void __launch_bounds__(32 * DWARPS)
rwkv6_decode_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                    const float* __restrict__ logw, const float* __restrict__ u, const float* s0,
                    T* __restrict__ out, float* s1, Strides sr, Strides sk, Strides sv,
                    Strides sw, Strides so, int H, int K, bool vec) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int cg = lane % DCG, rg = warp * DRW + lane / DCG;
    const int j0 = blockIdx.x * DKC + 4 * cg, q0 = rg * DRPT;
    const int h = blockIdx.y, b = blockIdx.z;
    const long long bh = static_cast<long long>(b) * H + h;
    const float* sp = s0 + bh * K * K;
    float* dp = s1 + bh * K * K;
    const T* rp = r + b * sr.b + h * sr.h;
    const T* kp = k + b * sk.b + h * sk.h;
    const T* vp = v + b * sv.b + h * sv.h;
    const float* wp = logw + b * sw.b + h * sw.h;
    const float* up = u + h * K;

    // The previous launch on the stream may have written s0: nothing is
    // read before it is done.
    asm volatile("griddepcontrol.wait;\n" ::: "memory");

    // every load first: the lane's state cells, then its slice of the vectors
    float4 st[DRPT];
#pragma unroll
    for (int i = 0; i < DRPT; ++i) {
        const int q = q0 + i;
        if (vec) {
            st[i] = (q < K && j0 < K) ? *reinterpret_cast<const float4*>(sp + q * K + j0)
                                      : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        } else {
            const float* row = sp + q * K + j0;
            const bool in = q < K;
            st[i] = make_float4(in && j0 < K ? row[0] : 0.0f, in && j0 + 1 < K ? row[1] : 0.0f,
                                in && j0 + 2 < K ? row[2] : 0.0f, in && j0 + 3 < K ? row[3] : 0.0f);
        }
    }
    float rr[DRPT], kk[DRPT], ww[DRPT], uu[DRPT], vv[4];
#pragma unroll
    for (int i = 0; i < DRPT; ++i) {
        const int q = q0 + i;
        const bool in = q < K;
        rr[i] = in ? to_f(rp[q]) : 0.0f;
        kk[i] = in ? to_f(kp[q]) : 0.0f;
        ww[i] = in ? wp[q] : 0.0f;
        uu[i] = in ? up[q] : 0.0f;
    }
#pragma unroll
    for (int x = 0; x < 4; ++x) vv[x] = j0 + x < K ? to_f(vp[j0 + x]) : 0.0f;

    // out and the bonus over the lane's rows; the new state, stored at once
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f}, bonus = 0.0f;
#pragma unroll
    for (int i = 0; i < DRPT; ++i) {
        const int q = q0 + i;
        const float4 s = st[i];
        acc[0] = fmaf(rr[i], s.x, acc[0]);
        acc[1] = fmaf(rr[i], s.y, acc[1]);
        acc[2] = fmaf(rr[i], s.z, acc[2]);
        acc[3] = fmaf(rr[i], s.w, acc[3]);
        bonus = fmaf(rr[i] * uu[i], kk[i], bonus);
        const float d = expf(ww[i]);
        const float4 n = make_float4(s.x * d + kk[i] * vv[0], s.y * d + kk[i] * vv[1],
                                     s.z * d + kk[i] * vv[2], s.w * d + kk[i] * vv[3]);
        if (q < K) {
            float* row = dp + q * K + j0;
            if (vec) {
                if (j0 < K) *reinterpret_cast<float4*>(row) = n;
            } else {
                if (j0 < K) row[0] = n.x;
                if (j0 + 1 < K) row[1] = n.y;
                if (j0 + 2 < K) row[2] = n.z;
                if (j0 + 3 < K) row[3] = n.w;
            }
        }
    }
    // over the warp's row groups (lanes cg, cg + DCG, ...), then its warps
#pragma unroll
    for (int o = DCG; o < 32; o <<= 1) {
#pragma unroll
        for (int x = 0; x < 4; ++x) acc[x] += __shfl_xor_sync(0xffffffffu, acc[x], o);
        bonus += __shfl_xor_sync(0xffffffffu, bonus, o);
    }
    if constexpr (DWARPS > 1) {
        __shared__ float part[DWARPS][DKC + 1];
        if (lane < DCG) {
#pragma unroll
            for (int x = 0; x < 4; ++x) part[warp][4 * cg + x] = acc[x];
            if (cg == 0) part[warp][DKC] = bonus;
        }
        __syncthreads();
        if (warp == 0 && lane < DCG) {
#pragma unroll
            for (int x = 0; x < 4; ++x) acc[x] = 0.0f;
            bonus = 0.0f;
            for (int w = 0; w < DWARPS; ++w) {
#pragma unroll
                for (int x = 0; x < 4; ++x) acc[x] += part[w][4 * cg + x];
                bonus += part[w][DKC];
            }
        }
    }
    if (warp == 0 && lane < DCG) {
        T* op = out + b * so.b + h * so.h;
#pragma unroll
        for (int x = 0; x < 4; ++x)
            if (j0 + x < K) op[j0 + x] = from_f<T>(acc[x] + bonus * vv[x]);
    }
}

template <typename T>
int launch_decode(const void* r, const void* k, const void* v, const void* logw, const void* u,
                  const void* s0, void* out, void* s1, const long long* strides, int B, int H,
                  int K, cudaStream_t stream) {
    const Strides sr{strides[0], strides[1], strides[2]}, sk{strides[3], strides[4], strides[5]},
        sv{strides[6], strides[7], strides[8]}, sw{strides[9], strides[10], strides[11]},
        so{strides[12], strides[13], strides[14]};
    const bool vec = K % 4 == 0 && reinterpret_cast<uintptr_t>(s0) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(s1) % 16 == 0;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>((K + DKC - 1) / DKC), static_cast<unsigned>(H),
                       static_cast<unsigned>(B));
    cfg.blockDim = dim3(32 * DWARPS);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return static_cast<int>(cudaLaunchKernelEx(
        &cfg, rwkv6_decode_kernel<T>, static_cast<const T*>(r), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const float*>(logw), static_cast<const float*>(u),
        static_cast<const float*>(s0), static_cast<T*>(out), static_cast<float*>(s1), sr, sk, sv,
        sw, so, H, K, vec));
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

// The two passes, for any S / L >= 1 (the wrapper sends S / L >= 2 here).
// Arguments as rwkv6_scan_launch's, plus `scratch`: B * H * (S / L) * Kp * Kp
// f32, 16-byte aligned, Kp = K rounded up to a multiple of 4; it receives
// the state each chunk starts from.  s1 may be s0.
extern "C" int rwkv6_scan_chunked_launch(const void* r, const void* k, const void* v,
                                         const void* logw, const void* u, const void* s0,
                                         void* out, void* s1, void* scratch,
                                         const long long* strides, int B, int H, int S, int K,
                                         int L, int dtype, void* stream) {
    if (K < 1 || K > 64 || L < 1 || L > 64 || S % L != 0 ||
        reinterpret_cast<uintptr_t>(scratch) % 16)
        return static_cast<int>(cudaErrorInvalidValue);
    if (B == 0 || H == 0 || S == 0) return 0;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
        return launch_chunked<float>(r, k, v, logw, u, s0, out, s1, scratch, strides, B, H, S, K,
                                     L, st);
    if (dtype == 1)
        return launch_chunked<__nv_bfloat16>(r, k, v, logw, u, s0, out, s1, scratch, strides, B,
                                             H, S, K, L, st);
    return static_cast<int>(cudaErrorInvalidValue);
}

// The decode step.  Arguments as rwkv6_scan_launch's, with S = L = 1; the
// kernel is launched as a programmatic dependent.  s1 may be s0.
extern "C" int rwkv6_scan_decode_launch(const void* r, const void* k, const void* v,
                                        const void* logw, const void* u, const void* s0,
                                        void* out, void* s1, const long long* strides, int B,
                                        int H, int S, int K, int L, int dtype, void* stream) {
    if (K < 1 || K > 64 || S != 1 || L != 1) return static_cast<int>(cudaErrorInvalidValue);
    if (B == 0 || H == 0) return 0;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return launch_decode<float>(r, k, v, logw, u, s0, out, s1, strides, B, H, K, st);
    if (dtype == 1)
        return launch_decode<__nv_bfloat16>(r, k, v, logw, u, s0, out, s1, strides, B, H, K, st);
    return static_cast<int>(cudaErrorInvalidValue);
}
