// fixmatmul.cu — int8 x int8 -> int32 matmul with per-row and per-column
// f32 scales, as CUDA kernels for Hopper (sm_90a).  They replace the TPU
// kernel `fixmatmul` of the JAX package
// (src/repro/kernels/fixmatmul/fixmatmul.py:57, pl.pallas_call at :77), a
// 256x256x256-tiled MXU GEMM with an int32 VMEM accumulator.
//
//     out[m, n] = (f32(sum_k xq[m, k] * wq[k, n]) * sx[m]) * sw[n]
//
// What bounds it on this card: bytes.  On the serving path M is the decode
// batch (1-16) and (K, N) a weight matrix of 1.6-268 MB, so every weight
// byte meets at most M multiply-adds, far below the ~590 int8 operations a
// byte at which the tensor cores would be the limit.  The least time is the
// int8 weights read once at 3.35 TB/s.  The epilogue multiplies in the
// reference's order with round-to-nearest and no contraction, so both
// kernels are bitwise equal to the plain version.  The caller's planner
// picks the kernel by M.
//
// fixmatmul_stream_kernel (M <= 16, every decode batch): one launch that
// streams the weights once.
//   * A block of 8 warps owns BN = 64 or 128 columns (strips of 32, one a
//     warp) and one range of K.  The planner takes the widest tile and
//     the fewest K splits that give about 1.5 blocks an SM: measured on the
//     card, fewer and wider blocks beat more and narrower ones at every
//     decode shape (scripts/fixmatmul_sweep.py).  At most 64 registers a
//     thread keep four blocks an SM.
//   * Weights and activations arrive by 16-byte cp.async.cg copies, each
//     lane on a row segment of wq at one k, into a ring of 4 shared-memory
//     stages of 8 KB of weights: three stages (24 KB a block, up to 96 KB
//     an SM) are in flight while the fourth is computed.  The weight rows
//     are XOR-swizzled in 32-byte units so the fragment loads are free of
//     bank conflicts.
//   * The fold runs on the tensor cores: mma.sync.m16n8k32 s8 x s8 -> s32
//     computes out^T = wq^T xq^T, so the batch is the n8 side (two n8 tiles
//     at M > 8).  A lane loads 4 k-rows x 4 columns of wq as four words and
//     turns them into four k-packed A-fragment words with __byte_perm
//     (0.5 prmt a weight byte); the A rows of an mma are a permutation of
//     the strip's columns, undone when the sums are stored.  __dp4a would
//     take 4 x M accumulators a lane and 2 integer ops a weight byte at
//     M = 8 (half the integer pipe at the memory rate), and 8x more partial
//     sums to reduce; the mma keeps 8 (16 at M > 8) and leaves the integer
//     pipe the transposes.
//   * The K splits of one column tile form a thread-block cluster of at
//     most 8 blocks, and each block owns a share of the tile's columns.
//     After its K loop a block adds its warps' sums in shared memory and
//     stores them into the owners' shared memory (distributed shared
//     memory; integer sums are exact in any order); one cluster barrier
//     later each block adds what it received and applies the epilogue to
//     its columns.  No partial sums go through device memory and there is
//     no second kernel.  One split launches without a cluster.  (Adding
//     into the owners with red.shared::cluster instead was several times
//     slower on an H100.)
//   * It launches as a programmatic dependent (PDL): its blocks are placed
//     while the previous kernel in the stream drains, and wait for it
//     (griddepcontrol.wait) before their first load or store, so most of
//     the launch latency overlaps that kernel (1.0-1.9 us a launch on an
//     H100).
//   * Nothing is padded or copied: ragged N, K and M are masked (rows past
//     a split's K range are zero-filled by the copies); operands whose rows
//     are not 16-byte aligned (N or K not a multiple of 16, a misaligned
//     pointer) take byte loads into the same stages.
//   What is left: 2.5-3.4 us a launch of fixed cost beside the bytes (the
//   first bytes' latency, the cluster's reduction, the epilogue; measured
//   at K = 0 on an H100), which holds the small matrices far from their
//   bounds: (2560, 640) moves 1.6 MB, a 0.5 us bound.  TMA with the
//   activations multicast to the cluster, and a persistent grid that
//   overlaps one tile's reduction with the next tile's copies, are the
//   next steps.
//
// fixmatmul_kernel (M > 16; the first design, kept as it was): one block
// of 256 threads owns 64 output columns and 4 * RPT rows, RPT (rows per
// thread) chosen from M by the caller.  A loop over K stages a 64-deep tile
// of wq and of xq in shared memory, packed four k to a 32-bit word (the
// weight tile is transposed in registers with __byte_perm), and each thread
// folds them with __dp4a into RPT int32 accumulators.  Few column tiles
// cannot fill 132 SMs, so K is split across blocks (grid z); each split
// writes its int32 partial sums and a second kernel adds them and applies
// the epilogue.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BN = 64;                 // output columns per block (thread x)
constexpr int BK = 64;                 // k per shared-memory stage
constexpr int THREADS = 256;
constexpr int RG = THREADS / BN;       // row groups (thread y)
constexpr int KW = BK / 4;             // packed words per tile row

__device__ __forceinline__ uint32_t pack4(const int8_t* p, int stride, int valid) {
    // Bytes p[0], p[stride], p[2*stride], p[3*stride] (the first `valid`
    // of them; zero past the edge) as one little-endian word.
    uint32_t w = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
        if (b < valid) w |= static_cast<uint32_t>(static_cast<uint8_t>(p[b * stride])) << (8 * b);
    }
    return w;
}

__device__ __forceinline__ float epilogue(int32_t acc, float sx, float sw) {
    return __fmul_rn(__fmul_rn(__int2float_rn(acc), sx), sw);
}

template <int RPT>
__global__ void __launch_bounds__(THREADS)
fixmatmul_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ wq,
                 const float* __restrict__ sx, const float* __restrict__ sw,
                 float* __restrict__ out, int32_t* __restrict__ part,
                 int M, int K, int N, int k_per_split, int vec_x, int vec_w) {
    constexpr int BM = RG * RPT;       // output rows per block
    __shared__ uint32_t xs[BM][KW];    // xs[r][g]: xq[m0 + r][k0 + 4g .. 4g + 3]
    __shared__ uint32_t ws[KW][BN];    // ws[g][c]: wq[k0 + 4g .. 4g + 3][n0 + c]

    const int tid = threadIdx.x;
    const int tx = tid % BN, ty = tid / BN;
    const int n0 = blockIdx.x * BN;
    const int m0 = blockIdx.y * BM;
    const int k_begin = blockIdx.z * k_per_split;
    const int k_end = min(K, k_begin + k_per_split);
    const int rows = min(BM, M - m0);

    int32_t acc[RPT];
#pragma unroll
    for (int j = 0; j < RPT; ++j) acc[j] = 0;

    for (int k0 = k_begin; k0 < k_end; k0 += BK) {
        // xq tile: rows past M are not loaded (their words are never read).
        for (int i = tid; i < rows * KW; i += THREADS) {
            const int r = i / KW, g = i % KW;
            const int k = k0 + 4 * g;
            const int8_t* p = xq + static_cast<size_t>(m0 + r) * K + k;
            const int valid = k_end - k;
            xs[r][g] = (vec_x && valid >= 4) ? *reinterpret_cast<const uint32_t*>(p)
                                             : (valid > 0 ? pack4(p, 1, valid) : 0u);
        }
        // wq tile, packed along k.
        if (vec_w) {
            // N % 4 == 0: each thread reads four 4-column words from four
            // consecutive k rows and transposes them.
            const int cq = tid % (BN / 4), g = tid / (BN / 4);
            const int n = n0 + 4 * cq;
            uint32_t r[4];
#pragma unroll
            for (int b = 0; b < 4; ++b) {
                const int k = k0 + 4 * g + b;
                r[b] = (n < N && k < k_end)
                           ? *reinterpret_cast<const uint32_t*>(wq + static_cast<size_t>(k) * N + n)
                           : 0u;
            }
            const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
            const uint32_t t1 = __byte_perm(r[2], r[3], 0x5140);
            const uint32_t t2 = __byte_perm(r[0], r[1], 0x7362);
            const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
            ws[g][4 * cq + 0] = __byte_perm(t0, t1, 0x5410);
            ws[g][4 * cq + 1] = __byte_perm(t0, t1, 0x7632);
            ws[g][4 * cq + 2] = __byte_perm(t2, t3, 0x5410);
            ws[g][4 * cq + 3] = __byte_perm(t2, t3, 0x7632);
        } else {
            for (int i = tid; i < KW * BN; i += THREADS) {
                const int g = i / BN, c = i % BN;
                const int k = k0 + 4 * g, n = n0 + c;
                ws[g][c] = (n < N && k < k_end)
                               ? pack4(wq + static_cast<size_t>(k) * N + n, N, k_end - k)
                               : 0u;
            }
        }
        __syncthreads();
#pragma unroll 4
        for (int g = 0; g < KW; ++g) {
            const int w4 = static_cast<int>(ws[g][tx]);
#pragma unroll
            for (int j = 0; j < RPT; ++j) {
                const int r = ty + RG * j;
                if (r < rows) acc[j] = __dp4a(static_cast<int>(xs[r][g]), w4, acc[j]);
            }
        }
        __syncthreads();
    }

    const int n = n0 + tx;
    if (n >= N) return;
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
        const int r = ty + RG * j;
        if (r >= rows) continue;
        const int m = m0 + r;
        if (part != nullptr) {
            part[(static_cast<size_t>(blockIdx.z) * M + m) * N + n] = acc[j];
        } else {
            out[static_cast<size_t>(m) * N + n] = epilogue(acc[j], sx[m], sw[n]);
        }
    }
}

__global__ void fixmatmul_reduce(const int32_t* __restrict__ part, const float* __restrict__ sx,
                                 const float* __restrict__ sw, float* __restrict__ out,
                                 int M, int N, int splits) {
    const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    const size_t mn = static_cast<size_t>(M) * N;
    if (i >= mn) return;
    uint32_t acc = 0;                     // wraps like the int32 accumulator
    for (int s = 0; s < splits; ++s) acc += static_cast<uint32_t>(part[s * mn + i]);
    out[i] = epilogue(static_cast<int32_t>(acc), sx[i / N], sw[i % N]);
}

template <int RPT>
void launch_tiles(const void* xq, const void* wq, const void* sx, const void* sw, void* out,
                  int32_t* part, int M, int K, int N, int splits, int k_per_split,
                  cudaStream_t st) {
    const int vec_x = (K % 4 == 0) && (reinterpret_cast<uintptr_t>(xq) % 4 == 0);
    const int vec_w = (N % 4 == 0) && (reinterpret_cast<uintptr_t>(wq) % 4 == 0);
    dim3 grid((N + BN - 1) / BN, (M + RG * RPT - 1) / (RG * RPT), splits);
    fixmatmul_kernel<RPT><<<grid, THREADS, 0, st>>>(
        static_cast<const int8_t*>(xq), static_cast<const int8_t*>(wq),
        static_cast<const float*>(sx), static_cast<const float*>(sw), static_cast<float*>(out),
        part, M, K, N, k_per_split, vec_x, vec_w);
}


// ---------------------------------------------------------------------------
// The streaming kernel (M <= 16)
// ---------------------------------------------------------------------------

constexpr int WARPS = THREADS / 32;
constexpr int STREAM_MAX_M = 16;       // rows it takes: two n8 tiles of the batch
constexpr int STAGES = 4;              // shared-memory ring; STAGES - 1 stages in flight
constexpr int MAX_CLUSTER = 8;         // K splits of one column tile (portable cluster size)
constexpr int K_STEP = 32;             // k of one mma; a K split is whole steps

template <int BN, int MR>
struct Stream {
    static constexpr int STRIPS = BN / 32;              // 32-column strips, one a warp
    static constexpr int KWARPS = WARPS / STRIPS;       // warps side by side along k
    static constexpr int BK = K_STEP * KWARPS;          // k rows a stage, one step a warp
    static constexpr int W_BYTES = BK * BN;             // 8 KB of weights a stage
    static constexpr int X_LD = BK + 16;                // activation row (bytes), padded
    static constexpr int X_CHUNKS = MR * BK / 16;
    static constexpr int STAGE = W_BYTES + MR * X_LD;
    static constexpr int SMEM = STAGES * STAGE;         // dynamic; the sums are static
    static_assert(W_BYTES == 8192 && W_BYTES / 16 == 2 * THREADS, "two weight copies a thread");
    static_assert(STAGE % 16 == 0 && X_CHUNKS <= THREADS, "stage layout");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled (nothing read) when !in.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool in) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// The first `valid` of the 16 bytes at p (zero past them), by byte loads:
// the path of rows that are not 16-byte aligned.
__device__ __forceinline__ uint4 load16(const int8_t* p, int valid) {
    uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int i = 0; i < 16; ++i)
        if (i < valid) w[i / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(__ldg(p + i))) << (8 * (i % 4));
    return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void sts128(uint32_t dst, uint4 v) {
    asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst), "r"(v.x), "r"(v.y),
                 "r"(v.z), "r"(v.w)
                 : "memory");
}

// Byte offset of (row r, byte c) in a stage's BK x BN weight tile.  The
// 32-byte units of each 128-byte line are XOR-ed with bits 2-3 of the row,
// so the rows 4t + b (t = 0..3) that one fragment load reads lie in four
// different quarters of the banks.
template <int BN>
__device__ __forceinline__ int w_off(int r, int c) {
    return (r * BN + c) ^ (((r >> 2) & 3) << 5);
}

// The thread-block cluster: its size and this block's rank (1 and 0 when
// launched without one), the split barrier, and a store into the shared
// memory of another block of the cluster.
__device__ __forceinline__ uint32_t cluster_size() {
    uint32_t n;
    asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
    return n;
}
__device__ __forceinline__ uint32_t cluster_rank() {
    uint32_t r;
    asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
    return r;
}
__device__ __forceinline__ void cluster_arrive() {
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void st_cluster(uint32_t local, uint32_t rank, int32_t v) {
    uint32_t remote;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(local), "r"(rank));
    asm volatile("st.shared::cluster.u32 [%0], %1;\n" ::"r"(remote), "r"(v) : "memory");
}

// d += a (16 x 32, row) * b (32 x 8, col), s8 in, s32 accumulate.
__device__ __forceinline__ void mma_s8(int32_t (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Word b of r holds row k + b of columns c..c+3; word j of w gets column
// c + j of rows k..k+3 (k-packed, low byte first).
__device__ __forceinline__ void transpose4(const uint32_t (&r)[4], uint32_t (&w)[4]) {
    const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
    const uint32_t t1 = __byte_perm(r[2], r[3], 0x5140);
    const uint32_t t2 = __byte_perm(r[0], r[1], 0x7362);
    const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
    w[0] = __byte_perm(t0, t1, 0x5410);
    w[1] = __byte_perm(t0, t1, 0x7632);
    w[2] = __byte_perm(t2, t3, 0x5410);
    w[3] = __byte_perm(t2, t3, 0x7632);
}

// Grid (column tiles, 1, splits), clusters of (1, 1, splits) at splits > 1:
// block z sums k in [z * k_per_split, min(K, (z + 1) * k_per_split)) for
// columns n0..n0+BN-1, the cluster adds its blocks' sums and each block
// writes the columns it owns.
template <int BN, int MR>
__global__ void __launch_bounds__(THREADS, 4)
fixmatmul_stream_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ wq,
                        const float* __restrict__ sx, const float* __restrict__ sw,
                        float* __restrict__ out, int M, int K, int N, int k_per_split,
                        int vec_x, int vec_w) {
    using S = Stream<BN, MR>;
    // Launched as a programmatic dependent: the blocks may start while the
    // previous kernel drains; nothing is read or written before it is done.
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
    extern __shared__ __align__(128) unsigned char smem[];
    __shared__ int32_t sums[MR][BN + 1];           // this block's sums over its K range
    __shared__ int32_t slots[MR * (BN + MAX_CLUSTER)];  // at cs > 1: each block's sums of the
                                                   // columns this block owns, [q][m][c - lo]
    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    const int strip = warp % S::STRIPS, kw = warp / S::STRIPS;
    const int g = lane / 4, t = lane % 4;          // mma groupID, thread in group
    const int n0 = blockIdx.x * BN;
    const int k_begin = blockIdx.z * k_per_split;
    const int k_end = min(K, k_begin + k_per_split);
    const int stages = k_end > k_begin ? (k_end - k_begin + S::BK - 1) / S::BK : 0;
    const uint32_t sbase = smem_u32(smem);
    const int cs = static_cast<int>(cluster_size());
    const int rank = static_cast<int>(cluster_rank());
    for (int i = tid; i < MR * (BN + 1); i += THREADS) (&sums[0][0])[i] = 0;
    if (cs > 1) cluster_arrive_relaxed();          // waited for before the first remote store

    // Stage st into ring slot st % STAGES: weight rows past k_end and
    // columns past N, and activation rows past M, are zero-filled.
    auto issue = [&](int st) {
        if (st < stages) {
            const uint32_t slot = sbase + (st % STAGES) * S::STAGE;
            const int k0 = k_begin + st * S::BK;
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                const int i = tid + j * THREADS;
                const int r = i / (BN / 16), c = 16 * (i % (BN / 16));
                const int k = k0 + r, n = n0 + c;
                const int8_t* src = wq + static_cast<size_t>(k) * N + n;
                const uint32_t dst = slot + w_off<BN>(r, c);
                if (vec_w) {
                    const bool in = k < k_end && n < N;
                    cp_async16(dst, in ? src : wq, in);
                } else {
                    sts128(dst, load16(src, k < k_end ? N - n : 0));
                }
            }
            if (tid < S::X_CHUNKS) {
                const int m = tid / (S::BK / 16), c = 16 * (tid % (S::BK / 16));
                const int8_t* src = xq + static_cast<size_t>(m) * K + k0 + c;
                const uint32_t dst = slot + S::W_BYTES + m * S::X_LD + c;
                const int valid = m < M ? k_end - (k0 + c) : 0;
                if (vec_x) cp_async16(dst, valid > 0 ? src : xq, valid > 0);
                else sts128(dst, load16(src, valid));
            }
        }
        cp_async_commit();                         // empty past the last stage
    };

    int32_t acc[MR / 8][2][4];
#pragma unroll
    for (int h = 0; h < MR / 8; ++h)
#pragma unroll
        for (int p = 0; p < 2; ++p)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[h][p][i] = 0;

#pragma unroll
    for (int st = 0; st < STAGES - 1; ++st) issue(st);
    // The epilogue's scales, fetched while the first stages are in flight.
    __shared__ float sx_s[MR], sw_s[BN];
    if (tid < MR) sx_s[tid] = tid < M ? sx[tid] : 0.0f;
    if (tid < BN) sw_s[tid] = n0 + tid < N ? sw[n0 + tid] : 0.0f;
    for (int st = 0; st < stages; ++st) {
        cp_async_wait<STAGES - 2>();               // stage st has landed for this thread ...
        __syncthreads();                           // ... and for all; slot st-1 is free
        issue(st + STAGES - 1);
        const unsigned char* ws = smem + (st % STAGES) * S::STAGE;
        const unsigned char* xs = ws + S::W_BYTES;
        const int kb = K_STEP * kw;
        // A fragments: mma p takes columns 4g + 2p (row g) and 4g + 2p + 1
        // (row g + 8) of the strip; regs 0-1 hold k 4t..4t+3, regs 2-3 16+4t..
        uint32_t a[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
            uint32_t r[4], w[4];
#pragma unroll
            for (int b = 0; b < 4; ++b)
                r[b] = *reinterpret_cast<const uint32_t*>(
                    ws + w_off<BN>(kb + 16 * j + 4 * t + b, 32 * strip + 4 * g));
            transpose4(r, w);
            a[0][2 * j] = w[0];
            a[0][2 * j + 1] = w[1];
            a[1][2 * j] = w[2];
            a[1][2 * j + 1] = w[3];
        }
        // B fragments: batch row 8h + g, k 4t..4t+3 and 16+4t..
#pragma unroll
        for (int h = 0; h < MR / 8; ++h) {
            const unsigned char* xr = xs + (8 * h + g) * S::X_LD + kb + 4 * t;
            const uint32_t b0 = *reinterpret_cast<const uint32_t*>(xr);
            const uint32_t b1 = *reinterpret_cast<const uint32_t*>(xr + 16);
            mma_s8(acc[h][0], a[0], b0, b1);
            mma_s8(acc[h][1], a[1], b0, b1);
        }
    }
    cp_async_wait<0>();
    __syncthreads();                               // sums zeroed

    // The warps' sums into this block's sums (the C fragment of mma p holds
    // column 4g + 2p in regs 0-1 and 4g + 2p + 1 in regs 2-3, batch rows 2t
    // and 2t + 1).  Integer adds are exact in any order and wrap like the
    // int32 accumulator.
#pragma unroll
    for (int h = 0; h < MR / 8; ++h)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int m = 8 * h + 2 * t + i;
            if (m >= M) continue;
#pragma unroll
            for (int j = 0; j < 4; ++j)
                atomicAdd(&sums[m][32 * strip + 4 * g + j], acc[h][j / 2][2 * (j % 2) + i]);
        }
    __syncthreads();

    // Block `rank` of the cluster owns columns lo..hi-1 (column c belongs
    // to rank c * cs / BN).  Every block stores its sums of each column into
    // the owner's slots (distributed shared memory), and after one cluster
    // barrier each owner adds its slots and writes out.
    const int lo = (rank * BN + cs - 1) / cs, width = ((rank + 1) * BN + cs - 1) / cs - lo;
    const int wmax = (BN + cs - 1) / cs;
    if (cs > 1) {
        cluster_wait();                            // every block of the cluster has started
        for (int e = tid; e < M * BN; e += THREADS) {
            const int m = e / BN, c = e % BN;
            const int r = c * cs / BN, c0 = (r * BN + cs - 1) / cs;
            st_cluster(smem_u32(&slots[(rank * MR + m) * wmax + c - c0]), r, sums[m][c]);
        }
        cluster_arrive();                          // release: this block's stores are done ...
        cluster_wait();                            // ... acquire: so are everyone's
    }
    for (int e = tid; e < M * width; e += THREADS) {
        const int m = e / width, c = lo + e % width, n = n0 + c;
        uint32_t s = static_cast<uint32_t>(sums[m][c]);
        if (cs > 1) {
            s = 0;
            for (int q = 0; q < cs; ++q) s += static_cast<uint32_t>(slots[(q * MR + m) * wmax + c - lo]);
        }
        if (n < N) out[static_cast<size_t>(m) * N + n] = epilogue(static_cast<int32_t>(s), sx_s[m], sw_s[c]);
    }
}

template <int BN, int MR>
int launch_stream(const void* xq, const void* wq, const void* sx, const void* sw, void* out,
                  int M, int K, int N, int splits, int k_per_split, cudaStream_t st) {
    auto kern = fixmatmul_stream_kernel<BN, MR>;
    constexpr int smem = Stream<BN, MR>::SMEM;
    static unsigned long long opted_in = 0;        // one bit a device, once per instance
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
    if (!(opted_in >> dev & 1ULL)) {
        e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e == cudaSuccess)
            e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                                     cudaSharedmemCarveoutMaxShared);
        if (e != cudaSuccess) return static_cast<int>(e);
        opted_in |= 1ULL << dev;
    }
    cudaLaunchAttribute attr[2];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    attr[1].id = cudaLaunchAttributeClusterDimension;      // the K splits, when there are some
    attr[1].val.clusterDim.x = 1;
    attr[1].val.clusterDim.y = 1;
    attr[1].val.clusterDim.z = static_cast<unsigned>(splits);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>((N + BN - 1) / BN), 1, static_cast<unsigned>(splits));
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cfg.attrs = attr;
    cfg.numAttrs = splits > 1 ? 2 : 1;
    const int vec_x = (K % 16 == 0) && (reinterpret_cast<uintptr_t>(xq) % 16 == 0);
    const int vec_w = (N % 16 == 0) && (reinterpret_cast<uintptr_t>(wq) % 16 == 0);
    return static_cast<int>(cudaLaunchKernelEx(
        &cfg, kern, static_cast<const int8_t*>(xq), static_cast<const int8_t*>(wq),
        static_cast<const float*>(sx), static_cast<const float*>(sw), static_cast<float*>(out), M,
        K, N, k_per_split, vec_x, vec_w));
}

template <int MR>
int stream_tile(int tile, const void* xq, const void* wq, const void* sx, const void* sw,
                void* out, int M, int K, int N, int splits, int k_per_split, cudaStream_t st) {
    switch (tile) {
        case 64: return launch_stream<64, MR>(xq, wq, sx, sw, out, M, K, N, splits, k_per_split, st);
        case 128: return launch_stream<128, MR>(xq, wq, sx, sw, out, M, K, N, splits, k_per_split, st);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // namespace

// Plain C interface for ctypes.  xq (M, K) int8, wq (K, N) int8, sx (M,)
// f32, sw (N,) f32, out (M, N) f32, all contiguous.  `kernel` 1 is the
// streaming kernel: M <= 16, `tile` the column tile (64 or 128),
// 1 <= splits <= 8 (the cluster size), `k_per_split` a multiple of 32;
// `part` is not used.  `kernel` 0 is the tiled kernel at any M: `tile` the
// rows per thread (1, 2, 4, 8 or 16), `k_per_split` a multiple of 64, and
// `part` (splits, M, N) int32 scratch when splits > 1.  Either way splits *
// k_per_split >= K.  Launches on `stream` and returns the CUDA error
// (0 = launched); cudaErrorInvalidValue for parameters it does not take.
extern "C" int fixmatmul_launch(const void* xq, const void* wq, const void* sx, const void* sw,
                                void* out, void* part, int M, int K, int N, int kernel, int tile,
                                int splits, int k_per_split, void* stream) {
    const int invalid = static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (M < 0 || K < 0 || N < 0 || splits < 1 || k_per_split < 1 ||
        static_cast<long long>(splits) * k_per_split < K)
        return invalid;
    if (kernel == 1) {
        if (M > STREAM_MAX_M || splits > MAX_CLUSTER || k_per_split % K_STEP != 0) return invalid;
        if (tile != 64 && tile != 128) return invalid;
        if (M > 0 && N > 0) {
            const int err = M <= 8 ? stream_tile<8>(tile, xq, wq, sx, sw, out, M, K, N, splits, k_per_split, st)
                                   : stream_tile<16>(tile, xq, wq, sx, sw, out, M, K, N, splits, k_per_split, st);
            if (err != 0) return err;
        }
    } else if (kernel == 0) {
        if (k_per_split % BK != 0 || (splits > 1 && part == nullptr)) return invalid;
        if (M > 0 && N > 0) {
            int32_t* p = splits > 1 ? static_cast<int32_t*>(part) : nullptr;
            switch (tile) {
                case 1: launch_tiles<1>(xq, wq, sx, sw, out, p, M, K, N, splits, k_per_split, st); break;
                case 2: launch_tiles<2>(xq, wq, sx, sw, out, p, M, K, N, splits, k_per_split, st); break;
                case 4: launch_tiles<4>(xq, wq, sx, sw, out, p, M, K, N, splits, k_per_split, st); break;
                case 8: launch_tiles<8>(xq, wq, sx, sw, out, p, M, K, N, splits, k_per_split, st); break;
                case 16: launch_tiles<16>(xq, wq, sx, sw, out, p, M, K, N, splits, k_per_split, st); break;
                default: return invalid;
            }
            if (splits > 1) {
                const size_t mn = static_cast<size_t>(M) * N;
                const int block = 256;
                fixmatmul_reduce<<<static_cast<unsigned>((mn + block - 1) / block), block, 0, st>>>(
                    p, static_cast<const float*>(sx), static_cast<const float*>(sw),
                    static_cast<float*>(out), M, N, splits);
            }
        }
    } else {
        return invalid;
    }
    return static_cast<int>(cudaGetLastError());
}
