// fixmatmul.cu — int8 x int8 -> int32 matmul with per-row and per-column
// f32 scales, as a CUDA kernel for Hopper (sm_90a).  It replaces the TPU
// kernel `fixmatmul` of the JAX package
// (src/repro/kernels/fixmatmul/fixmatmul.py, pl.pallas_call), a
// 256x256x256-tiled MXU GEMM with an int32 VMEM accumulator.
//
//     out[m, n] = (f32(sum_k xq[m, k] * wq[k, n]) * sx[m]) * sw[n]
//
// What bounds it on this card: on the serving path M is the batch (1-64)
// and (K, N) a weight matrix of 1.6-82 MB, so every weight byte is used by
// at most M multiply-adds.  The kernel streams int8 weights from device
// memory and is bound by bytes, far below the int8 tensor-core rate.
//
// Design: one block of 256 threads owns 64 output columns and 4 * RPT
// rows, RPT (rows per thread, 1 to 16) chosen from M by the caller so a
// small batch issues no work for rows it does not have.  A loop over K
// stages a 64-deep tile of wq and of xq in shared memory, packed four k to
// a 32-bit word (the weight tile is transposed in registers with
// __byte_perm), and each thread folds them with __dp4a into RPT int32
// accumulators.  No operand is padded: the ragged edges of M, N and K are
// masked.  Few column tiles cannot fill 132 SMs, so K is split across
// blocks (grid z); each split writes its int32 partial sums, and a second
// kernel adds them (integer sums are exact in any order) and applies the
// epilogue.  The epilogue multiplies in the reference's order with
// round-to-nearest and no contraction, so the result is bitwise equal to
// the plain version.  Tensor cores (int8 mma/wgmma) and asynchronous
// copies are later work.
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

}  // namespace

// Plain C interface for ctypes.  xq (M, K) int8, wq (K, N) int8, sx (M,)
// f32, sw (N,) f32, out (M, N) f32, all contiguous; `part` is (splits, M,
// N) int32 scratch when splits > 1, else null.  `rpt` (1, 2, 4, 8 or 16)
// sets the rows per block, 4 * rpt; `k_per_split` is a multiple of 64
// with splits * k_per_split >= K.  Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
extern "C" int fixmatmul_launch(const void* xq, const void* wq, const void* sx, const void* sw,
                                void* out, void* part, int M, int K, int N, int rpt,
                                int splits, int k_per_split, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (M > 0 && N > 0) {
        int32_t* p = splits > 1 ? static_cast<int32_t*>(part) : nullptr;
        switch (rpt) {
            case 1: launch_tiles<1>(xq, wq, sx, sw, out, p, M, K, N, splits, k_per_split, st); break;
            case 2: launch_tiles<2>(xq, wq, sx, sw, out, p, M, K, N, splits, k_per_split, st); break;
            case 4: launch_tiles<4>(xq, wq, sx, sw, out, p, M, K, N, splits, k_per_split, st); break;
            case 8: launch_tiles<8>(xq, wq, sx, sw, out, p, M, K, N, splits, k_per_split, st); break;
            case 16: launch_tiles<16>(xq, wq, sx, sw, out, p, M, K, N, splits, k_per_split, st); break;
            default: return static_cast<int>(cudaErrorInvalidValue);
        }
        if (splits > 1) {
            const size_t mn = static_cast<size_t>(M) * N;
            const int block = 256;
            fixmatmul_reduce<<<static_cast<unsigned>((mn + block - 1) / block), block, 0, st>>>(
                p, static_cast<const float*>(sx), static_cast<const float*>(sw),
                static_cast<float*>(out), M, N, splits);
        }
    }
    return static_cast<int>(cudaGetLastError());
}
