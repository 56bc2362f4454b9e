// Fused W8A8 matmul for Hopper (sm_90a): per-row dynamic int8 quantization of
// the activations, int8 x int8 -> int32 on the tensor cores, rescale by the
// row and column scales, in one launch.
//
// Replaces f5tts_tpu/ops/pallas/quant_matmul.py:quant_matmul (kernel _kernel).
// For x (M, K) in bf16 or fp32, w_q int8 and s_w (N,) fp32:
//   ax  = max_k |x[m, k]|                               fp32, over the whole K
//   sx  = max(max(ax, amax_floor) / 127, scale_floor)   a true division
//   xq  = rint(x / sx)                                  half to even, a true division, int8
//   acc = xq . w_q                                      int32, exact
//   out = (float(acc) * sx) * s_w[n]                    fp32, in that order, one rounding to x's type
// The two floors are arguments because the JAX package has two conventions:
// its Pallas kernel floors the abs-max at 1e-6 (amax_floor = 1e-6, scale_floor
// = 0), its `_linear_int8` floors the scale at 1e-8 (amax_floor = 0,
// scale_floor = 1e-8). They differ only for rows whose abs-max is below 1.27e-6.
// Every step is exact integer arithmetic or one correctly rounded fp32
// operation, so the result equals the plain PyTorch version bit for bit.
//
// Bound: at the serving shapes (M 16384, K and N 1024-2048) the bytes of x and
// the output at the memory rate (~0.02 ms) just exceed 2MKN at the int8
// tensor-core peak (~0.017 ms); the weights are small and shared by all rows.
//
// Design:
// - The row scale needs the whole row before the first product. A block owns
//   BM rows and keeps their int8 copy for the whole K in shared memory
//   (BM x K bytes: 128 x 1024 or 64 x 2048), built once: one pass over the
//   rows for the abs-max, a second (an L1/L2 hit) to quantize. The block then
//   walks ALL N tiles of its rows, so no row is quantized twice (a grid over
//   (M, N) tiles would repeat the quantization N / 128 times). What it costs:
//   every block streams the whole weight matrix from the L2 (M / BM x K x N
//   bytes in all), the abs-max pass runs before any product of the block, and
//   with one block per SM nothing overlaps the two phases.
// - The int8 mma wants both operands K-contiguous, and `ldmatrix.trans` moves
//   16-bit elements only, so the weights arrive in a kernel layout (N, K)
//   made ONCE when the parameters are quantized (the wrapper's `w_qt`), never
//   per call. Tiles of 128 (n) x 128 (k) bytes stream through a 3-stage
//   cp.async ring, one __syncthreads per tile.
// - mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32; 8 warps tile the BM x 128
//   output tile; fragments are plain 32-bit shared-memory loads, conflict-free
//   through the 16-byte row padding.
// - Any M (the last tile's missing rows are zero and never written); K and N
//   multiples of 16 (K is zero-padded to the 128-byte tile in shared memory);
//   K up to what 32 rows of shared memory hold.
// On the card the kernel runs at a fifth of what mma.sync s8 alone runs at
// (PERF.md has the times and what was tried); wgmma, TMA and overlapping the
// quantize pass of one row block with the products of another are later work.

#include <cstdint>

#include "attention.cuh"
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using f5::cp_async16;
using f5::cp_async_commit;
using f5::cp_async_wait_one;

constexpr int NW = 8;  // warps per block
constexpr int NTHREADS = NW * 32;
constexpr int BN = 128;        // output columns per tile
constexpr int BK = 128;        // bytes of K per streamed weight tile
constexpr int STAGES = 3;      // weight tiles in flight (cp_async_wait_one leaves STAGES - 2 pending)
constexpr int PAD = 16;        // bytes of padding per shared-memory row: fragment loads hit 32 distinct banks
constexpr int LDB = BK + PAD;  // row stride of a weight tile
constexpr int MAX_SMEM = 232448;  // bytes of dynamic shared memory a block may ask for on sm_90
static_assert(STAGES == 3, "the ring waits with cp_async_wait_one");

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

// Eight consecutive elements of a row, as floats (one or two 16-byte loads).
template <typename T> struct Row8;
template <> struct Row8<float> {
    static __device__ __forceinline__ void load(const float* p, float (&v)[8]) {
        const float4 a = *reinterpret_cast<const float4*>(p);
        const float4 b = *reinterpret_cast<const float4*>(p + 4);
        v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
        v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    }
};
template <> struct Row8<bf16> {
    static __device__ __forceinline__ void load(const bf16* p, float (&v)[8]) {
        const uint4 raw = *reinterpret_cast<const uint4*>(p);
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const float2 f = __bfloat1622float2(h[i]);
            v[2 * i] = f.x;
            v[2 * i + 1] = f.y;
        }
    }
};

__device__ __forceinline__ void store2(float* p, float a, float b) { *reinterpret_cast<float2*>(p) = make_float2(a, b); }
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) { return *reinterpret_cast<const uint32_t*>(p); }

// c (16 x 8 int32) += a (16 x 32 int8, row-major) . b (32 x 8 int8, K-contiguous per column).
// With g = lane / 4, tq = lane % 4, each register holds 4 consecutive k:
//   a[0] = A[g][4tq..], a[1] = A[g+8][4tq..], a[2] = A[g][16+4tq..], a[3] = A[g+8][16+4tq..]
//   b[0] = B[4tq..][g], b[1] = B[16+4tq..][g]
//   c[0..1] = C[g][2tq..2tq+1], c[2..3] = C[g+8][2tq..2tq+1]
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
    return x;
}

__device__ __forceinline__ uint32_t pack4(int q0, int q1, int q2, int q3) {
    return (uint32_t)(q0 & 0xff) | ((uint32_t)(q1 & 0xff) << 8) | ((uint32_t)(q2 & 0xff) << 16) |
           ((uint32_t)(q3 & 0xff) << 24);
}

// x, out: (M, K) / (M, N) row-major; wt: (N, K) int8 row-major (the kernel
// layout of w_q); s_w: (N,) fp32. Grid ceil(M / BM), NTHREADS threads, dynamic
// shared memory BM * (Kp + PAD) + STAGES * BN * LDB + BM * 4 bytes with
// Kp = round_up(K, BK). The 8 warps tile the BM x BN output as WM x WN.
template <typename T, int BM, int WM, int WN>
__global__ void __launch_bounds__(NTHREADS)
quant_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ wt, const float* __restrict__ s_w,
                    T* __restrict__ out, int M, int K, int N, float amax_floor, float scale_floor) {
    static_assert(WM * WN == NW, "warp grid must use all warps");
    constexpr int TM = BM / WM, TN = BN / WN;  // one warp's output tile
    constexpr int MT = TM / 16, NT = TN / 8;   // in mma tiles
    static_assert(TM % 16 == 0 && TN % 8 == 0, "warp tile must hold whole mma tiles");

    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int Kp = round_up(K, BK);
    const int lda = Kp + PAD;
    int8_t* As = reinterpret_cast<int8_t*>(smem_raw);                           // (BM, lda) quantized rows
    int8_t* Bs = As + (size_t)BM * lda;                                          // STAGES x (BN, LDB) weight tiles
    float* sx_s = reinterpret_cast<float*>(Bs + (size_t)STAGES * BN * LDB);      // (BM,) row scales

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, tq = lane & 3;
    const int m0 = blockIdx.x * BM;
    const int n_tiles = (N + BN - 1) / BN, k_tiles = Kp / BK;

    // The next weight tile (n tile ld_nt, k tile ld_kt) into ring slot ld_slot;
    // rows past N and bytes past K arrive as zeros. Always commits, so group
    // counts match. Tiles are walked with counters: a division by k_tiles per
    // tile would sit, unhidden, in front of every tile's products.
    int ld_nt = 0, ld_kt = 0, ld_slot = 0;
    auto load_next_tile = [&]() {
        if (ld_nt < n_tiles) {
            const int n_base = ld_nt * BN, k_base = ld_kt * BK;
            int8_t* dst = Bs + (size_t)ld_slot * BN * LDB;
            for (int c = tid; c < BN * (BK / 16); c += NTHREADS) {
                const int nl = c / (BK / 16), kc = (c % (BK / 16)) * 16;
                const int n = n_base + nl, k = k_base + kc;
                const bool valid = n < N && k < K;  // K % 16 == 0: a chunk is whole or absent
                cp_async16(dst + nl * LDB + kc, wt + (valid ? (size_t)n * K + k : 0), valid);
            }
            if (++ld_kt == k_tiles) { ld_kt = 0; ++ld_nt; }
            if (++ld_slot == STAGES) ld_slot = 0;
        }
        cp_async_commit();
    };
    load_next_tile();  // in flight while the rows are quantized
    load_next_tile();

    // ---- phase 1: abs-max, scale and int8 copy of this block's rows ---------
    for (int r = warp; r < BM; r += NW) {
        const int row = m0 + r;
        int8_t* arow = As + (size_t)r * lda;
        if (row >= M) {  // past the ragged edge: zeros, never written out
            for (int k = lane * 16; k < Kp; k += 32 * 16) *reinterpret_cast<uint4*>(arow + k) = make_uint4(0, 0, 0, 0);
            if (lane == 0) sx_s[r] = 0.0f;
            continue;
        }
        const T* xr = x + (size_t)row * K;
        float amax = 0.0f;
#pragma unroll 4
        for (int k = lane * 8; k < K; k += 32 * 8) {
            float v[8];
            Row8<T>::load(xr + k, v);
#pragma unroll
            for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(v[e]));
        }
        amax = warp_max(amax);
        const float sx = fmaxf(__fdiv_rn(fmaxf(amax, amax_floor), 127.0f), scale_floor);
        if (lane == 0) sx_s[r] = sx;
#pragma unroll 4
        for (int k = lane * 8; k < Kp; k += 32 * 8) {
            uint2 q = make_uint2(0u, 0u);
            if (k < K) {  // K % 8 == 0: a group of 8 is whole or absent
                float v[8];
                Row8<T>::load(xr + k, v);
                int qi[8];
#pragma unroll
                for (int e = 0; e < 8; ++e) qi[e] = __float2int_rn(__fdiv_rn(v[e], sx));  // rint, half to even
                q.x = pack4(qi[0], qi[1], qi[2], qi[3]);
                q.y = pack4(qi[4], qi[5], qi[6], qi[7]);
            }
            *reinterpret_cast<uint2*>(arow + k) = q;
        }
    }

    // ---- phase 2: all N tiles of these rows ----------------------------------
    const int wm = warp / WN, wn = warp % WN;
    int acc[MT][NT][4];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int ni = 0; ni < NT; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

    int slot = 0;
    for (int nt = 0; nt < n_tiles; ++nt)
    for (int kt = 0; kt < k_tiles; ++kt) {
        cp_async_wait_one();  // this tile has landed (one newer group may still be in flight)
        __syncthreads();      // ... for every thread; the rows' int8 copy is visible; the previous tile's slot is free
        load_next_tile();
        const int8_t* bs = Bs + (size_t)slot * BN * LDB;
        if (++slot == STAGES) slot = 0;
#pragma unroll
        for (int ks = 0; ks < BK / 32; ++ks) {
            uint32_t a[MT][4], b[NT][2];
#pragma unroll
            for (int mi = 0; mi < MT; ++mi) {
                const int8_t* p = As + (size_t)(wm * TM + mi * 16 + g) * lda + kt * BK + ks * 32 + tq * 4;
                a[mi][0] = lds32(p);
                a[mi][1] = lds32(p + 8 * lda);
                a[mi][2] = lds32(p + 16);
                a[mi][3] = lds32(p + 8 * lda + 16);
            }
#pragma unroll
            for (int ni = 0; ni < NT; ++ni) {
                const int8_t* p = bs + (wn * TN + ni * 8 + g) * LDB + ks * 32 + tq * 4;
                b[ni][0] = lds32(p);
                b[ni][1] = lds32(p + 16);
            }
#pragma unroll
            for (int mi = 0; mi < MT; ++mi)
#pragma unroll
                for (int ni = 0; ni < NT; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni]);
        }
        if (kt == k_tiles - 1) {  // this N tile is complete: rescale, write, start the next
            const int n0 = nt * BN + wn * TN;
#pragma unroll
            for (int ni = 0; ni < NT; ++ni) {
                const int col = n0 + ni * 8 + tq * 2;
                const bool col_ok = col < N;  // N % 2 == 0: the pair is whole or absent
                const float sw0 = col_ok ? __ldg(s_w + col) : 0.0f;
                const float sw1 = col_ok ? __ldg(s_w + col + 1) : 0.0f;
#pragma unroll
                for (int mi = 0; mi < MT; ++mi)
#pragma unroll
                    for (int half = 0; half < 2; ++half) {
                        const int r = wm * TM + mi * 16 + g + half * 8;
                        const int row = m0 + r;
                        if (col_ok && row < M) {
                            const float sx = sx_s[r];
                            const float v0 = __fmul_rn(__fmul_rn(__int2float_rn(acc[mi][ni][half * 2]), sx), sw0);
                            const float v1 = __fmul_rn(__fmul_rn(__int2float_rn(acc[mi][ni][half * 2 + 1]), sx), sw1);
                            store2(out + (size_t)row * N + col, v0, v1);
                        }
                        acc[mi][ni][half * 2] = 0;
                        acc[mi][ni][half * 2 + 1] = 0;
                    }
            }
        }
    }
}

__global__ void __launch_bounds__(NTHREADS) mma_rate_kernel(int iters, int* sink) {
    int acc[8][4] = {};
    uint32_t a[4] = {threadIdx.x, threadIdx.x * 3u, threadIdx.x * 5u, threadIdx.x * 7u};
    uint32_t b[2] = {threadIdx.x * 11u, threadIdx.x * 13u};
    for (int i = 0; i < iters; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) mma_s8(acc[j], a, b);
    }
    int sum = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) sum += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
    if (sum == 0x7fffffff) *sink = sum;  // practically never: the store only keeps the products alive
}

size_t smem_bytes(int bm, int k) {
    return (size_t)bm * (round_up(k, BK) + PAD) + (size_t)STAGES * BN * LDB + (size_t)bm * sizeof(float);
}

// Rows per block: the most whose int8 copy fits (one pass over the weights per
// 128 rows), halved while fewer than half the card's 132 SMs would get a block.
int pick_bm(int m, int k) {
    int bm = 0;
    for (int cand = 128; cand >= 32 && bm == 0; cand /= 2)
        if (smem_bytes(cand, k) <= (size_t)MAX_SMEM) bm = cand;
    while (bm > 32 && (m + bm - 1) / bm < 66) bm /= 2;
    return bm;
}

template <typename T, int BM, int WM, int WN>
int launch(const void* x, const void* wt, const void* s_w, void* out, int m, int k, int n, float amax_floor,
           float scale_floor, cudaStream_t stream) {
    const size_t smem = smem_bytes(BM, k);
    const cudaError_t err = cudaFuncSetAttribute(quant_matmul_kernel<T, BM, WM, WN>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    quant_matmul_kernel<T, BM, WM, WN><<<(m + BM - 1) / BM, NTHREADS, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const int8_t*>(wt), static_cast<const float*>(s_w),
        static_cast<T*>(out), m, k, n, amax_floor, scale_floor);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_bm(const void* x, const void* wt, const void* s_w, void* out, int m, int k, int n, float amax_floor,
              float scale_floor, cudaStream_t stream) {
    switch (pick_bm(m, k)) {
        case 128: return launch<T, 128, 4, 2>(x, wt, s_w, out, m, k, n, amax_floor, scale_floor, stream);
        case 64: return launch<T, 64, 2, 4>(x, wt, s_w, out, m, k, n, amax_floor, scale_floor, stream);
        case 32: return launch<T, 32, 2, 4>(x, wt, s_w, out, m, k, n, amax_floor, scale_floor, stream);
        default: return (int)cudaErrorInvalidValue;  // K too large for a block's shared memory
    }
}

}  // namespace

extern "C" {

// x: (m, k) contiguous, bf16 (is_bf16 = 1) or fp32; wt: (n, k) int8 contiguous
// (w_q transposed); s_w: (n,) fp32; out: (m, n) in x's type. k and n multiples
// of 16. Returns the cudaError_t of the launch.
int f5_quant_matmul(const void* x, const void* wt, const void* s_w, void* out, int m, int k, int n,
                    float amax_floor, float scale_floor, int is_bf16, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (m < 1 || k < 16 || n < 16 || k % 16 != 0 || n % 16 != 0) return (int)cudaErrorInvalidValue;
    if (is_bf16) return launch_bm<bf16>(x, wt, s_w, out, m, k, n, amax_floor, scale_floor, s);
    return launch_bm<float>(x, wt, s_w, out, m, k, n, amax_floor, scale_floor, s);
}

// Measurement aid (chip_smoke.py): every warp of `blocks` blocks runs
// 8 * iters independent-accumulator mma.sync m16n8k32 s8 products on register
// operands: the rate of the instruction the kernel is built on, with no
// memory in the way. `sink` (>= 4 bytes) only keeps the work alive.
int f5_quant_matmul_mma_rate(int blocks, int iters, void* sink, void* stream) {
    mma_rate_kernel<<<blocks, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(iters, static_cast<int*>(sink));
    return (int)cudaGetLastError();
}

// The largest K whose rows fit a block's shared memory (32 rows per block).
int f5_quant_matmul_max_k() {
    const long long room = (long long)MAX_SMEM - (long long)STAGES * BN * LDB - 32 * (long long)sizeof(float);
    return (int)(room / 32 - PAD) / BK * BK;
}

const char* f5_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
