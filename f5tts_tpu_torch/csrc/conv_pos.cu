// The DiT's conv-position pair, two grouped Conv1d + bias + Mish, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel f5tts_tpu/ops/pallas/conv_pos.py:conv_pos_pallas
// (_conv_pos_kernel), which fuses both layers with the intermediate in VMEM.
//
// What it computes, for x (b, n, c) already masked by the caller, w (k,
// c/groups, c) with the group index on the output axis, "same" zero padding
// k//2:
//   y1[b, t, o] = mish(b1[o] + sum_{tap, i} x[b, t + tap - k//2, g*cg + i] * w1[tap, i, o]),
//   zeroed at t >= lens[b] (the intermediate's row boundary), stored as x's type;
//   y = mish(b2 + conv2(y1)) likewise, g = o / cg, fp32 accumulation and Mish.
//
// What bounds it: at the main-path shape (x (16, 1024, 1024) bf16, k = 31,
// 16 groups of 64) the pair is 2 * 2*16*1024*1024*31*64 = 133 GFLOP, about
// 135 us at the 989 TFLOP/s bf16 peak, against about 2 x 33.5 MB of x / y
// traffic (about 20 us at 3.35 TB/s): compute-bound.
//
// Design of the bf16, group-width-64 path (conv_pair_kernel, one launch for
// the pair, y1 never in device memory): a block owns (batch row, group, a
// tile of TT = 256 output frames) and 4 warpgroups. Warpgroup 0 is the
// producer: one thread loads the x slab (TT + 4*pad rows x 64 channels, five
// TMA boxes of 64 rows, zero outside [0, n)) and then streams the 2k tap
// slices of the weights ((64 in x 64 out) bf16, 8 KB each, straight from the
// (k, cg, c) parameter through TMA) into a ring of 4 stages with full/empty
// mbarriers; setmaxnreg gives its registers to the consumers. Warpgroups 1-3
// are consumers: layer 1 computes y1 for TT + 2*pad rows, rounded up to 5
// wgmma tiles of 64 rows (320 rows for 256 frames: 25% recompute of the halo
// and the padding), each tap as wgmma m64n64k16 with A (the slab shifted by
// the tap) in registers through ldmatrix and B (the tap's weight slice,
// MN-major) from shared memory; one tap's products stay in flight while the
// next tap's are issued and its A is loaded. The epilogue adds the bias,
// applies Mish and the masks and writes y1 into shared memory as bf16; layer
// 2 runs the same loop over y1's 4 tiles and stages its bf16 tile in the dead
// slab for 16-byte stores. The 9 tiles go 2 + 1, 2 + 1, 1 + 2 to the three
// consumers (layer 1 + layer 2), fixed at compile time. Each staged tap serves
// 320 (layer 1) or 256 (layer 2) rows. TT = 256, not 128: at 128 layer 1
// needs 3 tiles for 128 frames, 50% recompute against 25%. Three consumers
// with compile-time tile lists, not two that drained the tensor cores after
// every tap: the first took 0.56 ms per call in a CUDA graph on an H100 80GB
// HBM3 at 700 W (PERF.md has this version's time).
//
// fp32 inputs and other group widths or kernel widths over 31 take
// conv_generic_kernel (CUDA cores), one launch per layer: a dispatch by type
// and shape that the wrapper states.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

using f5::from_f;
using f5::to_f;

namespace {

constexpr int TT = 64;  // frames per block of the CUDA-core path
constexpr int NTHREADS = 128;

__device__ __forceinline__ float mish(float x) {
    const float softplus = fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
    return x * tanhf(softplus);
}

template <typename T>
__device__ __forceinline__ void store_out(T* y, const int* lens, float acc, int bi, int t, int n, int c, int ch,
                                          int mask_rows) {
    float val = mish(acc);
    if (mask_rows && t >= lens[bi]) val = 0.0f;
    y[((size_t)bi * n + t) * c + ch] = from_f<T>(val);
}

// ---------------------------------------------------------------------------
// bf16, group width 64: the fused pair on wgmma
// ---------------------------------------------------------------------------

namespace hp = f5::hopper;

constexpr int PT = 256;           // output frames per block
constexpr int PNT1 = 5;           // layer-1 wgmma tiles of 64 rows (PT + 2*pad <= 320)
constexpr int PNT2 = PT / 64;     // layer-2 tiles
constexpr int PROWS = PNT1 * 64;  // slab and y1 rows held in shared memory
constexpr int PKMAX = 31;         // widest kernel the slab holds (PT + 4*15 <= PROWS)
constexpr int PSTAGES = 4;        // weight ring
constexpr int NCW = 3;            // consumer warpgroups
constexpr int PTHREADS = 128 * (NCW + 1);
constexpr int TILE_BYTES = 64 * 128;
constexpr size_t PAIR_SMEM = 1024 + 2 * (size_t)PROWS * 128 + (size_t)PSTAGES * TILE_BYTES + 256;

// Consumer W owns layer-1 tiles W, W + 3 and layer-2 tiles (W + 1) % 3,
// (W + 1) % 3 + 3 (those that exist): 2 + 1, 2 + 1, 1 + 2 tiles. The lists are
// compile-time, so no branch surrounds a wgmma (a runtime one makes ptxas
// serialize them).
template <int W>
struct Tiles {
    static constexpr int FIRST1 = W, N1 = (PNT1 - W + NCW - 1) / NCW;
    static constexpr int FIRST2 = (W + 1) % NCW, N2 = (PNT2 - FIRST2 + NCW - 1) / NCW;
};

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

struct PairRing {
    unsigned char* w;  // PSTAGES tap slices
    uint64_t* full;
    uint64_t* empty;
};

template <int NJ, int FIRST>
__device__ __forceinline__ void load_taps(uint32_t (&a)[NJ][4][4], const unsigned char* src, int tap, int warp,
                                          int lane) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
        // rows past the slab feed only y1 rows that layer 2 never reads
        const int row = min((FIRST + NCW * j) * 64 + warp * 16 + tap, PROWS - 16);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) hp::ldmatrix_a(a[j][kk], src, row, kk * 16, lane);
    }
}

// One tap: issue acc[j] += A(tap) . W(slice) behind the previous tap's
// products (one group stays in flight), then release the previous tap's weight
// slice and load the next tap's A into its registers, `nxt`.
template <int NJ, int FIRST>
__device__ __forceinline__ void tap_step(float (&acc)[NJ][32], uint32_t (&cur)[NJ][4][4], uint32_t (&nxt)[NJ][4][4],
                                         const unsigned char* src, const PairRing& ring, int slice, int tap, int k,
                                         int warp, int lane) {
    const int stage = slice % PSTAGES;
    hp::mbar_wait(&ring.full[stage], (slice / PSTAGES) & 1);
    const unsigned char* wt = ring.w + stage * TILE_BYTES;
    hp::wgmma_fence();
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
            hp::wgmma_m64n64k16_rs<1>(acc[j], cur[j][kk], hp::desc_b128(wt + kk * 2048, TILE_BYTES, 1024), 1);
    hp::wgmma_commit();
    if (tap > 0) {
        hp::wgmma_wait<1>();  // the previous tap's products are done: its slice and its A registers are free
        __syncwarp();
        if (lane == 0) hp::mbar_arrive(&ring.empty[(slice - 1) % PSTAGES]);
    }
    if (tap + 1 < k) load_taps<NJ, FIRST>(nxt, src, tap + 1, warp, lane);
}

// acc[j] = sum over the k taps (weight slices s0 .. s0 + k - 1) of tile
// FIRST + NCW*j of `src`.
template <int NJ, int FIRST>
__device__ __forceinline__ void conv_layer(float (&acc)[NJ][32], const unsigned char* src, const PairRing& ring,
                                           int s0, int k, int warp, int lane) {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 32; ++e) acc[j][e] = 0.0f;
    uint32_t a0[NJ][4][4], a1[NJ][4][4];
    load_taps<NJ, FIRST>(a0, src, 0, warp, lane);
#pragma unroll
    for (int j = 0; j < NJ; ++j) hp::fence_regs(acc[j]);
    for (int tap = 0; tap < k; tap += 2) {
        tap_step<NJ, FIRST>(acc, a0, a1, src, ring, s0 + tap, tap, k, warp, lane);
        if (tap + 1 < k) tap_step<NJ, FIRST>(acc, a1, a0, src, ring, s0 + tap + 1, tap + 1, k, warp, lane);
    }
    hp::wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < NJ; ++j) hp::fence_regs(acc[j]);
    __syncwarp();
    if (lane == 0) hp::mbar_arrive(&ring.empty[(s0 + k - 1) % PSTAGES]);
}

struct PairArgs {
    unsigned char* xs;   // PROWS x 64 bf16, swizzled: the x slab, later the output tile
    unsigned char* y1s;  // PROWS x 64 bf16, swizzled
    PairRing ring;
    const float* b1;
    const float* b2;
    __nv_bfloat16* y;
    int t0, g, bi, n, c, k, len;
};

// Both layers of consumer warpgroup W (thread ctid of the 384 consumers).
template <int W>
__device__ __forceinline__ void pair_consumer(const PairArgs& a, int ctid) {
    using T = Tiles<W>;
    const int warp = (ctid / 32) % 4;
    const int lane = ctid % 32;
    const int gr = lane >> 2, tq = lane & 3;
    const int pad = a.k / 2;

    float acc[T::N1][32];
    conv_layer<T::N1, T::FIRST1>(acc, a.xs, a.ring, 0, a.k, warp, lane);
    // y1 rows r = t - (t0 - pad): bias, Mish, zero outside [0, min(n, lens))
#pragma unroll
    for (int j = 0; j < T::N1; ++j) {
        const int mt = T::FIRST1 + NCW * j;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const int col = 8 * i + 2 * tq;
            const float bb0 = a.b1[a.g * 64 + col], bb1 = a.b1[a.g * 64 + col + 1];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int r = mt * 64 + warp * 16 + gr + 8 * h;
                const int t = a.t0 - pad + r;
                const bool keep = t >= 0 && t < a.n && t < a.len;
                const float v0 = keep ? mish(acc[j][4 * i + 2 * h] + bb0) : 0.0f;
                const float v1 = keep ? mish(acc[j][4 * i + 2 * h + 1] + bb1) : 0.0f;
                *reinterpret_cast<uint32_t*>(a.y1s + hp::swz(r, col)) = pack2(v0, v1);
            }
        }
    }
    hp::named_sync(1, 128 * NCW);  // y1 complete; the slab is no longer read

    float acc2[T::N2][32];
    conv_layer<T::N2, T::FIRST2>(acc2, a.y1s, a.ring, a.k, a.k, warp, lane);
#pragma unroll
    for (int j = 0; j < T::N2; ++j) {
        const int mt = T::FIRST2 + NCW * j;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const int col = 8 * i + 2 * tq;
            const float bb0 = a.b2[a.g * 64 + col], bb1 = a.b2[a.g * 64 + col + 1];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int r = mt * 64 + warp * 16 + gr + 8 * h;
                *reinterpret_cast<uint32_t*>(a.xs + hp::swz(r, col)) =
                    pack2(mish(acc2[j][4 * i + 2 * h] + bb0), mish(acc2[j][4 * i + 2 * h + 1] + bb1));
            }
        }
    }
    hp::named_sync(1, 128 * NCW);
    for (int q = ctid; q < PT * 8; q += 128 * NCW) {  // 16-byte stores of the staged tile
        const int r = q / 8, ch = q % 8;
        const int t = a.t0 + r;
        if (t < a.n)
            *reinterpret_cast<uint4*>(a.y + ((size_t)a.bi * a.n + t) * a.c + a.g * 64 + ch * 8) =
                *reinterpret_cast<const uint4*>(a.xs + r * 128 + ((ch ^ (r & 7)) << 4));
    }
}

__global__ void __launch_bounds__(PTHREADS, 1)
conv_pair_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap w1map,
                 const __grid_constant__ CUtensorMap w2map, const float* __restrict__ b1,
                 const float* __restrict__ b2, const int* __restrict__ lens, __nv_bfloat16* __restrict__ y, int n,
                 int c, int k) {
    extern __shared__ unsigned char smem_raw[];
    unsigned char* base = reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
    PairArgs a;
    a.xs = base;
    a.y1s = a.xs + PROWS * 128;
    a.ring.w = a.y1s + PROWS * 128;
    a.ring.full = reinterpret_cast<uint64_t*>(a.ring.w + PSTAGES * TILE_BYTES);
    a.ring.empty = a.ring.full + PSTAGES;
    uint64_t* xbar = a.ring.empty + PSTAGES;
    a.t0 = blockIdx.x * PT;
    a.g = blockIdx.y;
    a.bi = blockIdx.z;
    a.b1 = b1;
    a.b2 = b2;
    a.y = y;
    a.n = n;
    a.c = c;
    a.k = k;
    const int pad = k / 2;
    const int tid = threadIdx.x;
    if (tid == 0) {
        for (int s = 0; s < PSTAGES; ++s) {
            hp::mbar_init(&a.ring.full[s], 1);
            hp::mbar_init(&a.ring.empty[s], 4 * NCW);  // one arrival per consumer warp
        }
        hp::mbar_init(xbar, 1);
        hp::mbar_init_fence();
    }
    __syncthreads();

    if (tid < 128) {  // producer warpgroup: one thread issues every copy
        hp::setmaxnreg_dec<24>();
        if (tid == 0) {
            hp::mbar_arrive_expect_tx(xbar, PNT1 * TILE_BYTES);
            for (int i = 0; i < PNT1; ++i)
                hp::tma_load_3d(a.xs + i * TILE_BYTES, &xmap, xbar, a.g * 64, a.t0 - 2 * pad + 64 * i, a.bi);
            for (int s = 0; s < 2 * k; ++s) {
                const int stage = s % PSTAGES;
                hp::mbar_wait(&a.ring.empty[stage], ((s / PSTAGES) & 1) ^ 1);
                hp::mbar_arrive_expect_tx(&a.ring.full[stage], TILE_BYTES);
                hp::tma_load_3d(a.ring.w + stage * TILE_BYTES, s < k ? &w1map : &w2map, &a.ring.full[stage],
                                a.g * 64, 0, s < k ? s : s - k);
            }
        }
    } else {  // consumer warpgroups 1-3 (W = 0, 1, 2)
        hp::setmaxnreg_inc<160>();
        a.len = lens[a.bi];
        hp::mbar_wait(xbar, 0);
        const int ctid = tid - 128;
        if (ctid < 128)
            pair_consumer<0>(a, ctid);
        else if (ctid < 256)
            pair_consumer<1>(a, ctid);
        else
            pair_consumer<2>(a, ctid);
    }
}

// ---------------------------------------------------------------------------
// fp32, or other group widths: one layer on the CUDA cores
// ---------------------------------------------------------------------------

// CUDA-core path: any type, any group width.
template <typename T>
__global__ void __launch_bounds__(NTHREADS)
conv_generic_kernel(const T* __restrict__ x, const T* __restrict__ w, const float* __restrict__ bias,
                    const int* __restrict__ lens, T* __restrict__ y, int n, int c, int cg, int k, int mask_rows) {
    extern __shared__ __align__(128) unsigned char smem_raw[];
    T* Xs = reinterpret_cast<T*>(smem_raw);  // (TT + k - 1) x cg
    const int t0 = blockIdx.x * TT;
    const int g = blockIdx.y;
    const int bi = blockIdx.z;
    const int pad = k / 2;
    for (int idx = threadIdx.x; idx < (TT + k - 1) * cg; idx += NTHREADS) {
        const int r = idx / cg, i = idx % cg;
        const int t = t0 - pad + r;
        Xs[idx] = (t >= 0 && t < n) ? x[((size_t)bi * n + t) * c + g * cg + i] : from_f<T>(0.0f);
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < TT * cg; idx += NTHREADS) {
        const int r = idx / cg, o = idx % cg;
        const int t = t0 + r;
        if (t >= n) continue;
        float acc = 0.0f;
        for (int tap = 0; tap < k; ++tap)
            for (int i = 0; i < cg; ++i)
                acc += to_f<T>(Xs[(r + tap) * cg + i]) * to_f<T>(w[((size_t)tap * cg + i) * c + g * cg + o]);
        store_out(y, lens, acc + bias[g * cg + o], bi, t, n, c, g * cg + o, mask_rows);
    }
}

}  // namespace

extern "C" {

// One layer on the CUDA cores (fp32, or group widths other than 64): x, y (b,
// n, c) contiguous; w (k, c/groups, c) contiguous, same type as x (bf16 when
// is_bf16 = 1, else fp32); bias (c,) fp32; lens (b,) int32. Returns the
// cudaError_t of the launch.
int f5_conv_pos_layer(const void* x, const void* w, const void* bias, const void* lens, void* y, int b, int n,
                      int c, int groups, int k, int is_bf16, int mask_rows, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int cg = c / groups;
    const dim3 grid((n + TT - 1) / TT, groups, b);
    const float* bs = static_cast<const float*>(bias);
    const int* ls = static_cast<const int*>(lens);
    cudaError_t err;
    if (is_bf16) {
        const size_t smem = (size_t)(TT + k - 1) * cg * sizeof(__nv_bfloat16);
        err = cudaFuncSetAttribute(conv_generic_kernel<__nv_bfloat16>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
        conv_generic_kernel<__nv_bfloat16><<<grid, NTHREADS, smem, s>>>(
            static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w), bs, ls,
            static_cast<__nv_bfloat16*>(y), n, c, cg, k, mask_rows);
    } else {
        const size_t smem = (size_t)(TT + k - 1) * cg * sizeof(float);
        err = cudaFuncSetAttribute(conv_generic_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
        conv_generic_kernel<float><<<grid, NTHREADS, smem, s>>>(
            static_cast<const float*>(x), static_cast<const float*>(w), bs, ls, static_cast<float*>(y), n, c, cg, k,
            mask_rows);
    }
    return (int)cudaGetLastError();
}

// The whole pair in one launch, bf16 with group width 64 and an odd k <= 31:
// x, y (b, n, c) bf16 contiguous (16-byte aligned, c a multiple of 64); w1, w2
// (k, 64, c) bf16 contiguous; b1, b2 (c,) fp32; lens (b,) int32. Returns the
// cudaError_t of the launch (cudaErrorInvalidValue for a shape it does not take).
int f5_conv_pos_pair(const void* x, const void* w1, const void* b1, const void* w2, const void* b2, const void* lens,
                     void* y, int b, int n, int c, int k, void* stream) {
    if (c % 64 || k % 2 == 0 || k > PKMAX || n < 1 || b < 1) return (int)cudaErrorInvalidValue;
    CUtensorMap xmap, w1map, w2map;
    const uint64_t xdims[3] = {(uint64_t)c, (uint64_t)n, (uint64_t)b};
    const uint64_t xstrides[2] = {(uint64_t)c * 2, (uint64_t)n * c * 2};
    const uint64_t wdims[3] = {(uint64_t)c, 64, (uint64_t)k};
    const uint64_t wstrides[2] = {(uint64_t)c * 2, (uint64_t)64 * c * 2};
    int err = hp::make_map_bf16(&xmap, x, 3, xdims, xstrides, 64);
    if (!err) err = hp::make_map_bf16(&w1map, w1, 3, wdims, wstrides, 64);
    if (!err) err = hp::make_map_bf16(&w2map, w2, 3, wdims, wstrides, 64);
    if (err) return err;
    cudaError_t e = cudaFuncSetAttribute(conv_pair_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)PAIR_SMEM);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((n + PT - 1) / PT, c / 64, b);
    conv_pair_kernel<<<grid, PTHREADS, PAIR_SMEM, static_cast<cudaStream_t>(stream)>>>(
        xmap, w1map, w2map, static_cast<const float*>(b1), static_cast<const float*>(b2), static_cast<const int*>(lens),
        static_cast<__nv_bfloat16*>(y), n, c, k);
    return (int)cudaGetLastError();
}

const char* f5_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
