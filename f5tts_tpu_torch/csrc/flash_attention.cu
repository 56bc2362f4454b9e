// Flash attention forward for Hopper (sm_90a): bidirectional, key-padding
// masked, with optional fused half-split RoPE.
//
// Replaces the TPU kernel f5tts_tpu/ops/pallas/flash_attention.py:flash_attention
// (_flash_packed_kernel / _flash_packed_multi_kernel / _flash_single_kernel /
// _flash_kernel, RoPE in _maybe_rope_pair / _rot).
//
// What it computes, per flat head bh = (batch, head) and query row t:
//   o[t] = sum_j softmax_j(q[t].k[j] * d^-1/2 + bias[j]) v[j],
//   bias[j] = 0 for a valid key, -1e30 for a masked key,
// with fp32 running max / sum, p cast to v's type before the PV product and
// o = acc / max(l, 1e-30) stored in q's type. Query rows of padded frames
// compute values the caller zeroes. With rope_mode 1 only head 0 of each batch
// row is rotated (flat bh % h == 0, the reference's flat-RoPE quirk); with 2
// every head is. cos/sin are rounded to q's type before rotating, and the
// rotation x*cos + rotate_half(x)*sin rounds each op to q's type, as the JAX
// code does.
//
// What bounds it: at the main-path shape (b*h = 256, n = 1024, d = 64, bf16)
// the QK^T and PV products are 4*b*h*n^2*d = 68.7 GFLOP, about 69 us at the
// H100's 989 TFLOP/s bf16 peak, against 134 MB of q/k/v/o traffic (about
// 40 us at 3.35 TB/s): compute-bound, so the products belong on the tensor
// cores and the scores must not round-trip through memory.
//
// Design: one block of 4 warps per (bh, 64-row query tile); each warp owns 16
// query rows and walks 64-key tiles of K and V staged in shared memory (RoPE
// applied while staging; the next tile's copies are in flight, cp.async, while
// the current one is used). bf16 (the serving path) runs
// FlashAttention-2 style on mma.sync m16n8k16: the warp's Q fragments, its
// 16 x 64 score tile, the online-softmax state and the output accumulator all
// stay in registers, and the score accumulators are repacked in place as the
// bf16 A operand of the PV product. fp32 inputs take a CUDA-core kernel with
// the same tiling. Any n works: ragged last tiles are masked. The TPU's
// head-pair block-diagonal packing is not carried over (it exists for the
// 128-wide MXU).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "attention.cuh"
#include "common.cuh"

using f5::cp_async16;
using f5::cp_async_commit;
using f5::cp_async_wait_one;
using f5::from_f;
using f5::ld32;
using f5::load_a;
using f5::mma16816;
using f5::mma_a_by_rows;
using f5::pack_bf16;
using f5::rnd;
using f5::to_f;
using bf16 = __nv_bfloat16;

namespace {

constexpr int NWARPS = 4;
constexpr int BQ = 16 * NWARPS;  // query rows per block (16 per warp)
constexpr int BK = 64;  // keys per tile
constexpr int NTHREADS = NWARPS * 32;
constexpr float NEG_BIG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// Element j of one row of q or k, rotated when `rot`.
template <typename T, int D>
__device__ __forceinline__ T load_rot(const T* row, int j, const float* cos_row, const float* sin_row, bool rot) {
    T x = row[j];
    if (!rot) return x;
    constexpr int H = D / 2;
    const float partner = to_f<T>(row[j < H ? j + H : j - H]);
    const float rh = j < H ? -partner : partner;
    const float a = rnd<T>(to_f<T>(x) * rnd<T>(cos_row[j]));
    const float b = rnd<T>(rh * rnd<T>(sin_row[j]));
    return from_f<T>(a + b);
}

__device__ __forceinline__ void stage_bias(float* bias, const uint8_t* key_mask, int b, int n, int k0, int tid) {
    f5::stage_key_bias<BK, NTHREADS>(bias, key_mask, b, n, k0, tid);
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16), FlashAttention-2 register layout
// ---------------------------------------------------------------------------

// Rows [row0, row0 + R) of an (n, D) bf16 matrix into dst (row stride LD),
// zero past n, rotated when `rot`; 16-byte vectors.
template <int D, int R, int LD>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, int row0, int n, bool rot,
                                           const float* cos_t, const float* sin_t, int tid) {
    for (int idx = tid; idx < R * D / 8; idx += NTHREADS) {
        const int r = idx / (D / 8), c = (idx % (D / 8)) * 8;
        const int t = row0 + r;
        uint4 val = make_uint4(0, 0, 0, 0);
        if (t < n) {
            const bf16* row = src + (size_t)t * D;
            if (!rot) {
                val = *reinterpret_cast<const uint4*>(row + c);
            } else {
                __align__(16) bf16 tmp[8];
#pragma unroll
                for (int i = 0; i < 8; ++i)
                    tmp[i] = load_rot<bf16, D>(row, c + i, cos_t + (size_t)t * D, sin_t + (size_t)t * D, true);
                val = *reinterpret_cast<const uint4*>(tmp);
            }
        }
        *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
    }
}

template <int D>
constexpr size_t smem_bf16() {  // Q tile, two K and two V tiles (rows of D+8), two bias rows
    return (size_t)(BQ + 4 * BK) * (D + 8) * sizeof(bf16) + 2 * BK * sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
               bf16* __restrict__ o, const uint8_t* __restrict__ key_mask, const float* __restrict__ cos_t,
               const float* __restrict__ sin_t, int h, int n, int rope_mode, float scale) {
    // Rows padded by 8 elements (16 bytes): the fragment loads below (row =
    // lane/4, column pair = lane%4) and the ldmatrix rows then hit distinct banks.
    constexpr int LD = D + 8;
    extern __shared__ __align__(128) unsigned char smem_raw[];
    bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // BQ x D
    bf16* Ks = Qs + BQ * LD;                        // 2 buffers of BK x D
    bf16* Vs = Ks + 2 * BK * LD;                    // 2 buffers of BK x D
    float* bias = reinterpret_cast<float*>(Vs + 2 * BK * LD);  // 2 buffers of BK

    const int bh = blockIdx.y;
    const int b = bh / h;
    const int q0 = blockIdx.x * BQ;
    const int tid = threadIdx.x;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane >> 2;  // fragment row group
    const int tq = lane & 3;  // thread within the group: column pair
    const bool rot = rope_mode == 2 || (rope_mode == 1 && bh % h == 0);
    const size_t base = (size_t)bh * n * D;

    // K/V tile of keys [k0, k0 + BK) into buffer `buf`: asynchronous copies,
    // except rotated K rows, which are computed and stored directly
    auto stage = [&](int buf, int k0) {
        bf16* kb = Ks + buf * BK * LD;
        bf16* vb = Vs + buf * BK * LD;
        for (int idx = tid; idx < BK * D / 8; idx += NTHREADS) {
            const int r = idx / (D / 8), c = (idx % (D / 8)) * 8;
            const bool valid = k0 + r < n;
            const size_t off = base + (size_t)(valid ? k0 + r : 0) * D + c;
            cp_async16(vb + r * LD + c, v + off, valid);
            if (!rot) cp_async16(kb + r * LD + c, k + off, valid);
        }
        if (rot) stage_rows<D, BK, LD>(kb, k + base, k0, n, true, cos_t, sin_t, tid);
        stage_bias(bias + buf * BK, key_mask, b, n, k0, tid);
    };

    stage_rows<D, BQ, LD>(Qs, q + base, q0, n, rot, cos_t, sin_t, tid);
    stage(0, 0);
    cp_async_commit();
    __syncthreads();
    uint32_t qf[D / 16][4];  // this warp's 16 query rows as A fragments
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) load_a(qf[kk], Qs, LD, warp * 16, kk * 16, lane);

    // rows g and g + 8 of the warp's 16: running max, per-thread partial sum.
    // Scores are kept in log2 units (exp(x) = exp2(x * log2 e), one MUFU op),
    // the start value too: a row whose keys are all masked then weighs every
    // key equally, as the reference does.
    const float scale_log2 = scale * LOG2E;
    float m0 = NEG_BIG * LOG2E, m1 = NEG_BIG * LOG2E, l0 = 0.0f, l1 = 0.0f;
    float acc[D / 8][4];
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb) acc[nb][0] = acc[nb][1] = acc[nb][2] = acc[nb][3] = 0.0f;

    const int ntiles = (n + BK - 1) / BK;
    for (int it = 0; it < ntiles; ++it) {
        const int buf = it & 1;
        if (it + 1 < ntiles) stage(buf ^ 1, (it + 1) * BK);  // prefetch the next tile
        cp_async_commit();
        cp_async_wait_one();  // this tile's copies have landed
        __syncthreads();
        const bf16* kb = Ks + buf * BK * LD;
        const bf16* vb = Vs + buf * BK * LD;
        const float* bb = bias + buf * BK;

        float s[BK / 8][4];  // scores of rows (g, g+8) x key columns (nb*8 + tq*2 + {0,1})
#pragma unroll
        for (int nb = 0; nb < BK / 8; ++nb) {
            s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.0f;
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk) {
                const bf16* p = kb + (nb * 8 + g) * LD + kk * 16 + tq * 2;
                mma16816(s[nb], qf[kk], ld32(p), ld32(p + 8));
            }
        }

        float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
        for (int nb = 0; nb < BK / 8; ++nb) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const float bc = bb[nb * 8 + tq * 2 + e] * LOG2E;
                s[nb][e] = s[nb][e] * scale_log2 + bc;
                s[nb][2 + e] = s[nb][2 + e] * scale_log2 + bc;
                mx0 = fmaxf(mx0, s[nb][e]);
                mx1 = fmaxf(mx1, s[nb][2 + e]);
            }
        }
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
        const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
        const float alpha0 = exp2f(m0 - mn0), alpha1 = exp2f(m1 - mn1);
        float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
        for (int nb = 0; nb < BK / 8; ++nb) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                s[nb][e] = exp2f(s[nb][e] - mn0);
                s[nb][2 + e] = exp2f(s[nb][2 + e] - mn1);
                sum0 += s[nb][e];
                sum1 += s[nb][2 + e];
            }
        }
        l0 = l0 * alpha0 + sum0;
        l1 = l1 * alpha1 + sum1;
        m0 = mn0;
        m1 = mn1;
#pragma unroll
        for (int nb = 0; nb < D / 8; ++nb) {
            acc[nb][0] *= alpha0;
            acc[nb][1] *= alpha0;
            acc[nb][2] *= alpha1;
            acc[nb][3] *= alpha1;
        }

        // PV: two adjacent score n-blocks are one k-step of the A operand; V
        // (keys x d, row-major) gives its B fragments through transposed ldmatrix
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
            const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                    pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                    pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
            mma_a_by_rows<D>(acc, pa, vb, LD, kk * 16, lane);
        }
        __syncthreads();  // every warp is done with this buffer before it is refilled
    }

    // the row sums are spread over the 4 threads of each row group
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
    const int t0 = q0 + warp * 16 + g, t1 = t0 + 8;
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb) {
        const int c = nb * 8 + tq * 2;
        if (t0 < n)
            *reinterpret_cast<uint32_t*>(o + base + (size_t)t0 * D + c) = pack_bf16(acc[nb][0] / den0, acc[nb][1] / den0);
        if (t1 < n)
            *reinterpret_cast<uint32_t*>(o + base + (size_t)t1 * D + c) = pack_bf16(acc[nb][2] / den1, acc[nb][3] / den1);
    }
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores, same tiling; scores and the tile's PV product in shared memory
// ---------------------------------------------------------------------------

template <int D>
constexpr size_t smem_fp32() {  // Q, K, V tiles; probabilities; scores; tile PV product; bias
    return (size_t)(BQ * D + 2 * BK * D + BQ * BK + BQ * BK + BQ * D + BK) * sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_fp32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
               float* __restrict__ o, const uint8_t* __restrict__ key_mask, const float* __restrict__ cos_t,
               const float* __restrict__ sin_t, int h, int n, int rope_mode, float scale) {
    extern __shared__ __align__(128) unsigned char smem_raw[];
    float* Qs = reinterpret_cast<float*>(smem_raw);  // BQ x D
    float* Ks = Qs + BQ * D;                           // BK x D
    float* Vs = Ks + BK * D;                           // BK x D
    float* Ps = Vs + BK * D;                           // BQ x BK probabilities
    float* Ss = Ps + BQ * BK;                          // BQ x BK scores
    float* Os = Ss + BQ * BK;                          // BQ x D tile PV product
    float* bias = Os + BQ * D;                         // BK

    const int bh = blockIdx.y;
    const int b = bh / h;
    const int q0 = blockIdx.x * BQ;
    const int tid = threadIdx.x;
    const bool rot = rope_mode == 2 || (rope_mode == 1 && bh % h == 0);
    const size_t base = (size_t)bh * n * D;

    for (int idx = tid; idx < BQ * D; idx += NTHREADS) {
        const int t = q0 + idx / D, j = idx % D;
        Qs[idx] = t < n ? load_rot<float, D>(q + base + (size_t)t * D, j, cos_t + (rot ? (size_t)t * D : 0),
                                              sin_t + (rot ? (size_t)t * D : 0), rot)
                        : 0.0f;
    }
    // thread pair (2r, 2r+1) owns query row r; each thread half the columns
    const int r = tid / 2;
    const int half = tid & 1;
    float m = NEG_BIG, l = 0.0f;
    float acc[D / 2];
#pragma unroll
    for (int c = 0; c < D / 2; ++c) acc[c] = 0.0f;

    for (int k0 = 0; k0 < n; k0 += BK) {
        __syncthreads();
        for (int idx = tid; idx < BK * D; idx += NTHREADS) {
            const int key = k0 + idx / D, j = idx % D;
            const size_t off = base + (size_t)key * D;
            Ks[idx] = key < n ? load_rot<float, D>(k + off, j, cos_t + (rot ? (size_t)key * D : 0),
                                                    sin_t + (rot ? (size_t)key * D : 0), rot)
                              : 0.0f;
            Vs[idx] = key < n ? v[off + j] : 0.0f;
        }
        stage_bias(bias, key_mask, b, n, k0, tid);
        __syncthreads();

        float mx = -INFINITY;
        for (int c = half * (BK / 2); c < (half + 1) * (BK / 2); ++c) {
            float s = 0.0f;
#pragma unroll 8
            for (int d = 0; d < D; ++d) s += Qs[r * D + d] * Ks[c * D + d];
            s = s * scale + bias[c];
            Ss[r * BK + c] = s;
            mx = fmaxf(mx, s);
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        const float m_new = fmaxf(m, mx);
        const float alpha = expf(m - m_new);
        float sum = 0.0f;
        for (int c = half * (BK / 2); c < (half + 1) * (BK / 2); ++c) {
            const float p = expf(Ss[r * BK + c] - m_new);
            sum += p;
            Ps[r * BK + c] = p;
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        l = l * alpha + sum;
        m = m_new;
        __syncwarp();
#pragma unroll
        for (int c = 0; c < D / 2; ++c) {
            const int col = half * (D / 2) + c;
            float s = 0.0f;
#pragma unroll 8
            for (int kk = 0; kk < BK; ++kk) s += Ps[r * BK + kk] * Vs[kk * D + col];
            acc[c] = acc[c] * alpha + s;
        }
    }
    const int t = q0 + r;
    if (t < n) {
        const float den = fmaxf(l, 1e-30f);
#pragma unroll
        for (int c = 0; c < D / 2; ++c) o[base + (size_t)t * D + half * (D / 2) + c] = acc[c] / den;
    }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, const void* key_mask, const void* cos_t,
           const void* sin_t, int b, int h, int n, int rope_mode, float scale, cudaStream_t stream) {
    const dim3 grid((n + BQ - 1) / BQ, b * h);
    const uint8_t* mask = static_cast<const uint8_t*>(key_mask);
    const float* cs = static_cast<const float*>(cos_t);
    const float* sn = static_cast<const float*>(sin_t);
    cudaError_t err;
    if constexpr (std::is_same<T, bf16>::value) {
        constexpr size_t smem = smem_bf16<D>();
        err = cudaFuncSetAttribute(flash_fwd_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
        flash_fwd_bf16<D><<<grid, NTHREADS, smem, stream>>>(
            static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
            static_cast<bf16*>(o), mask, cs, sn, h, n, rope_mode, scale);
    } else {
        constexpr size_t smem = smem_fp32<D>();
        err = cudaFuncSetAttribute(flash_fwd_fp32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
        flash_fwd_fp32<D><<<grid, NTHREADS, smem, stream>>>(
            static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
            static_cast<float*>(o), mask, cs, sn, h, n, rope_mode, scale);
    }
    return (int)cudaGetLastError();
}

template <typename T>
int launch_d(int d, const void* q, const void* k, const void* v, void* o, const void* key_mask, const void* cos_t,
             const void* sin_t, int b, int h, int n, int rope_mode, float scale, cudaStream_t stream) {
    switch (d) {
        case 32: return launch<T, 32>(q, k, v, o, key_mask, cos_t, sin_t, b, h, n, rope_mode, scale, stream);
        case 64: return launch<T, 64>(q, k, v, o, key_mask, cos_t, sin_t, b, h, n, rope_mode, scale, stream);
        case 128: return launch<T, 128>(q, k, v, o, key_mask, cos_t, sin_t, b, h, n, rope_mode, scale, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" {

// q, k, v, o: (b, h, n, d) contiguous, bf16 (is_bf16 = 1) or fp32; key_mask:
// (b, n) bytes (1 = valid) or null; cos_t, sin_t: (n, d) fp32 or null when
// rope_mode == 0. Returns the cudaError_t of the launch.
int f5_flash_attention(const void* q, const void* k, const void* v, void* o, const void* key_mask,
                       const void* cos_t, const void* sin_t, int b, int h, int n, int d, int is_bf16,
                       int rope_mode, float scale, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (is_bf16) return launch_d<bf16>(d, q, k, v, o, key_mask, cos_t, sin_t, b, h, n, rope_mode, scale, s);
    return launch_d<float>(d, q, k, v, o, key_mask, cos_t, sin_t, b, h, n, rope_mode, scale, s);
}

const char* f5_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
