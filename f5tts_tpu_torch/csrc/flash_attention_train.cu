// Differentiable flash attention for Hopper (sm_90a): a forward kernel that
// also writes the per-row logsumexp, and the FlashAttention-2 backward as two
// kernels (dK/dV, then dQ).
//
// Replaces the TPU kernels of f5tts_tpu/ops/pallas/flash_attention.py's
// training path: _flash_fwd_lse_kernel (launched from _flash_train_fwd_impl)
// and _flash_bwd_kernel (launched from _flash_train_bwd).
//
// What it computes, per flat head bh = (batch, head), with s = q.k * d^-1/2 +
// bias[key] in fp32 (bias 0 for a valid key, -1e30 for a masked one):
//   forward:  o[t] = sum_j p[t,j] v[j] / max(l[t], 1e-30),  p = exp(s - m),
//             lse[t] = m[t] + log(max(l[t], 1e-30)),
//             p rounded to v's type before the PV product;
//   backward: P = exp(s - lse), D = rowsum(dO * O) (computed by the caller),
//             dV = P^T dO   (P rounded to dO's type),
//             dP = dO V^T,  dS = P * (dP - D)   (rounded to q's type),
//             dQ = dS K * scale,  dK = dS^T Q * scale,
//   all products with fp32 accumulation. No RoPE here: training rotates q and
//   k before the call, so the rotation's gradient is autograd's. Scores stay in
//   natural-log units (exp(x) = exp2(x * log2 e)), so a row whose keys are all
//   masked gets lse = -1e30 exactly, as the TPU kernel's fp32 arithmetic gives.
//
// What bounds it: at the training shape (b*h = 592, n = 1024, d = 64, bf16)
// the forward does 4*b*h*n^2*d = 159 GFLOP (0.16 ms at 989 TFLOP/s) against
// 310 MB of q/k/v/o traffic (0.09 ms at 3.35 TB/s); the backward's five
// products are 10*b*h*n^2*d = 397 GFLOP (0.40 ms) against 620 MB of
// q/k/v/o/dO in and dq/dk/dv out (0.19 ms).
// Both are compute-bound: the products run on the tensor cores and no n x n
// matrix reaches device memory.
//
// Design (bf16, mma.sync m16n8k16, 4 warps of 16 rows, 64-wide tiles staged
// with cp.async, double-buffered):
// - forward: one block per (bh, 64 query rows), the serving kernel's
//   FlashAttention-2 loop over key tiles, plus lse.
// - dK/dV: one block per (bh, 64 keys); each warp keeps the dK and dV rows of
//   its 16 keys in registers and walks all query tiles, computing S^T = K Q^T
//   and dP^T = V dO^T so that P^T and dS^T come out of the accumulators
//   already in the A-operand layout of dV += P^T dO and dK += dS^T Q.
// - dQ: one block per (bh, 64 query rows), walking key tiles:
//   S = Q K^T, dP = dO V^T, dQ += dS K.
// A TPU block holds a whole key row in VMEM; a Hopper block cannot, so dQ
// (a sum over keys) and dK/dV (sums over queries) take separate passes and
// recompute S and dP in each: 14 n^2 d products instead of 10, and no atomics,
// so the result is deterministic. fp32 inputs take CUDA-core kernels with the
// same tiling. Any n works: ragged tiles are zero-filled, keys past n get
// -inf and query rows past n get lse = +inf (P = 0).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "attention.cuh"

using f5::cp_async16;
using f5::cp_async_commit;
using f5::cp_async_wait_all;
using f5::cp_async_wait_one;
using f5::load_a;
using f5::mma16816;
using f5::mma_a_by_rows;
using f5::pack_bf16;
using bf16 = __nv_bfloat16;

namespace {

constexpr int NWARPS = 4;
constexpr int BT = 16 * NWARPS;  // rows per tile, queries or keys (16 per warp)
constexpr int NTHREADS = NWARPS * 32;
constexpr float NEG_BIG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float exp_nat(float x) { return exp2f(x * LOG2E); }

__device__ __forceinline__ void stage_bias(float* bias, const uint8_t* key_mask, int b, int n, int k0, int tid) {
    f5::stage_key_bias<BT, NTHREADS>(bias, key_mask, b, n, k0, tid);
}

// lse and D of query rows [q0, q0 + BT): lse = +inf past n (P = 0 there), D = 0.
__device__ __forceinline__ void stage_stats(float* lse_s, float* dl_s, const float* lse, const float* delta,
                                            size_t row_base, int q0, int n, int tid) {
    for (int j = tid; j < BT; j += NTHREADS) {
        const int t = q0 + j;
        lse_s[j] = t < n ? lse[row_base + t] : INFINITY;
        dl_s[j] = t < n ? delta[row_base + t] : 0.0f;
    }
}

// Rows [r0, r0 + BT) of an (n, D) bf16 matrix into dst (row stride LD),
// zero-filled past n; asynchronous 16-byte copies.
template <int D, int LD>
__device__ __forceinline__ void copy_rows(bf16* dst, const bf16* src, int r0, int n, int tid) {
    for (int idx = tid; idx < BT * D / 8; idx += NTHREADS) {
        const int r = idx / (D / 8), c = (idx % (D / 8)) * 8;
        const bool valid = r0 + r < n;
        cp_async16(dst + r * LD + c, src + (size_t)(valid ? r0 + r : 0) * D + c, valid);
    }
}

// ---------------------------------------------------------------------------
// bf16 forward with logsumexp
// ---------------------------------------------------------------------------

template <int D>
constexpr size_t smem_fwd_bf16() {  // Q tile, two K and two V tiles (rows of D+8), two bias rows
    return (size_t)(5 * BT) * (D + 8) * sizeof(bf16) + 2 * BT * sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
fwd_lse_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
             bf16* __restrict__ o, float* __restrict__ lse, const uint8_t* __restrict__ key_mask, int h, int n,
             float scale) {
    // rows padded by 8 elements: fragment loads and ldmatrix rows hit distinct banks
    constexpr int LD = D + 8;
    extern __shared__ __align__(128) unsigned char smem_raw[];
    bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
    bf16* Ks = Qs + BT * LD;
    bf16* Vs = Ks + 2 * BT * LD;
    float* bias = reinterpret_cast<float*>(Vs + 2 * BT * LD);

    const int bh = blockIdx.y, b = bh / h, q0 = blockIdx.x * BT;
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, tq = lane & 3;
    const size_t base = (size_t)bh * n * D;

    auto stage = [&](int buf, int k0) {
        copy_rows<D, LD>(Ks + buf * BT * LD, k + base, k0, n, tid);
        copy_rows<D, LD>(Vs + buf * BT * LD, v + base, k0, n, tid);
        stage_bias(bias + buf * BT, key_mask, b, n, k0, tid);
    };
    copy_rows<D, LD>(Qs, q + base, q0, n, tid);
    stage(0, 0);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    uint32_t qf[D / 16][4];  // this warp's 16 query rows as A fragments
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) load_a(qf[kk], Qs, LD, warp * 16, kk * 16, lane);

    // rows g and g + 8 of the warp's 16: running max (starting at -1e30, so a
    // row whose keys are all masked weighs every key equally), per-thread sums
    float m0 = NEG_BIG, m1 = NEG_BIG, l0 = 0.0f, l1 = 0.0f;
    float acc[D / 8][4];
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb) acc[nb][0] = acc[nb][1] = acc[nb][2] = acc[nb][3] = 0.0f;

    const int ntiles = (n + BT - 1) / BT;
    for (int it = 0; it < ntiles; ++it) {
        const int buf = it & 1;
        if (it + 1 < ntiles) stage(buf ^ 1, (it + 1) * BT);  // prefetch the next tile
        cp_async_commit();
        cp_async_wait_one();  // this tile's copies have landed
        __syncthreads();
        const bf16* kb = Ks + buf * BT * LD;
        const bf16* vb = Vs + buf * BT * LD;
        const float* bb = bias + buf * BT;

        float s[BT / 8][4];  // rows (g, g+8) x key columns nb*8 + tq*2 + {0,1}
#pragma unroll
        for (int nb = 0; nb < BT / 8; ++nb) s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.0f;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
            for (int nb = 0; nb < BT / 8; ++nb) {
                const bf16* p = kb + (nb * 8 + g) * LD + kk * 16 + tq * 2;
                mma16816(s[nb], qf[kk], f5::ld32(p), f5::ld32(p + 8));
            }
        }
        float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
        for (int nb = 0; nb < BT / 8; ++nb) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const float bc = bb[nb * 8 + tq * 2 + e];
                s[nb][e] = fmaf(s[nb][e], scale, bc);
                s[nb][2 + e] = fmaf(s[nb][2 + e], scale, bc);
                mx0 = fmaxf(mx0, s[nb][e]);
                mx1 = fmaxf(mx1, s[nb][2 + e]);
            }
        }
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
        const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
        const float alpha0 = exp_nat(m0 - mn0), alpha1 = exp_nat(m1 - mn1);
        float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
        for (int nb = 0; nb < BT / 8; ++nb) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                s[nb][e] = exp_nat(s[nb][e] - mn0);
                s[nb][2 + e] = exp_nat(s[nb][2 + e] - mn1);
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
        // PV: two adjacent score n-blocks are one k-step of the A operand
#pragma unroll
        for (int kk = 0; kk < BT / 16; ++kk) {
            const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                    pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                    pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
            mma_a_by_rows<D>(acc, pa, vb, LD, kk * 16, lane);
        }
        __syncthreads();  // every warp is done with this buffer before it is refilled
    }

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
    if (tq == 0) {
        if (t0 < n) lse[(size_t)bh * n + t0] = m0 + logf(den0);
        if (t1 < n) lse[(size_t)bh * n + t1] = m1 + logf(den1);
    }
}

// ---------------------------------------------------------------------------
// bf16 backward, pass 1: dK and dV of one key tile over all query tiles
// ---------------------------------------------------------------------------

template <int D>
constexpr size_t smem_bwd_bf16() {  // 2 resident tiles + 2 x 2 streamed tiles; bias; 2 x (lse, D)
    return (size_t)(6 * BT) * (D + 8) * sizeof(bf16) + (BT + 4 * BT) * sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
bwd_dkdv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
              const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dk, bf16* __restrict__ dv, const uint8_t* __restrict__ key_mask, int h, int n,
              float scale) {
    constexpr int LD = D + 8;
    extern __shared__ __align__(128) unsigned char smem_raw[];
    bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // this block's keys
    bf16* Vs = Ks + BT * LD;
    bf16* Qs = Vs + BT * LD;    // 2 buffers of query rows
    bf16* dOs = Qs + 2 * BT * LD;  // 2 buffers of dO rows
    float* bias = reinterpret_cast<float*>(dOs + 2 * BT * LD);
    float* lse_s = bias + BT;  // 2 buffers
    float* dl_s = lse_s + 2 * BT;  // 2 buffers

    const int bh = blockIdx.y, b = bh / h, k0 = blockIdx.x * BT;
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, tq = lane & 3;
    const size_t base = (size_t)bh * n * D;
    const size_t row_base = (size_t)bh * n;

    auto stage = [&](int buf, int q0) {
        copy_rows<D, LD>(Qs + buf * BT * LD, q + base, q0, n, tid);
        copy_rows<D, LD>(dOs + buf * BT * LD, dout + base, q0, n, tid);
        stage_stats(lse_s + buf * BT, dl_s + buf * BT, lse, delta, row_base, q0, n, tid);
    };
    copy_rows<D, LD>(Ks, k + base, k0, n, tid);
    copy_rows<D, LD>(Vs, v + base, k0, n, tid);
    stage_bias(bias, key_mask, b, n, k0, tid);
    stage(0, 0);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    const float bias0 = bias[warp * 16 + g], bias1 = bias[warp * 16 + g + 8];

    float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) dk_acc[nb][e] = dv_acc[nb][e] = 0.0f;

    const int ntiles = (n + BT - 1) / BT;
    for (int it = 0; it < ntiles; ++it) {
        const int buf = it & 1;
        if (it + 1 < ntiles) stage(buf ^ 1, (it + 1) * BT);
        cp_async_commit();
        cp_async_wait_one();
        __syncthreads();
        const bf16* qb = Qs + buf * BT * LD;
        const bf16* db = dOs + buf * BT * LD;
        const float* lb = lse_s + buf * BT;
        const float* deb = dl_s + buf * BT;

        // S^T (this warp's 16 keys x BT queries) = K Q^T, then P^T = exp(S^T - lse)
        float s[BT / 8][4];
#pragma unroll
        for (int nb = 0; nb < BT / 8; ++nb) s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.0f;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
            uint32_t a[4];
            load_a(a, Ks, LD, warp * 16, kk * 16, lane);
#pragma unroll
            for (int nb = 0; nb < BT / 8; ++nb) {
                const bf16* p = qb + (nb * 8 + g) * LD + kk * 16 + tq * 2;
                mma16816(s[nb], a, f5::ld32(p), f5::ld32(p + 8));
            }
        }
#pragma unroll
        for (int nb = 0; nb < BT / 8; ++nb) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const float L = lb[nb * 8 + tq * 2 + e];
                s[nb][e] = exp_nat(fmaf(s[nb][e], scale, bias0) - L);
                s[nb][2 + e] = exp_nat(fmaf(s[nb][2 + e], scale, bias1) - L);
            }
        }
        // dV += P^T dO (P^T rounded to bf16 as the A operand)
#pragma unroll
        for (int kk = 0; kk < BT / 16; ++kk) {
            const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                    pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                    pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
            mma_a_by_rows<D>(dv_acc, pa, db, LD, kk * 16, lane);
        }
        // dP^T = V dO^T
        float dp[BT / 8][4];
#pragma unroll
        for (int nb = 0; nb < BT / 8; ++nb) dp[nb][0] = dp[nb][1] = dp[nb][2] = dp[nb][3] = 0.0f;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
            uint32_t a[4];
            load_a(a, Vs, LD, warp * 16, kk * 16, lane);
#pragma unroll
            for (int nb = 0; nb < BT / 8; ++nb) {
                const bf16* p = db + (nb * 8 + g) * LD + kk * 16 + tq * 2;
                mma16816(dp[nb], a, f5::ld32(p), f5::ld32(p + 8));
            }
        }
        // dS^T = P^T (dP^T - D), rounded to bf16; dK += dS^T Q
#pragma unroll
        for (int kk = 0; kk < BT / 16; ++kk) {
            float ds[2][4];
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int nb = 2 * kk + half;
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const float dd = deb[nb * 8 + tq * 2 + e];
                    ds[half][e] = s[nb][e] * (dp[nb][e] - dd);
                    ds[half][2 + e] = s[nb][2 + e] * (dp[nb][2 + e] - dd);
                }
            }
            const uint32_t da[4] = {pack_bf16(ds[0][0], ds[0][1]), pack_bf16(ds[0][2], ds[0][3]),
                                    pack_bf16(ds[1][0], ds[1][1]), pack_bf16(ds[1][2], ds[1][3])};
            mma_a_by_rows<D>(dk_acc, da, qb, LD, kk * 16, lane);
        }
        __syncthreads();
    }

    const int j0 = k0 + warp * 16 + g, j1 = j0 + 8;
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb) {
        const int c = nb * 8 + tq * 2;
        if (j0 < n) {
            *reinterpret_cast<uint32_t*>(dk + base + (size_t)j0 * D + c) =
                pack_bf16(dk_acc[nb][0] * scale, dk_acc[nb][1] * scale);
            *reinterpret_cast<uint32_t*>(dv + base + (size_t)j0 * D + c) = pack_bf16(dv_acc[nb][0], dv_acc[nb][1]);
        }
        if (j1 < n) {
            *reinterpret_cast<uint32_t*>(dk + base + (size_t)j1 * D + c) =
                pack_bf16(dk_acc[nb][2] * scale, dk_acc[nb][3] * scale);
            *reinterpret_cast<uint32_t*>(dv + base + (size_t)j1 * D + c) = pack_bf16(dv_acc[nb][2], dv_acc[nb][3]);
        }
    }
}

// ---------------------------------------------------------------------------
// bf16 backward, pass 2: dQ of one query tile over all key tiles
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(NTHREADS)
bwd_dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
            const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
            bf16* __restrict__ dq, const uint8_t* __restrict__ key_mask, int h, int n, float scale) {
    constexpr int LD = D + 8;
    extern __shared__ __align__(128) unsigned char smem_raw[];
    bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // this block's query rows
    bf16* dOs = Qs + BT * LD;
    bf16* Ks = dOs + BT * LD;  // 2 buffers
    bf16* Vs = Ks + 2 * BT * LD;  // 2 buffers
    float* bias = reinterpret_cast<float*>(Vs + 2 * BT * LD);  // 2 buffers

    const int bh = blockIdx.y, b = bh / h, q0 = blockIdx.x * BT;
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, tq = lane & 3;
    const size_t base = (size_t)bh * n * D;
    const int t0 = q0 + warp * 16 + g, t1 = t0 + 8;
    const float lse0 = t0 < n ? lse[(size_t)bh * n + t0] : INFINITY;
    const float lse1 = t1 < n ? lse[(size_t)bh * n + t1] : INFINITY;
    const float dl0 = t0 < n ? delta[(size_t)bh * n + t0] : 0.0f;
    const float dl1 = t1 < n ? delta[(size_t)bh * n + t1] : 0.0f;

    auto stage = [&](int buf, int k0) {
        copy_rows<D, LD>(Ks + buf * BT * LD, k + base, k0, n, tid);
        copy_rows<D, LD>(Vs + buf * BT * LD, v + base, k0, n, tid);
        stage_bias(bias + buf * BT, key_mask, b, n, k0, tid);
    };
    copy_rows<D, LD>(Qs, q + base, q0, n, tid);
    copy_rows<D, LD>(dOs, dout + base, q0, n, tid);
    stage(0, 0);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();

    float dq_acc[D / 8][4];
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb) dq_acc[nb][0] = dq_acc[nb][1] = dq_acc[nb][2] = dq_acc[nb][3] = 0.0f;

    const int ntiles = (n + BT - 1) / BT;
    for (int it = 0; it < ntiles; ++it) {
        const int buf = it & 1;
        if (it + 1 < ntiles) stage(buf ^ 1, (it + 1) * BT);
        cp_async_commit();
        cp_async_wait_one();
        __syncthreads();
        const bf16* kb = Ks + buf * BT * LD;
        const bf16* vb = Vs + buf * BT * LD;
        const float* bb = bias + buf * BT;

        // S = Q K^T and dP = dO V^T (this warp's 16 query rows x BT keys)
        float s[BT / 8][4], dp[BT / 8][4];
#pragma unroll
        for (int nb = 0; nb < BT / 8; ++nb)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[nb][e] = dp[nb][e] = 0.0f;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
            uint32_t aq[4], ad[4];
            load_a(aq, Qs, LD, warp * 16, kk * 16, lane);
            load_a(ad, dOs, LD, warp * 16, kk * 16, lane);
#pragma unroll
            for (int nb = 0; nb < BT / 8; ++nb) {
                const bf16* pk = kb + (nb * 8 + g) * LD + kk * 16 + tq * 2;
                const bf16* pv = vb + (nb * 8 + g) * LD + kk * 16 + tq * 2;
                mma16816(s[nb], aq, f5::ld32(pk), f5::ld32(pk + 8));
                mma16816(dp[nb], ad, f5::ld32(pv), f5::ld32(pv + 8));
            }
        }
        // dS = P (dP - D), rounded to bf16; dQ += dS K
#pragma unroll
        for (int kk = 0; kk < BT / 16; ++kk) {
            float ds[2][4];
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int nb = 2 * kk + half;
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const float bc = bb[nb * 8 + tq * 2 + e];
                    const float p0 = exp_nat(fmaf(s[nb][e], scale, bc) - lse0);
                    const float p1 = exp_nat(fmaf(s[nb][2 + e], scale, bc) - lse1);
                    ds[half][e] = p0 * (dp[nb][e] - dl0);
                    ds[half][2 + e] = p1 * (dp[nb][2 + e] - dl1);
                }
            }
            const uint32_t da[4] = {pack_bf16(ds[0][0], ds[0][1]), pack_bf16(ds[0][2], ds[0][3]),
                                    pack_bf16(ds[1][0], ds[1][1]), pack_bf16(ds[1][2], ds[1][3])};
            mma_a_by_rows<D>(dq_acc, da, kb, LD, kk * 16, lane);
        }
        __syncthreads();
    }

#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb) {
        const int c = nb * 8 + tq * 2;
        if (t0 < n)
            *reinterpret_cast<uint32_t*>(dq + base + (size_t)t0 * D + c) =
                pack_bf16(dq_acc[nb][0] * scale, dq_acc[nb][1] * scale);
        if (t1 < n)
            *reinterpret_cast<uint32_t*>(dq + base + (size_t)t1 * D + c) =
                pack_bf16(dq_acc[nb][2] * scale, dq_acc[nb][3] * scale);
    }
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores, same tiling. A thread pair owns one row of the tile (each
// thread half the columns); intermediates go through shared memory.
// ---------------------------------------------------------------------------

__device__ __forceinline__ float dot_rows(const float* a, const float* b, int d) {
    float s = 0.0f;
#pragma unroll 8
    for (int i = 0; i < d; ++i) s += a[i] * b[i];
    return s;
}

// Rows [r0, r0 + BT) of an (n, D) fp32 matrix into dst (dense, D per row), zero past n.
template <int D>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src, int r0, int n, int tid) {
    for (int idx = tid; idx < BT * D; idx += NTHREADS) {
        const int t = r0 + idx / D;
        dst[idx] = t < n ? src[(size_t)t * D + idx % D] : 0.0f;
    }
}

template <int D>
constexpr size_t smem_fwd_fp32() {  // Q, K, V tiles; probabilities; bias
    return (size_t)(3 * BT * D + BT * BT + BT) * sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
fwd_lse_fp32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
             float* __restrict__ o, float* __restrict__ lse, const uint8_t* __restrict__ key_mask, int h, int n,
             float scale) {
    extern __shared__ __align__(128) unsigned char smem_raw[];
    float* Qs = reinterpret_cast<float*>(smem_raw);
    float* Ks = Qs + BT * D;
    float* Vs = Ks + BT * D;
    float* Ps = Vs + BT * D;  // BT x BT
    float* bias = Ps + BT * BT;

    const int bh = blockIdx.y, b = bh / h, q0 = blockIdx.x * BT, tid = threadIdx.x;
    const int r = tid / 2, half = tid & 1;
    const size_t base = (size_t)bh * n * D;
    load_rows_f32<D>(Qs, q + base, q0, n, tid);
    float m = NEG_BIG, l = 0.0f;
    float acc[D / 2];
#pragma unroll
    for (int c = 0; c < D / 2; ++c) acc[c] = 0.0f;

    for (int k0 = 0; k0 < n; k0 += BT) {
        __syncthreads();
        load_rows_f32<D>(Ks, k + base, k0, n, tid);
        load_rows_f32<D>(Vs, v + base, k0, n, tid);
        stage_bias(bias, key_mask, b, n, k0, tid);
        __syncthreads();
        float mx = -INFINITY;
        for (int c = half * (BT / 2); c < (half + 1) * (BT / 2); ++c) {
            const float s = fmaf(dot_rows(Qs + r * D, Ks + c * D, D), scale, bias[c]);
            Ps[r * BT + c] = s;
            mx = fmaxf(mx, s);
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        const float m_new = fmaxf(m, mx);
        const float alpha = expf(m - m_new);
        float sum = 0.0f;
        for (int c = half * (BT / 2); c < (half + 1) * (BT / 2); ++c) {
            const float p = expf(Ps[r * BT + c] - m_new);
            sum += p;
            Ps[r * BT + c] = p;
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
            for (int kk = 0; kk < BT; ++kk) s += Ps[r * BT + kk] * Vs[kk * D + col];
            acc[c] = acc[c] * alpha + s;
        }
    }
    const int t = q0 + r;
    if (t < n) {
        const float den = fmaxf(l, 1e-30f);
#pragma unroll
        for (int c = 0; c < D / 2; ++c) o[base + (size_t)t * D + half * (D / 2) + c] = acc[c] / den;
        if (half == 0) lse[(size_t)bh * n + t] = m + logf(den);
    }
}

template <int D>
constexpr size_t smem_bwd_fp32() {  // 4 row tiles; P and dS tiles; bias; lse, D
    return (size_t)(4 * BT * D + 2 * BT * BT + 3 * BT) * sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
bwd_dkdv_fp32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
              const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dk, float* __restrict__ dv, const uint8_t* __restrict__ key_mask, int h, int n,
              float scale) {
    extern __shared__ __align__(128) unsigned char smem_raw[];
    float* Ks = reinterpret_cast<float*>(smem_raw);
    float* Vs = Ks + BT * D;
    float* Qs = Vs + BT * D;
    float* dOs = Qs + BT * D;
    float* Ps = dOs + BT * D;  // BT keys x BT queries
    float* dSs = Ps + BT * BT;
    float* bias = dSs + BT * BT;
    float* lse_s = bias + BT;
    float* dl_s = lse_s + BT;

    const int bh = blockIdx.y, b = bh / h, k0 = blockIdx.x * BT, tid = threadIdx.x;
    const int r = tid / 2, half = tid & 1;  // key row r of the tile
    const size_t base = (size_t)bh * n * D;
    load_rows_f32<D>(Ks, k + base, k0, n, tid);
    load_rows_f32<D>(Vs, v + base, k0, n, tid);
    stage_bias(bias, key_mask, b, n, k0, tid);
    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int c = 0; c < D / 2; ++c) dk_acc[c] = dv_acc[c] = 0.0f;

    for (int q0 = 0; q0 < n; q0 += BT) {
        __syncthreads();
        load_rows_f32<D>(Qs, q + base, q0, n, tid);
        load_rows_f32<D>(dOs, dout + base, q0, n, tid);
        stage_stats(lse_s, dl_s, lse, delta, (size_t)bh * n, q0, n, tid);
        __syncthreads();
        for (int c = half * (BT / 2); c < (half + 1) * (BT / 2); ++c) {
            const float s = fmaf(dot_rows(Ks + r * D, Qs + c * D, D), scale, bias[r]);
            const float p = expf(s - lse_s[c]);
            const float dp = dot_rows(Vs + r * D, dOs + c * D, D);
            Ps[r * BT + c] = p;
            dSs[r * BT + c] = p * (dp - dl_s[c]);
        }
        __syncwarp();
#pragma unroll
        for (int c = 0; c < D / 2; ++c) {
            const int col = half * (D / 2) + c;
            float sv = 0.0f, sk = 0.0f;
#pragma unroll 8
            for (int j = 0; j < BT; ++j) {
                sv += Ps[r * BT + j] * dOs[j * D + col];
                sk += dSs[r * BT + j] * Qs[j * D + col];
            }
            dv_acc[c] += sv;
            dk_acc[c] += sk;
        }
    }
    const int j = k0 + r;
    if (j < n) {
#pragma unroll
        for (int c = 0; c < D / 2; ++c) {
            dk[base + (size_t)j * D + half * (D / 2) + c] = dk_acc[c] * scale;
            dv[base + (size_t)j * D + half * (D / 2) + c] = dv_acc[c];
        }
    }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
bwd_dq_fp32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
            const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
            float* __restrict__ dq, const uint8_t* __restrict__ key_mask, int h, int n, float scale) {
    extern __shared__ __align__(128) unsigned char smem_raw[];
    float* Qs = reinterpret_cast<float*>(smem_raw);
    float* dOs = Qs + BT * D;
    float* Ks = dOs + BT * D;
    float* Vs = Ks + BT * D;
    float* dSs = Vs + BT * D;  // BT queries x BT keys
    float* bias = dSs + BT * BT;

    const int bh = blockIdx.y, b = bh / h, q0 = blockIdx.x * BT, tid = threadIdx.x;
    const int r = tid / 2, half = tid & 1;  // query row r of the tile
    const size_t base = (size_t)bh * n * D;
    const int t = q0 + r;
    const float L = t < n ? lse[(size_t)bh * n + t] : INFINITY;
    const float dl = t < n ? delta[(size_t)bh * n + t] : 0.0f;
    load_rows_f32<D>(Qs, q + base, q0, n, tid);
    load_rows_f32<D>(dOs, dout + base, q0, n, tid);
    float dq_acc[D / 2];
#pragma unroll
    for (int c = 0; c < D / 2; ++c) dq_acc[c] = 0.0f;

    for (int k0 = 0; k0 < n; k0 += BT) {
        __syncthreads();
        load_rows_f32<D>(Ks, k + base, k0, n, tid);
        load_rows_f32<D>(Vs, v + base, k0, n, tid);
        stage_bias(bias, key_mask, b, n, k0, tid);
        __syncthreads();
        for (int c = half * (BT / 2); c < (half + 1) * (BT / 2); ++c) {
            const float p = expf(fmaf(dot_rows(Qs + r * D, Ks + c * D, D), scale, bias[c]) - L);
            const float dp = dot_rows(dOs + r * D, Vs + c * D, D);
            dSs[r * BT + c] = p * (dp - dl);
        }
        __syncwarp();
#pragma unroll
        for (int c = 0; c < D / 2; ++c) {
            const int col = half * (D / 2) + c;
            float s = 0.0f;
#pragma unroll 8
            for (int j = 0; j < BT; ++j) s += dSs[r * BT + j] * Ks[j * D + col];
            dq_acc[c] += s;
        }
    }
    if (t < n) {
#pragma unroll
        for (int c = 0; c < D / 2; ++c) dq[base + (size_t)t * D + half * (D / 2) + c] = dq_acc[c] * scale;
    }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename K>
int prepare(K kernel, size_t smem) {
    return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse, const void* mask, int b, int h, int n,
               float scale, cudaStream_t st) {
    const dim3 grid((n + BT - 1) / BT, b * h);
    const uint8_t* km = static_cast<const uint8_t*>(mask);
    int err;
    if constexpr (std::is_same<T, bf16>::value) {
        constexpr size_t smem = smem_fwd_bf16<D>();
        if ((err = prepare(fwd_lse_bf16<D>, smem)) != 0) return err;
        fwd_lse_bf16<D><<<grid, NTHREADS, smem, st>>>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                                                      static_cast<const bf16*>(v), static_cast<bf16*>(o),
                                                      static_cast<float*>(lse), km, h, n, scale);
    } else {
        constexpr size_t smem = smem_fwd_fp32<D>();
        if ((err = prepare(fwd_lse_fp32<D>, smem)) != 0) return err;
        fwd_lse_fp32<D><<<grid, NTHREADS, smem, st>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                                                      static_cast<const float*>(v), static_cast<float*>(o),
                                                      static_cast<float*>(lse), km, h, n, scale);
    }
    return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkdv(const void* q, const void* k, const void* v, const void* dout, const void* lse, const void* delta,
                void* dk, void* dv, const void* mask, int b, int h, int n, float scale, cudaStream_t st) {
    const dim3 grid((n + BT - 1) / BT, b * h);
    const uint8_t* km = static_cast<const uint8_t*>(mask);
    const float* ls = static_cast<const float*>(lse);
    const float* dl = static_cast<const float*>(delta);
    int err;
    if constexpr (std::is_same<T, bf16>::value) {
        constexpr size_t smem = smem_bwd_bf16<D>();
        if ((err = prepare(bwd_dkdv_bf16<D>, smem)) != 0) return err;
        bwd_dkdv_bf16<D><<<grid, NTHREADS, smem, st>>>(
            static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
            static_cast<const bf16*>(dout), ls, dl, static_cast<bf16*>(dk), static_cast<bf16*>(dv), km, h, n, scale);
    } else {
        constexpr size_t smem = smem_bwd_fp32<D>();
        if ((err = prepare(bwd_dkdv_fp32<D>, smem)) != 0) return err;
        bwd_dkdv_fp32<D><<<grid, NTHREADS, smem, st>>>(
            static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
            static_cast<const float*>(dout), ls, dl, static_cast<float*>(dk), static_cast<float*>(dv), km, h, n,
            scale);
    }
    return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse, const void* delta,
              void* dq, const void* mask, int b, int h, int n, float scale, cudaStream_t st) {
    const dim3 grid((n + BT - 1) / BT, b * h);
    const uint8_t* km = static_cast<const uint8_t*>(mask);
    const float* ls = static_cast<const float*>(lse);
    const float* dl = static_cast<const float*>(delta);
    int err;
    if constexpr (std::is_same<T, bf16>::value) {
        constexpr size_t smem = smem_bwd_bf16<D>();
        if ((err = prepare(bwd_dq_bf16<D>, smem)) != 0) return err;
        bwd_dq_bf16<D><<<grid, NTHREADS, smem, st>>>(
            static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
            static_cast<const bf16*>(dout), ls, dl, static_cast<bf16*>(dq), km, h, n, scale);
    } else {
        constexpr size_t smem = smem_bwd_fp32<D>();
        if ((err = prepare(bwd_dq_fp32<D>, smem)) != 0) return err;
        bwd_dq_fp32<D><<<grid, NTHREADS, smem, st>>>(
            static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
            static_cast<const float*>(dout), ls, dl, static_cast<float*>(dq), km, h, n, scale);
    }
    return (int)cudaGetLastError();
}

}  // namespace

#define F5_DISPATCH(FN, ...)                                                                    \
    do {                                                                                        \
        if (is_bf16) {                                                                          \
            switch (d) {                                                                        \
                case 32: return FN<bf16, 32>(__VA_ARGS__);                                      \
                case 64: return FN<bf16, 64>(__VA_ARGS__);                                      \
                case 128: return FN<bf16, 128>(__VA_ARGS__);                                    \
            }                                                                                   \
        } else {                                                                                \
            switch (d) {                                                                        \
                case 32: return FN<float, 32>(__VA_ARGS__);                                     \
                case 64: return FN<float, 64>(__VA_ARGS__);                                     \
                case 128: return FN<float, 128>(__VA_ARGS__);                                   \
            }                                                                                   \
        }                                                                                       \
        return (int)cudaErrorInvalidValue;                                                      \
    } while (0)

extern "C" {

// q, k, v, o, dout, dq, dk, dv: (b, h, n, d) contiguous, bf16 (is_bf16 = 1) or
// fp32; lse, delta: (b, h, n) fp32; key_mask: (b, n) bytes (1 = valid) or
// null. Each returns the cudaError_t of its launch.
int f5_flash_train_fwd(const void* q, const void* k, const void* v, void* o, void* lse, const void* key_mask, int b,
                       int h, int n, int d, int is_bf16, float scale, void* stream) {
    F5_DISPATCH(launch_fwd, q, k, v, o, lse, key_mask, b, h, n, scale, static_cast<cudaStream_t>(stream));
}

int f5_flash_train_bwd_dkdv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                            const void* delta, void* dk, void* dv, const void* key_mask, int b, int h, int n, int d,
                            int is_bf16, float scale, void* stream) {
    F5_DISPATCH(launch_dkdv, q, k, v, dout, lse, delta, dk, dv, key_mask, b, h, n, scale,
                static_cast<cudaStream_t>(stream));
}

int f5_flash_train_bwd_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                          const void* delta, void* dq, const void* key_mask, int b, int h, int n, int d, int is_bf16,
                          float scale, void* stream) {
    F5_DISPATCH(launch_dq, q, k, v, dout, lse, delta, dq, key_mask, b, h, n, scale, static_cast<cudaStream_t>(stream));
}

const char* f5_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
