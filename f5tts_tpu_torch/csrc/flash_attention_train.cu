// Differentiable flash attention for Hopper (sm_90a): a forward kernel that
// also writes the per-row logsumexp, and the backward as two deterministic
// passes (dQ, then dK/dV).
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
//   backward: P = exp(s - lse), D = rowsum(dO * O) (the dQ pass computes it
//             and stores it for the dK/dV pass),
//             dV = P^T dO   (P rounded to dO's type),
//             dP = dO V^T,  dS = P * (dP - D)   (rounded to q's type),
//             dQ = dS K * scale,  dK = dS^T Q * scale,
//   all products with fp32 accumulation. No RoPE here: training rotates q and
//   k before the call, so the rotation's gradient is autograd's. A row whose
//   keys are all masked gets lse = -1e30 exactly, as the TPU kernel's fp32
//   arithmetic gives (its backward then weighs each of its keys by exp(0) = 1).
//
// What bounds it: at the training shape (b*h = 592, n = 1024, d = 64, bf16)
// the forward does 4*b*h*n^2*d = 159 GFLOP (0.16 ms at 989 TFLOP/s) against
// 310 MB of q/k/v/o traffic (0.09 ms at 3.35 TB/s); the backward's five
// products are 10*b*h*n^2*d = 397 GFLOP (0.40 ms) against 620 MB of
// q/k/v/o/dO in and dq/dk/dv out (0.19 ms); the two passes, which recompute S
// and dP each, do 14*b*h*n^2*d (0.56 ms). Both are compute-bound: the products
// run on the tensor cores and no n x n matrix reaches device memory.
//
// Layout: q, k, v, dO and o are read as strided (b, h, n, d) views, each with
// its own element strides (batch, head, row; the last axis contiguous, the
// others multiples of 16 bytes), e.g. the head split of (b, n, h*d)
// projections; o, dq, dk and dv are written into (b, n, h, d) buffers, which
// the wrapper returns as (b, h, n, d) views; lse and D are (b, h, n) fp32.
//
// Design of bf16 at d 64 (the training path), FlashAttention-3 style on
// hopper.cuh (wgmma with A in registers and B from 128-byte-swizzled shared
// memory, TMA maps that carry the strides, mbarrier rings, setmaxnreg):
// - forward, fwd_lse_wgmma: the serving kernel's block (flash_wgmma.cuh): a
//   producer warp streams 128-key K/V tiles, two consumer warpgroups of 64
//   query rows issue S_j with P_{j-1} V_{j-1} and take turns through named
//   barriers; plus the lse epilogue. Compile-time switches: without the key
//   bias when key_mask is null (no staging, no add; only the ragged last tile
//   masks keys past n); at d 64 Q as a TMA-loaded shared-memory operand,
//   which leaves room for 3 consumer warpgroups (192 query rows a block, 160
//   registers a consumer thread): more warps to hide the softmax's latency.
//   It measured faster than the 2-warpgroup builds with Q in shared memory
//   or in registers (PERF.md has the three times). d 128 takes the
//   2-warpgroup forward with Q in registers.
// - backward, bwd_wgmma<PASS, BIAS>: one block of 3 warpgroups per (bh, 128
//   resident rows); the producer warp streams 64-row tiles of the other side
//   through TMA (4 stages) with their per-row statistics beside them; each
//   consumer warpgroup holds its 64 resident rows' two A operands in registers
//   and, per tile, issues S = A1 X^T and dP = A2 Y^T (X, Y K-major), turns S
//   into P in the accumulators, repacks P and dS = P (dP - D) as A operands,
//   and accumulates with X / Y as MN-major B operands:
//     dQ pass   (rows = queries; A1, A2 = Q, dO; X, Y = K, V): dQ += dS K;
//               first it computes D for its rows from its dO fragments and O;
//     dK/dV pass (rows = keys; A1, A2 = K, V; X, Y = Q, dO):
//               dV += P^T dO, dK += dS^T Q, with lse and D staged per column.
//   Per tile a warpgroup makes P and dS from the accumulators, then issues
//   the next tile's S and dP with this tile's gradient products in one
//   batch; the two warpgroups take turns issuing through named barriers, so
//   one's exponentials run under the other's products. Each block owns its
//   rows, so there are no atomics
//   and the result is bit-identical from run to run. Launch count: 2 per
//   backward call (dQ, then dK/dV). d 128 keeps the mma.sync backward below:
//   its dK and dV accumulators (2 x 64 registers a thread) with the K and V
//   fragments (2 x 32) do not fit in 255 registers.
// bf16 at d 32 (the tiny demo geometry) and the d 128 backward keep the first
// design: mma.sync m16n8k16, 4 warps of 16 rows, 64-wide tiles staged with
// cp.async, double-buffered; dK/dV computes S^T = K Q^T and dP^T = V dO^T so
// that P^T and dS^T come out of the accumulators already in the A-operand
// layout. fp32 inputs take CUDA-core kernels with the same tiling. Any n
// works: ragged tiles are zero-filled, keys past n get -inf (or contribute
// nothing: their K and V rows are zero and their dK/dV rows are not stored)
// and query rows past n get lse = +inf (P = 0).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "attention.cuh"
#include "flash_wgmma.cuh"
#include "hopper.cuh"

using f5::cp_async16;
using f5::cp_async_commit;
using f5::cp_async_wait_all;
using f5::cp_async_wait_one;
using f5::ex2;
using f5::ld32;
using f5::load_a;
using f5::mma16816;
using f5::mma_a_by_rows;
using f5::pack_bf16;
using bf16 = __nv_bfloat16;

namespace {

namespace hp = f5::hopper;
namespace fw = f5::fwdw;

constexpr int NWARPS = 4;
constexpr int BT = 16 * NWARPS;  // rows per tile, queries or keys (16 per warp)
constexpr int NTHREADS = NWARPS * 32;
constexpr float NEG_BIG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// Element strides of one (b, h, n, d) operand: batch, head, row.
struct View {
    long long sb, sh, sn;
};

__device__ __forceinline__ size_t at(const View& v, int b, int head) { return (size_t)b * v.sb + (size_t)head * v.sh; }

// Offset of row t of head `head` in a (b, n, h, D) output.
__device__ __forceinline__ size_t out_row(int b, int t, int head, int n, int h, int D) {
    return (((size_t)b * n + t) * h + head) * D;
}

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

// Rows [r0, r0 + BT) of an (n, D) bf16 matrix with row stride sn into dst
// (row stride LD), zero-filled past n; asynchronous 16-byte copies.
template <int D, int LD>
__device__ __forceinline__ void copy_rows(bf16* dst, const bf16* src, long long sn, int r0, int n, int tid) {
    for (int idx = tid; idx < BT * D / 8; idx += NTHREADS) {
        const int r = idx / (D / 8), c = (idx % (D / 8)) * 8;
        const bool valid = r0 + r < n;
        cp_async16(dst + r * LD + c, src + (size_t)(valid ? r0 + r : 0) * sn + c, valid);
    }
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// ---------------------------------------------------------------------------
// bf16 d 64 / 128 forward with logsumexp: the shared wgmma block
// ---------------------------------------------------------------------------

template <int D, bool BIAS, bool QSMEM, int NWG>
__global__ void __launch_bounds__(128 * (NWG + 1), 1)
fwd_lse_wgmma(const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
              const __grid_constant__ CUtensorMap qmap, const bf16* __restrict__ q, View vq, bf16* __restrict__ o,
              float* __restrict__ lse, const uint8_t* __restrict__ key_mask, int h, int n, float scale) {
    extern __shared__ unsigned char smem_raw[];
    const int bh = blockIdx.y, bi = bh / h, head = bh % h;
    fw::Args a;
    a.kmap = &kmap;
    a.vmap = &vmap;
    a.qmap = &qmap;
    a.kh = head;
    a.vh = head;
    a.qrows = q + at(vq, bi, head);
    a.qsn = vq.sn;
    a.o = o;
    a.lse = lse;
    a.key_mask = key_mask;
    a.bi = bi;
    a.head = head;
    a.h = h;
    a.n = n;
    a.scale = scale;
    fw::block<D, BIAS, true, QSMEM, NWG>(smem_raw, a);
}

// ---------------------------------------------------------------------------
// bf16 d 64 backward: two wgmma passes
// ---------------------------------------------------------------------------

constexpr int BR = 128;  // resident rows per block: 2 consumer warpgroups of 64
constexpr int BS = 64;   // streamed rows per tile
constexpr int BSTAGES = 4;
constexpr int BTILE = BS * 128;  // a 64-row tile of 64 bf16 columns (one swizzled panel): 8 KB
constexpr int BSTAGE = 2 * BTILE;  // X then Y
constexpr size_t BSMEM = 1024 + (size_t)BSTAGES * BSTAGE + (size_t)BSTAGES * 2 * BS * 4 + 2 * BSTAGES * 8;
constexpr int PASS_DQ = 0, PASS_DKDV = 1;

// This thread's A fragments of rows r0, r1 (0 past n) over d 64, 4 k-steps.
__device__ __forceinline__ void load_frags(uint32_t (&f)[4][4], const bf16* rows, long long sn, int r0, int r1, int n,
                                           int tq) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
        const int c = kk * 16 + tq * 2;
        f[kk][0] = r0 < n ? ld32(rows + (size_t)r0 * sn + c) : 0u;
        f[kk][1] = r1 < n ? ld32(rows + (size_t)r1 * sn + c) : 0u;
        f[kk][2] = r0 < n ? ld32(rows + (size_t)r0 * sn + c + 8) : 0u;
        f[kk][3] = r1 < n ? ld32(rows + (size_t)r1 * sn + c + 8) : 0u;
    }
}

// Key bias in log2 units: 0 valid, -1e30 masked, -inf past n.
__device__ __forceinline__ float key_bias2(const uint8_t* key_mask, int bi, int n, int key) {
    return key >= n ? -INFINITY : (key_mask != nullptr && !key_mask[(size_t)bi * n + key] ? NEG_BIG * LOG2E : 0.0f);
}

// PASS_DQ: resident rows are queries (ar = q, br = dO), X / Y tiles are K / V;
// computes D from dO and o, stores it in delta, writes dq to out0.
// PASS_DKDV: resident rows are keys (ar = k, br = v), X / Y tiles are Q / dO;
// reads delta, writes dk to out0 and dv to out1.
template <int PASS, bool BIAS>
__global__ void __launch_bounds__(384, 1)
bwd_wgmma(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap ymap,
          const bf16* __restrict__ ar, View va, const bf16* __restrict__ br, View vb, const bf16* __restrict__ o,
          View vo, const float* __restrict__ lse, float* __restrict__ delta, bf16* __restrict__ out0,
          bf16* __restrict__ out1, const uint8_t* __restrict__ key_mask, int h, int n, float scale) {
    constexpr bool COLSTATS = PASS == PASS_DKDV || BIAS;  // the producer stages per-column values
    extern __shared__ unsigned char smem_raw[];
    unsigned char* base = reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
    float* stats = reinterpret_cast<float*>(base + BSTAGES * BSTAGE);  // per stage: BS of column term, BS of D
    uint64_t* full = reinterpret_cast<uint64_t*>(stats + BSTAGES * 2 * BS);
    uint64_t* empty = full + BSTAGES;

    const int bh = blockIdx.y, bi = bh / h, head = bh % h;
    const int rbase = blockIdx.x * BR;
    const int ntiles = (n + BS - 1) / BS;
    const size_t row_base = (size_t)bh * n;  // of lse and delta
    const int tid = threadIdx.x;
    if (tid == 0) {
        for (int i = 0; i < BSTAGES; ++i) {
            hp::mbar_init(&full[i], COLSTATS ? 32 : 1);
            hp::mbar_init(&empty[i], 8);
        }
        hp::mbar_init_fence();
    }
    __syncthreads();

    if (tid < 128) {  // producer warpgroup; its first warp keeps the ring full
        hp::setmaxnreg_dec<24>();
        if (tid < 32) {
            for (int j = 0; j < ntiles; ++j) {
                const int stage = j % BSTAGES;
                hp::mbar_wait(&empty[stage], ((j / BSTAGES) & 1) ^ 1);
                if constexpr (COLSTATS) {
                    float* ca = stats + stage * 2 * BS;
#pragma unroll
                    for (int e = 0; e < BS / 32; ++e) {
                        const int c = tid * (BS / 32) + e, t = j * BS + c;
                        if constexpr (PASS == PASS_DKDV) {  // -lse and D of query t, in log2 units
                            ca[c] = t < n ? -lse[row_base + t] * LOG2E : -INFINITY;
                            ca[BS + c] = t < n ? delta[row_base + t] : 0.0f;
                        } else {
                            ca[c] = key_bias2(key_mask, bi, n, t);
                        }
                    }
                }
                if (tid == 0) {
                    unsigned char* xt = base + stage * BSTAGE;
                    hp::mbar_arrive_expect_tx(&full[stage], BSTAGE);
                    hp::tma_load_4d(xt, &xmap, &full[stage], 0, j * BS, head, bi);
                    hp::tma_load_4d(xt + BTILE, &ymap, &full[stage], 0, j * BS, head, bi);
                } else if (COLSTATS) {
                    hp::mbar_arrive(&full[stage]);
                }
            }
        }
    } else {  // consumer warpgroups: 64 resident rows each
        hp::setmaxnreg_inc<240>();
        const int ctid = tid - 128;
        const int wg = ctid / 128;
        const int warp = (ctid / 32) % 4;
        const int lane = ctid % 32;
        const int g = lane >> 2, tq = lane & 3;
        const int r0 = rbase + wg * 64 + warp * 16 + g, r1 = r0 + 8;

        uint32_t a1[4][4], a2[4][4];
        load_frags(a1, ar + at(va, bi, head), va.sn, r0, r1, n, tq);
        load_frags(a2, br + at(vb, bi, head), vb.sn, r0, r1, n, tq);
        const float sl2 = scale * LOG2E;
        // per-row terms: p = exp2(s * scale log2 e + radd + column term)
        float radd0, radd1, rd0 = 0.0f, rd1 = 0.0f;
        if constexpr (PASS == PASS_DQ) {
            radd0 = r0 < n ? -lse[row_base + r0] * LOG2E : -INFINITY;
            radd1 = r1 < n ? -lse[row_base + r1] * LOG2E : -INFINITY;
            // D = rowsum(dO * O): this thread's 16 columns of each row, then the row's 4 threads
            const bf16* ob = o + at(vo, bi, head);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                    const int c = kk * 16 + tq * 2 + half * 8;
                    if (r0 < n) {
                        const float2 x = unpack_bf16(a2[kk][2 * half]), y = unpack_bf16(ld32(ob + (size_t)r0 * vo.sn + c));
                        rd0 += x.x * y.x + x.y * y.y;
                    }
                    if (r1 < n) {
                        const float2 x = unpack_bf16(a2[kk][2 * half + 1]), y = unpack_bf16(ld32(ob + (size_t)r1 * vo.sn + c));
                        rd1 += x.x * y.x + x.y * y.y;
                    }
                }
            }
            rd0 += __shfl_xor_sync(0xffffffffu, rd0, 1);
            rd0 += __shfl_xor_sync(0xffffffffu, rd0, 2);
            rd1 += __shfl_xor_sync(0xffffffffu, rd1, 1);
            rd1 += __shfl_xor_sync(0xffffffffu, rd1, 2);
            if (tq == 0) {
                if (r0 < n) delta[row_base + r0] = rd0;
                if (r1 < n) delta[row_base + r1] = rd1;
            }
        } else {
            radd0 = BIAS ? key_bias2(key_mask, bi, n, r0) : 0.0f;
            radd1 = BIAS ? key_bias2(key_mask, bi, n, r1) : 0.0f;
        }

        float s[32], dp[32], acc0[32], acc1[32];
        uint32_t pf[4][4], dsf[4][4];
#pragma unroll
        for (int i = 0; i < 32; ++i) acc0[i] = acc1[i] = 0.0f;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) pf[i][e] = dsf[i][e] = 0u;

        // S = A1 X^T and dP = A2 Y^T of the tile in `stage`, two commit groups
        auto issue_sdp = [&](int stage) {
            const unsigned char* xt = base + stage * BSTAGE;
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
                hp::wgmma_m64n64k16_rs<0>(s, a1[kk], hp::desc_b128(xt + kk * 32, 16, 1024), kk > 0);
            hp::wgmma_commit();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
                hp::wgmma_m64n64k16_rs<0>(dp, a2[kk], hp::desc_b128(xt + BTILE + kk * 32, 16, 1024), kk > 0);
            hp::wgmma_commit();
        };
        // acc += f (64 x 64, k over the tile's rows) . tile (64 rows x d, MN-major), one commit group
        auto issue_acc = [&](float (&acc)[32], const uint32_t (&f)[4][4], const unsigned char* t) {
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
                hp::wgmma_m64n64k16_rs<1>(acc, f[kk], hp::desc_b128(t + kk * 2048, BTILE, 1024), 1);
            hp::wgmma_commit();
        };
        auto pack = [&](uint32_t (&f)[4][4]) {
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
                f[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
                f[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
                f[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
                f[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
            }
        };
        auto release = [&](int stage) {
            __syncwarp();
            if (lane == 0) hp::mbar_arrive(&empty[stage]);
        };

        // P (in place in s; packed into pf for dV) and dS = P (dP - D) (in
        // place; packed into dsf) of the tile in `stage`
        auto compute = [&](int stage) {
            const float* ca = stats + stage * 2 * BS;
#pragma unroll
            for (int i = 0; i < 8; ++i) {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    float* x0 = &s[4 * i + e];
                    float* x1 = &s[4 * i + 2 + e];
                    if constexpr (BIAS) {  // a row term and a column term
                        const float cadd = ca[8 * i + 2 * tq + e];
                        *x0 = ex2(fmaf(*x0, sl2, radd0) + cadd);
                        *x1 = ex2(fmaf(*x1, sl2, radd1) + cadd);
                    } else if constexpr (PASS == PASS_DKDV) {  // the column's -lse only
                        const float cadd = ca[8 * i + 2 * tq + e];
                        *x0 = ex2(fmaf(*x0, sl2, cadd));
                        *x1 = ex2(fmaf(*x1, sl2, cadd));
                    } else {  // the row's -lse only
                        *x0 = ex2(fmaf(*x0, sl2, radd0));
                        *x1 = ex2(fmaf(*x1, sl2, radd1));
                    }
                }
            }
            if constexpr (PASS == PASS_DKDV) pack(pf);
#pragma unroll
            for (int i = 0; i < 8; ++i) {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const float d0 = PASS == PASS_DKDV ? ca[BS + 8 * i + 2 * tq + e] : rd0;
                    const float d1 = PASS == PASS_DKDV ? ca[BS + 8 * i + 2 * tq + e] : rd1;
                    s[4 * i + e] *= dp[4 * i + e] - d0;
                    s[4 * i + 2 + e] *= dp[4 * i + 2 + e] - d1;
                }
            }
            pack(dsf);
        };
        // dV += P^T dO and dK += dS^T Q, or dQ += dS K, from the tile in `stage`
        auto issue_grads = [&](int stage) {
            const unsigned char* xt = base + stage * BSTAGE;
            if constexpr (PASS == PASS_DKDV) issue_acc(acc1, pf, xt + BTILE);
            issue_acc(acc0, dsf, xt);
        };
        auto fence_all = [&]() {
            hp::fence_regs(s);
            hp::fence_regs(dp);
            hp::fence_regs(acc0);
            hp::fence_regs(dsf);
            if constexpr (PASS == PASS_DKDV) {
                hp::fence_regs(acc1);
                hp::fence_regs(pf);
            }
        };

        // Per tile j, one wgmma pipeline stage: S_{j+1} and dP_{j+1} with the
        // gradient products of tile j, issued after P_j and dS_j are made and
        // drained (wait 0) before the next tile's exponentials: a register
        // that a non-wgmma instruction writes must not be a wgmma accumulator
        // later in the same open stage, or ptxas serialises every wgmma
        // (warning C7515). The two warpgroups take turns issuing (named
        // barriers 1, 2; 0 first), so one's exponentials run under the
        // other's products.
        const int my_bar = 1 + wg, next_bar = 2 - wg;
        if (wg == 1) hp::named_arrive(1, 256);
        hp::mbar_wait(&full[0], 0);
        hp::named_sync(my_bar, 256);
        fence_all();
        hp::wgmma_fence();
        issue_sdp(0);
        hp::named_arrive(next_bar, 256);
        hp::wgmma_wait<0>();
        fence_all();
        for (int j = 0; j + 1 < ntiles; ++j) {
            const int stage = j % BSTAGES, next = (j + 1) % BSTAGES;
            compute(stage);
            hp::mbar_wait(&full[next], ((j + 1) / BSTAGES) & 1);
            hp::named_sync(my_bar, 256);
            fence_all();
            hp::wgmma_fence();
            issue_sdp(next);
            issue_grads(stage);
            hp::named_arrive(next_bar, 256);
            hp::wgmma_wait<0>();
            fence_all();
            release(stage);
        }
        const int last = (ntiles - 1) % BSTAGES;
        compute(last);
        hp::named_sync(my_bar, 256);
        fence_all();
        hp::wgmma_fence();
        issue_grads(last);
        if (wg == 0) hp::named_arrive(next_bar, 256);
        hp::wgmma_wait<0>();
        fence_all();
        release(last);
        hp::fence_regs(a1);
        hp::fence_regs(a2);

#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const int c = 8 * i + 2 * tq;
            if (r0 < n) {
                *reinterpret_cast<uint32_t*>(out0 + out_row(bi, r0, head, n, h, 64) + c) =
                    pack_bf16(acc0[4 * i] * scale, acc0[4 * i + 1] * scale);
                if constexpr (PASS == PASS_DKDV)
                    *reinterpret_cast<uint32_t*>(out1 + out_row(bi, r0, head, n, h, 64) + c) =
                        pack_bf16(acc1[4 * i], acc1[4 * i + 1]);
            }
            if (r1 < n) {
                *reinterpret_cast<uint32_t*>(out0 + out_row(bi, r1, head, n, h, 64) + c) =
                    pack_bf16(acc0[4 * i + 2] * scale, acc0[4 * i + 3] * scale);
                if constexpr (PASS == PASS_DKDV)
                    *reinterpret_cast<uint32_t*>(out1 + out_row(bi, r1, head, n, h, 64) + c) =
                        pack_bf16(acc1[4 * i + 2], acc1[4 * i + 3]);
            }
        }
    }
}

// ---------------------------------------------------------------------------
// bf16 forward with logsumexp, mma.sync (d 32)
// ---------------------------------------------------------------------------

template <int D>
constexpr size_t smem_fwd_bf16() {  // Q tile, two K and two V tiles (rows of D+8), two bias rows
    return (size_t)(5 * BT) * (D + 8) * sizeof(bf16) + 2 * BT * sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
fwd_lse_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
             bf16* __restrict__ o, float* __restrict__ lse, const uint8_t* __restrict__ key_mask, int h, int n,
             float scale, View vq, View vk, View vv) {
    // rows padded by 8 elements: fragment loads and ldmatrix rows hit distinct banks
    constexpr int LD = D + 8;
    extern __shared__ __align__(128) unsigned char smem_raw[];
    bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
    bf16* Ks = Qs + BT * LD;
    bf16* Vs = Ks + 2 * BT * LD;
    float* bias = reinterpret_cast<float*>(Vs + 2 * BT * LD);

    const int bh = blockIdx.y, b = bh / h, head = bh % h, q0 = blockIdx.x * BT;
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, tq = lane & 3;
    const bf16* kb0 = k + at(vk, b, head);
    const bf16* vb0 = v + at(vv, b, head);

    auto stage = [&](int buf, int k0) {
        copy_rows<D, LD>(Ks + buf * BT * LD, kb0, vk.sn, k0, n, tid);
        copy_rows<D, LD>(Vs + buf * BT * LD, vb0, vv.sn, k0, n, tid);
        stage_bias(bias + buf * BT, key_mask, b, n, k0, tid);
    };
    copy_rows<D, LD>(Qs, q + at(vq, b, head), vq.sn, q0, n, tid);
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
                mma16816(s[nb], qf[kk], ld32(p), ld32(p + 8));
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
            *reinterpret_cast<uint32_t*>(o + out_row(b, t0, head, n, h, D) + c) =
                pack_bf16(acc[nb][0] / den0, acc[nb][1] / den0);
        if (t1 < n)
            *reinterpret_cast<uint32_t*>(o + out_row(b, t1, head, n, h, D) + c) =
                pack_bf16(acc[nb][2] / den1, acc[nb][3] / den1);
    }
    if (tq == 0) {
        if (t0 < n) lse[(size_t)bh * n + t0] = m0 + logf(den0);
        if (t1 < n) lse[(size_t)bh * n + t1] = m1 + logf(den1);
    }
}

// ---------------------------------------------------------------------------
// bf16 backward on mma.sync (d 32, d 128), pass 1: dQ of one query tile over
// all key tiles; also D of its rows, stored for pass 2
// ---------------------------------------------------------------------------

template <int D>
constexpr size_t smem_bwd_bf16() {  // 2 resident tiles + 2 x 2 streamed tiles; bias; 2 x (lse, D)
    return (size_t)(6 * BT) * (D + 8) * sizeof(bf16) + (BT + 4 * BT) * sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
bwd_dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
            const bf16* __restrict__ dout, const bf16* __restrict__ o, const float* __restrict__ lse,
            float* __restrict__ delta, bf16* __restrict__ dq, const uint8_t* __restrict__ key_mask, int h, int n,
            float scale, View vq, View vk, View vv, View vdo, View vo) {
    constexpr int LD = D + 8;
    extern __shared__ __align__(128) unsigned char smem_raw[];
    bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // this block's query rows
    bf16* dOs = Qs + BT * LD;
    bf16* Ks = dOs + BT * LD;  // 2 buffers
    bf16* Vs = Ks + 2 * BT * LD;  // 2 buffers
    float* bias = reinterpret_cast<float*>(Vs + 2 * BT * LD);  // 2 buffers

    const int bh = blockIdx.y, b = bh / h, head = bh % h, q0 = blockIdx.x * BT;
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, tq = lane & 3;
    const int t0 = q0 + warp * 16 + g, t1 = t0 + 8;
    const float lse0 = t0 < n ? lse[(size_t)bh * n + t0] : INFINITY;
    const float lse1 = t1 < n ? lse[(size_t)bh * n + t1] : INFINITY;
    const bf16* kb0 = k + at(vk, b, head);
    const bf16* vb0 = v + at(vv, b, head);

    auto stage = [&](int buf, int k0) {
        copy_rows<D, LD>(Ks + buf * BT * LD, kb0, vk.sn, k0, n, tid);
        copy_rows<D, LD>(Vs + buf * BT * LD, vb0, vv.sn, k0, n, tid);
        stage_bias(bias + buf * BT, key_mask, b, n, k0, tid);
    };
    copy_rows<D, LD>(Qs, q + at(vq, b, head), vq.sn, q0, n, tid);
    copy_rows<D, LD>(dOs, dout + at(vdo, b, head), vdo.sn, q0, n, tid);
    stage(0, 0);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();

    // D = rowsum(dO * O) of rows t0, t1: D/4 columns a thread, then the row's 4 threads
    float dl0 = 0.0f, dl1 = 0.0f;
    {
        const bf16* ob = o + at(vo, b, head);
#pragma unroll
        for (int c = tq * (D / 4); c < (tq + 1) * (D / 4); c += 2) {
            if (t0 < n) {
                const float2 x = unpack_bf16(ld32(dOs + (warp * 16 + g) * LD + c)), y = unpack_bf16(ld32(ob + (size_t)t0 * vo.sn + c));
                dl0 += x.x * y.x + x.y * y.y;
            }
            if (t1 < n) {
                const float2 x = unpack_bf16(ld32(dOs + (warp * 16 + g + 8) * LD + c)), y = unpack_bf16(ld32(ob + (size_t)t1 * vo.sn + c));
                dl1 += x.x * y.x + x.y * y.y;
            }
        }
        dl0 += __shfl_xor_sync(0xffffffffu, dl0, 1);
        dl0 += __shfl_xor_sync(0xffffffffu, dl0, 2);
        dl1 += __shfl_xor_sync(0xffffffffu, dl1, 1);
        dl1 += __shfl_xor_sync(0xffffffffu, dl1, 2);
        if (tq == 0) {
            if (t0 < n) delta[(size_t)bh * n + t0] = dl0;
            if (t1 < n) delta[(size_t)bh * n + t1] = dl1;
        }
    }

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
                mma16816(s[nb], aq, ld32(pk), ld32(pk + 8));
                mma16816(dp[nb], ad, ld32(pv), ld32(pv + 8));
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
            *reinterpret_cast<uint32_t*>(dq + out_row(b, t0, head, n, h, D) + c) =
                pack_bf16(dq_acc[nb][0] * scale, dq_acc[nb][1] * scale);
        if (t1 < n)
            *reinterpret_cast<uint32_t*>(dq + out_row(b, t1, head, n, h, D) + c) =
                pack_bf16(dq_acc[nb][2] * scale, dq_acc[nb][3] * scale);
    }
}

// ---------------------------------------------------------------------------
// bf16 backward on mma.sync (d 32, d 128), pass 2: dK and dV of one key tile
// over all query tiles
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(NTHREADS)
bwd_dkdv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
              const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dk, bf16* __restrict__ dv, const uint8_t* __restrict__ key_mask, int h, int n,
              float scale, View vq, View vk, View vv, View vdo) {
    constexpr int LD = D + 8;
    extern __shared__ __align__(128) unsigned char smem_raw[];
    bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // this block's keys
    bf16* Vs = Ks + BT * LD;
    bf16* Qs = Vs + BT * LD;    // 2 buffers of query rows
    bf16* dOs = Qs + 2 * BT * LD;  // 2 buffers of dO rows
    float* bias = reinterpret_cast<float*>(dOs + 2 * BT * LD);
    float* lse_s = bias + BT;  // 2 buffers
    float* dl_s = lse_s + 2 * BT;  // 2 buffers

    const int bh = blockIdx.y, b = bh / h, head = bh % h, k0 = blockIdx.x * BT;
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, tq = lane & 3;
    const size_t row_base = (size_t)bh * n;
    const bf16* qb0 = q + at(vq, b, head);
    const bf16* db0 = dout + at(vdo, b, head);

    auto stage = [&](int buf, int q0) {
        copy_rows<D, LD>(Qs + buf * BT * LD, qb0, vq.sn, q0, n, tid);
        copy_rows<D, LD>(dOs + buf * BT * LD, db0, vdo.sn, q0, n, tid);
        stage_stats(lse_s + buf * BT, dl_s + buf * BT, lse, delta, row_base, q0, n, tid);
    };
    copy_rows<D, LD>(Ks, k + at(vk, b, head), vk.sn, k0, n, tid);
    copy_rows<D, LD>(Vs, v + at(vv, b, head), vv.sn, k0, n, tid);
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
                mma16816(s[nb], a, ld32(p), ld32(p + 8));
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
                mma16816(dp[nb], a, ld32(p), ld32(p + 8));
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
            *reinterpret_cast<uint32_t*>(dk + out_row(b, j0, head, n, h, D) + c) =
                pack_bf16(dk_acc[nb][0] * scale, dk_acc[nb][1] * scale);
            *reinterpret_cast<uint32_t*>(dv + out_row(b, j0, head, n, h, D) + c) = pack_bf16(dv_acc[nb][0], dv_acc[nb][1]);
        }
        if (j1 < n) {
            *reinterpret_cast<uint32_t*>(dk + out_row(b, j1, head, n, h, D) + c) =
                pack_bf16(dk_acc[nb][2] * scale, dk_acc[nb][3] * scale);
            *reinterpret_cast<uint32_t*>(dv + out_row(b, j1, head, n, h, D) + c) = pack_bf16(dv_acc[nb][2], dv_acc[nb][3]);
        }
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

// Rows [r0, r0 + BT) of an (n, D) fp32 matrix with row stride sn into dst (dense, D per row), zero past n.
template <int D>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src, long long sn, int r0, int n, int tid) {
    for (int idx = tid; idx < BT * D; idx += NTHREADS) {
        const int t = r0 + idx / D;
        dst[idx] = t < n ? src[(size_t)t * sn + idx % D] : 0.0f;
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
             float scale, View vq, View vk, View vv) {
    extern __shared__ __align__(128) unsigned char smem_raw[];
    float* Qs = reinterpret_cast<float*>(smem_raw);
    float* Ks = Qs + BT * D;
    float* Vs = Ks + BT * D;
    float* Ps = Vs + BT * D;  // BT x BT
    float* bias = Ps + BT * BT;

    const int bh = blockIdx.y, b = bh / h, head = bh % h, q0 = blockIdx.x * BT, tid = threadIdx.x;
    const int r = tid / 2, half = tid & 1;
    load_rows_f32<D>(Qs, q + at(vq, b, head), vq.sn, q0, n, tid);
    float m = NEG_BIG, l = 0.0f;
    float acc[D / 2];
#pragma unroll
    for (int c = 0; c < D / 2; ++c) acc[c] = 0.0f;

    for (int k0 = 0; k0 < n; k0 += BT) {
        __syncthreads();
        load_rows_f32<D>(Ks, k + at(vk, b, head), vk.sn, k0, n, tid);
        load_rows_f32<D>(Vs, v + at(vv, b, head), vv.sn, k0, n, tid);
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
        for (int c = 0; c < D / 2; ++c) o[out_row(b, t, head, n, h, D) + half * (D / 2) + c] = acc[c] / den;
        if (half == 0) lse[(size_t)bh * n + t] = m + logf(den);
    }
}

template <int D>
constexpr size_t smem_bwd_fp32() {  // 4 row tiles; P and dS tiles; bias; lse, D
    return (size_t)(4 * BT * D + 2 * BT * BT + 3 * BT) * sizeof(float);
}

// pass 1: dQ of one query tile, and D of its rows
template <int D>
__global__ void __launch_bounds__(NTHREADS)
bwd_dq_fp32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
            const float* __restrict__ dout, const float* __restrict__ o, const float* __restrict__ lse,
            float* __restrict__ delta, float* __restrict__ dq, const uint8_t* __restrict__ key_mask, int h, int n,
            float scale, View vq, View vk, View vv, View vdo, View vo) {
    extern __shared__ __align__(128) unsigned char smem_raw[];
    float* Qs = reinterpret_cast<float*>(smem_raw);
    float* dOs = Qs + BT * D;
    float* Ks = dOs + BT * D;
    float* Vs = Ks + BT * D;
    float* dSs = Vs + BT * D;  // BT queries x BT keys
    float* bias = dSs + BT * BT;

    const int bh = blockIdx.y, b = bh / h, head = bh % h, q0 = blockIdx.x * BT, tid = threadIdx.x;
    const int r = tid / 2, half = tid & 1;  // query row r of the tile
    const int t = q0 + r;
    const float L = t < n ? lse[(size_t)bh * n + t] : INFINITY;
    load_rows_f32<D>(Qs, q + at(vq, b, head), vq.sn, q0, n, tid);
    load_rows_f32<D>(dOs, dout + at(vdo, b, head), vdo.sn, q0, n, tid);
    __syncthreads();
    float dl = 0.0f;  // D = rowsum(dO * O): half the columns a thread, then the pair
    if (t < n) {
        const float* orow = o + at(vo, b, head) + (size_t)t * vo.sn;
        for (int c = half * (D / 2); c < (half + 1) * (D / 2); ++c) dl += dOs[r * D + c] * orow[c];
    }
    dl += __shfl_xor_sync(0xffffffffu, dl, 1);
    if (t < n && half == 0) delta[(size_t)bh * n + t] = dl;
    float dq_acc[D / 2];
#pragma unroll
    for (int c = 0; c < D / 2; ++c) dq_acc[c] = 0.0f;

    for (int k0 = 0; k0 < n; k0 += BT) {
        __syncthreads();
        load_rows_f32<D>(Ks, k + at(vk, b, head), vk.sn, k0, n, tid);
        load_rows_f32<D>(Vs, v + at(vv, b, head), vv.sn, k0, n, tid);
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
        for (int c = 0; c < D / 2; ++c) dq[out_row(b, t, head, n, h, D) + half * (D / 2) + c] = dq_acc[c] * scale;
    }
}

// pass 2: dK and dV of one key tile
template <int D>
__global__ void __launch_bounds__(NTHREADS)
bwd_dkdv_fp32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
              const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dk, float* __restrict__ dv, const uint8_t* __restrict__ key_mask, int h, int n,
              float scale, View vq, View vk, View vv, View vdo) {
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

    const int bh = blockIdx.y, b = bh / h, head = bh % h, k0 = blockIdx.x * BT, tid = threadIdx.x;
    const int r = tid / 2, half = tid & 1;  // key row r of the tile
    load_rows_f32<D>(Ks, k + at(vk, b, head), vk.sn, k0, n, tid);
    load_rows_f32<D>(Vs, v + at(vv, b, head), vv.sn, k0, n, tid);
    stage_bias(bias, key_mask, b, n, k0, tid);
    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int c = 0; c < D / 2; ++c) dk_acc[c] = dv_acc[c] = 0.0f;

    for (int q0 = 0; q0 < n; q0 += BT) {
        __syncthreads();
        load_rows_f32<D>(Qs, q + at(vq, b, head), vq.sn, q0, n, tid);
        load_rows_f32<D>(dOs, dout + at(vdo, b, head), vdo.sn, q0, n, tid);
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
            dk[out_row(b, j, head, n, h, D) + half * (D / 2) + c] = dk_acc[c] * scale;
            dv[out_row(b, j, head, n, h, D) + half * (D / 2) + c] = dv_acc[c];
        }
    }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename K>
int prepare(K kernel, size_t smem) {
    return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// The five operands' views, in the order q, k, v, dO, o.
struct Views {
    View q, k, v, dout, o;
};

Views views_of(const long long* st) {
    Views w;
    View* all[5] = {&w.q, &w.k, &w.v, &w.dout, &w.o};
    for (int i = 0; i < 5; ++i) *all[i] = View{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
    return w;
}

int rows_map(CUtensorMap* map, const void* ptr, const View& w, int d, int n, int h, int b, int box_rows) {
    return fw::make_rows_map(map, ptr, d, n, h, b, w.sb, w.sh, w.sn, box_rows);
}

template <int D, bool BIAS, bool QSMEM, int NWG>
int launch_fwd_wgmma(const void* q, const void* k, const void* v, void* o, void* lse, const void* mask, int b, int h,
                     int n, float scale, const Views& w, cudaStream_t st) {
    CUtensorMap kmap, vmap, qmap;
    int err = rows_map(&kmap, k, w.k, D, n, h, b, fw::WK);
    if (!err) err = rows_map(&vmap, v, w.v, D, n, h, b, fw::WK);
    using C = fw::Cfg<D, QSMEM, NWG>;
    if (!err) err = QSMEM ? rows_map(&qmap, q, w.q, D, n, h, b, C::BQ) : 0;
    if (err) return err;
    if (!QSMEM) qmap = kmap;  // not read
    if ((err = prepare(fwd_lse_wgmma<D, BIAS, QSMEM, NWG>, C::SMEM)) != 0) return err;
    const dim3 grid((n + C::BQ - 1) / C::BQ, b * h);
    fwd_lse_wgmma<D, BIAS, QSMEM, NWG><<<grid, C::THREADS, C::SMEM, st>>>(
        kmap, vmap, qmap, static_cast<const bf16*>(q), w.q, static_cast<bf16*>(o), static_cast<float*>(lse),
        static_cast<const uint8_t*>(mask), h, n, scale);
    return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse, const void* mask, int b, int h, int n,
               float scale, const Views& w, cudaStream_t st) {
    const dim3 grid((n + BT - 1) / BT, b * h);
    const uint8_t* km = static_cast<const uint8_t*>(mask);
    int err;
    if constexpr (std::is_same<T, bf16>::value && D != 32) {
        // d 64: Q in shared memory, 3 consumer warpgroups; d 128: Q in registers, 2.
        constexpr bool QSMEM = D == 64;
        constexpr int NWG = QSMEM ? 3 : 2;
        return mask ? launch_fwd_wgmma<D, true, QSMEM, NWG>(q, k, v, o, lse, mask, b, h, n, scale, w, st)
                    : launch_fwd_wgmma<D, false, QSMEM, NWG>(q, k, v, o, lse, mask, b, h, n, scale, w, st);
    } else if constexpr (std::is_same<T, bf16>::value) {
        constexpr size_t smem = smem_fwd_bf16<D>();
        if ((err = prepare(fwd_lse_bf16<D>, smem)) != 0) return err;
        fwd_lse_bf16<D><<<grid, NTHREADS, smem, st>>>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                                                      static_cast<const bf16*>(v), static_cast<bf16*>(o),
                                                      static_cast<float*>(lse), km, h, n, scale, w.q, w.k, w.v);
    } else {
        constexpr size_t smem = smem_fwd_fp32<D>();
        if ((err = prepare(fwd_lse_fp32<D>, smem)) != 0) return err;
        fwd_lse_fp32<D><<<grid, NTHREADS, smem, st>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                                                      static_cast<const float*>(v), static_cast<float*>(o),
                                                      static_cast<float*>(lse), km, h, n, scale, w.q, w.k, w.v);
    }
    return (int)cudaGetLastError();
}

// The d 64 wgmma backward pass PASS: dQ reads q, dO (resident) and K, V tiles;
// dK/dV reads k, v (resident) and Q, dO tiles.
template <int PASS>
int launch_bwd_wgmma(const void* q, const void* k, const void* v, const void* dout, const void* o, const void* lse,
                     void* delta, void* g0, void* g1, const void* mask, int b, int h, int n, float scale,
                     const Views& w, cudaStream_t st) {
    CUtensorMap xmap, ymap;
    const bool dq = PASS == PASS_DQ;
    int err = dq ? rows_map(&xmap, k, w.k, 64, n, h, b, BS) : rows_map(&xmap, q, w.q, 64, n, h, b, BS);
    if (!err) err = dq ? rows_map(&ymap, v, w.v, 64, n, h, b, BS) : rows_map(&ymap, dout, w.dout, 64, n, h, b, BS);
    if (err) return err;
    const bf16* ar = static_cast<const bf16*>(dq ? q : k);
    const bf16* br = static_cast<const bf16*>(dq ? dout : v);
    const View va = dq ? w.q : w.k, vb = dq ? w.dout : w.v;
    const dim3 grid((n + BR - 1) / BR, b * h);
    const bf16* ob = static_cast<const bf16*>(o);
    const float* ls = static_cast<const float*>(lse);
    float* dl = static_cast<float*>(delta);
    const uint8_t* km = static_cast<const uint8_t*>(mask);
    if (mask) {
        if ((err = prepare(bwd_wgmma<PASS, true>, BSMEM)) != 0) return err;
        bwd_wgmma<PASS, true><<<grid, 384, BSMEM, st>>>(xmap, ymap, ar, va, br, vb, ob, w.o, ls, dl,
                                                         static_cast<bf16*>(g0), static_cast<bf16*>(g1), km, h, n,
                                                         scale);
    } else {
        if ((err = prepare(bwd_wgmma<PASS, false>, BSMEM)) != 0) return err;
        bwd_wgmma<PASS, false><<<grid, 384, BSMEM, st>>>(xmap, ymap, ar, va, br, vb, ob, w.o, ls, dl,
                                                          static_cast<bf16*>(g0), static_cast<bf16*>(g1), km, h, n,
                                                          scale);
    }
    return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* o, const void* lse,
              void* delta, void* dq, const void* mask, int b, int h, int n, float scale, const Views& w,
              cudaStream_t st) {
    const dim3 grid((n + BT - 1) / BT, b * h);
    const uint8_t* km = static_cast<const uint8_t*>(mask);
    const float* ls = static_cast<const float*>(lse);
    float* dl = static_cast<float*>(delta);
    int err;
    if constexpr (std::is_same<T, bf16>::value && D == 64) {
        return launch_bwd_wgmma<PASS_DQ>(q, k, v, dout, o, lse, delta, dq, nullptr, mask, b, h, n, scale, w, st);
    } else if constexpr (std::is_same<T, bf16>::value) {
        constexpr size_t smem = smem_bwd_bf16<D>();
        if ((err = prepare(bwd_dq_bf16<D>, smem)) != 0) return err;
        bwd_dq_bf16<D><<<grid, NTHREADS, smem, st>>>(
            static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
            static_cast<const bf16*>(dout), static_cast<const bf16*>(o), ls, dl, static_cast<bf16*>(dq), km, h, n,
            scale, w.q, w.k, w.v, w.dout, w.o);
    } else {
        constexpr size_t smem = smem_bwd_fp32<D>();
        if ((err = prepare(bwd_dq_fp32<D>, smem)) != 0) return err;
        bwd_dq_fp32<D><<<grid, NTHREADS, smem, st>>>(
            static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
            static_cast<const float*>(dout), static_cast<const float*>(o), ls, dl, static_cast<float*>(dq), km, h, n,
            scale, w.q, w.k, w.v, w.dout, w.o);
    }
    return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkdv(const void* q, const void* k, const void* v, const void* dout, const void* o, const void* lse,
                void* delta, void* dk, void* dv, const void* mask, int b, int h, int n, float scale, const Views& w,
                cudaStream_t st) {
    const dim3 grid((n + BT - 1) / BT, b * h);
    const uint8_t* km = static_cast<const uint8_t*>(mask);
    const float* ls = static_cast<const float*>(lse);
    const float* dl = static_cast<const float*>(delta);
    int err;
    if constexpr (std::is_same<T, bf16>::value && D == 64) {
        return launch_bwd_wgmma<PASS_DKDV>(q, k, v, dout, o, lse, delta, dk, dv, mask, b, h, n, scale, w, st);
    } else if constexpr (std::is_same<T, bf16>::value) {
        constexpr size_t smem = smem_bwd_bf16<D>();
        if ((err = prepare(bwd_dkdv_bf16<D>, smem)) != 0) return err;
        bwd_dkdv_bf16<D><<<grid, NTHREADS, smem, st>>>(
            static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
            static_cast<const bf16*>(dout), ls, dl, static_cast<bf16*>(dk), static_cast<bf16*>(dv), km, h, n, scale,
            w.q, w.k, w.v, w.dout);
    } else {
        constexpr size_t smem = smem_bwd_fp32<D>();
        if ((err = prepare(bwd_dkdv_fp32<D>, smem)) != 0) return err;
        bwd_dkdv_fp32<D><<<grid, NTHREADS, smem, st>>>(
            static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
            static_cast<const float*>(dout), ls, dl, static_cast<float*>(dk), static_cast<float*>(dv), km, h, n,
            scale, w.q, w.k, w.v, w.dout);
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

// q, k, v, dout, o: (b, h, n, d) bf16 (is_bf16 = 1) or fp32, read through
// strides: 15 element strides (batch, head, row) in the order q, k, v, dout, o
// (the forward reads the first three), a contiguous last axis, the other
// strides multiples of 16 bytes, 16-byte aligned. o (forward), dq, dk, dv:
// (b, n, h, d) contiguous outputs. lse, delta: (b, h, n) fp32; the dQ pass
// writes delta (D = rowsum(dO * O)) and the dK/dV pass reads it, so dQ runs
// first. key_mask: (b, n) bytes (1 = valid) or null. Each launches one
// kernel and returns the cudaError_t of its launch.
int f5_flash_train_fwd(const void* q, const void* k, const void* v, void* o, void* lse, const void* key_mask, int b,
                       int h, int n, int d, int is_bf16, float scale, const long long* strides, void* stream) {
    const Views w = views_of(strides);
    F5_DISPATCH(launch_fwd, q, k, v, o, lse, key_mask, b, h, n, scale, w, static_cast<cudaStream_t>(stream));
}

int f5_flash_train_bwd_dq(const void* q, const void* k, const void* v, const void* dout, const void* o,
                          const void* lse, void* delta, void* dq, const void* key_mask, int b, int h, int n, int d,
                          int is_bf16, float scale, const long long* strides, void* stream) {
    const Views w = views_of(strides);
    F5_DISPATCH(launch_dq, q, k, v, dout, o, lse, delta, dq, key_mask, b, h, n, scale, w,
                static_cast<cudaStream_t>(stream));
}

int f5_flash_train_bwd_dkdv(const void* q, const void* k, const void* v, const void* dout, const void* o,
                            const void* lse, void* delta, void* dk, void* dv, const void* key_mask, int b, int h, int n,
                            int d, int is_bf16, float scale, const long long* strides, void* stream) {
    const Views w = views_of(strides);
    F5_DISPATCH(launch_dkdv, q, k, v, dout, o, lse, delta, dk, dv, key_mask, b, h, n, scale, w,
                static_cast<cudaStream_t>(stream));
}

const char* f5_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
