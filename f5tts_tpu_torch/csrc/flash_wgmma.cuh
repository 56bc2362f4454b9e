// The warp-specialised flash-attention forward block on wgmma, shared by the
// serving kernel (flash_attention.cu: flash_wgmma, RoPE'd rows, key bias, no
// logsumexp) and the training forward (flash_attention_train.cu:
// fwd_lse_wgmma, which also stores the per-row logsumexp and has a variant
// without the key bias for key_mask = None) and the attention-layout
// ablation's `unpacked` layout (ablate_attention.cu). Compile-time switches:
//   BIAS  where each tile's additive key bias comes from: NO_BIAS (only the
//         ragged last tile masks its keys past n, in the softmax), KEY_MASK
//         (0 valid, -1e30 masked) or ROW (an fp32 row shared by every head,
//         bias_row[key]); with a bias the producer writes it beside the tile,
//         -inf past n, in log2 units;
//   LSE   the epilogue also stores lse = m + log(max(l, 1e-30)) (natural log);
//   QSMEM Q is a shared-memory wgmma operand loaded by TMA (d 64) instead of
//         register fragments loaded from global memory;
//   NWG   consumer warpgroups: 1 (no turns to take), 2 or (with QSMEM) 3;
//   COUNT block() returns the tensor-core products its warpgroup issued, in
//         m16n8k16 equivalents (4 N / 8 per wgmma m64nNk16); else 0.
//
// One block of 1 + NWG warpgroups per (bh, 64 NWG query rows). Warpgroup 0 is
// the producer: one warp keeps 128-key K/V tiles in flight through TMA (4-D
// maps that carry each tensor's strides, 128-byte swizzle, zero fill past n)
// in a ring of 3 stages (2 at d 128) with full/empty mbarriers; setmaxnreg
// gives its registers to the consumers. The consumers own 64 query rows each: S = Q K^T
// on wgmma m64n128k16 (K from shared memory, K-major), the online softmax on
// the accumulators, O += P V with P repacked from S into registers and V an
// MN-major shared-memory operand. Each warpgroup issues S of tile j together
// with P V of tile j-1 and runs the softmax of S_j while P V is on the tensor
// cores; named barriers make the warpgroups take turns issuing, so one's
// softmax covers the others' products. Scores are kept in log2 units (exp(x) =
// exp2(x log2 e), one MUFU op), the start value of the running max too, so a
// row whose keys are all masked weighs every key equally, as the reference
// does; its lse, (-1e30 log2 e) ln 2 + log(l), rounds to -1e30 exactly in fp32.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "attention.cuh"
#include "hopper.cuh"

namespace f5 {
namespace fwdw {

namespace hp = f5::hopper;
using bf16 = __nv_bfloat16;

constexpr int WK = 128;        // keys per tile
constexpr int WTHREADS = 384;  // the serving block: a producer and 2 consumer warpgroups
constexpr float NEG_BIG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

enum BiasSource { NO_BIAS = 0, KEY_MASK = 1, ROW = 2 };

// NWG consumer warpgroups of 64 query rows (2, or 3 with Q from shared
// memory: the consumers' registers then shrink from 240 to 160 a thread; 1 in
// a block launched two to an SM, 128 registers a thread at launch: 232).
template <int D, bool QSMEM, int NWG = 2>
struct Cfg {
    static constexpr int BQ = 64 * NWG;          // query rows per block
    static constexpr int THREADS = 128 * (NWG + 1);
    static constexpr int CREGS = NWG == 1 ? 232 : (NWG == 2 ? 240 : 160);
    static constexpr int STAGES = D == 64 ? 3 : 2;
    static constexpr int PANEL = WK * 128;         // bytes of one 64-column panel of a tile
    static constexpr int TILE = PANEL * (D / 64);  // K (or V) tile bytes
    static constexpr int STAGE = 2 * TILE;         // K then V
    static constexpr int QBYTES = QSMEM ? BQ * D * 2 : 0;
    static constexpr size_t SMEM = 1024 + (size_t)STAGES * STAGE + QBYTES + STAGES * WK * 4 + (2 * STAGES + 1) * 8;
};

// What one block reads and writes. K and V come through TMA maps of (D, n,
// heads, b) with 128-row boxes (kh, vh: this block's head index in each);
// Q through a map of the same form (QSMEM) or from qrows, this head's rows
// with row stride qsn; o is (b, n, h, D); lse (b, h, n) fp32 when LSE;
// key_mask (b, n) for KEY_MASK, bias_row (n,) fp32 for ROW.
struct Args {
    const CUtensorMap* kmap;
    const CUtensorMap* vmap;
    const CUtensorMap* qmap;
    int kh, vh;
    const bf16* qrows;
    long long qsn;
    bf16* o;
    float* lse;
    const uint8_t* key_mask;
    int bi, head, h, n;
    float scale;
    const float* bias_row;
};

// s[64]: scores of rows (g, g+8) of this warp x 128 keys, columns 8i + 2tq + {0,1}.
template <int D>
__device__ __forceinline__ void issue_s(float (&s)[64], const uint32_t (&qf)[D / 16][4], const unsigned char* kt) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
        hp::wgmma_m64n128k16_rs<0>(s, qf[kk], hp::desc_b128(kt + (kk / 4) * Cfg<D, false>::PANEL + (kk % 4) * 32, 16, 1024),
                                   kk > 0);
}

// The same with this warpgroup's 64 Q rows (d 64) as a swizzled shared-memory operand.
__device__ __forceinline__ void issue_s_smem(float (&s)[64], const unsigned char* qt, const unsigned char* kt) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
        hp::wgmma_m64n128k16_ss<0>(s, hp::desc_b128(qt + kk * 32, 16, 1024), hp::desc_b128(kt + kk * 32, 16, 1024),
                                   kk > 0);
}

template <int D>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2], const uint32_t (&p)[WK / 16][4], const unsigned char* vt) {
#pragma unroll
    for (int kk = 0; kk < WK / 16; ++kk) {
        const uint64_t desc = hp::desc_b128(vt + kk * 2048, Cfg<D, false>::PANEL, 1024);
        if constexpr (D == 64)
            hp::wgmma_m64n64k16_rs<1>(acc, p[kk], desc, 1);
        else
            hp::wgmma_m64n128k16_rs<1>(acc, p[kk], desc, 1);
    }
}

// Offset of row t of head `head` in a (b, n, h, D) tensor.
__device__ __forceinline__ size_t out_row(int b, int t, int head, int n, int h, int D) {
    return (((size_t)b * n + t) * h + head) * D;
}

// The block body; smem_raw is the kernel's dynamic shared memory (Cfg::SMEM
// bytes), launched as Cfg::THREADS threads on a grid of (ceil(n / Cfg::BQ), b * h).
template <int D, int BIAS, bool LSE, bool QSMEM, int NWG = 2, bool COUNT = false>
__device__ __forceinline__ unsigned block(unsigned char* smem_raw, const Args& a) {
    static_assert(!QSMEM || D == 64, "Q from shared memory is built for d 64");
    static_assert(NWG == 1 || NWG == 2 || (NWG == 3 && QSMEM), "3 consumer warpgroups fit with Q in shared memory only");
    using C = Cfg<D, QSMEM, NWG>;
    unsigned char* base = reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
    unsigned char* qs = base + C::STAGES * C::STAGE;  // QSMEM: the block's Q rows, 1024-aligned
    float* bias = reinterpret_cast<float*>(qs + C::QBYTES);  // STAGES x WK, in log2 units
    uint64_t* full = reinterpret_cast<uint64_t*>(bias + C::STAGES * WK);
    uint64_t* empty = full + C::STAGES;
    uint64_t* qbar = empty + C::STAGES;

    const int n = a.n, bi = a.bi;
    const int q0 = blockIdx.x * C::BQ;
    const int ntiles = (n + WK - 1) / WK;
    const int tid = threadIdx.x;
    if (tid == 0) {
        for (int i = 0; i < C::STAGES; ++i) {
            hp::mbar_init(&full[i], BIAS ? 32 : 1);  // the producer warp (bias rows written) or its lane 0
            hp::mbar_init(&empty[i], 4 * NWG);       // one arrival per consumer warp
        }
        hp::mbar_init(qbar, 1);
        hp::mbar_init_fence();
    }
    __syncthreads();

    if (tid < 128) {  // producer warpgroup; its first warp keeps the K/V ring full
        hp::setmaxnreg_dec<24>();
        if (tid < 32) {
            if (QSMEM && tid == 0) {
                hp::mbar_arrive_expect_tx(qbar, C::QBYTES);
                hp::tma_load_4d(qs, a.qmap, qbar, 0, q0, a.head, bi);
            }
            for (int j = 0; j < ntiles; ++j) {
                const int stage = j % C::STAGES;
                hp::mbar_wait(&empty[stage], ((j / C::STAGES) & 1) ^ 1);
                if constexpr (BIAS) {
#pragma unroll
                    for (int e = 0; e < WK / 32; ++e) {
                        const int col = tid * (WK / 32) + e, key = j * WK + col;
                        float bv;
                        if constexpr (BIAS == ROW)
                            bv = key >= n ? -INFINITY : a.bias_row[key];
                        else
                            bv = key >= n ? -INFINITY
                                          : (a.key_mask != nullptr && !a.key_mask[(size_t)bi * n + key] ? NEG_BIG : 0.0f);
                        bias[stage * WK + col] = bv * LOG2E;
                    }
                }
                if (tid == 0) {
                    unsigned char* kt = base + stage * C::STAGE;
                    hp::mbar_arrive_expect_tx(&full[stage], C::STAGE);
#pragma unroll
                    for (int pnl = 0; pnl < D / 64; ++pnl) {
                        hp::tma_load_4d(kt + pnl * C::PANEL, a.kmap, &full[stage], pnl * 64, j * WK, a.kh, bi);
                        hp::tma_load_4d(kt + C::TILE + pnl * C::PANEL, a.vmap, &full[stage], pnl * 64, j * WK, a.vh, bi);
                    }
                } else if (BIAS) {
                    hp::mbar_arrive(&full[stage]);
                }
            }
        }
    } else {  // consumer warpgroups: 64 query rows each
        hp::setmaxnreg_inc<C::CREGS>();
        const int ctid = tid - 128;
        const int wg = ctid / 128;
        const int warp = (ctid / 32) % 4;
        const int lane = ctid % 32;
        const int g = lane >> 2, tq = lane & 3;
        const int r0 = q0 + wg * 64 + warp * 16 + g, r1 = r0 + 8;
        const unsigned char* qt = qs + wg * 64 * 128;  // QSMEM: this warpgroup's 64 rows

        // this thread's Q fragments, straight from global memory (rows past n are 0)
        uint32_t qf[D / 16][4];
        if constexpr (!QSMEM) {
            const bf16* qb = a.qrows;
            const size_t rs = (size_t)a.qsn;
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk) {
                const int c = kk * 16 + tq * 2;
                qf[kk][0] = r0 < n ? ld32(qb + r0 * rs + c) : 0u;
                qf[kk][1] = r1 < n ? ld32(qb + r1 * rs + c) : 0u;
                qf[kk][2] = r0 < n ? ld32(qb + r0 * rs + c + 8) : 0u;
                qf[kk][3] = r1 < n ? ld32(qb + r1 * rs + c + 8) : 0u;
            }
        } else {
            hp::mbar_wait(qbar, 0);
        }

        const float scale_log2 = a.scale * LOG2E;
        float m0 = NEG_BIG * LOG2E, m1 = NEG_BIG * LOG2E, l0 = 0.0f, l1 = 0.0f;
        float acc[D / 2];
#pragma unroll
        for (int e = 0; e < D / 2; ++e) acc[e] = 0.0f;
        float s[64];
        uint32_t p[WK / 16][4];
        // the warpgroups take turns issuing, 0, 1, (2,) 0, ...: each waits on
        // its named barrier 1 + wg, which the one before it arrives at
        const int my_bar = 1 + wg, next_bar = 1 + (wg + 1) % NWG;
        if constexpr (NWG > 1)
            if (wg == NWG - 1) hp::named_arrive(1, 256);
        unsigned products = 0;  // COUNT: m16n8k16 equivalents this warpgroup issued
        constexpr unsigned S_PRODUCTS = (D / 16) * (4 * WK / 8), PV_PRODUCTS = (WK / 16) * (4 * D / 8);

        auto scores = [&](const unsigned char* kt) {
            if constexpr (QSMEM)
                issue_s_smem(s, qt, kt);
            else
                issue_s<D>(s, qf, kt);
        };
        // softmax of tile j (in `stage`) in s: exponentials in place, row sums,
        // the running max; returns the rescale factors of the old state.
        // Without the bias the max is taken over the raw scores (the scale is
        // positive) and scaling and subtracting it are one FMA per score.
        auto softmax = [&](int j, int stage, float& alpha0, float& alpha1) {
            float mx0 = -INFINITY, mx1 = -INFINITY;
            if constexpr (BIAS) {
                const float* bb = bias + stage * WK;
#pragma unroll
                for (int i = 0; i < 16; ++i) {
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const float bc = bb[8 * i + 2 * tq + e];
                        s[4 * i + e] = s[4 * i + e] * scale_log2 + bc;
                        s[4 * i + 2 + e] = s[4 * i + 2 + e] * scale_log2 + bc;
                    }
                }
            } else {
                const int kend = n - j * WK;  // keys of this tile before n
                if (kend < WK) {
#pragma unroll
                    for (int i = 0; i < 16; ++i) {
#pragma unroll
                        for (int e = 0; e < 2; ++e) {
                            if (8 * i + 2 * tq + e >= kend) s[4 * i + e] = s[4 * i + 2 + e] = -INFINITY;
                        }
                    }
                }
            }
#pragma unroll
            for (int i = 0; i < 16; ++i) {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    mx0 = fmaxf(mx0, s[4 * i + e]);
                    mx1 = fmaxf(mx1, s[4 * i + 2 + e]);
                }
            }
            mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
            mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
            mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
            mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
            if constexpr (!BIAS) {
                mx0 *= scale_log2;
                mx1 *= scale_log2;
            }
            const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
            alpha0 = ex2(m0 - mn0);
            alpha1 = ex2(m1 - mn1);
            float sum0[4] = {0.0f, 0.0f, 0.0f, 0.0f}, sum1[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // 4 short chains a row
#pragma unroll
            for (int i = 0; i < 16; ++i) {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    if constexpr (BIAS) {
                        s[4 * i + e] = ex2(s[4 * i + e] - mn0);
                        s[4 * i + 2 + e] = ex2(s[4 * i + 2 + e] - mn1);
                    } else {
                        s[4 * i + e] = ex2(fmaf(s[4 * i + e], scale_log2, -mn0));
                        s[4 * i + 2 + e] = ex2(fmaf(s[4 * i + 2 + e], scale_log2, -mn1));
                    }
                    sum0[i & 3] += s[4 * i + e];
                    sum1[i & 3] += s[4 * i + 2 + e];
                }
            }
            l0 = l0 * alpha0 + ((sum0[0] + sum0[1]) + (sum0[2] + sum0[3]));
            l1 = l1 * alpha1 + ((sum1[0] + sum1[1]) + (sum1[2] + sum1[3]));
            m0 = mn0;
            m1 = mn1;
        };
        auto rescale_and_pack = [&](float alpha0, float alpha1) {
#pragma unroll
            for (int i = 0; i < D / 8; ++i) {
                acc[4 * i] *= alpha0;
                acc[4 * i + 1] *= alpha0;
                acc[4 * i + 2] *= alpha1;
                acc[4 * i + 3] *= alpha1;
            }
#pragma unroll
            for (int kk = 0; kk < WK / 16; ++kk) {
                p[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
                p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
                p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
                p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
            }
        };
        auto release = [&](int stage) {
            __syncwarp();
            if (lane == 0) hp::mbar_arrive(&empty[stage]);
        };

        // tile 0: S alone
        hp::mbar_wait(&full[0], 0);
        if constexpr (NWG > 1) hp::named_sync(my_bar, 256);
        hp::fence_regs(s);
        hp::wgmma_fence();
        scores(base);
        hp::wgmma_commit();
        if constexpr (COUNT) products += S_PRODUCTS;
        if constexpr (NWG > 1) hp::named_arrive(next_bar, 256);
        hp::wgmma_wait<0>();
        hp::fence_regs(s);
        {
            float a0, a1;
            softmax(0, 0, a0, a1);
            rescale_and_pack(a0, a1);
        }
        // tile j: S_j and P_{j-1} V_{j-1} in flight together; the softmax of
        // S_j runs while P_{j-1} V_{j-1} is still on the tensor cores
        for (int j = 1; j < ntiles; ++j) {
            const int stage = j % C::STAGES, prev = (j - 1) % C::STAGES;
            hp::mbar_wait(&full[stage], (j / C::STAGES) & 1);
            if constexpr (NWG > 1) hp::named_sync(my_bar, 256);
            hp::fence_regs(s);
            hp::fence_regs(acc);
            hp::fence_regs(p);
            hp::wgmma_fence();
            scores(base + stage * C::STAGE);
            hp::wgmma_commit();
            issue_pv<D>(acc, p, base + prev * C::STAGE + C::TILE);
            hp::wgmma_commit();
            if constexpr (COUNT) products += S_PRODUCTS + PV_PRODUCTS;
            if constexpr (NWG > 1) hp::named_arrive(next_bar, 256);
            hp::wgmma_wait<1>();
            hp::fence_regs(s);
            float a0, a1;
            softmax(j, stage, a0, a1);
            hp::wgmma_wait<0>();
            hp::fence_regs(acc);
            hp::fence_regs(p);
            release(prev);
            rescale_and_pack(a0, a1);
        }
        // the last tile's PV
        const int last = (ntiles - 1) % C::STAGES;
        if constexpr (NWG > 1) hp::named_sync(my_bar, 256);
        hp::fence_regs(acc);
        hp::fence_regs(p);
        hp::wgmma_fence();
        issue_pv<D>(acc, p, base + last * C::STAGE + C::TILE);
        hp::wgmma_commit();
        if constexpr (COUNT) products += PV_PRODUCTS;
        if constexpr (NWG > 1)
            if (wg != NWG - 1) hp::named_arrive(next_bar, 256);
        hp::wgmma_wait<0>();
        hp::fence_regs(acc);
        hp::fence_regs(p);
        release(last);

        l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
        l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
        l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
        l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
        const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
#pragma unroll
        for (int i = 0; i < D / 8; ++i) {
            const int c = 8 * i + 2 * tq;
            if (r0 < n)
                *reinterpret_cast<uint32_t*>(a.o + out_row(bi, r0, a.head, n, a.h, D) + c) =
                    pack_bf16(acc[4 * i] / den0, acc[4 * i + 1] / den0);
            if (r1 < n)
                *reinterpret_cast<uint32_t*>(a.o + out_row(bi, r1, a.head, n, a.h, D) + c) =
                    pack_bf16(acc[4 * i + 2] / den1, acc[4 * i + 3] / den1);
        }
        if constexpr (LSE) {
            if (tq == 0) {
                const size_t row = ((size_t)bi * a.h + a.head) * n;
                if (r0 < n) a.lse[row + r0] = m0 * LN2 + logf(den0);
                if (r1 < n) a.lse[row + r1] = m1 * LN2 + logf(den1);
            }
        }
        return products;
    }
    return 0;
}

// A (D, n, heads, b) map of `box_rows`-row boxes over a bf16 tensor with
// element strides (sb, sh, sn) and a contiguous last axis.
inline int make_rows_map(CUtensorMap* map, const void* ptr, int d, int n, int heads, int b, long long sb, long long sh,
                         long long sn, int box_rows = WK) {
    const uint64_t dims[4] = {(uint64_t)d, (uint64_t)n, (uint64_t)heads, (uint64_t)b};
    const uint64_t strides[3] = {(uint64_t)sn * 2, (uint64_t)sh * 2, (uint64_t)sb * 2};
    return hp::make_map_bf16(map, ptr, 4, dims, strides, (uint32_t)box_rows);
}

}  // namespace fwdw
}  // namespace f5
