// The d = 64 attention core in five exact layouts, for Hopper (sm_90a): a
// layout ablation that measures how the cost of the attention kernel splits
// between its tensor-core products and everything around them.
//
// Replaces the TPU kernel scripts/ablate_attention.py:build(...).call
// (pallas_call at :177; bodies k_unpacked :60 and PAIR_KERNELS :145).
//
// What it computes, per head bh and query row t (q, k, v: (BH, n, 64) bf16;
// bias: (n,) fp32, added to every row's scores; scale = 64^-1/2):
//   o[t] = sum_j p_j v[j] / max(l, 1e-30),  p_j = exp(s_j - m),  l = sum_j p_j,
//   s_j  = q[t].k[j] * scale + bias[j],
// with p rounded to bf16 before the PV product and l the fp32 sum of the
// unrounded p; o is stored in bf16. The five layouts compute that same
// function and differ only in what they hand the tensor cores. Layouts 1-4
// take heads in pairs (a = 2i, b = 2i + 1), as the JAX bodies do:
//   0 unpacked             per head: s = q.k^T (K = 64), o = p.v (N = 64)
//   1 packed_blockdiag     s = [qa|qb].blockdiag(ka,kb)^T (K = 128) and
//                          o = [pa|pb].blockdiag(va,vb): 2x the MACs in both
//                          products, the zero quadrants really multiplied
//   2 packed_sep_o         s as in 1; o as the two dense products pa.va, pb.vb
//   3 sumdiff_blockdiag    ssum = [qa|qb].[ka|kb]^T, sdif = [qa|-qb].[ka|kb]^T
//                          (two dense K = 128 products), then in fp32
//                          sa = 0.5 (ssum + sdif) scale + bias,
//                          sb = 0.5 (ssum - sdif) scale + bias; o as in 1
//   4 sumdiff_dense_cross  s as in 3; o as ONE dense product of the stacked
//                          rows [pa; pb] by [va|vb] (N = 128), of which the
//                          diagonal blocks are kept and the off-diagonal
//                          blocks pa.vb, pb.va computed and thrown away
//
// What bounds it: the true work at the ablation's shape (BH = 256, n = 1024,
// d = 64) is 4 BH n^2 d = 68.7 GFLOP, about 69 us at the H100's 989 TFLOP/s
// bf16 peak, against 134 MB of q/k/v/o (about 40 us at 3.35 TB/s): compute-
// bound. Layouts 1, 3, 4 issue twice those products and layout 2 one and a
// half times; the bound of the function stays the same, so every layout is
// read against one yardstick.
//
// Design: the serving kernel's (csrc/flash_attention.cu) on mma.sync m16n8k16
// (bf16 in, fp32 accumulate). One block per (head, or head pair) x BQ query
// rows, BQ / 16 warps; each warp owns 16 query rows (of both heads in the pair
// layouts) and walks 64-key tiles of K and V staged in shared memory, the next
// tile's cp.async copies in flight while the current one is used. A whole
// score row of 1024 keys does not fit a warp's registers, so the softmax runs
// online: an fp32 running max and sum per row (per row and head in the pair
// layouts), scores in natural units in the JAX order (dot * scale + bias),
// p = exp(s - m) in fp32. That is the GPU's form of the same function, not the
// TPU's single pass over a VMEM row. The block-diagonal tiles (128 keys-of-a-
// pair x 128) are staged with their zero quadrants written into shared memory
// once per block, as the JAX body builds them once per grid step; the copies
// refill only the diagonal quadrants. -qb is qb's fragments with the sign bit
// flipped (exact in bf16). The discarded quadrants of layout 4 go into
// accumulators of their own that reach the output only multiplied by a zero
// the host passes, so the compiler cannot drop those products.
//
// Each warp counts the mma.sync it issues; with a non-null counter the block's
// warps add their counts to it, which is how the ablation shows what each
// layout hands the tensor cores. Shapes: d = 64, n % BQ == 0, BQ in {64, 128},
// an even BH for the pair layouts (the wrapper raises on anything else).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "attention.cuh"

using f5::cp_async16;
using f5::cp_async_commit;
using f5::cp_async_wait_all;
using f5::cp_async_wait_one;
using f5::ld32;
using f5::ldmatrix_x4_trans;
using f5::load_a;
using f5::mma16816;
using f5::pack_bf16;
using bf16 = __nv_bfloat16;

namespace {

enum Layout { UNPACKED = 0, PACKED_BLOCKDIAG = 1, PACKED_SEP_O = 2, SUMDIFF_BLOCKDIAG = 3, SUMDIFF_DENSE_CROSS = 4 };

constexpr int D = 64;    // head dim
constexpr int BK = 64;   // keys per tile
constexpr float LOG2E = 1.4426950408889634f;

template <int L>
struct Geo {
    static constexpr bool PAIR = L != UNPACKED;
    static constexpr int HEADS = PAIR ? 2 : 1;
    static constexpr bool SUMDIFF = L == SUMDIFF_BLOCKDIAG || L == SUMDIFF_DENSE_CROSS;
    static constexpr bool BLOCKDIAG_K = L == PACKED_BLOCKDIAG || L == PACKED_SEP_O;
    static constexpr bool BLOCKDIAG_V = L == PACKED_BLOCKDIAG || L == SUMDIFF_BLOCKDIAG;
    static constexpr int W = HEADS * D;                  // row width of the Q, K and V tiles
    static constexpr int KR = BLOCKDIAG_K ? 2 * BK : BK;  // K tile rows
    static constexpr int VR = BLOCKDIAG_V ? 2 * BK : BK;  // V tile rows
    static constexpr int LD = W + 8;  // padded by 16 bytes: fragment loads and ldmatrix rows hit distinct banks
    static constexpr int NB = HEADS * BK / 8;            // 8-column score blocks per warp and tile
};

template <int L, int BQ>
constexpr size_t smem_bytes() {  // Q tile, two K and two V tiles, two bias rows
    using G = Geo<L>;
    return (size_t)(BQ + 2 * G::KR + 2 * G::VR) * G::LD * sizeof(bf16) + 2 * BK * sizeof(float);
}

// (a * b) + c as two rounded operations, never fused: the JAX order
__device__ __forceinline__ float mul_add(float a, float b, float c) { return __fadd_rn(__fmul_rn(a, b), c); }

template <int L, int BQ>
__global__ void __launch_bounds__(BQ / 16 * 32)
ablate_attn(const float* __restrict__ bias, const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, bf16* __restrict__ o, int n, float scale, float discard,
            unsigned long long* __restrict__ mma_count) {
    using G = Geo<L>;
    constexpr int NT = BQ / 16 * 32;
    constexpr int LD = G::LD;
    extern __shared__ __align__(128) unsigned char smem_raw[];
    bf16* Qs = reinterpret_cast<bf16*>(smem_raw);      // BQ x W: [qa|qb]
    bf16* Ks = Qs + BQ * LD;                            // 2 buffers of KR x W
    bf16* Vs = Ks + 2 * G::KR * LD;                     // 2 buffers of VR x W
    float* bs = reinterpret_cast<float*>(Vs + 2 * G::VR * LD);  // 2 buffers of BK

    const int q0 = blockIdx.x * BQ;
    const int tid = threadIdx.x;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane >> 2;  // fragment row group
    const int tq = lane & 3;  // thread within the group: column pair
    const size_t hs = (size_t)n * D;  // elements of one head
    const size_t head0 = (size_t)blockIdx.y * G::HEADS * hs;

    // zero quadrants of the block-diagonal tiles, both buffers: the copies
    // below write only the diagonal quadrants, so these stay zero
    if constexpr (G::BLOCKDIAG_K || G::BLOCKDIAG_V) {
        for (int idx = tid; idx < 2 * 2 * BK * (D / 8); idx += NT) {
            const int buf = idx / (2 * BK * (D / 8)), r = idx % (2 * BK * (D / 8)) / (D / 8);
            const int c = (idx % (D / 8)) * 8 + (r < BK ? D : 0);  // right half of the top rows, left of the bottom
            if constexpr (G::BLOCKDIAG_K)
                *reinterpret_cast<uint4*>(Ks + (buf * G::KR + r) * LD + c) = make_uint4(0, 0, 0, 0);
            if constexpr (G::BLOCKDIAG_V)
                *reinterpret_cast<uint4*>(Vs + (buf * G::VR + r) * LD + c) = make_uint4(0, 0, 0, 0);
        }
    }

    // 64 rows of head hh from row `row0` into dst at (drow, dcol), 16 bytes per copy
    auto copy_tile = [&](bf16* dst, const bf16* src, int hh, int row0, int drow, int dcol) {
        for (int idx = tid; idx < BK * (D / 8); idx += NT) {
            const int r = idx / (D / 8), c = (idx % (D / 8)) * 8;
            cp_async16(dst + (drow + r) * LD + dcol + c, src + head0 + hh * hs + (size_t)(row0 + r) * D + c, true);
        }
    };
    auto stage = [&](int buf, int k0) {
#pragma unroll
        for (int hh = 0; hh < G::HEADS; ++hh) {
            copy_tile(Ks + buf * G::KR * LD, k, hh, k0, G::BLOCKDIAG_K ? hh * BK : 0, hh * D);
            copy_tile(Vs + buf * G::VR * LD, v, hh, k0, G::BLOCKDIAG_V ? hh * BK : 0, hh * D);
        }
        for (int idx = tid; idx < BK / 4; idx += NT) cp_async16(bs + buf * BK + idx * 4, bias + k0 + idx * 4, true);
    };

#pragma unroll
    for (int hh = 0; hh < G::HEADS; ++hh)
        for (int r0 = 0; r0 < BQ; r0 += BK) copy_tile(Qs, q, hh, q0 + r0, r0, hh * D);
    stage(0, 0);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    uint32_t qf[G::W / 16][4];  // this warp's 16 query rows of [qa|qb] as A fragments
#pragma unroll
    for (int kk = 0; kk < G::W / 16; ++kk) load_a(qf[kk], Qs, LD, warp * 16, kk * 16, lane);

    unsigned mmas = 0;  // mma.sync issued by this warp
    auto mma = [&](float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
        mma16816(d, a, b0, b1);
        ++mmas;
    };
    // acc[nb] (16 x 8 blocks) += a (16 x 16) . M[k0 .. k0+16][c0 + 8 nb ..] for nb < NBLK,
    // M row-major in shared memory; B through transposed ldmatrix, two blocks per load
    auto mma_rows = [&](float(*acc_)[4], const uint32_t* a, const bf16* m, int k0, int c0, auto nblk) {
#pragma unroll
        for (int nb = 0; nb < decltype(nblk)::value; nb += 2) {
            uint32_t f[4];
            ldmatrix_x4_trans(f, m + (k0 + (lane & 8) + (lane & 7)) * LD + c0 + (nb + (lane >> 4)) * 8);
            mma(acc_[nb], a, f[0], f[1]);
            mma(acc_[nb + 1], a, f[2], f[3]);
        }
    };

    // per head hh and row (g, g + 8): running max, per-thread partial sum
    float m[G::HEADS][2], l[G::HEADS][2];
#pragma unroll
    for (int hh = 0; hh < G::HEADS; ++hh) m[hh][0] = m[hh][1] = -INFINITY, l[hh][0] = l[hh][1] = 0.0f;
    float acc[G::HEADS * D / 8][4];  // o of head hh in blocks hh * 8 ..
#pragma unroll
    for (int nb = 0; nb < G::HEADS * D / 8; ++nb) acc[nb][0] = acc[nb][1] = acc[nb][2] = acc[nb][3] = 0.0f;
    float xo[4][4];  // layout 4: the off-diagonal blocks it computes and throws away
#pragma unroll
    for (int i = 0; i < 4; ++i) xo[i][0] = xo[i][1] = xo[i][2] = xo[i][3] = 0.0f;

    const int ntiles = n / BK;
    for (int it = 0; it < ntiles; ++it) {
        const int buf = it & 1;
        if (it + 1 < ntiles) stage(buf ^ 1, (it + 1) * BK);  // prefetch the next tile
        cp_async_commit();
        cp_async_wait_one();  // this tile's copies have landed
        __syncthreads();
        const bf16* kb = Ks + buf * G::KR * LD;
        const bf16* vb = Vs + buf * G::VR * LD;
        const float* bb = bs + buf * BK;

        // scores of rows (g, g+8) x key columns (nb * 8 + tq * 2 + {0, 1}); block
        // hh * 8 + j holds head hh's keys j * 8 .. (sumdiff: ssum in 0..7, sdif in 8..15)
        float s[G::NB][4];
#pragma unroll
        for (int nb = 0; nb < G::NB; ++nb) s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.0f;
        if constexpr (!G::SUMDIFF) {
            // unpacked: q.k^T (K = 64); packed: [qa|qb].blockdiag(ka,kb)^T over all 128 rows (K = 128)
#pragma unroll
            for (int nb = 0; nb < G::NB; ++nb) {
#pragma unroll
                for (int kk = 0; kk < G::W / 16; ++kk) {
                    const bf16* p = kb + (nb * 8 + g) * LD + kk * 16 + tq * 2;
                    mma(s[nb], qf[kk], ld32(p), ld32(p + 8));
                }
            }
        } else {
            // [qa|qb].[ka|kb]^T and [qa|-qb].[ka|kb]^T, one B fragment for both
#pragma unroll
            for (int kk = 0; kk < G::W / 16; ++kk) {
                uint32_t qd[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) qd[i] = kk < D / 16 ? qf[kk][i] : qf[kk][i] ^ 0x80008000u;
#pragma unroll
                for (int nb = 0; nb < BK / 8; ++nb) {
                    const bf16* p = kb + (nb * 8 + g) * LD + kk * 16 + tq * 2;
                    const uint32_t b0 = ld32(p), b1 = ld32(p + 8);
                    mma(s[nb], qf[kk], b0, b1);
                    mma(s[BK / 8 + nb], qd, b0, b1);
                }
            }
        }

        // to scores in natural units, in fp32 and the JAX order
#pragma unroll
        for (int nb = 0; nb < BK / 8; ++nb) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const float bc = bb[nb * 8 + tq * 2 + e];
#pragma unroll
                for (int r = e; r < 4; r += 2) {
                    if constexpr (G::SUMDIFF) {
                        const float ssum = s[nb][r], sdif = s[BK / 8 + nb][r];
                        s[nb][r] = mul_add(__fmul_rn(0.5f, __fadd_rn(ssum, sdif)), scale, bc);
                        s[BK / 8 + nb][r] = mul_add(__fmul_rn(0.5f, __fsub_rn(ssum, sdif)), scale, bc);
                    } else {
#pragma unroll
                        for (int hh = 0; hh < G::HEADS; ++hh) s[hh * 8 + nb][r] = mul_add(s[hh * 8 + nb][r], scale, bc);
                    }
                }
            }
        }

        // online softmax per head: p = exp(s - m) in fp32, the output rescaled by exp(m_old - m)
#pragma unroll
        for (int hh = 0; hh < G::HEADS; ++hh) {
            float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
            for (int nb = hh * 8; nb < hh * 8 + 8; ++nb) {
                mx0 = fmaxf(mx0, fmaxf(s[nb][0], s[nb][1]));
                mx1 = fmaxf(mx1, fmaxf(s[nb][2], s[nb][3]));
            }
            mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
            mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
            mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
            mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
            const float mn0 = fmaxf(m[hh][0], mx0), mn1 = fmaxf(m[hh][1], mx1);
            const float alpha0 = exp2f((m[hh][0] - mn0) * LOG2E), alpha1 = exp2f((m[hh][1] - mn1) * LOG2E);
            float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
            for (int nb = hh * 8; nb < hh * 8 + 8; ++nb) {
                s[nb][0] = exp2f((s[nb][0] - mn0) * LOG2E);
                s[nb][1] = exp2f((s[nb][1] - mn0) * LOG2E);
                s[nb][2] = exp2f((s[nb][2] - mn1) * LOG2E);
                s[nb][3] = exp2f((s[nb][3] - mn1) * LOG2E);
                sum0 += s[nb][0] + s[nb][1];
                sum1 += s[nb][2] + s[nb][3];
            }
            l[hh][0] = l[hh][0] * alpha0 + sum0;
            l[hh][1] = l[hh][1] * alpha1 + sum1;
            m[hh][0] = mn0;
            m[hh][1] = mn1;
#pragma unroll
            for (int nb = hh * 8; nb < hh * 8 + 8; ++nb) {
                acc[nb][0] *= alpha0;
                acc[nb][1] *= alpha0;
                acc[nb][2] *= alpha1;
                acc[nb][3] *= alpha1;
            }
        }

        // PV: two adjacent score blocks, rounded to bf16, are one k-step of the A operand
        auto a_frag = [&](uint32_t* a, int nb) {
            a[0] = pack_bf16(s[nb][0], s[nb][1]);
            a[1] = pack_bf16(s[nb][2], s[nb][3]);
            a[2] = pack_bf16(s[nb + 1][0], s[nb + 1][1]);
            a[3] = pack_bf16(s[nb + 1][2], s[nb + 1][3]);
        };
        if constexpr (L == UNPACKED) {
#pragma unroll
            for (int kk = 0; kk < BK / 16; ++kk) {
                uint32_t a[4];
                a_frag(a, 2 * kk);
                mma_rows(acc, a, vb, kk * 16, 0, std::integral_constant<int, D / 8>{});
            }
        } else if constexpr (G::BLOCKDIAG_V) {
            // [pa|pb] (K = 128 keys-of-the-pair) . blockdiag(va, vb) (128 x 128)
#pragma unroll
            for (int kk = 0; kk < 2 * BK / 16; ++kk) {
                uint32_t a[4];
                a_frag(a, 2 * kk);
                mma_rows(acc, a, vb, kk * 16, 0, std::integral_constant<int, 2 * D / 8>{});
            }
        } else if constexpr (L == PACKED_SEP_O) {
            // pa . va and pb . vb, with V staged as [va|vb]
#pragma unroll
            for (int kk = 0; kk < BK / 16; ++kk) {
                uint32_t aa[4], ab[4];
                a_frag(aa, 2 * kk);
                a_frag(ab, BK / 8 + 2 * kk);
                mma_rows(acc, aa, vb, kk * 16, 0, std::integral_constant<int, D / 8>{});
                mma_rows(acc + D / 8, ab, vb, kk * 16, D, std::integral_constant<int, D / 8>{});
            }
        } else {
            // [pa; pb] (32 rows) . [va|vb] (N = 128): keep pa.va and pb.vb
#pragma unroll
            for (int kk = 0; kk < BK / 16; ++kk) {
                uint32_t aa[4], ab[4];
                a_frag(aa, 2 * kk);
                a_frag(ab, BK / 8 + 2 * kk);
#pragma unroll
                for (int nb = 0; nb < 2 * D / 8; nb += 2) {
                    uint32_t f[4];
                    ldmatrix_x4_trans(f, vb + (kk * 16 + (lane & 8) + (lane & 7)) * LD + (nb + (lane >> 4)) * 8);
                    if (nb < D / 8) {  // va's columns: pa.va kept, pb.va thrown away
                        mma(acc[nb], aa, f[0], f[1]);
                        mma(acc[nb + 1], aa, f[2], f[3]);
                        mma(xo[nb & 3], ab, f[0], f[1]);
                        mma(xo[(nb + 1) & 3], ab, f[2], f[3]);
                    } else {  // vb's columns: pa.vb thrown away, pb.vb kept
                        mma(xo[nb & 3], aa, f[0], f[1]);
                        mma(xo[(nb + 1) & 3], aa, f[2], f[3]);
                        mma(acc[nb], ab, f[0], f[1]);
                        mma(acc[nb + 1], ab, f[2], f[3]);
                    }
                }
            }
        }
        __syncthreads();  // every warp is done with this buffer before it is refilled
    }

    float junk = 0.0f;  // layout 4's discarded blocks, times the host's zero
#pragma unroll
    for (int i = 0; i < 4; ++i) junk += xo[i][0] + xo[i][1] + xo[i][2] + xo[i][3];
    junk *= discard;
    auto out = [&](float x, float den) { return L == SUMDIFF_DENSE_CROSS ? x / den + junk : x / den; };
    const int t0 = q0 + warp * 16 + g, t1 = t0 + 8;
#pragma unroll
    for (int hh = 0; hh < G::HEADS; ++hh) {
        // the row sums are spread over the 4 threads of each row group
        float l0 = l[hh][0], l1 = l[hh][1];
        l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
        l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
        l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
        l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
        const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
        bf16* oh = o + head0 + hh * hs;
#pragma unroll
        for (int nb = 0; nb < D / 8; ++nb) {
            const float* a = acc[hh * 8 + nb];
            const int c = nb * 8 + tq * 2;
            *reinterpret_cast<uint32_t*>(oh + (size_t)t0 * D + c) = pack_bf16(out(a[0], den0), out(a[1], den0));
            *reinterpret_cast<uint32_t*>(oh + (size_t)t1 * D + c) = pack_bf16(out(a[2], den1), out(a[3], den1));
        }
    }
    if (mma_count != nullptr && lane == 0) atomicAdd(mma_count, (unsigned long long)mmas);
}

// f(integral_constant<L>, integral_constant<BQ>) for a runtime (layout, bq)
template <typename F>
int dispatch(int layout, int bq, F f) {
    auto with_bq = [&](auto lay) {
        if (bq == 64) return f(lay, std::integral_constant<int, 64>{});
        if (bq == 128) return f(lay, std::integral_constant<int, 128>{});
        return (int)cudaErrorInvalidValue;
    };
    switch (layout) {
        case UNPACKED: return with_bq(std::integral_constant<int, UNPACKED>{});
        case PACKED_BLOCKDIAG: return with_bq(std::integral_constant<int, PACKED_BLOCKDIAG>{});
        case PACKED_SEP_O: return with_bq(std::integral_constant<int, PACKED_SEP_O>{});
        case SUMDIFF_BLOCKDIAG: return with_bq(std::integral_constant<int, SUMDIFF_BLOCKDIAG>{});
        case SUMDIFF_DENSE_CROSS: return with_bq(std::integral_constant<int, SUMDIFF_DENSE_CROSS>{});
        default: return (int)cudaErrorInvalidValue;
    }
}

// the dynamic shared memory of a launch: the layout's own, or min_smem where
// that is more (fewer blocks then share an SM; nothing else changes)
template <int L, int BQ>
int configure(int min_smem, size_t* smem) {
    *smem = smem_bytes<L, BQ>() > (size_t)min_smem ? smem_bytes<L, BQ>() : (size_t)min_smem;
    return (int)cudaFuncSetAttribute(ablate_attn<L, BQ>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
}

}  // namespace

extern "C" {

// bias: (n,) fp32; q, k, v, o: (bh, n, 64) contiguous bf16; layout 0-4 in the
// order above; bq 64 or 128 with n % bq == 0; bh even for layouts 1-4;
// min_smem: bytes of dynamic shared memory to reserve at least (0: the
// layout's own); mma_count: one unsigned 64-bit integer the warps add their
// mma.sync counts to, or null. Returns the cudaError_t of the launch.
int f5_ablate_attention(const void* bias, const void* q, const void* k, const void* v, void* o, int layout, int bh,
                        int n, int bq, float scale, int min_smem, void* mma_count, void* stream) {
    return dispatch(layout, bq, [&](auto lay, auto bqc) {
        constexpr int L = decltype(lay)::value, BQ = decltype(bqc)::value;
        size_t smem;
        const int err = configure<L, BQ>(min_smem, &smem);
        if (err != 0) return err;
        const dim3 grid(n / BQ, bh / Geo<L>::HEADS);
        ablate_attn<L, BQ><<<grid, BQ / 16 * 32, smem, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float*>(bias), static_cast<const bf16*>(q), static_cast<const bf16*>(k),
            static_cast<const bf16*>(v), static_cast<bf16*>(o), n, scale, 0.0f,
            static_cast<unsigned long long*>(mma_count));
        return (int)cudaGetLastError();
    });
}

// The layout's own dynamic shared memory in bytes (negative: a cudaError_t).
long long f5_ablate_attention_smem(int layout, int bq) {
    long long out = -(long long)cudaErrorInvalidValue;
    dispatch(layout, bq, [&](auto lay, auto bqc) {
        out = (long long)smem_bytes<decltype(lay)::value, decltype(bqc)::value>();
        return 0;
    });
    return out;
}

// Blocks of (layout, bq) that fit one SM at once with min_smem as above
// (negative: a cudaError_t).
int f5_ablate_attention_blocks_per_sm(int layout, int bq, int min_smem) {
    int blocks = 0;
    const int err = dispatch(layout, bq, [&](auto lay, auto bqc) {
        constexpr int L = decltype(lay)::value, BQ = decltype(bqc)::value;
        size_t smem;
        const int e = configure<L, BQ>(min_smem, &smem);
        if (e != 0) return e;
        return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, ablate_attn<L, BQ>, BQ / 16 * 32, smem);
    });
    return err != 0 ? -err : blocks;
}

const char* f5_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
