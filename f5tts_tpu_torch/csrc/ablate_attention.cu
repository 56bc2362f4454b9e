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
// Design: every layout on the wgmma machinery the port ships (hopper.cuh,
// flash_wgmma.cuh). A block is 1 + NWG warpgroups (NWG = BQ / 64: 1 or 2): a
// producer warp keeps K/V tiles in an mbarrier ring through TMA (128-byte
// swizzle) and writes each tile's bias row beside it in log2 units; each
// consumer warpgroup owns 64 query rows, runs S on wgmma with K from a
// shared-memory descriptor, the online softmax on the accumulators (scores
// in log2 units: s * (scale log2 e) + bias log2 e as one FMA, p = 2^(s - m)),
// and O += P V with P repacked into registers and V MN-major; with two
// warpgroups they take turns issuing.
// - `unpacked` IS the serving block (flash_wgmma.cuh: 128-key tiles, 3
//   stages, S_j issued with P_{j-1} V_{j-1}) with its third bias source, the
//   fp32 row shared by every head; at BQ 64 one consumer warpgroup, two blocks
//   to an SM.
// - the pair layouts share one body (ablate_pair): 64-key tiles of the pair
//   (2 stages), Q = [qa|qb] a TMA-loaded shared-memory operand (for the
//   sum/difference layouts also [qa|-qb]: qb's panel copied with the sign bits
//   flipped, exact in bf16); per tile S, its softmax, then PV, each warpgroup
//   draining its products before the next tile (a pipelined S_j beside
//   P_{j-1} V_{j-1} does not fit layout 4's registers: its O is 128 columns
//   twice). S is m64n128k16 against the staged block-diagonal K tile (zero
//   quadrants written into shared memory once per block and really
//   multiplied) or two m64n64k16 against [ka|kb]; PV is m64n128k16 against
//   block-diagonal V, two m64n64k16 (pa.va, pb.vb), or layout 4's two
//   m64n128k16 [pa; pb].[va|vb], whose off-diagonal halves go into
//   accumulators that reach the output only multiplied by a zero the host
//   passes, so the compiler cannot drop those products.
//
// Each warpgroup counts the tensor-core products it issues in m16n8k16
// equivalents (a wgmma m64nNk16 is 4 N / 8 of them); with a non-null counter
// one thread of each adds its count, which is how the ablation shows what
// each layout hands the tensor cores. Shapes: d = 64, n a multiple of BQ and
// of 128, BQ in {64, 128}, an even BH for the pair layouts (the wrapper raises
// on anything else).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "attention.cuh"
#include "flash_wgmma.cuh"
#include "hopper.cuh"

using f5::ex2;
using f5::pack_bf16;
using bf16 = __nv_bfloat16;

namespace {

namespace hp = f5::hopper;
namespace fw = f5::fwdw;

enum Layout { UNPACKED = 0, PACKED_BLOCKDIAG = 1, PACKED_SEP_O = 2, SUMDIFF_BLOCKDIAG = 3, SUMDIFF_DENSE_CROSS = 4 };

constexpr int D = 64;     // head dim
constexpr int BK = 64;    // keys per tile of the pair layouts
constexpr int PSTAGES = 2;
constexpr int BOX = BK * 128;  // one TMA box and one swizzled panel of 64 rows x 64 bf16: 8 KB
constexpr float LOG2E = fw::LOG2E;

__host__ __device__ constexpr unsigned products(int n_cols) { return 4 * n_cols / 8; }  // of a wgmma m64nNk16

// ---------------------------------------------------------------------------
// unpacked: the serving block with the row bias
// ---------------------------------------------------------------------------

template <int NWG>
using UCfg = fw::Cfg<D, false, NWG>;

template <int NWG>
__global__ void __launch_bounds__(UCfg<NWG>::THREADS, NWG == 1 ? 2 : 1)
ablate_unpacked(const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
                const float* __restrict__ bias, const bf16* __restrict__ q, bf16* __restrict__ o, int n, float scale,
                unsigned long long* __restrict__ count) {
    extern __shared__ unsigned char smem_raw[];
    const int bh = blockIdx.y;
    fw::Args a;
    a.kmap = &kmap;
    a.vmap = &vmap;
    a.qmap = nullptr;
    a.kh = 0;
    a.vh = 0;
    a.qrows = q + (size_t)bh * n * D;
    a.qsn = D;
    a.o = o;
    a.lse = nullptr;
    a.key_mask = nullptr;
    a.bias_row = bias;
    a.bi = bh;
    a.head = 0;
    a.h = 1;
    a.n = n;
    a.scale = scale;
    const unsigned issued = fw::block<D, fw::ROW, false, false, NWG, true>(smem_raw, a);
    if (count != nullptr && threadIdx.x >= 128 && threadIdx.x % 128 == 0) atomicAdd(count, (unsigned long long)issued);
}

// ---------------------------------------------------------------------------
// the pair layouts
// ---------------------------------------------------------------------------

template <int L>
struct Pair {
    static constexpr bool SUMDIFF = L == SUMDIFF_BLOCKDIAG || L == SUMDIFF_DENSE_CROSS;
    static constexpr bool BD_K = L == PACKED_BLOCKDIAG || L == PACKED_SEP_O;  // block-diagonal K tile
    static constexpr bool BD_V = L == PACKED_BLOCKDIAG || L == SUMDIFF_BLOCKDIAG;
    // a K (V) tile is two 64-column panels: [ka|kb] of 64 rows, or blockdiag(ka, kb) of 128 rows
    static constexpr int KPANEL = (BD_K ? 2 : 1) * BOX;
    static constexpr int VPANEL = (BD_V ? 2 : 1) * BOX;
    static constexpr int KT = 2 * KPANEL, VT = 2 * VPANEL;
    static constexpr int STAGE = KT + VT;
    static constexpr int QWG = (SUMDIFF ? 3 : 2) * BOX;  // a warpgroup's Q panels: qa, qb (, -qb)
    static constexpr int ACC = L == SUMDIFF_DENSE_CROSS ? 128 : 64;  // O accumulators a thread
    static constexpr int HB = L == SUMDIFF_DENSE_CROSS ? 96 : 32;    // where head b's 32 start in them
};

template <int L, int NWG>
struct PairCfg {
    static constexpr int BQ = 64 * NWG;
    static constexpr int THREADS = 128 * (NWG + 1);
    static constexpr int CREGS = NWG == 1 ? 232 : 240;
    static constexpr size_t SMEM =
        1024 + (size_t)PSTAGES * Pair<L>::STAGE + (size_t)NWG * Pair<L>::QWG + PSTAGES * BK * 4 + (2 * PSTAGES + 1) * 8;
};

// q, k, v through (64, n, BH) maps of 64-row boxes; o (BH, n, 64); bias (n,).
// grid (n / BQ, BH / 2), PairCfg::THREADS threads, PairCfg::SMEM bytes.
template <int L, int NWG>
__global__ void __launch_bounds__(PairCfg<L, NWG>::THREADS, NWG == 1 ? 2 : 1)
ablate_pair(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
            const __grid_constant__ CUtensorMap vmap, const float* __restrict__ bias_row, bf16* __restrict__ o, int n,
            float scale, float discard, unsigned long long* __restrict__ count) {
    using P = Pair<L>;
    using C = PairCfg<L, NWG>;
    extern __shared__ unsigned char smem_raw[];
    unsigned char* base = reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
    unsigned char* qs = base + PSTAGES * P::STAGE;
    float* bias = reinterpret_cast<float*>(qs + NWG * P::QWG);  // PSTAGES x BK, log2 units
    uint64_t* full = reinterpret_cast<uint64_t*>(bias + PSTAGES * BK);
    uint64_t* empty = full + PSTAGES;
    uint64_t* qbar = empty + PSTAGES;

    const int ha = 2 * blockIdx.y, hb = ha + 1;
    const int q0 = blockIdx.x * C::BQ;
    const int ntiles = n / BK;
    const int tid = threadIdx.x;

    // the zero quadrants of the block-diagonal tiles, every stage, once: the
    // copies below fill only the diagonal ones (K: rows 64.. of panel 0 and
    // rows ..63 of panel 1 are zero; V alike)
    if constexpr (P::BD_K || P::BD_V) {
        for (int i = tid; i < PSTAGES * 2 * (BOX / 16); i += C::THREADS) {
            const int st = i / (2 * (BOX / 16)), which = i / (BOX / 16) % 2, c = i % (BOX / 16);
            unsigned char* stage = base + st * P::STAGE;
            if constexpr (P::BD_K)
                reinterpret_cast<uint4*>(stage + (which ? P::KPANEL : BOX))[c] = make_uint4(0, 0, 0, 0);
            if constexpr (P::BD_V)
                reinterpret_cast<uint4*>(stage + P::KT + (which ? P::VPANEL : BOX))[c] = make_uint4(0, 0, 0, 0);
        }
        hp::fence_proxy_async();  // the wgmma reads them through the async proxy
    }
    if (tid == 0) {
        for (int i = 0; i < PSTAGES; ++i) {
            hp::mbar_init(&full[i], 32);     // the producer warp (bias rows written)
            hp::mbar_init(&empty[i], 4 * NWG);  // one arrival per consumer warp
        }
        hp::mbar_init(qbar, 1);
        hp::mbar_init_fence();
    }
    __syncthreads();

    if (tid < 128) {  // producer warpgroup; its first warp keeps the ring full
        hp::setmaxnreg_dec<24>();
        if (tid < 32) {
            if (tid == 0) {
                hp::mbar_arrive_expect_tx(qbar, NWG * 2 * BOX);
                for (int wg = 0; wg < NWG; ++wg) {
                    hp::tma_load_3d(qs + wg * P::QWG, &qmap, qbar, 0, q0 + 64 * wg, ha);
                    hp::tma_load_3d(qs + wg * P::QWG + BOX, &qmap, qbar, 0, q0 + 64 * wg, hb);
                }
            }
            for (int j = 0; j < ntiles; ++j) {
                const int stage = j % PSTAGES;
                hp::mbar_wait(&empty[stage], ((j / PSTAGES) & 1) ^ 1);
#pragma unroll
                for (int e = 0; e < BK / 32; ++e) {
                    const int col = tid * (BK / 32) + e;
                    bias[stage * BK + col] = bias_row[j * BK + col] * LOG2E;
                }
                if (tid == 0) {
                    unsigned char* kt = base + stage * P::STAGE;
                    unsigned char* vt = kt + P::KT;
                    hp::mbar_arrive_expect_tx(&full[stage], 4 * BOX);
                    // ka, kb into panels 0, 1 (rows 0.. and, block-diagonal, rows 64..)
                    hp::tma_load_3d(kt, &kmap, &full[stage], 0, j * BK, ha);
                    hp::tma_load_3d(kt + P::KPANEL + (P::BD_K ? BOX : 0), &kmap, &full[stage], 0, j * BK, hb);
                    hp::tma_load_3d(vt, &vmap, &full[stage], 0, j * BK, ha);
                    hp::tma_load_3d(vt + P::VPANEL + (P::BD_V ? BOX : 0), &vmap, &full[stage], 0, j * BK, hb);
                } else {
                    hp::mbar_arrive(&full[stage]);
                }
            }
        }
        return;
    }

    // consumer warpgroups: 64 query rows (of both heads) each
    hp::setmaxnreg_inc<C::CREGS>();
    const int ctid = tid - 128;
    const int wg = ctid / 128;
    const int warp = (ctid / 32) % 4;
    const int lane = ctid % 32;
    const int g = lane >> 2, tq = lane & 3;
    const unsigned char* qt = qs + wg * P::QWG;  // panels qa, qb (, -qb)

    hp::mbar_wait(qbar, 0);
    if constexpr (P::SUMDIFF) {  // -qb: qb with its sign bits flipped, in the same swizzled places
        const uint4* src = reinterpret_cast<const uint4*>(qt + BOX);
        uint4* dst = reinterpret_cast<uint4*>(qs + wg * P::QWG + 2 * BOX);
        for (int i = ctid % 128; i < BOX / 16; i += 128) {
            uint4 x = src[i];
            x.x ^= 0x80008000u;
            x.y ^= 0x80008000u;
            x.z ^= 0x80008000u;
            x.w ^= 0x80008000u;
            dst[i] = x;
        }
        hp::fence_proxy_async();
        hp::named_sync(3 + wg, 128);
    }

    const float sc = (P::SUMDIFF ? 0.5f : 1.0f) * scale * LOG2E;
    float m[2][2], l[2][2];  // per head, rows (g, g + 8): running max (log2 units), this thread's partial sum
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) m[hh][0] = m[hh][1] = fw::NEG_BIG * LOG2E, l[hh][0] = l[hh][1] = 0.0f;
    float acc[P::ACC];
#pragma unroll
    for (int e = 0; e < P::ACC; ++e) acc[e] = 0.0f;
    float s[2][32];  // per head: rows (g, g+8) x 64 keys, columns 8i + 2tq + {0,1} (sumdiff: ssum, sdif first)
    uint32_t p[2 * BK / 16][4];  // P as A fragments: k-steps 0..3 head a, 4..7 head b
    unsigned issued = 0;
    const int my_bar = 1 + wg, next_bar = 1 + (wg + 1) % NWG;
    if constexpr (NWG > 1)
        if (wg == NWG - 1) hp::named_arrive(1, 256);

    auto desc_q = [&](int kk, bool negated) {  // A: K-step kk of [qa|qb] or [qa|-qb]
        const int panel = kk < 4 ? 0 : (negated ? 2 : 1);
        return hp::desc_b128(qt + panel * BOX + (kk % 4) * 32, 16, 1024);
    };
    auto issue_s = [&](const unsigned char* kt) {
#pragma unroll
        for (int kk = 0; kk < 2 * D / 16; ++kk) {
            const uint64_t kd = hp::desc_b128(kt + (kk / 4) * P::KPANEL + (kk % 4) * 32, 16, 1024);
            if constexpr (!P::SUMDIFF) {  // [qa|qb].blockdiag(ka,kb)^T: 128 keys of the pair
                hp::wgmma_m64n128k16_ss<0>(&s[0][0], desc_q(kk, false), kd, kk > 0);
                issued += products(128);
            } else {  // [qa|qb].[ka|kb]^T and [qa|-qb].[ka|kb]^T
                hp::wgmma_m64n64k16_ss<0>(s[0], desc_q(kk, false), kd, kk > 0);
                hp::wgmma_m64n64k16_ss<0>(s[1], desc_q(kk, true), kd, kk > 0);
                issued += 2 * products(64);
            }
        }
    };
    auto issue_pv = [&](const unsigned char* vt) {
        if constexpr (P::BD_V) {  // [pa|pb] (K = 128 keys of the pair) . blockdiag(va, vb)
#pragma unroll
            for (int kk = 0; kk < 2 * BK / 16; ++kk) {
                hp::wgmma_m64n128k16_rs<1>(acc, p[kk], hp::desc_b128(vt + kk * 2048, P::VPANEL, 1024), 1);
                issued += products(128);
            }
        } else if constexpr (L == PACKED_SEP_O) {  // pa.va and pb.vb
#pragma unroll
            for (int kk = 0; kk < BK / 16; ++kk) {
                hp::wgmma_m64n64k16_rs<1>(acc, p[kk], hp::desc_b128(vt + kk * 2048, P::VPANEL, 1024), 1);
                hp::wgmma_m64n64k16_rs<1>(acc + 32, p[4 + kk], hp::desc_b128(vt + P::VPANEL + kk * 2048, P::VPANEL, 1024),
                                          1);
                issued += 2 * products(64);
            }
        } else {  // [pa; pb] . [va|vb]: pa's rows and pb's rows, 128 columns each
#pragma unroll
            for (int kk = 0; kk < BK / 16; ++kk) {
                const uint64_t vd = hp::desc_b128(vt + kk * 2048, P::VPANEL, 1024);
                hp::wgmma_m64n128k16_rs<1>(acc, p[kk], vd, 1);
                hp::wgmma_m64n128k16_rs<1>(acc + 64, p[4 + kk], vd, 1);
                issued += 2 * products(128);
            }
        }
    };

    for (int j = 0; j < ntiles; ++j) {
        const int stage = j % PSTAGES;
        unsigned char* kt = base + stage * P::STAGE;
        hp::mbar_wait(&full[stage], (j / PSTAGES) & 1);
        if constexpr (NWG > 1) hp::named_sync(my_bar, 256);
        hp::fence_regs(s[0]);
        hp::fence_regs(s[1]);
        hp::wgmma_fence();
        issue_s(kt);
        hp::wgmma_commit();
        if constexpr (NWG > 1) hp::named_arrive(next_bar, 256);
        hp::wgmma_wait<0>();
        hp::fence_regs(s[0]);
        hp::fence_regs(s[1]);

        // scores in log2 units; sum/difference back to the two heads first
        const float* bb = bias + stage * BK;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float bc = bb[8 * i + 2 * tq + (e & 1)];
                float xa = s[0][4 * i + e], xb = s[1][4 * i + e];
                if constexpr (P::SUMDIFF) {
                    const float sum = xa + xb, dif = xa - xb;
                    xa = sum;
                    xb = dif;
                }
                s[0][4 * i + e] = fmaf(xa, sc, bc);
                s[1][4 * i + e] = fmaf(xb, sc, bc);
            }
        }
        // online softmax per head; the head's O columns rescaled; P packed as A fragments
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
            float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                mx0 = fmaxf(mx0, fmaxf(s[hh][4 * i], s[hh][4 * i + 1]));
                mx1 = fmaxf(mx1, fmaxf(s[hh][4 * i + 2], s[hh][4 * i + 3]));
            }
            mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
            mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
            mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
            mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
            const float mn0 = fmaxf(m[hh][0], mx0), mn1 = fmaxf(m[hh][1], mx1);
            const float alpha0 = ex2(m[hh][0] - mn0), alpha1 = ex2(m[hh][1] - mn1);
            float sum0[2] = {0.0f, 0.0f}, sum1[2] = {0.0f, 0.0f};
#pragma unroll
            for (int i = 0; i < 8; ++i) {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    s[hh][4 * i + e] = ex2(s[hh][4 * i + e] - mn0);
                    s[hh][4 * i + 2 + e] = ex2(s[hh][4 * i + 2 + e] - mn1);
                    sum0[i & 1] += s[hh][4 * i + e];
                    sum1[i & 1] += s[hh][4 * i + 2 + e];
                }
            }
            l[hh][0] = l[hh][0] * alpha0 + (sum0[0] + sum0[1]);
            l[hh][1] = l[hh][1] * alpha1 + (sum1[0] + sum1[1]);
            m[hh][0] = mn0;
            m[hh][1] = mn1;
            float* oh = acc + (hh ? P::HB : 0);
#pragma unroll
            for (int i = 0; i < D / 8; ++i) {
                oh[4 * i] *= alpha0;
                oh[4 * i + 1] *= alpha0;
                oh[4 * i + 2] *= alpha1;
                oh[4 * i + 3] *= alpha1;
            }
#pragma unroll
            for (int kk = 0; kk < BK / 16; ++kk) {
                p[4 * hh + kk][0] = pack_bf16(s[hh][8 * kk], s[hh][8 * kk + 1]);
                p[4 * hh + kk][1] = pack_bf16(s[hh][8 * kk + 2], s[hh][8 * kk + 3]);
                p[4 * hh + kk][2] = pack_bf16(s[hh][8 * kk + 4], s[hh][8 * kk + 5]);
                p[4 * hh + kk][3] = pack_bf16(s[hh][8 * kk + 6], s[hh][8 * kk + 7]);
            }
        }

        if constexpr (NWG > 1) hp::named_sync(my_bar, 256);
        hp::fence_regs(acc);
        hp::fence_regs(p);
        hp::wgmma_fence();
        issue_pv(kt + P::KT);
        hp::wgmma_commit();
        if constexpr (NWG > 1)
            if (j + 1 < ntiles || wg != NWG - 1) hp::named_arrive(next_bar, 256);
        hp::wgmma_wait<0>();
        hp::fence_regs(acc);
        hp::fence_regs(p);
        __syncwarp();
        if (lane == 0) hp::mbar_arrive(&empty[stage]);
    }

    float junk = 0.0f;  // layout 4's off-diagonal halves, times the host's zero
    if constexpr (L == SUMDIFF_DENSE_CROSS) {
#pragma unroll
        for (int e = 32; e < 96; ++e) junk += acc[e];
        junk *= discard;
    }
    const int r0 = q0 + wg * 64 + warp * 16 + g, r1 = r0 + 8;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
        float l0 = l[hh][0], l1 = l[hh][1];
        l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
        l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
        l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
        l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
        const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
        const float* oh = acc + (hh ? P::HB : 0);
        bf16* out = o + (size_t)(ha + hh) * n * D;
#pragma unroll
        for (int i = 0; i < D / 8; ++i) {
            const int c = 8 * i + 2 * tq;
            *reinterpret_cast<uint32_t*>(out + (size_t)r0 * D + c) =
                pack_bf16(oh[4 * i] / den0 + junk, oh[4 * i + 1] / den0 + junk);
            *reinterpret_cast<uint32_t*>(out + (size_t)r1 * D + c) =
                pack_bf16(oh[4 * i + 2] / den1 + junk, oh[4 * i + 3] / den1 + junk);
        }
    }
    if (count != nullptr && ctid % 128 == 0) atomicAdd(count, (unsigned long long)issued);
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------

// f(integral_constant<L>, integral_constant<NWG>) for a runtime (layout, bq)
template <typename F>
int dispatch(int layout, int bq, F f) {
    auto with_nwg = [&](auto lay) {
        if (bq == 64) return f(lay, std::integral_constant<int, 1>{});
        if (bq == 128) return f(lay, std::integral_constant<int, 2>{});
        return (int)cudaErrorInvalidValue;
    };
    switch (layout) {
        case UNPACKED: return with_nwg(std::integral_constant<int, UNPACKED>{});
        case PACKED_BLOCKDIAG: return with_nwg(std::integral_constant<int, PACKED_BLOCKDIAG>{});
        case PACKED_SEP_O: return with_nwg(std::integral_constant<int, PACKED_SEP_O>{});
        case SUMDIFF_BLOCKDIAG: return with_nwg(std::integral_constant<int, SUMDIFF_BLOCKDIAG>{});
        case SUMDIFF_DENSE_CROSS: return with_nwg(std::integral_constant<int, SUMDIFF_DENSE_CROSS>{});
        default: return (int)cudaErrorInvalidValue;
    }
}

template <int L, int NWG>
struct Kernel {
    static constexpr size_t SMEM = L == UNPACKED ? UCfg<NWG>::SMEM : PairCfg<L, NWG>::SMEM;
    static constexpr int THREADS = 128 * (NWG + 1);
    static const void* fn() {
        if constexpr (L == UNPACKED)
            return reinterpret_cast<const void*>(ablate_unpacked<NWG>);
        else
            return reinterpret_cast<const void*>(ablate_pair<L, NWG>);
    }
};

// the dynamic shared memory of a launch: the layout's own, or min_smem where
// that is more (fewer blocks then share an SM; nothing else changes)
template <int L, int NWG>
int configure(int min_smem, size_t* smem) {
    *smem = Kernel<L, NWG>::SMEM > (size_t)min_smem ? Kernel<L, NWG>::SMEM : (size_t)min_smem;
    return (int)cudaFuncSetAttribute(Kernel<L, NWG>::fn(), cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
}

// A (64, n, bh) map of 64-row boxes over a contiguous (bh, n, 64) bf16 tensor.
int rows_map64(CUtensorMap* map, const void* ptr, int n, int bh) {
    const uint64_t dims[3] = {(uint64_t)D, (uint64_t)n, (uint64_t)bh};
    const uint64_t strides[2] = {(uint64_t)D * 2, (uint64_t)n * D * 2};
    return hp::make_map_bf16(map, ptr, 3, dims, strides, BK);
}

}  // namespace

extern "C" {

// bias: (n,) fp32; q, k, v, o: (bh, n, 64) contiguous bf16; layout 0-4 in the
// order above; bq 64 or 128 with n a multiple of bq and of 128; bh even for
// layouts 1-4; min_smem: bytes of dynamic shared memory to reserve at least
// (0: the layout's own); mma_count: one unsigned 64-bit integer the
// warpgroups add their tensor-core products to (m16n8k16 equivalents), or
// null. Returns the cudaError_t of the launch.
int f5_ablate_attention(const void* bias, const void* q, const void* k, const void* v, void* o, int layout, int bh,
                        int n, int bq, float scale, int min_smem, void* mma_count, void* stream) {
    if (n < 128 || n % 128 || n % bq) return (int)cudaErrorInvalidValue;
    return dispatch(layout, bq, [&](auto lay, auto nwg) {
        constexpr int L = decltype(lay)::value, NWG = decltype(nwg)::value;
        size_t smem;
        int err = configure<L, NWG>(min_smem, &smem);
        if (err != 0) return err;
        cudaStream_t s = static_cast<cudaStream_t>(stream);
        auto* count = static_cast<unsigned long long*>(mma_count);
        CUtensorMap kmap, vmap;
        if constexpr (L == UNPACKED) {
            err = fw::make_rows_map(&kmap, k, D, n, 1, bh, (long long)n * D, (long long)n * D, D);
            if (!err) err = fw::make_rows_map(&vmap, v, D, n, 1, bh, (long long)n * D, (long long)n * D, D);
            if (err) return err;
            const dim3 grid(n / UCfg<NWG>::BQ, bh);
            ablate_unpacked<NWG><<<grid, UCfg<NWG>::THREADS, smem, s>>>(
                kmap, vmap, static_cast<const float*>(bias), static_cast<const bf16*>(q), static_cast<bf16*>(o), n,
                scale, count);
        } else {
            CUtensorMap qmap;
            err = rows_map64(&qmap, q, n, bh);
            if (!err) err = rows_map64(&kmap, k, n, bh);
            if (!err) err = rows_map64(&vmap, v, n, bh);
            if (err) return err;
            const dim3 grid(n / PairCfg<L, NWG>::BQ, bh / 2);
            ablate_pair<L, NWG><<<grid, PairCfg<L, NWG>::THREADS, smem, s>>>(
                qmap, kmap, vmap, static_cast<const float*>(bias), static_cast<bf16*>(o), n, scale, 0.0f, count);
        }
        return (int)cudaGetLastError();
    });
}

// The layout's own dynamic shared memory in bytes (negative: a cudaError_t).
long long f5_ablate_attention_smem(int layout, int bq) {
    long long out = -(long long)cudaErrorInvalidValue;
    dispatch(layout, bq, [&](auto lay, auto nwg) {
        out = (long long)Kernel<decltype(lay)::value, decltype(nwg)::value>::SMEM;
        return 0;
    });
    return out;
}

// Blocks of (layout, bq) that fit one SM at once with min_smem as above
// (negative: a cudaError_t).
int f5_ablate_attention_blocks_per_sm(int layout, int bq, int min_smem) {
    int blocks = 0;
    const int err = dispatch(layout, bq, [&](auto lay, auto nwg) {
        constexpr int L = decltype(lay)::value, NWG = decltype(nwg)::value;
        size_t smem;
        const int e = configure<L, NWG>(min_smem, &smem);
        if (e != 0) return e;
        return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, Kernel<L, NWG>::fn(), Kernel<L, NWG>::THREADS,
                                                                  smem);
    });
    return err != 0 ? -err : blocks;
}

const char* f5_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
