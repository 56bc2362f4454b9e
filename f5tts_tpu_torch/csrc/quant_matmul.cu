// Fused W8A8 matmul for Hopper (sm_90a): per-row dynamic int8 quantization of
// the activations, int8 x int8 -> int32 on the tensor cores (wgmma), rescale
// by the row and column scales, optional bias.
//
// Replaces f5tts_tpu/ops/pallas/quant_matmul.py:quant_matmul (kernel _kernel).
// For x (M, K) in bf16 or fp32, w_q int8 and s_w (N,) fp32:
//   ax  = max_k |x[m, k]|                               fp32, over the whole K
//   sx  = max(max(ax, amax_floor) / 127, scale_floor)   a true division
//   xq  = rint(x / sx)                                  half to even, a true division, int8
//   acc = xq . w_q                                      int32, exact
//   out = (float(acc) * sx) * s_w[n]                    fp32, in that order, one rounding to x's type
//   with a bias b (x's type): out = round(float(out) + float(b[n])), the
//   rounding of `_linear_int8`'s separate add.
// The two floors are arguments because the JAX package has two conventions:
// its Pallas kernel floors the abs-max at 1e-6 (amax_floor = 1e-6, scale_floor
// = 0), its `_linear_int8` floors the scale at 1e-8 (amax_floor = 0,
// scale_floor = 1e-8). Every step is exact integer arithmetic or one correctly
// rounded fp32 operation, so the result equals the plain PyTorch version bit
// for bit.
//
// Bound: at the serving shapes (M 16384, K and N 1024-2048) the bytes of x and
// the output at the memory rate (0.020 ms at K = N = 1024) just exceed 2MKN at
// the int8 tensor-core peak (0.017 ms). The weights are small and shared by
// all rows, but every block streams them again from the L2 (M / 128 x K x N
// bytes in all: 128 MB at K = N = 1024, about the L2's rate for the
// products' time).
//
// Design (quant_matmul_kernel<T, STREAM>): a block owns 128 rows and a run of
// `per` N tiles of 128 columns; one producer warpgroup and two pairs of
// consumer warpgroups.
// - Fused path (STREAM false), where the block's 128 rows of int8 for the
//   whole K fit in shared memory (K up to 1152): all 20 warps quantize them
//   once, and every N tile of the block reuses them. The ring's and the
//   epilogue's shared memory, idle until the products start, hold rows of x
//   brought in whole by 1-D bulk copies (each warp keeps its next rows in
//   flight); a warp takes a row's abs-max and writes rint(x / sx) straight
//   into the 128-byte-swizzled K-major panels wgmma reads. rint(x / sx) is
//   taken as rint(x * (1 / sx)) except within 2^-14 of a tie, where the
//   correctly rounded division decides: the same integer, without a division
//   per element.
// - Streamed path (STREAM true), for any K and where the row blocks alone
//   would leave SMs idle: a pre-pass kernel (quantize_rows_kernel, one warp a
//   row) writes xq (M, K) int8 and sx (M,), and the product kernel takes A
//   panels by TMA beside the weights, so blocks may split N without
//   quantizing a row twice. One wrapper call, two launches.
// - Weights: w_qt (N, K) int8, made once with the parameters, streamed by a
//   producer thread through TMA (128-byte swizzle, 128 k x 128 rows a stage)
//   into an mbarrier ring (full / empty); no __syncthreads in the tile loop.
//   Blocks start their tile walk at different tiles, so the L2 serves several
//   weight tiles at once.
// - Products: wgmma.mma_async m64n128k32 .s32.s8.s8, A and B both K-major
//   from shared-memory descriptors, int32 accumulators in the consumer
//   warpgroups' registers (setmaxnreg 112). The two warpgroups of a pair read
//   one stage, 64 rows each. The pairs take the block's tiles in turn (a
//   named barrier passes the turn once a pair has issued every panel of its
//   tile), so one pair's epilogue runs under the other's products; a stage's
//   products stay in flight while the next stage's are issued.
// - Epilogue: rescale in registers (s_w and the bias per column, loaded
//   during the products and passed through shared memory; sx per row), stage
//   8 rows x 128 bytes a piece in the warp's swizzled buffer, TMA store (rows
//   past M and columns past N clipped): the writes leave asynchronously.
// - Any M (rows past M are zeros and never written), K and N multiples of 16
//   (K is zero-padded to the 128-byte panel, columns past N are zero weights
//   and never written), K up to MAX_K (int32 accumulators stay exact).
// - Tensor parallelism (a row-parallel linear: K sharded over ranks). The row
//   abs-max must span the whole row and the products the whole K, so the
//   kernel takes two options: a given per-row abs-max `amax` (M,) fp32 (the
//   ranks' local maxima all-reduced with MAX; the quantize phase and the
//   pre-pass then skip their reduction), and a raw mode (RAW) whose epilogue
//   stores the int32 accumulators (M, N) with no rescale and no bias, to be
//   summed over the ranks exactly. Two companions close the path:
//   row_amax_kernel (the local abs-max, one warp a row) and
//   rescale_rows_kernel (the summed accumulators rescaled as above, the bias
//   added after the rounding to x's type). Integer sums are exact, so a sharded
//   linear equals the one-device one bit for bit.
// The plan (path, N split) is chosen by the wrapper's pure Python `plan`
// (ops/kernels/quant_matmul.py) from (M, K, N, SM count).
// A barrier wait that outlasts 4 s traps: a lost arrival fails the launch
// instead of hanging the card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

namespace hp = f5::hopper;
using bf16 = __nv_bfloat16;

constexpr int BK = 128;           // k values (bytes) of one panel: a 128-byte swizzled row per operand row
constexpr int BM = 128;           // rows of a block
constexpr int BN = 128;           // output columns of a tile
constexpr int NCW = 4;            // consumer warpgroups
constexpr int THREADS = 128 * (NCW + 1);
constexpr int NWARPS = THREADS / 32;
// setmaxnreg: the consumers can take only what the producer warpgroup gives back of the block's
// launch allocation (LAUNCH_REGS a thread, what __launch_bounds__ leaves for one block an SM)
constexpr int LAUNCH_REGS = 65536 / THREADS / 8 * 8;
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 112;
static_assert(NCW * (CONSUMER_REGS - LAUNCH_REGS) <= LAUNCH_REGS - PRODUCER_REGS, "setmaxnreg would wait forever");
constexpr int STG = 8 * 128;      // epilogue staging per consumer warp: a piece of 8 rows x 128 bytes
constexpr int COLS = 2 * BN;      // per consumer warpgroup: its columns' s_w and bias, as floats
constexpr int MAX_SMEM = 232448;  // bytes of dynamic shared memory a block may ask for on sm_90
constexpr int MAX_K = 65536;      // |acc| <= K * 127 * 127 stays under 2^31
constexpr int QROWS = 8;          // rows (warps) per block of the pre-pass
constexpr int MAX_STAGES = 12;    // barrier pairs reserved; the ring gets what shared memory leaves, at most this
constexpr int MIN_STAGES = 3;     // fewer and the ring cannot cover the weights' L2 latency: no plan uses it
constexpr int XSLOTS = 3 * NWARPS;  // the fused quantize phase's row slots (and their barriers)

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

template <bool STREAM>
struct Cfg {
    static constexpr int A_STAGE = STREAM ? BM * BK : 0;  // bytes of A in a stage
    static constexpr int STAGE = A_STAGE + BN * BK;
    // everything but the ring: alignment slack, the fused path's int8 rows, staging, row scales, tile
    // columns, barriers
    static size_t fixed(int k) {
        return 1024 + (STREAM ? 0 : (size_t)BM * cdiv(k, BK) * BK) + NCW * 4 * STG + BM * sizeof(float) +
               NCW * COLS * sizeof(float) + (2 * MAX_STAGES + XSLOTS) * sizeof(uint64_t);
    }
    // ring stages: what the rest of the block's shared memory holds, at most MAX_STAGES; 0 below MIN_STAGES
    static int stages(int k) {
        const long long room = (long long)MAX_SMEM - (long long)fixed(k);
        const long long n = room / STAGE < MAX_STAGES ? room / STAGE : MAX_STAGES;
        return n < MIN_STAGES ? 0 : (int)n;
    }
    // what ops/kernels/quant_matmul.py:smem_bytes computes too
    static size_t smem(int k) { return fixed(k) + (size_t)stages(k) * STAGE; }
};

// Eight consecutive elements of a row, as floats (one or two 16-byte loads).
template <typename T> struct Row8;
template <> struct Row8<float> {
    static __device__ __forceinline__ void load(const float* p, float* v) {
        const float4 a = *reinterpret_cast<const float4*>(p);
        const float4 b = *reinterpret_cast<const float4*>(p + 4);
        v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
        v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    }
};
template <> struct Row8<bf16> {
    static __device__ __forceinline__ void load(const bf16* p, float* v) {
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

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
    return x;
}

// max |x| of one row (the whole warp: lane-strided 8-element loads, K % 8 == 0).
template <typename T>
__device__ __forceinline__ float row_absmax(const T* xr, int k, int lane) {
    float amax = 0.0f;
#pragma unroll 4
    for (int c = lane * 8; c < k; c += 32 * 8) {
        float v[8];
        Row8<T>::load(xr + c, v);
#pragma unroll
        for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(v[e]));
    }
    return warp_max(amax);
}

// rint(v / sx), half to even, of the correctly rounded quotient, for 16 values, packed as int8, with
// r = 1 / sx (rounded): y = v * r lies within 2^-15 of fl(v / sx) (|v / sx| <= 127: two roundings of
// relative 2^-24, and fl's own half ulp), so rint(y) is rint(fl(v / sx)) unless y lies within 2^-14 of
// a half-integer; a chunk with such a value (rare: bf16 ties such as x = amax / 2) is redone with the
// correctly rounded division.
__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
    return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}
__device__ __forceinline__ uint4 quant16(const float* v, float sx, float r) {
    int q[16];
    bool near_tie = false;
#pragma unroll
    for (int e = 0; e < 16; ++e) {
        const float y = __fmul_rn(v[e], r);
        const float n = rintf(y);
        near_tie |= fabsf(fabsf(y - n) - 0.5f) < 0x1p-14f;
        q[e] = (int)n;
    }
    if (near_tie) {
#pragma unroll
        for (int e = 0; e < 16; ++e) q[e] = __float2int_rn(__fdiv_rn(v[e], sx));
    }
    return make_uint4(pack4(q[0], q[1], q[2], q[3]), pack4(q[4], q[5], q[6], q[7]), pack4(q[8], q[9], q[10], q[11]),
                      pack4(q[12], q[13], q[14], q[15]));
}

// 16 consecutive elements (one int8 chunk of A) as raw 16-byte words: 2 (bf16) or 4 (fp32).
template <typename T> struct Chunk {
    static constexpr int WORDS = (int)sizeof(T);
    static __device__ __forceinline__ void to_float(const uint4 (&u)[WORDS], float* v);
};
template <> __device__ __forceinline__ void Chunk<bf16>::to_float(const uint4 (&u)[2], float* v) {
#pragma unroll
    for (int w = 0; w < 2; ++w) {
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u[w]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const float2 f = __bfloat1622float2(h[i]);
            v[8 * w + 2 * i] = f.x;
            v[8 * w + 2 * i + 1] = f.y;
        }
    }
}
template <> __device__ __forceinline__ void Chunk<float>::to_float(const uint4 (&u)[4], float* v) {
#pragma unroll
    for (int w = 0; w < 4; ++w) {
        v[4 * w] = __uint_as_float(u[w].x);
        v[4 * w + 1] = __uint_as_float(u[w].y);
        v[4 * w + 2] = __uint_as_float(u[w].z);
        v[4 * w + 3] = __uint_as_float(u[w].w);
    }
}

__device__ __forceinline__ bool mbar_try(uint64_t* bar, uint32_t parity) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(hp::smem_u32(bar)), "r"(parity)
        : "memory");
    return done != 0;
}

__device__ __forceinline__ uint64_t global_ns() {
    uint64_t t;
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
    return t;
}

// mbar_wait that traps after 4 s: a lost arrival fails the launch instead of hanging the card.
__device__ __forceinline__ void wait_or_trap(uint64_t* bar, uint32_t parity) {
    if (mbar_try(bar, parity)) return;
    const uint64_t t0 = global_ns();
    while (!mbar_try(bar, parity))
        if (global_ns() - t0 > 4000000000ull) __trap();
}

// v + b before the last rounding to T, as `_linear_int8` adds its bias: v rounded to T, then the add in fp32.
__device__ __forceinline__ float with_bias(bf16, float v, float b) {
    return __fadd_rn(__bfloat162float(__float2bfloat16_rn(v)), b);
}
__device__ __forceinline__ float with_bias(float, float v, float b) { return __fadd_rn(v, b); }

__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ void put2(unsigned char* p, bf16, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void put2(unsigned char* p, float, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void put2(unsigned char* p, int a, int b) {
    *reinterpret_cast<int2*>(p) = make_int2(a, b);
}

// sx from a row's abs-max: max(max(amax, amax_floor) / 127, scale_floor), a true division.
__device__ __forceinline__ float scale_of(float amax, float amax_floor, float scale_floor) {
    return fmaxf(__fdiv_rn(fmaxf(amax, amax_floor), 127.0f), scale_floor);
}

struct Params {
    const void* x;     // (m, k), T: the fused path's activations
    const float* sx;   // (m,): the streamed path's row scales (the pre-pass's)
    const float* s_w;  // (n,)
    const void* bias;  // (n,), T, or null
    const float* amax;  // (m,): a given per-row abs-max (the quantize phase skips its reduction), or null
    int m, k, n;
    int n_tiles, per;  // N tiles of BN; tiles per block (blockIdx.y owns tiles per*y ..)
    int stages;        // ring stages (Cfg::stages)
    float amax_floor, scale_floor;
};

// The fused path's quantize phase. The ring and the staging buffers (`xbuf`, `room` bytes, unused until
// the products start) hold rows of x: QW warps own S row slots each; lane 0 of a warp brings whole rows
// in with 1-D bulk copies (its S rows in flight), the warp takes the abs-max and the scale from shared
// memory, writes rint(x / sx) into the 128-byte-swizzled K-major panels (zeros past K), and refills
// the slot with its row QW x S further on. Rows past M are zeros with scale 0, never written out.
template <typename T>
__device__ __forceinline__ void quantize_rows(const Params& p, unsigned char* As, float* sx_s, unsigned char* xbuf,
                                              size_t room, uint64_t* xbar, int m0, int KP, int warp, int lane) {
    constexpr int WORDS = Chunk<T>::WORDS;
    const uint32_t row_bytes = (uint32_t)p.k * sizeof(T);
    const int slots = (int)min((size_t)XSLOTS, room / row_bytes);
    const int qw = min(NWARPS, slots), nslot = slots / qw;  // warps with slots, slots a warp
    if (warp >= qw) return;  // rows r = warp + q qw of the warps with slots cover the block
    const int chunks = KP * 8;  // 16-element chunks of the padded row (K % 16 == 0: each whole or absent)
    const int live_rows = min(BM, p.m - m0);  // rows past it are zeros
    const T* x = static_cast<const T*>(p.x);
    auto fetch = [&](int r, int i) {  // row r (< live_rows) into this warp's slot i
        if (lane == 0) {
            uint64_t* bar = &xbar[warp * nslot + i];
            hp::mbar_arrive_expect_tx(bar, row_bytes);
            hp::bulk_load(xbuf + (size_t)(warp * nslot + i) * row_bytes, x + (size_t)(m0 + r) * p.k, row_bytes, bar);
        }
    };
    for (int i = 0; i < nslot && warp + i * qw < live_rows; ++i) fetch(warp + i * qw, i);
    for (int q = 0;; ++q) {
        const int r = warp + q * qw;
        if (r >= BM) break;
        unsigned char* arow = As + r * BK;
        if (r >= live_rows) {  // dead rows form the block's tail: no slot waits after this one
            for (int c = lane; c < chunks; c += 32)
                *reinterpret_cast<uint4*>(arow + (size_t)(c >> 3) * (BM * BK) + (c & 7) * 16) = make_uint4(0, 0, 0, 0);
            if (lane == 0) sx_s[r] = 0.0f;
            continue;
        }
        const int i = q % nslot;
        wait_or_trap(&xbar[warp * nslot + i], (q / nslot) & 1);
        const uint4* row = reinterpret_cast<const uint4*>(xbuf + (size_t)(warp * nslot + i) * row_bytes);
        float amax = 0.0f;
        if (p.amax != nullptr) {
            amax = __ldg(p.amax + m0 + r);
        } else {
            for (int c = lane; c * 16 < p.k; c += 32) {
                uint4 u[WORDS];
#pragma unroll
                for (int w = 0; w < WORDS; ++w) u[w] = row[c * WORDS + w];
                float v[16];
                Chunk<T>::to_float(u, v);
#pragma unroll
                for (int e = 0; e < 16; ++e) amax = fmaxf(amax, fabsf(v[e]));
            }
            amax = warp_max(amax);
        }
        const float sx = scale_of(amax, p.amax_floor, p.scale_floor);
        const float rcp = __fdiv_rn(1.0f, sx);
        if (lane == 0) sx_s[r] = sx;
        for (int c = lane; c < chunks; c += 32) {
            uint4 q16 = make_uint4(0, 0, 0, 0);
            if (c * 16 < p.k) {
                uint4 u[WORDS];
#pragma unroll
                for (int w = 0; w < WORDS; ++w) u[w] = row[c * WORDS + w];
                float v[16];
                Chunk<T>::to_float(u, v);
                q16 = quant16(v, sx, rcp);
            }
            *reinterpret_cast<uint4*>(arow + (size_t)(c >> 3) * (BM * BK) + (((c & 7) ^ (r & 7)) << 4)) = q16;
        }
        const int next = r + nslot * qw;
        if (next < live_rows) {
            hp::fence_proxy_async();  // this warp's reads of the slot come before the copy that overwrites it
            __syncwarp();
            fetch(next, i);
        }
    }
}

// Grid (row blocks, ceil(n_tiles / per)), THREADS threads, Cfg::smem(k) bytes of dynamic shared memory.
// wmap: w_qt (n, k) int8 in boxes of 128 k x BN rows; amap (STREAM): xq (m, k) in boxes of 128 k x BM
// rows; omap: out (m, n) in boxes of 128 bytes x 8 rows. RAW: out is the int32 accumulators.
template <typename T, bool STREAM, bool RAW>
__global__ void __launch_bounds__(THREADS, 1)
quant_matmul_kernel(const __grid_constant__ CUtensorMap wmap, const __grid_constant__ CUtensorMap amap,
                    const __grid_constant__ CUtensorMap omap, const Params p) {
    using C = Cfg<STREAM>;
    using O = std::conditional_t<RAW, int, T>;  // the output's element
    constexpr int CW = 128 / (int)sizeof(O);   // output columns in a 128-byte staged row
    constexpr int JC = CW / 8;                 // 8-column groups in it

    extern __shared__ unsigned char smem_raw[];
    unsigned char* base = reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
    const int KP = cdiv(p.k, BK), stages = p.stages;
    unsigned char* As = base;  // fused: KP panels of BM rows x 128 bytes
    unsigned char* ring = As + (STREAM ? 0 : (size_t)BM * KP * BK);
    unsigned char* stg = ring + (size_t)stages * C::STAGE;
    float* sx_s = reinterpret_cast<float*>(stg + NCW * 4 * STG);
    float* cols = sx_s + BM;  // NCW x (s_w, bias) of the columns being finished, as floats
    uint64_t* full = reinterpret_cast<uint64_t*>(cols + NCW * COLS);
    uint64_t* empty = full + MAX_STAGES;
    uint64_t* xbar = empty + MAX_STAGES;

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int m0 = blockIdx.x * BM;
    const int t0 = blockIdx.y * p.per;
    const int ntl = min(p.n_tiles - t0, p.per);  // >= 1: the grid has no empty block
    // Blocks walk their tiles from different starting points, so that the L2 serves different
    // weight tiles at once rather than one tile to every SM.
    const int rot = (int)blockIdx.x % ntl;

    if (tid == 0) {
        for (int s = 0; s < stages; ++s) {
            hp::mbar_init(&full[s], 1);
            hp::mbar_init(&empty[s], 8);  // each warp of the pair of warpgroups that reads the stage
        }
        if constexpr (!STREAM)
            for (int s = 0; s < XSLOTS; ++s) hp::mbar_init(&xbar[s], 1);
        hp::mbar_init_fence();
    }
    __syncthreads();

    if constexpr (!STREAM) {  // every warp quantizes rows of the block into the swizzled panels
        quantize_rows<T>(p, As, sx_s, ring, (size_t)stages * C::STAGE + NCW * 4 * STG, xbar, m0, KP, warp, lane);
        hp::fence_proxy_async();  // the panels are wgmma operands, and the ring's x rows are overwritten by TMA
    }
    __syncthreads();

    if (warp < 4) {  // producer warpgroup: one thread keeps the ring full, in (tile, panel) order
        hp::setmaxnreg_dec<PRODUCER_REGS>();
        if (tid == 0) {
            int s = 0, kp = 0, t = 0;
            uint32_t ph = 0;
            for (int i = 0; i < ntl * KP; ++i) {
                wait_or_trap(&empty[s], ph ^ 1);
                unsigned char* st = ring + (size_t)s * C::STAGE;
                hp::mbar_arrive_expect_tx(&full[s], C::STAGE);
                if constexpr (STREAM) hp::tma_load_2d(st, &amap, &full[s], kp * BK, m0);
                hp::tma_load_2d(st + C::A_STAGE, &wmap, &full[s], kp * BK, (t0 + (t + rot) % ntl) * BN);
                if (++kp == KP) { kp = 0; ++t; }
                if (++s == stages) { s = 0; ph ^= 1; }
            }
        }
    } else {
        hp::setmaxnreg_inc<CONSUMER_REGS>();
        // Two pairs of consumer warpgroups take the block's tiles in turn; the second warpgroup of a pair
        // owns the block's last 64 rows.
        const int wg = warp / 4 - 1, pr = wg >> 1, row0 = (wg & 1) * 64;
        const int w = warp % 4, g = lane >> 2, tq = lane & 3, ct = tid % 128;
        unsigned char* my_stg = stg + (wg * 4 + w) * STG;
        float* my_cols = cols + wg * COLS;
        const T* bias = static_cast<const T*>(p.bias);
        uint32_t acc[BN / 2];
#pragma unroll
        for (int e = 0; e < BN / 2; ++e) acc[e] = 0u;
        hp::fence_regs(acc);

        auto issue = [&](int s, uint32_t ph, int kp) {
            wait_or_trap(&full[s], ph);
            const unsigned char* st = ring + (size_t)s * C::STAGE;
            const unsigned char* a = (STREAM ? st : As + (size_t)kp * (BM * BK)) + row0 * BK;
            const unsigned char* b = st + C::A_STAGE;
            hp::wgmma_fence();
#pragma unroll
            for (int ks = 0; ks < BK / 32; ++ks) {
                hp::wgmma_m64n128k32_s8(acc, hp::desc_b128(a + ks * 32, 16, 1024), hp::desc_b128(b + ks * 32, 16, 1024),
                                        kp > 0 || ks > 0);
            }
            hp::wgmma_commit();
        };
        auto release = [&](int s) {
            __syncwarp();
            if (lane == 0) hp::mbar_arrive(&empty[s]);
        };

        for (int t = pr; t < ntl; t += 2) {
            // Turns: a pair waits for a tile's panels only after the other pair has waited for every panel
            // of the tile before (a parity wait may be at most one phase ahead of its slot), so the pairs'
            // product loops follow each other and each pair's epilogue runs under the other's products.
            if (t > 0) hp::named_sync(1 + pr, 512);
            const int n0 = (t0 + (t + rot) % ntl) * BN;
            float sw_t = 0.0f, b_t = 0.0f;  // this thread's column: loaded now, used after the products
            if (!RAW && n0 + ct < p.n) {
                sw_t = __ldg(p.s_w + n0 + ct);
                if (bias != nullptr) b_t = to_float(bias[n0 + ct]);
            }
            int s = (t * KP) % stages, prev = s;
            uint32_t ph = ((t * KP) / stages) & 1;
            issue(s, ph, 0);
            if (++s == stages) { s = 0; ph ^= 1; }
            for (int kp = 1; kp < KP; ++kp) {
                issue(s, ph, kp);
                hp::wgmma_wait<1>();  // the previous panel's products are done: its slot is free
                release(prev);
                prev = s;
                if (++s == stages) { s = 0; ph ^= 1; }
            }
            if (t + 1 < ntl) hp::named_arrive(1 + (pr ^ 1), 512);
            hp::wgmma_wait<0>();
            release(prev);
            hp::fence_regs(acc);
            hp::named_sync(3 + wg, 128);  // the warpgroup has finished the previous tile's columns
            my_cols[ct] = sw_t;
            my_cols[BN + ct] = b_t;
            hp::named_sync(3 + wg, 128);

            // epilogue: this warp's 16 rows in pieces of 8 rows x 128 bytes, each staged in the warp's
            // swizzled buffer and written by a TMA store
#pragma unroll
            for (int h = 0; h < 2; ++h) {  // rows rl + g: h 0 the warp's first 8, h 1 its last 8
                const int rl = row0 + w * 16 + 8 * h;
                float sxr = 0.0f;  // RAW: the accumulators leave unscaled
                if constexpr (!RAW) {
                    if constexpr (STREAM)
                        sxr = m0 + rl + g < p.m ? __ldg(p.sx + m0 + rl + g) : 0.0f;
                    else
                        sxr = sx_s[rl + g];
                }
#pragma unroll
                for (int c = 0; c < BN / CW; ++c) {
                    if (lane == 0) hp::bulk_wait_read<0>();  // the last piece has left the buffer
                    __syncwarp();
#pragma unroll
                    for (int jj = 0; jj < JC; ++jj) {
                        const int j = c * JC + jj;
                        const int bc = (8 * jj + 2 * tq) * (int)sizeof(O);  // byte column in the staged row
                        unsigned char* dst = my_stg + g * 128 + ((((bc >> 4) ^ g) << 4) | (bc & 15));
                        if constexpr (RAW) {
                            put2(dst, (int)acc[4 * j + 2 * h], (int)acc[4 * j + 2 * h + 1]);
                            continue;
                        }
                        const float2 sw = *reinterpret_cast<const float2*>(my_cols + 8 * j + 2 * tq);
                        const float2 bb = *reinterpret_cast<const float2*>(my_cols + BN + 8 * j + 2 * tq);
                        const float v0 = __fmul_rn(__fmul_rn(__int2float_rn((int)acc[4 * j + 2 * h]), sxr), sw.x);
                        const float v1 = __fmul_rn(__fmul_rn(__int2float_rn((int)acc[4 * j + 2 * h + 1]), sxr), sw.y);
                        if (bias != nullptr)
                            put2(dst, T{}, with_bias(T{}, v0, bb.x), with_bias(T{}, v1, bb.y));
                        else
                            put2(dst, T{}, v0, v1);
                    }
                    hp::fence_proxy_async();  // the staged piece is read by the TMA store
                    __syncwarp();
                    if (lane == 0) {
                        hp::tma_store_2d(&omap, my_stg, n0 + c * CW, m0 + rl);
                        hp::bulk_commit();
                    }
                }
            }
        }
        if (lane == 0) hp::bulk_wait<0>();  // the last piece has left shared memory before the block ends
    }
}

// The streamed path's pre-pass: xq (m, k) int8 and sx (m,) fp32, one warp a row; with a given abs-max
// `amax` (m,) the row's reduction is skipped.
template <typename T>
__global__ void __launch_bounds__(QROWS * 32)
quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ sx,
                     const float* __restrict__ amax, int m, int k, float amax_floor, float scale_floor) {
    const int row = blockIdx.x * QROWS + (threadIdx.x >> 5), lane = threadIdx.x & 31;
    if (row >= m) return;
    const T* xr = x + (size_t)row * k;
    const float a = amax != nullptr ? __ldg(amax + row) : row_absmax<T>(xr, k, lane);
    const float s = scale_of(a, amax_floor, scale_floor);
    if (lane == 0) sx[row] = s;
    const float rcp = __fdiv_rn(1.0f, s);
    int8_t* qr = xq + (size_t)row * k;
    for (int c = lane * 16; c < k; c += 32 * 16) {
        float v[16];
        Row8<T>::load(xr + c, v);
        Row8<T>::load(xr + c + 8, v + 8);
        *reinterpret_cast<uint4*>(qr + c) = quant16(v, s, rcp);
    }
}

// The local row abs-max of a row-parallel linear: amax[row] = max_k |x[row, k]| (fp32), one warp a row.
template <typename T>
__global__ void __launch_bounds__(QROWS * 32)
row_amax_kernel(const T* __restrict__ x, float* __restrict__ amax, int m, int k) {
    const int row = blockIdx.x * QROWS + (threadIdx.x >> 5), lane = threadIdx.x & 31;
    if (row >= m) return;
    const float a = row_absmax<T>(x + (size_t)row * k, k, lane);
    if (lane == 0) amax[row] = a;
}

// The summed int32 accumulators of a row-parallel linear rescaled as the product kernel's epilogue does:
// out = round_T((float(acc) * sx[row]) * s_w[col]), sx from the row's (global) abs-max with the floors; a
// bias is added after that rounding, in fp32, and rounded again. Four columns a thread (n % 16 == 0).
template <typename T>
__global__ void __launch_bounds__(256)
rescale_rows_kernel(const int* __restrict__ acc, const float* __restrict__ amax, const float* __restrict__ s_w,
                    const T* __restrict__ bias, T* __restrict__ out, int m, int n, float amax_floor,
                    float scale_floor) {
    const size_t i = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
    if (i >= (size_t)m * n) return;
    const int row = (int)(i / n), col = (int)(i % n);
    const float sx = scale_of(__ldg(amax + row), amax_floor, scale_floor);
    const int4 a = *reinterpret_cast<const int4*>(acc + i);
    const float4 sw = *reinterpret_cast<const float4*>(s_w + col);
    const int ai[4] = {a.x, a.y, a.z, a.w};
    const float swi[4] = {sw.x, sw.y, sw.z, sw.w};
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = __fmul_rn(__fmul_rn(__int2float_rn(ai[e]), sx), swi[e]);
    if (bias != nullptr) {
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = with_bias(T{}, v[e], to_float(bias[col + e]));
    }
    put2(reinterpret_cast<unsigned char*>(out + i), T{}, v[0], v[1]);
    put2(reinterpret_cast<unsigned char*>(out + i + 2), T{}, v[2], v[3]);
}

// ---------------------------------------------------------------------------
// measurement aids: the rates of the two int8 tensor-core instructions alone
// ---------------------------------------------------------------------------

// c (16 x 8 int32) += a (16 x 32 int8) . b (32 x 8 int8): the warp-level int8 instruction.
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(256) mma_rate_kernel(int iters, int* sink) {
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

constexpr int RATE_SMEM = 1024 + 64 * BK + 128 * BK;
constexpr int RATE_THREADS = 3 * 128;

// Every one of 3 warpgroups: iters x 8 wgmma m64n128k32 s8 on one shared-memory tile pair.
__global__ void __launch_bounds__(RATE_THREADS, 1) wgmma_rate_kernel(int iters, int* sink) {
    extern __shared__ unsigned char smem_raw[];
    unsigned char* a = reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
    unsigned char* b = a + 64 * BK;
    for (int i = threadIdx.x; i < (64 + 128) * BK / 16; i += RATE_THREADS)
        reinterpret_cast<uint4*>(a)[i] = make_uint4(i, 3 * i, 5 * i, 7 * i);
    hp::fence_proxy_async();
    __syncthreads();
    uint32_t acc[64];
    for (int i = 0; i < iters; ++i) {
        hp::wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 8; ++ks)
            hp::wgmma_m64n128k32_s8(acc, hp::desc_b128(a + (ks & 3) * 32, 16, 1024),
                                    hp::desc_b128(b + (ks & 3) * 32, 16, 1024), i > 0 || ks > 0);
        hp::wgmma_commit();
        hp::wgmma_wait<0>();
    }
    hp::fence_regs(acc);
    uint32_t sum = 0;
#pragma unroll
    for (int j = 0; j < 64; ++j) sum += acc[j];
    if (sum == 0x7fffffffu) *sink = (int)sum;
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------

struct Call {
    const void* x;
    const void* wt;
    const float* s_w;
    const void* bias;
    const float* amax;
    void* out;
    int8_t* xq;
    float* sx;
    int m, k, n, split;
    float amax_floor, scale_floor;
};

template <typename T, bool STREAM, bool RAW>
int launch(const Call& c, cudaStream_t stream) {
    using Cf = Cfg<STREAM>;
    const size_t smem = Cf::smem(c.k);
    if (Cf::stages(c.k) == 0) return (int)cudaErrorInvalidValue;
    auto kernel = quant_matmul_kernel<T, STREAM, RAW>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;

    Params p;
    p.x = c.x;
    p.sx = c.sx;
    p.s_w = c.s_w;
    p.bias = c.bias;
    p.amax = c.amax;
    p.m = c.m;
    p.k = c.k;
    p.n = c.n;
    p.n_tiles = cdiv(c.n, BN);
    p.per = cdiv(p.n_tiles, c.split);
    p.stages = Cf::stages(c.k);
    p.amax_floor = c.amax_floor;
    p.scale_floor = c.scale_floor;

    CUtensorMap wmap, amap, omap;
    int e = hp::make_map_2d(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, c.wt, c.k, c.n, c.k, BK, BN);
    using O = std::conditional_t<RAW, int, T>;
    if (!e)
        e = hp::make_map_2d(&omap,
                            RAW                ? CU_TENSOR_MAP_DATA_TYPE_INT32
                            : sizeof(T) == 2   ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                               : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                            c.out, c.n, c.m, (uint64_t)c.n * sizeof(O), 128 / sizeof(O), 8);
    if (e) return e;
    if constexpr (STREAM) {
        quantize_rows_kernel<T><<<cdiv(c.m, QROWS), QROWS * 32, 0, stream>>>(
            static_cast<const T*>(c.x), c.xq, c.sx, c.amax, c.m, c.k, c.amax_floor, c.scale_floor);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
        e = hp::make_map_2d(&amap, CU_TENSOR_MAP_DATA_TYPE_UINT8, c.xq, c.k, c.m, c.k, BK, BM);
        if (e) return e;
    } else {
        amap = wmap;  // not read
    }
    kernel<<<dim3(cdiv(c.m, BM), cdiv(p.n_tiles, p.per)), THREADS, smem, stream>>>(wmap, amap, omap, p);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (m, k) contiguous, bf16 (is_bf16 = 1) or fp32; wt: (n, k) int8 contiguous
// (w_q transposed); s_w: (n,) fp32; bias: (n,) in x's type or null; amax: (m,)
// fp32, a given per-row abs-max, or null (the kernel takes its own); out: (m, n)
// in x's type, or int32 accumulators with raw = 1 (s_w and bias then unread,
// bias must be null); xq (m, k) int8 and sx (m,) fp32: scratch of the streamed
// path (stream_a = 1), else unused. k and n multiples of 16, k <= f5_quant_matmul_max_k().
// The plan: the n / 128 tiles split over `split` blocks per 128-row block.
// Returns the cudaError_t of the launch.
int f5_quant_matmul(const void* x, const void* wt, const void* s_w, const void* bias, const void* amax, void* out,
                    void* xq, void* sx, int m, int k, int n, float amax_floor, float scale_floor, int is_bf16,
                    int stream_a, int split, int raw, void* stream) {
    if (m < 1 || k < 16 || n < 16 || k % 16 != 0 || n % 16 != 0 || k > MAX_K || split < 1 || split > 65535)
        return (int)cudaErrorInvalidValue;
    if ((stream_a && (xq == nullptr || sx == nullptr)) || (raw && bias != nullptr)) return (int)cudaErrorInvalidValue;
    const Call c{x, wt, static_cast<const float*>(s_w), bias, static_cast<const float*>(amax), out,
                 static_cast<int8_t*>(xq), static_cast<float*>(sx), m, k, n, split, amax_floor, scale_floor};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (raw) {
        if (stream_a) return is_bf16 ? launch<bf16, true, true>(c, s) : launch<float, true, true>(c, s);
        return is_bf16 ? launch<bf16, false, true>(c, s) : launch<float, false, true>(c, s);
    }
    if (stream_a) return is_bf16 ? launch<bf16, true, false>(c, s) : launch<float, true, false>(c, s);
    return is_bf16 ? launch<bf16, false, false>(c, s) : launch<float, false, false>(c, s);
}

// amax (m,) fp32 = the abs-max of each row of x (m, k) (contiguous, bf16 or fp32, k % 16 == 0, 16-byte aligned).
int f5_quant_row_amax(const void* x, void* amax, int m, int k, int is_bf16, void* stream) {
    if (m < 1 || k < 16 || k % 16 != 0) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    float* out = static_cast<float*>(amax);
    if (is_bf16)
        row_amax_kernel<bf16><<<cdiv(m, QROWS), QROWS * 32, 0, s>>>(static_cast<const bf16*>(x), out, m, k);
    else
        row_amax_kernel<float><<<cdiv(m, QROWS), QROWS * 32, 0, s>>>(static_cast<const float*>(x), out, m, k);
    return (int)cudaGetLastError();
}

// out (m, n) in bf16 (is_bf16 = 1) or fp32 = the int32 accumulators acc (m, n) rescaled by the row scales
// (from amax (m,) and the floors) and s_w (n,), plus bias (n,) in out's type or null. n % 16 == 0, every
// pointer 16-byte aligned.
int f5_quant_rescale_rows(const void* acc, const void* amax, const void* s_w, const void* bias, void* out, int m, int n,
                          float amax_floor, float scale_floor, int is_bf16, void* stream) {
    if (m < 1 || n < 16 || n % 16 != 0) return (int)cudaErrorInvalidValue;
    const size_t threads = (size_t)m * n / 4;
    const unsigned blocks = (unsigned)((threads + 255) / 256);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int* a = static_cast<const int*>(acc);
    const float* am = static_cast<const float*>(amax);
    const float* sw = static_cast<const float*>(s_w);
    if (is_bf16)
        rescale_rows_kernel<bf16><<<blocks, 256, 0, s>>>(a, am, sw, static_cast<const bf16*>(bias),
                                                         static_cast<bf16*>(out), m, n, amax_floor, scale_floor);
    else
        rescale_rows_kernel<float><<<blocks, 256, 0, s>>>(a, am, sw, static_cast<const float*>(bias),
                                                          static_cast<float*>(out), m, n, amax_floor, scale_floor);
    return (int)cudaGetLastError();
}

// Dynamic shared memory of the product kernel of either path at this k, in bytes (0: it does not fit).
long long f5_quant_matmul_smem(int stream_a, int k) {
    if (stream_a) return Cfg<true>::stages(k) ? (long long)Cfg<true>::smem(k) : 0;
    return Cfg<false>::stages(k) ? (long long)Cfg<false>::smem(k) : 0;
}

int f5_quant_matmul_max_k() { return MAX_K; }

// Measurement aids (chip_smoke.py): every warp of `blocks` blocks of 8 warps
// runs 8 * iters independent-accumulator mma.sync m16n8k32 s8 products on
// register operands; every warpgroup of `blocks` blocks of 3 warpgroups runs
// 8 * iters wgmma m64n128k32 s8 from shared memory. `sink` (>= 4 bytes) only
// keeps the work alive.
int f5_quant_matmul_mma_rate(int blocks, int iters, void* sink, void* stream) {
    mma_rate_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(iters, static_cast<int*>(sink));
    return (int)cudaGetLastError();
}

int f5_quant_matmul_wgmma_rate(int blocks, int iters, void* sink, void* stream) {
    const cudaError_t err = cudaFuncSetAttribute(wgmma_rate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, RATE_SMEM);
    if (err != cudaSuccess) return (int)err;
    wgmma_rate_kernel<<<blocks, RATE_THREADS, RATE_SMEM, static_cast<cudaStream_t>(stream)>>>(iters, static_cast<int*>(sink));
    return (int)cudaGetLastError();
}

const char* f5_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
