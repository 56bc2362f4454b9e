// Decode-step attention for Hopper (sm_90a): one query position per row
// against a KV cache, grouped-query heads sharing their K/V reads.
//
// Replaces f5tts_tpu/ops/pallas/decode_attention.py:decode_attention (kernel
// _decode_attn_kernel). For each batch row, KV head and group member:
//   s = q . K^T + bias          fp32, over all `total` cache positions
//   p = exp(s - max) / max(sum, 1e-30)   fp32, then rounded to the cache dtype
//   o = p . V                   fp32 accumulation, written in q's dtype
// q arrives pre-scaled by head_dim^-0.5; bias is additive (0 / -1e9).
//
// Bound: bytes. A length-1 query is a matrix-vector product: 2 FLOP per cache
// element read, far below the card's ~295 FLOP/byte ridge, so the least time
// is K and V read once (2 * b * n_kv * total * d elements) over the memory
// rate; tensor cores have nothing to add.
//
// Design, against that bound:
// - the caches are (b, n_kv, total, d) row-major: one K or V row of d = 64
//   bf16 is one 128-byte line, read as 16-byte vectors by 8 neighbouring
//   lanes, so a warp reads 4 whole rows per load instruction. (The TPU kernel
//   kept K transposed and `total` padded to 128 for its lane tiling; neither
//   carries over.)
// - one block per (kv head, batch row, tile of GT group members): 256 blocks
//   at b 16 x 16 heads instead of the TPU grid of b. The group's query rows
//   live in registers and share each K/V vector read.
// - two passes inside the block, scores in shared memory (GT * total floats):
//   pass 1 streams K once (warps split the positions, dot products reduced
//   with shuffles), then the block reduces max and sum; pass 2 streams V once
//   with p = e / sum rounded to the cache dtype BEFORE the product, which is
//   exactly the plain version's arithmetic (an online softmax would have to
//   round p before it knows the sum). Warps combine their accumulators
//   through shared memory.
// - a fully masked row (every bias -1e9) collapses to s = -1e9 everywhere in
//   fp32, so p is uniform over the `total` positions given: the same as the
//   plain version on an unpadded cache.
// There is no split over positions across blocks: at b = 1 only n_kv blocks
// run (streaming); a second combine pass is the known next step.

#include <cstdint>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using f5::from_f;
using f5::rnd;

constexpr int NW = 8;  // warps per block
constexpr int NTHREADS = NW * 32;
constexpr int MAX_SMEM = 232448 - 1024;  // bytes of dynamic shared memory a block may ask for on sm_90 (1 KB kept for the static arrays)

// 16-byte vector of T, unpacked to floats.
template <typename T> struct Vec;
template <> struct Vec<float> {
    static constexpr int E = 4;
    static __device__ __forceinline__ void load(const float* p, float (&out)[4]) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(p));
        out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
    }
};
template <> struct Vec<bf16> {
    static constexpr int E = 8;
    static __device__ __forceinline__ void load(const bf16* p, float (&out)[8]) {
        const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const float2 f = __bfloat1622float2(h[i]);
            out[2 * i] = f.x;
            out[2 * i + 1] = f.y;
        }
    }
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
    return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
    return x;
}

// q, o: (b, h, d); k, v: (b, n_kv, total, d); bias: (b, total) fp32.
// grid (n_kv, b, ceil(group / GT)), NTHREADS threads,
// dynamic shared memory (GT * total + NW * GT * D) floats.
template <typename T, int D, int GT>
__global__ void __launch_bounds__(NTHREADS)
decode_attn(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const float* __restrict__ bias, T* __restrict__ o, int h, int n_kv, int total) {
    constexpr int E = Vec<T>::E;    // elements per 16-byte vector
    constexpr int LPR = D / E;      // lanes that cover one cache row
    constexpr int RPW = 32 / LPR;   // cache rows a warp reads per instruction
    static_assert(LPR >= 1 && LPR <= 32 && 32 % LPR == 0, "head dim must tile a warp");

    extern __shared__ __align__(16) float smem[];
    float* S = smem;                       // (GT, total) scores, then exp(s - max)
    float* red = smem + (size_t)GT * total;  // (NW, GT, D) per-warp accumulators
    __shared__ float wmax[NW][GT];
    __shared__ float wsum[NW][GT];

    const int kvh = blockIdx.x, bi = blockIdx.y;
    const int group = h / n_kv;
    const int g0 = blockIdx.z * GT;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int sub = lane / LPR;  // which of the warp's RPW rows
    const int c = lane % LPR;    // which 16-byte vector of the row

    float qr[GT][E];
#pragma unroll
    for (int g = 0; g < GT; ++g) {
        if (g0 + g < group) {
            Vec<T>::load(q + ((size_t)bi * h + (size_t)kvh * group + g0 + g) * D + c * E, qr[g]);
        } else {
#pragma unroll
            for (int e = 0; e < E; ++e) qr[g][e] = 0.0f;
        }
    }

    const size_t cache_off = ((size_t)bi * n_kv + kvh) * (size_t)total * D;
    const T* kb = k + cache_off;
    const T* vb = v + cache_off;
    const float* bb = bias + (size_t)bi * total;

    // ---- pass 1: scores ----------------------------------------------------
    float mx[GT];
#pragma unroll
    for (int g = 0; g < GT; ++g) mx[g] = -INFINITY;
#pragma unroll 4
    for (int base = warp * RPW; base < total; base += NW * RPW) {
        const int pos = base + sub;
        const bool ok = pos < total;
        float kv[E];
        if (ok) {
            Vec<T>::load(kb + (size_t)pos * D + c * E, kv);
        } else {
#pragma unroll
            for (int e = 0; e < E; ++e) kv[e] = 0.0f;
        }
        const float bv = ok ? __ldg(bb + pos) : 0.0f;
#pragma unroll
        for (int g = 0; g < GT; ++g) {
            float s = 0.0f;
#pragma unroll
            for (int e = 0; e < E; ++e) s += qr[g][e] * kv[e];
#pragma unroll
            for (int off = LPR / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
            s += bv;
            if (ok) {
                mx[g] = fmaxf(mx[g], s);
                if (c == 0) S[(size_t)g * total + pos] = s;
            }
        }
    }
#pragma unroll
    for (int g = 0; g < GT; ++g) {
        const float m = warp_max(mx[g]);
        if (lane == 0) wmax[warp][g] = m;
    }
    __syncthreads();  // scores and per-warp maxima are visible

    // ---- softmax numerators and their sum ----------------------------------
    float den[GT];
#pragma unroll
    for (int g = 0; g < GT; ++g) {
        float m = wmax[0][g];
#pragma unroll
        for (int w = 1; w < NW; ++w) m = fmaxf(m, wmax[w][g]);
        float sum = 0.0f;
        for (int i = tid; i < total; i += NTHREADS) {
            const float e = expf(S[(size_t)g * total + i] - m);
            S[(size_t)g * total + i] = e;
            sum += e;
        }
        sum = warp_sum(sum);
        if (lane == 0) wsum[warp][g] = sum;
    }
    __syncthreads();  // numerators and per-warp sums are visible
#pragma unroll
    for (int g = 0; g < GT; ++g) {
        float sum = 0.0f;
#pragma unroll
        for (int w = 0; w < NW; ++w) sum += wsum[w][g];
        den[g] = fmaxf(sum, 1e-30f);
    }

    // ---- pass 2: o = p . V -------------------------------------------------
    float acc[GT][E];
#pragma unroll
    for (int g = 0; g < GT; ++g)
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] = 0.0f;
#pragma unroll 4
    for (int base = warp * RPW; base < total; base += NW * RPW) {
        const int pos = base + sub;
        if (pos < total) {
            float vv[E];
            Vec<T>::load(vb + (size_t)pos * D + c * E, vv);
#pragma unroll
            for (int g = 0; g < GT; ++g) {
                const float p = rnd<T>(S[(size_t)g * total + pos] / den[g]);
#pragma unroll
                for (int e = 0; e < E; ++e) acc[g][e] += p * vv[e];
            }
        }
    }
    // rows of one warp, then warps through shared memory
#pragma unroll
    for (int g = 0; g < GT; ++g)
#pragma unroll
        for (int e = 0; e < E; ++e) {
            float a = acc[g][e];
#pragma unroll
            for (int off = LPR; off < 32; off <<= 1) a += __shfl_xor_sync(0xffffffffu, a, off);
            if (sub == 0) red[((size_t)warp * GT + g) * D + c * E + e] = a;
        }
    __syncthreads();
    for (int idx = tid; idx < GT * D; idx += NTHREADS) {
        const int g = idx / D, dd = idx % D;
        if (g0 + g >= group) continue;
        float a = 0.0f;
#pragma unroll
        for (int w = 0; w < NW; ++w) a += red[((size_t)w * GT + g) * D + dd];
        o[((size_t)bi * h + (size_t)kvh * group + g0 + g) * D + dd] = from_f<T>(a);
    }
}

template <typename T, int D, int GT>
int launch(const void* q, const void* k, const void* v, const void* bias, void* o, int b, int h, int n_kv,
           int total, cudaStream_t stream) {
    const int group = h / n_kv;
    const size_t smem = ((size_t)GT * total + (size_t)NW * GT * D) * sizeof(float);
    if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(decode_attn<T, D, GT>,
                                                     cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    const dim3 grid(n_kv, b, (group + GT - 1) / GT);
    decode_attn<T, D, GT><<<grid, NTHREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const float*>(bias), static_cast<T*>(o), h, n_kv, total);
    return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_g(const void* q, const void* k, const void* v, const void* bias, void* o, int b, int h, int n_kv,
             int total, cudaStream_t stream) {
    const int group = h / n_kv;
    if (group == 1) return launch<T, D, 1>(q, k, v, bias, o, b, h, n_kv, total, stream);
    if (group == 2) return launch<T, D, 2>(q, k, v, bias, o, b, h, n_kv, total, stream);
    return launch<T, D, 4>(q, k, v, bias, o, b, h, n_kv, total, stream);  // larger groups: tiles of 4
}

template <typename T>
int launch_d(int d, const void* q, const void* k, const void* v, const void* bias, void* o, int b, int h,
             int n_kv, int total, cudaStream_t stream) {
    switch (d) {
        case 32: return launch_g<T, 32>(q, k, v, bias, o, b, h, n_kv, total, stream);
        case 64: return launch_g<T, 64>(q, k, v, bias, o, b, h, n_kv, total, stream);
        case 128: return launch_g<T, 128>(q, k, v, bias, o, b, h, n_kv, total, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" {

// q, o: (b, h, 1, d) contiguous; k, v: (b, n_kv, total, d) contiguous; all
// bf16 (is_bf16 = 1) or fp32; bias: (b, total) fp32. Returns the cudaError_t
// of the launch.
int f5_decode_attention(const void* q, const void* k, const void* v, const void* bias, void* o, int b, int h,
                        int n_kv, int total, int d, int is_bf16, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (b < 1 || b > 65535 || n_kv < 1 || h % n_kv != 0 || total < 1) return (int)cudaErrorInvalidValue;
    if (is_bf16) return launch_d<bf16>(d, q, k, v, bias, o, b, h, n_kv, total, s);
    return launch_d<float>(d, q, k, v, bias, o, b, h, n_kv, total, s);
}

// Bytes of shared memory the launch above asks for, and the most a block may have.
long long f5_decode_attention_smem(int group, int total, int d) {
    const int gt = group == 1 ? 1 : (group == 2 ? 2 : 4);
    return ((long long)gt * total + (long long)NW * gt * d) * (long long)sizeof(float);
}
int f5_decode_attention_max_smem() { return MAX_SMEM; }

const char* f5_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
