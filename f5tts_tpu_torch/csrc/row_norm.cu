// The backbones' row norms in one pass, for Hopper (sm_90a): AdaLN's modulated
// layer norm (the DiT and the MMDiT) and the UNetT's RMSNorm.
//
// Replaces no TPU kernel. The JAX package spells both norms out
// (f5tts_tpu/models/modules.py:layer_norm with adaln_zero's modulation, and
// rms_norm), and XLA fused each chain into one pass on the TPU. Eager PyTorch
// runs every op of the chain as a launch of its own over an fp32 copy of the
// activation: ~13 launches and ~15 full passes a site. This kernel is that
// fusion, written by hand for the port's call sites
// (f5tts_tpu_torch/models/modules.py:modulated_layer_norm and rms_norm).
//
// What it computes, for each row r of x (rows, c), in fp32 from x's type and
// rounded once to x's type:
//   MOD  y = (x - mean) * rsqrt(var + eps) * (1 + scale[r / n]) + shift[r / n],
//        mean and var taken in two passes over the row, as the plain chain does;
//   RMS  y = x * rsqrt(max(sum x^2, eps)) * sqrt(c) * g.
// scale and shift are (b, c) rows read through a row stride (chunks of the
// AdaLN projection: a stride of 6c or 2c) in x's type, g is (c,) in bf16 or fp32.
//
// What bounds it: bytes. At the main-path shape (16 384 rows of 1024 bf16, the
// fused-CFG batch of 8 x 1024 frames) the row is read once and written once,
// 2 * 16 384 * 1024 * 2 B = 67.1 MB, plus 2 * 16 * 1024 * 2 B of scale and
// shift: 20.0 us at 3.35 TB/s. About ten flops an element are nothing beside it.
//
// Design: one warp a row, eight rows a block. Each lane issues all its 16-byte
// loads of the row first (NV pieces; NV * 32 lanes * 16 B cover the row), keeps
// the row in registers as fp32, and takes both sums with warp shuffles: the row
// crosses device memory once each way and nothing goes through shared memory.
// The vectors come in the same pieces (8, 16 or 32 bytes, by their type) while
// the row is written. NV is a template argument (1, 2, 4, 8, 16), the smallest
// that covers c; pieces past the row's end are predicated off. At c 1024 bf16 a
// lane holds 32 floats, so tens of warps fit an SM and some 4000 rows (8 MB)
// are in flight over the card's 132 SMs, more than the memory's latency needs.
// Takes c % 8 == 0 up to 4096 (bf16) or 2048 (fp32).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int WARPS = 8;  // rows a block
constexpr int MAX_NV = 16;

// fp32 <-> the 32-bit words of a type's storage (bf16: two to a word, the first in the low half)
template <typename T> struct Words;
template <> struct Words<float> {
    static constexpr int PER = 1;
    __device__ __forceinline__ static void unpack(uint32_t w, float* f) { f[0] = __uint_as_float(w); }
    __device__ __forceinline__ static uint32_t pack(const float* f) { return __float_as_uint(f[0]); }
};
template <> struct Words<bf16> {
    static constexpr int PER = 2;
    __device__ __forceinline__ static void unpack(uint32_t w, float* f) {
        f[0] = __uint_as_float(w << 16);
        f[1] = __uint_as_float(w & 0xffff0000u);
    }
    __device__ __forceinline__ static uint32_t pack(const float* f) {
        return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(f[0]))
               | ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(f[1])) << 16);
    }
};

// N elements of T at p (N * sizeof(T) = 8, 16 or 32 bytes, aligned to that) as fp32
template <typename T, int N>
__device__ __forceinline__ void load(const T* p, float* out) {
    constexpr int W = N / Words<T>::PER;
    static_assert(W == 2 || W % 4 == 0, "a piece is 8, 16 or 32 bytes");
    uint32_t w[W];
    if constexpr (W == 2) {
        const uint2 v = *reinterpret_cast<const uint2*>(p);
        w[0] = v.x;
        w[1] = v.y;
    } else {
#pragma unroll
        for (int i = 0; i < W / 4; ++i) {
            const uint4 v = reinterpret_cast<const uint4*>(p)[i];
            w[4 * i] = v.x;
            w[4 * i + 1] = v.y;
            w[4 * i + 2] = v.z;
            w[4 * i + 3] = v.w;
        }
    }
#pragma unroll
    for (int i = 0; i < W; ++i) Words<T>::unpack(w[i], out + i * Words<T>::PER);
}

// 16 bytes of T at p from fp32, rounded once
template <typename T>
__device__ __forceinline__ void store16(T* p, const float* in) {
    constexpr int PER = Words<T>::PER;
    *reinterpret_cast<uint4*>(p) = make_uint4(Words<T>::pack(in), Words<T>::pack(in + PER),
                                              Words<T>::pack(in + 2 * PER), Words<T>::pack(in + 3 * PER));
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    return s;
}

template <typename T, typename V, bool MOD, int NV>
__global__ void __launch_bounds__(WARPS * 32)
row_norm_kernel(const T* __restrict__ x, T* __restrict__ y, const V* __restrict__ va, const V* __restrict__ vb,
                long long vstride, long long rows, int n, int c, float eps, float sqrt_c) {
    constexpr int E = 16 / sizeof(T);  // elements in a 16-byte piece of the row
    const long long row = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (row >= rows) return;  // the whole warp: the shuffles below see every lane
    const int pieces = c / E;
    const T* xr = x + row * c;
    T* yr = y + row * c;
    float v[NV][E];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
        const int p = lane + 32 * i;
        if (p < pieces) {
            load<T, E>(xr + p * E, v[i]);
        } else {
#pragma unroll
            for (int e = 0; e < E; ++e) v[i][e] = 0.0f;
        }
    }
    float s = 0.0f;
    if constexpr (MOD) {
#pragma unroll
        for (int i = 0; i < NV; ++i)
#pragma unroll
            for (int e = 0; e < E; ++e) s += v[i][e];
        const float mean = warp_sum(s) / (float)c;
        float q = 0.0f;
#pragma unroll
        for (int i = 0; i < NV; ++i) {
            if (lane + 32 * i < pieces) {
#pragma unroll
                for (int e = 0; e < E; ++e) {
                    v[i][e] -= mean;
                    q += v[i][e] * v[i][e];
                }
            }
        }
        const float rstd = rsqrtf(warp_sum(q) / (float)c + eps);
        const long long bi = row / n;
        const V* sr = va + bi * vstride;
        const V* hr = vb + bi * vstride;
#pragma unroll
        for (int i = 0; i < NV; ++i) {
            const int p = lane + 32 * i;
            if (p < pieces) {
                float sc[E], sh[E], out[E];
                load<V, E>(sr + p * E, sc);
                load<V, E>(hr + p * E, sh);
#pragma unroll
                for (int e = 0; e < E; ++e) out[e] = v[i][e] * rstd * (1.0f + sc[e]) + sh[e];
                store16<T>(yr + p * E, out);
            }
        }
    } else {
#pragma unroll
        for (int i = 0; i < NV; ++i)
#pragma unroll
            for (int e = 0; e < E; ++e) s += v[i][e] * v[i][e];
        const float r = rsqrtf(fmaxf(warp_sum(s), eps));
#pragma unroll
        for (int i = 0; i < NV; ++i) {
            const int p = lane + 32 * i;
            if (p < pieces) {
                float g[E], out[E];
                load<V, E>(va + p * E, g);
#pragma unroll
                for (int e = 0; e < E; ++e) out[e] = v[i][e] * r * sqrt_c * g[e];
                store16<T>(yr + p * E, out);
            }
        }
    }
}

template <typename T, typename V, bool MOD>
int launch(const void* x, void* y, const void* va, const void* vb, long long vstride, long long rows, int n, int c,
           float eps, cudaStream_t s) {
    constexpr int E = 16 / sizeof(T);
    const int per_lane = (c / E + 31) / 32;
    const long long blocks = (rows + WARPS - 1) / WARPS;
    if (per_lane > MAX_NV || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)blocks), block(WARPS * 32);
    const T* xp = static_cast<const T*>(x);
    T* yp = static_cast<T*>(y);
    const V* ap = static_cast<const V*>(va);
    const V* bp = static_cast<const V*>(vb);
    const float sqrt_c = sqrtf((float)c);
    if (per_lane <= 1)
        row_norm_kernel<T, V, MOD, 1><<<grid, block, 0, s>>>(xp, yp, ap, bp, vstride, rows, n, c, eps, sqrt_c);
    else if (per_lane <= 2)
        row_norm_kernel<T, V, MOD, 2><<<grid, block, 0, s>>>(xp, yp, ap, bp, vstride, rows, n, c, eps, sqrt_c);
    else if (per_lane <= 4)
        row_norm_kernel<T, V, MOD, 4><<<grid, block, 0, s>>>(xp, yp, ap, bp, vstride, rows, n, c, eps, sqrt_c);
    else if (per_lane <= 8)
        row_norm_kernel<T, V, MOD, 8><<<grid, block, 0, s>>>(xp, yp, ap, bp, vstride, rows, n, c, eps, sqrt_c);
    else
        row_norm_kernel<T, V, MOD, 16><<<grid, block, 0, s>>>(xp, yp, ap, bp, vstride, rows, n, c, eps, sqrt_c);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x, y: (rows, c) contiguous, 16-byte aligned, bf16 (x_bf16 = 1) or fp32; c % 8 == 0.
// mod = 1: the modulated layer norm; va = scale, vb = shift, each b = rows / n rows of c
//   elements a row stride of vstride elements apart.
// mod = 0: the RMS norm; va = g (c,), vb unused.
// The vectors are bf16 (v_bf16 = 1) or fp32, scale and shift in x's type, each piece of
// 16 / sizeof(x) elements aligned to its own size. Returns the cudaError_t of the launch
// (cudaErrorInvalidValue for a shape or a pair of types it does not take).
int f5_row_norm(const void* x, void* y, const void* va, const void* vb, long long vstride, long long rows, int n,
                int c, float eps, int x_bf16, int v_bf16, int mod, void* stream) {
    if (rows < 1 || n < 1 || c < 8 || c % 8 != 0 || va == nullptr || (mod && (vb == nullptr || v_bf16 != x_bf16)))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (mod)
        return x_bf16 ? launch<bf16, bf16, true>(x, y, va, vb, vstride, rows, n, c, eps, s)
                      : launch<float, float, true>(x, y, va, vb, vstride, rows, n, c, eps, s);
    if (x_bf16)
        return v_bf16 ? launch<bf16, bf16, false>(x, y, va, vb, vstride, rows, n, c, eps, s)
                      : launch<bf16, float, false>(x, y, va, vb, vstride, rows, n, c, eps, s);
    return v_bf16 ? launch<float, bf16, false>(x, y, va, vb, vstride, rows, n, c, eps, s)
                  : launch<float, float, false>(x, y, va, vb, vstride, rows, n, c, eps, s);
}

const char* f5_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
