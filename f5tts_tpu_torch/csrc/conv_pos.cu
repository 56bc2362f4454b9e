// One grouped Conv1d + bias + Mish layer of the DiT's conv-position embedding
// for Hopper (sm_90a); run twice it is the conv-position pair.
//
// Replaces the TPU kernel f5tts_tpu/ops/pallas/conv_pos.py:conv_pos_pallas
// (_conv_pos_kernel), which fuses both layers with the intermediate in VMEM.
// Here the wrapper (ops/kernels/conv_pos.py) launches this kernel twice, with
// the intermediate y1 in device memory in x's type: the first version's
// chosen design. Fusing the pair with halo recompute across time tiles is
// later work.
//
// What one launch computes, for x (b, n, c) already masked by the caller,
// w (k, c/groups, c) with the group index on the output axis, "same" zero
// padding k//2:
//   y[b, t, o] = mish(bias[o] + sum_{tap, i} x[b, t + tap - k//2, g*cg + i] * w[tap, i, o]),
// g = o / cg, accumulated in fp32, Mish in fp32; with mask_rows set, rows
// t >= lens[b] are zeroed (the intermediate's row boundary); stored in x's type.
//
// What bounds it: at the main-path shape (x (16, 1024, 1024) bf16, k = 31,
// 16 groups of 64) the pair is 2 * 2*16*1024*1024*31*64 = 133 GFLOP, about
// 135 us at the 989 TFLOP/s bf16 peak, against about 4 x 33.5 MB of x/y1/y
// traffic (about 40 us at 3.35 TB/s): compute-bound.
//
// Design: one group's whole weight (31*64*64 bf16 = 254 KB) is larger than
// the 227 KB of shared memory a block can use, so a block covers (batch row,
// group, 64-frame time tile, all 64 output channels of the group). It stages
// the input slab (64 + k - 1, 64) once and walks the taps, staging one tap's
// (64, 64) weight slice at a time; each of its 4 warps owns 16 output frames
// and accumulates 4 WMMA bf16 16x16 fragments. fp32 inputs and group widths
// other than 64 take a CUDA-core loop with the same tiling.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "common.cuh"

using namespace nvcuda;
using f5::from_f;
using f5::to_f;

namespace {

constexpr int TT = 64;  // frames per block
constexpr int NTHREADS = 128;
constexpr int CG = 64;  // group width of the tensor-core path
// Padded shared-memory row stride (bf16 elements). A tap shifts the A tile by
// one row, and WMMA needs 32-byte aligned tile pointers, so a row is a
// multiple of 32 bytes: 80 elements = 160 bytes.
constexpr int LDX = CG + 16;
constexpr int LDA = CG + 4;  // padded fp32 accumulator stride

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

// Tensor-core path: bf16, group width 64.
__global__ void __launch_bounds__(NTHREADS)
conv_wmma_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                 const float* __restrict__ bias, const int* __restrict__ lens, __nv_bfloat16* __restrict__ y,
                 int n, int c, int k, int mask_rows) {
    extern __shared__ __align__(128) unsigned char smem_raw[];
    __nv_bfloat16* Xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // (TT + k - 1) x CG, stride LDX
    __nv_bfloat16* Ws = Xs + (TT + k - 1) * LDX;                      // CG x CG, stride LDX
    float* Acc = reinterpret_cast<float*>(Ws + CG * LDX);             // TT x CG, stride LDA

    const int t0 = blockIdx.x * TT;
    const int g = blockIdx.y;
    const int bi = blockIdx.z;
    const int pad = k / 2;
    const int tid = threadIdx.x;
    const int warp = tid / 32;

    for (int idx = tid; idx < (TT + k - 1) * CG; idx += NTHREADS) {
        const int r = idx / CG, i = idx % CG;
        const int t = t0 - pad + r;
        Xs[r * LDX + i] = (t >= 0 && t < n) ? x[((size_t)bi * n + t) * c + g * CG + i] : __float2bfloat16_rn(0.0f);
    }

    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bw;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[CG / 16];
#pragma unroll
    for (int j = 0; j < CG / 16; ++j) wmma::fill_fragment(acc[j], 0.0f);

    for (int tap = 0; tap < k; ++tap) {
        __syncthreads();  // the previous tap's weights are consumed (and the slab is staged)
        for (int idx = tid; idx < CG * CG; idx += NTHREADS) {
            const int i = idx / CG, o = idx % CG;
            Ws[i * LDX + o] = w[((size_t)tap * CG + i) * c + g * CG + o];
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < CG / 16; ++kk) {
            wmma::load_matrix_sync(a, Xs + (warp * 16 + tap) * LDX + kk * 16, LDX);
#pragma unroll
            for (int j = 0; j < CG / 16; ++j) {
                wmma::load_matrix_sync(bw, Ws + kk * 16 * LDX + j * 16, LDX);
                wmma::mma_sync(acc[j], a, bw, acc[j]);
            }
        }
    }
#pragma unroll
    for (int j = 0; j < CG / 16; ++j)
        wmma::store_matrix_sync(Acc + warp * 16 * LDA + j * 16, acc[j], LDA, wmma::mem_row_major);
    __syncthreads();

    for (int idx = tid; idx < TT * CG; idx += NTHREADS) {
        const int r = idx / CG, o = idx % CG;
        const int t = t0 + r;
        if (t < n) store_out(y, lens, Acc[r * LDA + o] + bias[g * CG + o], bi, t, n, c, g * CG + o, mask_rows);
    }
}

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

// x, y: (b, n, c) contiguous; w: (k, c/groups, c) contiguous, same type as x
// (bf16 when is_bf16 = 1, else fp32); bias: (c,) fp32; lens: (b,) int32.
// Returns the cudaError_t of the launch.
int f5_conv_pos_layer(const void* x, const void* w, const void* bias, const void* lens, void* y, int b, int n,
                      int c, int groups, int k, int is_bf16, int mask_rows, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int cg = c / groups;
    const dim3 grid((n + TT - 1) / TT, groups, b);
    const float* bs = static_cast<const float*>(bias);
    const int* ls = static_cast<const int*>(lens);
    cudaError_t err;
    if (is_bf16 && cg == CG) {
        const size_t smem = (size_t)((TT + k - 1) * LDX + CG * LDX) * sizeof(__nv_bfloat16) + (size_t)TT * LDA * sizeof(float);
        err = cudaFuncSetAttribute(conv_wmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
        conv_wmma_kernel<<<grid, NTHREADS, smem, s>>>(
            static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w), bs, ls,
            static_cast<__nv_bfloat16*>(y), n, c, k, mask_rows);
    } else if (is_bf16) {
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

const char* f5_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
