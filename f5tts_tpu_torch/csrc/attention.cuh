// Shared helpers of the attention kernels: the key bias, mma.sync m16n8k16
// (bf16 in, fp32 accumulate), fragment loads, cp.async.
//
// Fragment layout of mma.sync.m16n8k16 (g = lane / 4, tq = lane % 4):
//   A (16 x 16, row-major): a[0] = A[g][2tq..2tq+1],  a[1] = A[g+8][2tq..],
//                           a[2] = A[g][2tq+8..],      a[3] = A[g+8][2tq+8..]
//   B (16 x 8, "col"):      b0 = B[2tq..2tq+1][g],     b1 = B[2tq+8..2tq+9][g]
//   C (16 x 8, fp32):       c[0..1] = C[g][2tq..],     c[2..3] = C[g+8][2tq..]
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace f5 {

using bf16 = __nv_bfloat16;

// Additive bias of keys [k0, k0 + TILE): 0 valid, -1e30 masked, -inf past n
// (keys past n contribute exactly nothing); threads of the block share the work.
template <int TILE, int THREADS>
__device__ __forceinline__ void stage_key_bias(float* bias, const uint8_t* key_mask, int b, int n, int k0, int tid) {
    for (int j = tid; j < TILE; j += THREADS) {
        const int key = k0 + j;
        bias[j] = key >= n ? -INFINITY : (key_mask != nullptr && !key_mask[(size_t)b * n + key] ? -1e30f : 0.0f);
    }
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) { return *reinterpret_cast<const uint32_t*>(p); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

// d (16x8 fp32) += a (16x16 bf16, row) . b (16x8 bf16, col)
__device__ __forceinline__ void mma16816(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment of rows [row0, row0 + 16), columns [col0, col0 + 16) of a
// row-major bf16 matrix with row stride ld (shared memory).
__device__ __forceinline__ void load_a(uint32_t* a, const bf16* m, int ld, int row0, int col0, int lane) {
    const bf16* p = m + (row0 + (lane >> 2)) * ld + col0 + (lane & 3) * 2;
    a[0] = ld32(p);
    a[1] = ld32(p + 8 * ld);
    a[2] = ld32(p + 8);
    a[3] = ld32(p + 8 * ld + 8);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy that bypasses registers; zero-fills when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
                 "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// Four transposed 8x8 bf16 tiles from shared memory: lane i addresses row i%8
// of tile i/8.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const bf16* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
}

// acc[nb] (16 x 8 blocks, nb < N/8) += a (16 x 16) . M[k0 .. k0+16][0 .. N)
// for a row-major (k, N) bf16 matrix M in shared memory with row stride ld:
// the B operand through transposed ldmatrix, two n-blocks per load.
template <int N>
__device__ __forceinline__ void mma_a_by_rows(float (*acc)[4], const uint32_t* a, const bf16* m, int ld, int k0,
                                              int lane) {
#pragma unroll
    for (int nb = 0; nb < N / 8; nb += 2) {
        uint32_t f[4];
        ldmatrix_x4_trans(f, m + (k0 + (lane & 8) + (lane & 7)) * ld + (nb + (lane >> 4)) * 8);
        mma16816(acc[nb], a, f[0], f[1]);
        mma16816(acc[nb + 1], a, f[2], f[3]);
    }
}

}  // namespace f5
