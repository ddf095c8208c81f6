// Tensor-core building blocks for Hopper (sm_90a) kernels written with
// mma.sync and cp.async: 16- and 4-byte asynchronous copies into shared memory,
// ldmatrix fragment loads, the m16n8k16 bf16 product with f32 accumulate,
// and the packing of f32 accumulators into bf16 A fragments.
//
// Fragment layout of mma.m16n8k16 (lane = 4 * g + t, g = lane / 4, t = lane % 4):
//   A (16 x 16, row-major), 4 x b32: a0 = (row g,     cols 2t, 2t+1)
//                                    a1 = (row g + 8, cols 2t, 2t+1)
//                                    a2 = (row g,     cols 2t+8, 2t+9)
//                                    a3 = (row g + 8, cols 2t+8, 2t+9)
//   B (16 x 8, k x n, "col"), 2 x b32: b0 = (k 2t, 2t+1; n g), b1 = (k 2t+8, 2t+9; n g)
//   C (16 x 8, f32), 4 floats:      c0, c1 = (row g, cols 2t, 2t+1)
//                                    c2, c3 = (row g + 8, cols 2t, 2t+1)
// ldmatrix.x4 loads four 8 x 8 b16 matrices; lanes 8i .. 8i+7 give the row
// addresses of matrix i, and register i of every lane receives matrix i in
// the A/B layout above (row g, elements 2t, 2t+1), or transposed with .trans.
// So two adjacent n8 tiles of a C accumulator, packed to bf16, are exactly
// one k16 A fragment: (c[2j][0,1], c[2j][2,3], c[2j+1][0,1], c[2j+1][2,3]).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously (L2 only, .cg);
// with valid false the 16 bytes are zero-filled and nothing is read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
    const int n = valid ? 16 : 0;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(n) : "memory");
}

// 4 bytes from global to shared memory, asynchronously (.ca, the only kind
// below 16 bytes); with valid false the 4 bytes are zero-filled
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
    const int n = valid ? 4 : 0;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_u32(p)) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_u32(p)) : "memory");
}

// c += a * b for one m16n8k16 tile: bf16 operands, f32 accumulator
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 values rounded to nearest bf16, lo in the low half (the lower
// column of a fragment)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

// the k16 A fragment made of two adjacent n8 accumulator tiles
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
    a[0] = pack_bf16(c0[0], c0[1]);
    a[1] = pack_bf16(c0[2], c0[3]);
    a[2] = pack_bf16(c1[0], c1[1]);
    a[3] = pack_bf16(c1[2], c1[3]);
}

}  // namespace tc
