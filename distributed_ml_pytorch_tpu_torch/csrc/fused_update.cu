// flat_axpy: y <- y + alpha * x over a flat float32 vector, in place.
//
// Replaces: distributed_ml_pytorch_tpu/ops/fused_update.py, _flat_axpy_pallas
//   (pallas_call at :57, body _axpy_kernel at :49) — the DownPour accumulator
//   that runs on every worker step (parallel/async_ps.py:1039).
// Bound on an H100: bytes. Each element reads y and x and writes y (12 B) for
//   two flops, far below the card's ~20 flop/B ridge; at the AlexNet length
//   (2,472,320) that is 29.7 MB, which also fits in the 50 MB L2.
// Design: one grid-stride kernel with 16-byte (float4) loads and stores, so
//   each thread moves whole 128-bit words and neighbouring threads touch
//   neighbouring addresses; a scalar tail covers a length that is not a
//   multiple of 4 (the TPU kernel needed 128-lane rows, this one takes any
//   length), and a scalar variant covers pointers that are not 16-byte
//   aligned. The grid is capped at a few waves of blocks per SM, which is
//   enough to keep the memory system busy at this size.
// In place: y is updated in its own buffer, as the TPU kernel aliases its
//   output onto y (input_output_aliases={1: 0}); this is the one in-place
//   update the port makes to an input.
// Rounding: __fadd_rn(y, __fmul_rn(alpha, x)) rounds the product and then
//   the sum, as the JAX and plain PyTorch versions do, so nvcc cannot
//   contract it into one FMA: the kernel is bit-identical to the plain
//   version for every alpha, not only alpha = 1.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 8;

__device__ __forceinline__ float axpy1(float y, float x, float alpha) {
    return __fadd_rn(y, __fmul_rn(alpha, x));
}

__global__ void flat_axpy_vec4(float* __restrict__ y, const float* __restrict__ x,
                               float alpha, long long n) {
    const long long n4 = n >> 2;
    float4* y4 = reinterpret_cast<float4*>(y);
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const long long stride = (long long)blockDim.x * gridDim.x;
    const long long start = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    for (long long i = start; i < n4; i += stride) {
        float4 a = y4[i];
        const float4 b = x4[i];
        a.x = axpy1(a.x, b.x, alpha);
        a.y = axpy1(a.y, b.y, alpha);
        a.z = axpy1(a.z, b.z, alpha);
        a.w = axpy1(a.w, b.w, alpha);
        y4[i] = a;
    }
    for (long long i = (n4 << 2) + start; i < n; i += stride) {
        y[i] = axpy1(y[i], x[i], alpha);
    }
}

__global__ void flat_axpy_scalar(float* __restrict__ y, const float* __restrict__ x,
                                 float alpha, long long n) {
    const long long stride = (long long)blockDim.x * gridDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += stride) {
        y[i] = axpy1(y[i], x[i], alpha);
    }
}

}  // namespace

extern "C" int dmt_flat_axpy_f32(void* y, const void* x, float alpha, long long n,
                                 void* stream) {
    if (n <= 0) return (int)cudaGetLastError();
    const bool aligned = ((uintptr_t)y % 16 == 0) && ((uintptr_t)x % 16 == 0);
    const long long work = aligned ? (n + 3) / 4 : n;
    long long blocks = (work + kThreads - 1) / kThreads;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    if (aligned) {
        flat_axpy_vec4<<<(unsigned)blocks, kThreads, 0, s>>>(
            static_cast<float*>(y), static_cast<const float*>(x), alpha, n);
    } else {
        flat_axpy_scalar<<<(unsigned)blocks, kThreads, 0, s>>>(
            static_cast<float*>(y), static_cast<const float*>(x), alpha, n);
    }
    return (int)cudaGetLastError();
}
