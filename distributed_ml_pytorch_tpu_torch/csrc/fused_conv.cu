// relu_pool2: m = maxpool2x2(relu(x [+ b])) over NHWC float32, forward and
// backward.
//
// Replaces: distributed_ml_pytorch_tpu/ops/fused_conv.py, _relu_pool_pallas
//   forward (pallas_call at :321, body _pool_kernel at :243) and backward
//   (pallas_call at :311, body _pool_bwd_kernel at :261) — the conv epilogue
//   of AlexNet(fused_epilogue=True).
// Bound on an H100: bytes. The forward reads x once and writes a quarter of
//   its size; the backward reads x, m and g and writes dx; each element costs
//   a handful of compares, far below the card's flop/byte ridge.
// Design: one thread per pooled output (n, h2, w2, c), channels innermost, so
//   neighbouring threads read neighbouring channels of the same window slot
//   and every load and store is coalesced. The TPU kernel restructured the
//   windows with a free reshape so that slots sat on static axes; here each
//   thread computes the four slot offsets itself from (n, h2, w2, c) and the
//   strides, and needs no shared memory. The thread re-derives relu(x + b)
//   in the backward instead of saving it, as the TPU kernel does. The
//   optional bias is read per channel; AlexNet keeps its bias in the conv and
//   passes none. No reduction crosses threads, so the grid needs no masks
//   beyond its bound.
// Numerics: the forward uses the same adds and maxima as the plain version
//   (relu as v > 0 ? v : 0, then max(max(y00, y01), max(y10, y11))), so it is
//   bit-identical; the backward sends each window's cotangent to the FIRST
//   maximal slot in window row-major order (0,0), (0,1), (1,0), (1,1), masked
//   by m > 0 (relu's gradient at 0 is 0), and writes zeros to the other
//   three slots. db is reduced outside, as in JAX.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;

struct Window {
    long long base;  // offset of slot (0,0)
    long long dw;    // offset of slot (0,1) from (0,0): C
    long long dh;    // offset of slot (1,0) from (0,0): W*C
};

__device__ __forceinline__ Window window_of(long long idx, int H, int W, int C,
                                            int* c_out) {
    const int H2 = H / 2, W2 = W / 2;
    const int c = (int)(idx % C);
    long long t = idx / C;
    const int w2 = (int)(t % W2);
    t /= W2;
    const int h2 = (int)(t % H2);
    const long long n = t / H2;
    *c_out = c;
    Window win;
    win.base = ((n * H + 2LL * h2) * W + 2LL * w2) * C + c;
    win.dw = C;
    win.dh = (long long)W * C;
    return win;
}

__device__ __forceinline__ float relu_b(float v, const float* bias, int c) {
    if (bias != nullptr) v = __fadd_rn(v, bias[c]);
    return v > 0.0f ? v : 0.0f;
}

__global__ void relu_pool2_fwd(const float* __restrict__ x, const float* __restrict__ bias,
                               float* __restrict__ m, long long total, int H, int W,
                               int C) {
    const long long stride = (long long)blockDim.x * gridDim.x;
    for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
         idx += stride) {
        int c;
        const Window w = window_of(idx, H, W, C, &c);
        const float y00 = relu_b(x[w.base], bias, c);
        const float y01 = relu_b(x[w.base + w.dw], bias, c);
        const float y10 = relu_b(x[w.base + w.dh], bias, c);
        const float y11 = relu_b(x[w.base + w.dh + w.dw], bias, c);
        m[idx] = fmaxf(fmaxf(y00, y01), fmaxf(y10, y11));
    }
}

__global__ void relu_pool2_bwd(const float* __restrict__ x, const float* __restrict__ bias,
                               const float* __restrict__ m, const float* __restrict__ g,
                               float* __restrict__ dx, long long total, int H, int W,
                               int C) {
    const long long stride = (long long)blockDim.x * gridDim.x;
    for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
         idx += stride) {
        int c;
        const Window w = window_of(idx, H, W, C, &c);
        const float y00 = relu_b(x[w.base], bias, c);
        const float y01 = relu_b(x[w.base + w.dw], bias, c);
        const float y10 = relu_b(x[w.base + w.dh], bias, c);
        const float y11 = relu_b(x[w.base + w.dh + w.dw], bias, c);
        const float mm = m[idx];
        const float gm = mm > 0.0f ? g[idx] : 0.0f;
        const bool e00 = y00 == mm;
        const bool e01 = !e00 && y01 == mm;
        const bool e10 = !e00 && !e01 && y10 == mm;
        const bool e11 = !e00 && !e01 && !e10 && y11 == mm;
        dx[w.base] = e00 ? gm : 0.0f;
        dx[w.base + w.dw] = e01 ? gm : 0.0f;
        dx[w.base + w.dh] = e10 ? gm : 0.0f;
        dx[w.base + w.dh + w.dw] = e11 ? gm : 0.0f;
    }
}

unsigned blocks_for(long long total) {
    long long blocks = (total + kThreads - 1) / kThreads;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    if (blocks < 1) blocks = 1;
    return (unsigned)blocks;
}

}  // namespace

extern "C" int dmt_relu_pool2_fwd_f32(const void* x, const void* bias, void* m, int N,
                                      int H, int W, int C, void* stream) {
    const long long total = (long long)N * (H / 2) * (W / 2) * C;
    if (total <= 0) return (int)cudaGetLastError();
    relu_pool2_fwd<<<blocks_for(total), kThreads, 0,
                     reinterpret_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(bias),
        static_cast<float*>(m), total, H, W, C);
    return (int)cudaGetLastError();
}

extern "C" int dmt_relu_pool2_bwd_f32(const void* x, const void* bias, const void* m,
                                      const void* g, void* dx, int N, int H, int W, int C,
                                      void* stream) {
    const long long total = (long long)N * (H / 2) * (W / 2) * C;
    if (total <= 0) return (int)cudaGetLastError();
    relu_pool2_bwd<<<blocks_for(total), kThreads, 0,
                     reinterpret_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(bias),
        static_cast<const float*>(m), static_cast<const float*>(g),
        static_cast<float*>(dx), total, H, W, C);
    return (int)cudaGetLastError();
}
