// relu_pool2: m = maxpool2x2(relu(x [+ b])) over NHWC float32 or bfloat16,
// forward and backward.
//
// Replaces: distributed_ml_pytorch_tpu/ops/fused_conv.py, _relu_pool_pallas
//   forward (pallas_call at :321, body _pool_kernel at :243) and backward
//   (pallas_call at :311, body _pool_bwd_kernel at :261) — the conv epilogue
//   of AlexNet(fused_epilogue=True).
// Bound on an H100: bytes. The forward reads x once and writes a quarter of
//   its size; the backward reads x, m and g and writes dx; each element costs
//   a handful of compares, far below the card's flop/byte ridge.
// Design: one thread per pooled output group (n, h2, w2, V channels),
//   channels innermost, so neighbouring threads read neighbouring channels
//   of the same window slot and every load and store is coalesced. The
//   vector route (V = 4: C % 4 == 0 and every pointer 16-byte aligned, which
//   all of AlexNet's tails meet) moves each window slot, bias, m, g and dx
//   as one 16-byte float4; the scalar route (V = 1) takes any C and any
//   alignment. The grid has one thread per group, no grid-stride loop. The
//   index arithmetic is 32-bit (the wrapper and the entry points refuse
//   tensors of 2^31 elements or more) with the two divisions it needs done
//   as a multiply-high by a magic number computed on the host, since the
//   card emulates integer division in dozens of instructions: the pooled
//   row r = n*H2 + h2 and w2 come from t / (C/V) and / W2, and the slot
//   (0,0) of the window sits at ((2r)*W + 2*w2)*C + c because n*H + 2*h2 =
//   2r. The TPU kernel restructured the windows with a free reshape so that
//   slots sat on static axes; here each thread computes the four slot
//   offsets itself and needs no shared memory. The thread re-derives
//   relu(x + b) in the backward instead of saving it, as the TPU kernel
//   does. No reduction crosses threads.
// Every load and store carries a streaming hint (__ldcs/__stcs: each byte
//   is touched once, so it is evicted first), and a block has 128 threads.
// bfloat16: the same kernels over the element type. The vector route moves
//   16 bytes (8 channels) a load when C % 8 == 0 and every pointer is
//   16-byte aligned (AlexNet's C = 64, 192 and 256 all are); the scalar
//   route takes the rest. Elements widen to float exactly; x + b is added
//   in float and rounded to bfloat16 once, as the plain bfloat16 version
//   rounds it; relu and max are exact on bfloat16 values, so the stores
//   narrow back exactly. The bfloat16 kernels carry their own names
//   (relu_pool2_bf16_fwd/bwd) so a profile tells the dtypes apart.
// Numerics: the forward uses the same adds and maxima as the plain version
//   (relu as v > 0 ? v : 0, then max(max(y00, y01), max(y10, y11))), so it is
//   bit-identical; the backward sends each window's cotangent to the FIRST
//   maximal slot in window row-major order (0,0), (0,1), (1,0), (1,1), masked
//   by m > 0 (relu's gradient at 0 is 0), and writes zeros to the other
//   three slots. db is reduced outside, as in JAX.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr long long kMaxIndex = 1LL << 31;

// q = n / d for n < 2^31 as (umulhi(n, mul) + n) >> shift (Granlund and
// Montgomery; CUTLASS's FastDivmod).
struct FastDiv {
    unsigned d, mul, shift;
};

FastDiv fast_div(unsigned d) {
    unsigned shift = 0;
    while ((1ull << shift) < d) ++shift;
    const unsigned long long mul = ((1ull << 32) * ((1ull << shift) - d)) / d + 1;
    return FastDiv{d, (unsigned)mul, shift};
}

__device__ __forceinline__ unsigned div_of(unsigned n, FastDiv f) {
    return (__umulhi(n, f.mul) + n) >> f.shift;
}

// The element types: how one element widens to float and narrows back, and
// how many make a 16-byte vector.
template <typename T>
struct Elem;

template <>
struct Elem<float> {
    static constexpr int kVec = 4;
    __device__ static float round(float v) { return v; }
};

template <>
struct Elem<__nv_bfloat16> {
    static constexpr int kVec = 8;
    __device__ static float round(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }
};

template <int V>
struct Pack {
    float v[V];
};

__device__ __forceinline__ float bf16_lo(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(unsigned w) { return __uint_as_float(w & 0xffff0000u); }
// v is bfloat16-exact: its upper 16 bits are the bfloat16 bits
__device__ __forceinline__ unsigned bf16_bits(float v) { return __float_as_uint(v) >> 16; }

template <typename T, int V>
__device__ __forceinline__ Pack<V> load(const T* p) {
    Pack<V> a;
    if constexpr (sizeof(T) == 4 && V == 4) {
        const float4 q = __ldcs(reinterpret_cast<const float4*>(p));
        a.v[0] = q.x; a.v[1] = q.y; a.v[2] = q.z; a.v[3] = q.w;
    } else if constexpr (sizeof(T) == 4) {
        a.v[0] = __ldcs(reinterpret_cast<const float*>(p));
    } else if constexpr (V == 8) {
        const uint4 q = __ldcs(reinterpret_cast<const uint4*>(p));
        const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            a.v[2 * i] = bf16_lo(w[i]);
            a.v[2 * i + 1] = bf16_hi(w[i]);
        }
    } else {
        a.v[0] = __uint_as_float((unsigned)__ldcs(reinterpret_cast<const unsigned short*>(p))
                                 << 16);
    }
    return a;
}

// Stores values that are exact in T (maxima, relus, cotangents of T).
template <typename T, int V>
__device__ __forceinline__ void store(T* p, const Pack<V>& a) {
    if constexpr (sizeof(T) == 4 && V == 4) {
        __stcs(reinterpret_cast<float4*>(p), make_float4(a.v[0], a.v[1], a.v[2], a.v[3]));
    } else if constexpr (sizeof(T) == 4) {
        __stcs(reinterpret_cast<float*>(p), a.v[0]);
    } else if constexpr (V == 8) {
        unsigned w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
            w[i] = bf16_bits(a.v[2 * i]) | (bf16_bits(a.v[2 * i + 1]) << 16);
        __stcs(reinterpret_cast<uint4*>(p), make_uint4(w[0], w[1], w[2], w[3]));
    } else {
        __stcs(reinterpret_cast<unsigned short*>(p), (unsigned short)bf16_bits(a.v[0]));
    }
}

// Offsets of one thread's group: slot (0,0) of its window in x and its
// pooled output in m, g; its first channel in the bias. False past the end.
struct Group {
    unsigned base, out, c;
};

__device__ __forceinline__ bool group_of(unsigned groups, FastDiv per_row, FastDiv w2s,
                                         unsigned W, unsigned C, int V, Group* gr) {
    const unsigned t = blockIdx.x * kThreads + threadIdx.x;
    if (t >= groups) return false;
    const unsigned q = div_of(t, per_row);  // r * W2 + w2
    const unsigned r = div_of(q, w2s);      // n * H2 + h2
    const unsigned w2 = q - r * w2s.d;
    gr->c = (t - q * per_row.d) * V;
    gr->base = (2 * r * W + 2 * w2) * C + gr->c;
    gr->out = t * V;
    return true;
}

__device__ __forceinline__ float relu(float v) { return v > 0.0f ? v : 0.0f; }

// The four slots of a window after relu(x + b): s[slot].v[channel]; x + b
// rounded to T once.
template <typename T, int V>
__device__ __forceinline__ void window(const T* __restrict__ x, const T* __restrict__ bias,
                                       const Group& gr, unsigned W, unsigned C, Pack<V> s[4]) {
    const unsigned dh = W * C;
    s[0] = load<T, V>(x + gr.base);
    s[1] = load<T, V>(x + gr.base + C);
    s[2] = load<T, V>(x + gr.base + dh);
    s[3] = load<T, V>(x + gr.base + dh + C);
    if (bias != nullptr) {
        const Pack<V> b = load<T, V>(bias + gr.c);
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
            for (int i = 0; i < V; ++i) s[k].v[i] = Elem<T>::round(__fadd_rn(s[k].v[i], b.v[i]));
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int i = 0; i < V; ++i) s[k].v[i] = relu(s[k].v[i]);
}

template <typename T, int V>
__device__ __forceinline__ void fwd_body(const T* __restrict__ x, const T* __restrict__ bias,
                                         T* __restrict__ m, unsigned groups, FastDiv per_row,
                                         FastDiv w2s, unsigned W, unsigned C) {
    Group gr;
    if (!group_of(groups, per_row, w2s, W, C, V, &gr)) return;
    Pack<V> s[4];
    window<T, V>(x, bias, gr, W, C, s);
    Pack<V> out;
#pragma unroll
    for (int i = 0; i < V; ++i)
        out.v[i] = fmaxf(fmaxf(s[0].v[i], s[1].v[i]), fmaxf(s[2].v[i], s[3].v[i]));
    store<T, V>(m + gr.out, out);
}

template <typename T, int V>
__device__ __forceinline__ void bwd_body(const T* __restrict__ x, const T* __restrict__ bias,
                                         const T* __restrict__ m, const T* __restrict__ g,
                                         T* __restrict__ dx, unsigned groups, FastDiv per_row,
                                         FastDiv w2s, unsigned W, unsigned C) {
    Group gr;
    if (!group_of(groups, per_row, w2s, W, C, V, &gr)) return;
    Pack<V> s[4];
    window<T, V>(x, bias, gr, W, C, s);
    const Pack<V> mm = load<T, V>(m + gr.out);
    const Pack<V> gg = load<T, V>(g + gr.out);
    Pack<V> d[4];
#pragma unroll
    for (int i = 0; i < V; ++i) {
        const float gm = mm.v[i] > 0.0f ? gg.v[i] : 0.0f;
        bool taken = false;  // the first maximal slot takes the cotangent
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const bool first = !taken && s[k].v[i] == mm.v[i];
            taken = taken || first;
            d[k].v[i] = first ? gm : 0.0f;
        }
    }
    const unsigned dh = W * C;
    store<T, V>(dx + gr.base, d[0]);
    store<T, V>(dx + gr.base + C, d[1]);
    store<T, V>(dx + gr.base + dh, d[2]);
    store<T, V>(dx + gr.base + dh + C, d[3]);
}

template <int V>
__global__ void __launch_bounds__(kThreads)
    relu_pool2_fwd(const float* __restrict__ x, const float* __restrict__ bias,
                   float* __restrict__ m, unsigned groups, FastDiv per_row, FastDiv w2s,
                   unsigned W, unsigned C) {
    fwd_body<float, V>(x, bias, m, groups, per_row, w2s, W, C);
}

template <int V>
__global__ void __launch_bounds__(kThreads)
    relu_pool2_bwd(const float* __restrict__ x, const float* __restrict__ bias,
                   const float* __restrict__ m, const float* __restrict__ g,
                   float* __restrict__ dx, unsigned groups, FastDiv per_row, FastDiv w2s,
                   unsigned W, unsigned C) {
    bwd_body<float, V>(x, bias, m, g, dx, groups, per_row, w2s, W, C);
}

template <int V>
__global__ void __launch_bounds__(kThreads)
    relu_pool2_bf16_fwd(const __nv_bfloat16* __restrict__ x,
                        const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ m,
                        unsigned groups, FastDiv per_row, FastDiv w2s, unsigned W, unsigned C) {
    fwd_body<__nv_bfloat16, V>(x, bias, m, groups, per_row, w2s, W, C);
}

template <int V>
__global__ void __launch_bounds__(kThreads)
    relu_pool2_bf16_bwd(const __nv_bfloat16* __restrict__ x,
                        const __nv_bfloat16* __restrict__ bias,
                        const __nv_bfloat16* __restrict__ m, const __nv_bfloat16* __restrict__ g,
                        __nv_bfloat16* __restrict__ dx, unsigned groups, FastDiv per_row,
                        FastDiv w2s, unsigned W, unsigned C) {
    bwd_body<__nv_bfloat16, V>(x, bias, m, g, dx, groups, per_row, w2s, W, C);
}

template <typename... Params, typename... Args>
int launch(void (*kernel)(Params...), unsigned groups, void* stream, Args... args) {
    const unsigned blocks = (groups + kThreads - 1) / kThreads;
    kernel<<<blocks, kThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(args...);
    return (int)cudaGetLastError();
}

// Checks the wrapper makes too: even H and W, positive sizes, fewer than
// 2^31 elements, and for the vector route C % vec_width == 0. The wrapper
// checks the pointers' alignment.
bool shape_ok(int N, int H, int W, int C, int vec, int vec_width) {
    if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || H % 2 || W % 2) return false;
    if ((long long)N * H * W * C >= kMaxIndex) return false;
    return !vec || C % vec_width == 0;
}

template <typename T, typename Fwd4, typename Fwd1>
int fwd_entry(Fwd4 vec_kernel, Fwd1 scalar_kernel, const void* x, const void* bias, void* m,
              int N, int H, int W, int C, int vec, void* stream) {
    constexpr int kVec = Elem<T>::kVec;
    if (!shape_ok(N, H, W, C, vec, kVec)) return (int)cudaErrorInvalidValue;
    const unsigned per_row = C / (vec ? kVec : 1), W2 = W / 2;
    const unsigned groups = (unsigned)N * (H / 2) * W2 * per_row;
    const auto* xs = static_cast<const T*>(x);
    const auto* bs = static_cast<const T*>(bias);
    auto* ms = static_cast<T*>(m);
    if (vec)
        return launch(vec_kernel, groups, stream, xs, bs, ms, groups, fast_div(per_row),
                      fast_div(W2), (unsigned)W, (unsigned)C);
    return launch(scalar_kernel, groups, stream, xs, bs, ms, groups, fast_div(per_row),
                  fast_div(W2), (unsigned)W, (unsigned)C);
}

template <typename T, typename Bwd4, typename Bwd1>
int bwd_entry(Bwd4 vec_kernel, Bwd1 scalar_kernel, const void* x, const void* bias,
              const void* m, const void* g, void* dx, int N, int H, int W, int C, int vec,
              void* stream) {
    constexpr int kVec = Elem<T>::kVec;
    if (!shape_ok(N, H, W, C, vec, kVec)) return (int)cudaErrorInvalidValue;
    const unsigned per_row = C / (vec ? kVec : 1), W2 = W / 2;
    const unsigned groups = (unsigned)N * (H / 2) * W2 * per_row;
    const auto* xs = static_cast<const T*>(x);
    const auto* bs = static_cast<const T*>(bias);
    const auto* mp = static_cast<const T*>(m);
    const auto* gp = static_cast<const T*>(g);
    auto* dxs = static_cast<T*>(dx);
    if (vec)
        return launch(vec_kernel, groups, stream, xs, bs, mp, gp, dxs, groups,
                      fast_div(per_row), fast_div(W2), (unsigned)W, (unsigned)C);
    return launch(scalar_kernel, groups, stream, xs, bs, mp, gp, dxs, groups, fast_div(per_row),
                  fast_div(W2), (unsigned)W, (unsigned)C);
}

}  // namespace

// vec: 1 for the 16-byte route, 0 for the scalar one. Returns a cudaError_t.
extern "C" int dmt_relu_pool2_fwd_f32(const void* x, const void* bias, void* m, int N,
                                      int H, int W, int C, int vec, void* stream) {
    return fwd_entry<float>(relu_pool2_fwd<4>, relu_pool2_fwd<1>, x, bias, m, N, H, W, C, vec,
                            stream);
}

extern "C" int dmt_relu_pool2_bwd_f32(const void* x, const void* bias, const void* m,
                                      const void* g, void* dx, int N, int H, int W, int C,
                                      int vec, void* stream) {
    return bwd_entry<float>(relu_pool2_bwd<4>, relu_pool2_bwd<1>, x, bias, m, g, dx, N, H, W,
                            C, vec, stream);
}

extern "C" int dmt_relu_pool2_fwd_bf16(const void* x, const void* bias, void* m, int N,
                                       int H, int W, int C, int vec, void* stream) {
    return fwd_entry<__nv_bfloat16>(relu_pool2_bf16_fwd<8>, relu_pool2_bf16_fwd<1>, x, bias,
                                    m, N, H, W, C, vec, stream);
}

extern "C" int dmt_relu_pool2_bwd_bf16(const void* x, const void* bias, const void* m,
                                       const void* g, void* dx, int N, int H, int W, int C,
                                       int vec, void* stream) {
    return bwd_entry<__nv_bfloat16>(relu_pool2_bf16_bwd<8>, relu_pool2_bf16_bwd<1>, x, bias,
                                    m, g, dx, N, H, W, C, vec, stream);
}
