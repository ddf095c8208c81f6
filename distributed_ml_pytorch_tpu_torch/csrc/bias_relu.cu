// bias_relu: y = relu(x [+ b]) over a (R, C) row view, forward (K3a) and
// backward (K3b), for float32 and bfloat16.
//
// Replaces: distributed_ml_pytorch_tpu/ops/fused_conv.py, _bias_relu_pallas
//   (pallas_call at :177; forward body _relu_kernel at :134, backward body
//   _relu_bwd_kernel at :144) — the elementwise conv epilogue priced by
//   bench_all's conv-epilogue ladder.
// Bound on an H100: bytes. The forward reads x and writes y; the backward
//   reads x and g and writes dz; one add and one compare per element, far
//   below the card's flop/byte ridge.
// Design: one grid-stride loop over the flat R*C elements. The TPU kernel
//   blocks rows so that a (rows, C) tile and the (1, C) bias sit in VMEM;
//   here the bias is read per element through the cache (C values, a few
//   KB) and each thread moves 16 bytes per access (4 float32 or 8 bfloat16
//   values) when C is a multiple of that width and every pointer is 16-byte
//   aligned, so a vector never straddles two rows; otherwise one element
//   per access. No reduction crosses threads. db is reduced outside, as in
//   JAX.
// Numerics: bit-identical to the plain version. z = x + b is one add in
//   float32 rounded to the input dtype (the plain `x + bias` in that dtype);
//   the forward writes z > 0 ? z : 0, the backward z > 0 ? g : 0 (relu's
//   gradient at 0 is 0). Nothing is contracted into an FMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;

template <typename T>
struct Elt;

template <>
struct Elt<float> {
    static __device__ __forceinline__ float load(float v) { return v; }
    static __device__ __forceinline__ float to(float x) { return x; }
};

template <>
struct Elt<__nv_bfloat16> {
    static __device__ __forceinline__ float load(__nv_bfloat16 v) { return __bfloat162float(v); }
    static __device__ __forceinline__ __nv_bfloat16 to(float x) { return __float2bfloat16_rn(x); }
};

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
    T v[VEC];
};

// z = x + b[c], rounded to T as the plain version's add in T
template <typename T>
__device__ __forceinline__ float biased(T xv, const T* __restrict__ bias, int c) {
    const float x = Elt<T>::load(xv);
    if (bias == nullptr) return x;
    return Elt<T>::load(Elt<T>::to(__fadd_rn(x, Elt<T>::load(bias[c]))));
}

template <typename T, int VEC>
__global__ void bias_relu_fwd(const T* __restrict__ x, const T* __restrict__ bias,
                              T* __restrict__ y, long long n_vec, int C) {
    const long long stride = (long long)blockDim.x * gridDim.x;
    const T zero = Elt<T>::to(0.0f);
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n_vec;
         i += stride) {
        const long long e0 = i * VEC;
        const int c0 = (int)(e0 % C);
        const Pack<T, VEC> xv = reinterpret_cast<const Pack<T, VEC>*>(x)[i];
        Pack<T, VEC> out;
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
            const float z = biased<T>(xv.v[j], bias, c0 + j);
            out.v[j] = z > 0.0f ? Elt<T>::to(z) : zero;
        }
        reinterpret_cast<Pack<T, VEC>*>(y)[i] = out;
    }
}

template <typename T, int VEC>
__global__ void bias_relu_bwd(const T* __restrict__ x, const T* __restrict__ bias,
                              const T* __restrict__ g, T* __restrict__ dz, long long n_vec,
                              int C) {
    const long long stride = (long long)blockDim.x * gridDim.x;
    const T zero = Elt<T>::to(0.0f);
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n_vec;
         i += stride) {
        const long long e0 = i * VEC;
        const int c0 = (int)(e0 % C);
        const Pack<T, VEC> xv = reinterpret_cast<const Pack<T, VEC>*>(x)[i];
        const Pack<T, VEC> gv = reinterpret_cast<const Pack<T, VEC>*>(g)[i];
        Pack<T, VEC> out;
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
            out.v[j] = biased<T>(xv.v[j], bias, c0 + j) > 0.0f ? gv.v[j] : zero;
        }
        reinterpret_cast<Pack<T, VEC>*>(dz)[i] = out;
    }
}

unsigned blocks_for(long long n) {
    long long blocks = (n + kThreads - 1) / kThreads;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    if (blocks < 1) blocks = 1;
    return (unsigned)blocks;
}

bool aligned16(const void* p) { return p == nullptr || ((uintptr_t)p & 15) == 0; }

template <typename T>
int launch(const void* x, const void* bias, const void* g, void* out, long long n, int C,
           cudaStream_t stream) {
    constexpr int VEC = 16 / sizeof(T);
    const bool vec = C % VEC == 0 && aligned16(x) && aligned16(bias) && aligned16(g) &&
                     aligned16(out);
    const T* xt = static_cast<const T*>(x);
    const T* bt = static_cast<const T*>(bias);
    if (g == nullptr) {
        T* yt = static_cast<T*>(out);
        if (vec)
            bias_relu_fwd<T, VEC><<<blocks_for(n / VEC), kThreads, 0, stream>>>(
                xt, bt, yt, n / VEC, C);
        else
            bias_relu_fwd<T, 1><<<blocks_for(n), kThreads, 0, stream>>>(xt, bt, yt, n, C);
    } else {
        const T* gt = static_cast<const T*>(g);
        T* dt = static_cast<T*>(out);
        if (vec)
            bias_relu_bwd<T, VEC><<<blocks_for(n / VEC), kThreads, 0, stream>>>(
                xt, bt, gt, dt, n / VEC, C);
        else
            bias_relu_bwd<T, 1><<<blocks_for(n), kThreads, 0, stream>>>(xt, bt, gt, dt, n, C);
    }
    return (int)cudaGetLastError();
}

int dispatch(const void* x, const void* bias, const void* g, void* out, long long n, int C,
             int dtype, void* stream) {
    if (n <= 0 || C <= 0) return (int)cudaGetLastError();
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    if (dtype == 0) return launch<float>(x, bias, g, out, n, C, s);
    if (dtype == 1) return launch<__nv_bfloat16>(x, bias, g, out, n, C, s);
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// n = R * C elements; bias is (C,) or null; dtype 0 = float32, 1 = bfloat16
extern "C" int dmt_bias_relu_fwd(const void* x, const void* bias, void* y, long long n, int C,
                                 int dtype, void* stream) {
    return dispatch(x, bias, nullptr, y, n, C, dtype, stream);
}

extern "C" int dmt_bias_relu_bwd(const void* x, const void* bias, const void* g, void* dz,
                                 long long n, int C, int dtype, void* stream) {
    return dispatch(x, bias, g, dz, n, C, dtype, stream);
}
