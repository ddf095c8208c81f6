// Single-token decode attention (K8): one query per (batch row, head) against
// a live-prefix K/V cache, a T-slot ring of this block's earlier tokens and
// the fresh token itself, under one f32 softmax.
//
// Replaces: distributed_ml_pytorch_tpu/ops/decode_attention.py
//   decode_attention_step (pallas_call at :128, body _decode_attn_kernel at :55)
//   — the single-token step of MultiHeadAttention._block_cached_attention
//   (distributed_ml_pytorch_tpu/models/transformer.py:300-330).
//
// Bound on an H100: bytes. Each live key costs one D-wide dot product and one
// D-wide axpy (4D operations) for 2D elements of K and V read (2D bytes under
// int8, 4D under bf16): one or two operations per byte, far below the card's
// ridge. At GPT-2-small's decode shape (b32 h12 d64, a few hundred live keys)
// the cache read is tens of MB per layer and step.
//
// Design. One block of 128 threads (4 warps) per (b, h). The TPU kernel ran
// one grid instance per batch row with the heads unrolled and the whole
// context in VMEM (hence its 4096-key gate); here the keys are a loop, so any
// context length runs. Within a warp, each key is taken by a group of LPK
// adjacent lanes, each lane loading 16 bytes of the K row and 16 bytes of the
// V row (LPK = D * sizeof(elem) / 16: 8 lanes at d64 bf16, 4 at d64 int8), so
// a warp reads 32/LPK whole rows per pass with 128-bit loads. The group's dot
// product is a few __shfl_xor_sync steps, and each group keeps its own online
// softmax state (running max m, sum l, and its lanes' slice of the weighted
// value sum) in registers. Two passes fill the states: the big cache over
// keys [0, ring_base), read through its strides (the caller passes a
// live-prefix view), then the ring over slots [0, t) followed by the fresh
// token. Every group then writes (m, l, acc) to shared memory and the block
// merges them into the output, which is divided once by the total sum and
// cast once to q's dtype.
//
// Masks and per-row state: t and ring_base are (B,) int32 device tensors read
// by each block (no host sync). Keys at or past ring_base in the big cache,
// and ring slots at or past t, are not read at all — the reference masks them
// to -inf, which contributes exactly 0.
//
// Numerics: scores = dot(q, k) in f32, times scale_k under int8, divided by
// sqrt(d); the fresh token is always present, so the softmax never sees an
// empty row. The value sum is in f32 with p * scale_v folded into the weight.
// The reference rounds p (times scale_v) to the activation dtype before its
// P·V products; this kernel keeps p in f32 — under bf16 that rounding is the
// whole difference between the two.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

// 16 bytes of a row, converted to f32.
template <typename E>
struct Vec;

template <>
struct Vec<float> {
    static constexpr int N = 4;
    __device__ static void load(const float* p, float* o) {
        const float4 v = *reinterpret_cast<const float4*>(p);
        o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
    }
};

template <>
struct Vec<__nv_bfloat16> {
    static constexpr int N = 8;
    __device__ static void load(const __nv_bfloat16* p, float* o) {
        const uint4 u = *reinterpret_cast<const uint4*>(p);
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const float2 f = __bfloat1622float2(h[i]);
            o[2 * i] = f.x;
            o[2 * i + 1] = f.y;
        }
    }
};

template <>
struct Vec<int8_t> {
    static constexpr int N = 16;
    __device__ static void load(const int8_t* p, float* o) {
        const uint4 u = *reinterpret_cast<const uint4*>(p);
        const int8_t* c = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
        for (int i = 0; i < 16; ++i) o[i] = static_cast<float>(c[i]);
    }
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Softmax states a pass over element type E writes: one per lane group.
template <typename E, int D>
__host__ __device__ constexpr int groups() {
    return kWarps * (32 / (D / Vec<E>::N));
}

// Fold keys [0, n) into per-group online-softmax states and write them to
// shared memory at slot_base + group. Rows j < n - 1 (or all rows when
// k_last is null) are k + j * ks; with k_last set, row n - 1 is k_last.
// Under kScale each score is multiplied by sk[j * sks] and each weight by
// sv[j * svs].
template <typename E, int D, bool kScale>
__device__ void fold(const E* k, long long ks, const E* v, long long vs,
                     const E* k_last, const E* v_last,
                     const float* sk, long long sks, const float* sv, long long svs,
                     int n, float sqrt_d, const float* q_s, int slot_base,
                     float* m_s, float* l_s, float* acc_s) {
    constexpr int N = Vec<E>::N;
    constexpr int LPK = D / N;
    constexpr int KPW = 32 / LPK;
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int g = lane / LPK;
    const int sub = lane % LPK;
    float qv[N];
#pragma unroll
    for (int i = 0; i < N; ++i) qv[i] = q_s[sub * N + i];
    float m = -INFINITY, l = 0.f;
    float acc[N];
#pragma unroll
    for (int i = 0; i < N; ++i) acc[i] = 0.f;

    for (int base = warp * KPW; base < n; base += kWarps * KPW) {
        const int j = base + g;
        const bool ok = j < n;
        float kf[N], vf[N];
        float part = 0.f;
        if (ok) {
            const bool last = k_last != nullptr && j == n - 1;
            const E* kr = last ? k_last : k + j * ks;
            const E* vr = last ? v_last : v + j * vs;
            Vec<E>::load(kr + sub * N, kf);
            Vec<E>::load(vr + sub * N, vf);
#pragma unroll
            for (int i = 0; i < N; ++i) part = fmaf(qv[i], kf[i], part);
        }
#pragma unroll
        for (int off = LPK / 2; off > 0; off >>= 1)
            part += __shfl_xor_sync(0xffffffffu, part, off);
        if (ok) {
            float s = part;
            float w = 1.f;
            if (kScale) {
                s *= sk[j * sks];
                w = sv[j * svs];
            }
            s = s / sqrt_d;
            if (s > m) {
                const float c = expf(m - s);
                l *= c;
#pragma unroll
                for (int i = 0; i < N; ++i) acc[i] *= c;
                m = s;
            }
            const float p = expf(s - m);
            l += p;
            const float pw = p * w;
#pragma unroll
            for (int i = 0; i < N; ++i) acc[i] = fmaf(pw, vf[i], acc[i]);
        }
    }
    const int slot = slot_base + warp * KPW + g;
    if (sub == 0) {
        m_s[slot] = m;
        l_s[slot] = l;
    }
#pragma unroll
    for (int i = 0; i < N; ++i) acc_s[slot * D + sub * N + i] = acc[i];
}

struct Params {
    const void* q;
    const void* kn;
    const void* vn;
    const void* bk;
    const void* bv;
    const void* rk;
    const void* rv;
    const float* sk;
    const float* sv;
    const int* t;
    const int* ring_base;
    void* out;
    // element strides (b, h[, position]) of q, kn, vn, bk, bv, rk, rv, sk, sv
    long long q_b, q_h, kn_b, kn_h, vn_b, vn_h;
    long long bk_b, bk_h, bk_c, bv_b, bv_h, bv_c;
    long long rk_b, rk_h, rk_t, rv_b, rv_h, rv_t;
    long long sk_b, sk_h, sk_c, sv_b, sv_h, sv_c;
    int B, H, C, T;
    float sqrt_d;
};

// T: activation dtype (q, ring, fresh token, output); S: big-cache storage.
template <typename T, typename S, int D>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const Params p) {
    constexpr bool kQuant = sizeof(S) == 1;
    constexpr int G_BIG = groups<S, D>();
    constexpr int G_RING = groups<T, D>();
    constexpr int SLOTS = G_BIG + G_RING;
    __shared__ float q_s[D];
    __shared__ float m_s[SLOTS];
    __shared__ float l_s[SLOTS];
    __shared__ float acc_s[SLOTS * D];

    const int b = blockIdx.x / p.H;
    const int h = blockIdx.x % p.H;
    const T* q = static_cast<const T*>(p.q) + b * p.q_b + h * p.q_h;
    for (int d = threadIdx.x; d < D; d += kThreads) q_s[d] = to_f32(q[d]);
    __syncthreads();

    const int nb = max(0, min(p.ring_base[b], p.C));
    const int nt = max(0, min(p.t[b], p.T));

    fold<S, D, kQuant>(
        static_cast<const S*>(p.bk) + b * p.bk_b + h * p.bk_h, p.bk_c,
        static_cast<const S*>(p.bv) + b * p.bv_b + h * p.bv_h, p.bv_c,
        nullptr, nullptr,
        kQuant ? p.sk + b * p.sk_b + h * p.sk_h : nullptr, p.sk_c,
        kQuant ? p.sv + b * p.sv_b + h * p.sv_h : nullptr, p.sv_c,
        nb, p.sqrt_d, q_s, 0, m_s, l_s, acc_s);
    fold<T, D, false>(
        static_cast<const T*>(p.rk) + b * p.rk_b + h * p.rk_h, p.rk_t,
        static_cast<const T*>(p.rv) + b * p.rv_b + h * p.rv_h, p.rv_t,
        static_cast<const T*>(p.kn) + b * p.kn_b + h * p.kn_h,
        static_cast<const T*>(p.vn) + b * p.vn_b + h * p.vn_h,
        nullptr, 0, nullptr, 0,
        nt + 1, p.sqrt_d, q_s, G_BIG, m_s, l_s, acc_s);
    __syncthreads();

    T* out = static_cast<T*>(p.out) + (static_cast<long long>(b) * p.H + h) * D;
    for (int d = threadIdx.x; d < D; d += kThreads) {
        float mx = -INFINITY;
        for (int s = 0; s < SLOTS; ++s) mx = fmaxf(mx, m_s[s]);
        float l = 0.f, o = 0.f;
        for (int s = 0; s < SLOTS; ++s) {
            const float w = m_s[s] == -INFINITY ? 0.f : expf(m_s[s] - mx);
            l = fmaf(l_s[s], w, l);
            o = fmaf(acc_s[s * D + d], w, o);
        }
        store(out + d, o / l);
    }
}

template <typename T, typename S>
cudaError_t launch_d(const Params& p, int d, cudaStream_t s) {
    const dim3 grid(p.B * p.H);
    switch (d) {
        case 32: decode_attention_kernel<T, S, 32><<<grid, kThreads, 0, s>>>(p); break;
        case 64: decode_attention_kernel<T, S, 64><<<grid, kThreads, 0, s>>>(p); break;
        case 128: decode_attention_kernel<T, S, 128><<<grid, kThreads, 0, s>>>(p); break;
        default: return cudaErrorInvalidValue;
    }
    return cudaGetLastError();
}

}  // namespace

// ptrs: q, k_new, v_new, big_k, big_v, ring_k, ring_v, scale_k, scale_v, t,
//   ring_base, out (scales null unless quant).
// strides: the 24 element strides of Params, in its order.
// dims: B, H, C, T, D, act dtype (0 float32, 1 bfloat16), quant (0/1).
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for a
// head_dim or dtype the kernel is not built for).
extern "C" int dmt_decode_attention(void* const* ptrs, const long long* strides,
                                    const int* dims, float sqrt_d, void* stream) {
    Params p;
    p.q = ptrs[0]; p.kn = ptrs[1]; p.vn = ptrs[2];
    p.bk = ptrs[3]; p.bv = ptrs[4]; p.rk = ptrs[5]; p.rv = ptrs[6];
    p.sk = static_cast<const float*>(ptrs[7]);
    p.sv = static_cast<const float*>(ptrs[8]);
    p.t = static_cast<const int*>(ptrs[9]);
    p.ring_base = static_cast<const int*>(ptrs[10]);
    p.out = ptrs[11];
    const long long* st = strides;
    p.q_b = st[0]; p.q_h = st[1]; p.kn_b = st[2]; p.kn_h = st[3]; p.vn_b = st[4]; p.vn_h = st[5];
    p.bk_b = st[6]; p.bk_h = st[7]; p.bk_c = st[8]; p.bv_b = st[9]; p.bv_h = st[10]; p.bv_c = st[11];
    p.rk_b = st[12]; p.rk_h = st[13]; p.rk_t = st[14]; p.rv_b = st[15]; p.rv_h = st[16];
    p.rv_t = st[17];
    p.sk_b = st[18]; p.sk_h = st[19]; p.sk_c = st[20]; p.sv_b = st[21]; p.sv_h = st[22];
    p.sv_c = st[23];
    p.B = dims[0]; p.H = dims[1]; p.C = dims[2]; p.T = dims[3];
    p.sqrt_d = sqrt_d;
    const int d = dims[4], act = dims[5], quant = dims[6];
    if (p.B * p.H == 0) return (int)cudaGetLastError();
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (act == 0) {
        err = quant ? launch_d<float, int8_t>(p, d, s) : launch_d<float, float>(p, d, s);
    } else if (act == 1) {
        err = quant ? launch_d<__nv_bfloat16, int8_t>(p, d, s)
                    : launch_d<__nv_bfloat16, __nv_bfloat16>(p, d, s);
    } else {
        err = cudaErrorInvalidValue;
    }
    return (int)err;
}
