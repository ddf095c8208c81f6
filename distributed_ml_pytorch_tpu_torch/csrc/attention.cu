// Flash attention over (batch*heads, seq, head_dim): the forward (K4), the
// fused backward (K5) and the split backward's dQ (K6a) and dK/dV (K6b)
// kernels at head_dim 8, 16, 32, 64 and 128, for float32 inputs only (the
// bfloat16 versions are the tensor-core kernels of flash_fwd_tc.cu and
// flash_bwd_tc.cu, at 16 to 128). Head_dim 8 is the JAX MPMD scenario's
// width (d_model 16 over 2 heads); there a row group's 8 threads hold one
// head-dim column each.
//
// Replaces: distributed_ml_pytorch_tpu/ops/attention.py
//   K4  _flash_fwd            (pallas_call at :311, body _flash_kernel at :196)
//   K5  _flash_bwd_core fused (pallas_call at :563, body _flash_bwd_fused_kernel at :428)
//   K6a _flash_bwd_core split (pallas_call at :592, body _flash_dq_kernel at :350)
//   K6b _flash_bwd_core split (pallas_call at :605, body _flash_dkv_kernel at :385)
//
// Bound on an H100: operations. At the LM's shape (b8 h12 s2048 d64, causal)
// the forward does 2 products over the score plane against 4 (b*h, s, d)
// tensors read or written, about 512 operations per byte, above the card's
// ridge. These kernels use scalar float32 FMAs out of shared memory, not the
// tensor cores (mma / wgmma): the tensor cores have no mode that keeps
// float32's numbers.
//
// Design. The TPU kernels walk a sequential grid and carry the online-softmax
// state (or dK/dV) in VMEM scratch from one grid step to the next. On the
// card blocks run in parallel and in no order, so the sequential grid axis
// becomes a loop inside one block:
//   - K4: one block per (b*h, 64-query tile); it loops over the key tiles,
//     keeping m, l and the output accumulator in registers (f32);
//   - K5 and K6b: one block per (b*h, 64-key tile); they loop over the query
//     tiles, keeping dK and dV in registers (f32);
//   - K6a: one block per (b*h, 64-query tile); it loops over the key tiles,
//     keeping dQ in registers (f32).
// K5 cannot keep dQ on chip (its query tile changes every iteration). The TPU
// kernel wrote per-key-tile dQ partials and summed them after; here each
// block adds its (64, d) dQ contribution into an f32 (b*h, sq, d) buffer with
// atomicAdd, which the wrapper zeroes before and casts after. That buffer is
// one sq*d f32 slab per head instead of n_k of them, but the order of the
// additions, and so dQ's last bits, vary from run to run. K6a/K6b are
// deterministic.
//
// Tiles are 64 x 64. A block of NT threads (128 at head_dim <= 64, 256 at
// 128) splits a 64 x 64 score tile into 16 row groups of 4 rows; the TX =
// NT/16 threads of a row group are adjacent lanes of one warp and share the
// group's 64 columns, strided by TX, so row max and row sum are a few
// __shfl_xor_sync steps. Q, K, V and dO tiles sit in shared memory as f32
// with a row stride of d + 1, and probability / dS tiles with a stride of 65,
// which keeps every shared load of the products free of bank conflicts.
// Causally dead tiles are skipped; only the tiles that straddle the diagonal,
// or the ragged end of a sequence, pay for the mask.
//
// Numerics follow the TPU kernels: scores in f32 and in log2 space (the
// 1/sqrt(d) scale and log2(e) folded into one factor), masked scores set to
// -1e30 so they underflow to exactly 0, p rounded to V's (dO's) dtype before
// the PV (P^T dO) product, dS rounded to the input dtype before the dK and dQ
// products, the lse kept base 2 ((b*h, sq) f32). delta = rowsum(dO * O)
// (minus the lse cotangent) is computed by the caller.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;
constexpr float kNegInf = -1e30f;

// loads, stores and rounding of the element type (float32: the identity
// rounding; the bfloat16 kernels are the tensor-core ones)
template <typename T>
struct Elt;

template <>
struct Elt<float> {
    static __device__ __forceinline__ float load(const float* p) { return *p; }
    static __device__ __forceinline__ void store(float* p, float x) { *p = x; }
    static __device__ __forceinline__ float round(float x) { return x; }
};

template <int D>
struct Cfg {
    static constexpr int NT = D >= 128 ? 256 : 128;  // threads per block
    static constexpr int TX = NT / 16;               // threads of one row group
    static constexpr int NJ = kTile / TX;            // tile columns per thread
    static constexpr int NM = D / TX;                // head-dim columns per thread
    static constexpr int SD = D + 1;                 // row stride of a (64, D) tile
    static constexpr int SP = kTile + 1;             // row stride of a (64, 64) tile
    static constexpr int TILE_D = kTile * SD;        // floats of a (64, D) tile
    static constexpr int TILE_P = kTile * SP;        // floats of a (64, 64) tile
};

// rows row0 .. row0+63 of a (rows, D) matrix into shared memory as f32;
// rows at or past `rows` read as zeros
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0, int rows) {
    using C = Cfg<D>;
    for (int idx = threadIdx.x; idx < kTile * D; idx += C::NT) {
        const int r = idx / D, c = idx % D;
        const int g = row0 + r;
        dst[r * C::SD + c] = g < rows ? Elt<T>::load(src + (size_t)g * D + c) : 0.0f;
    }
}

// a 64-vector (lse or delta rows row0 ..) into shared memory, zeros past `rows`
__device__ __forceinline__ void load_rows(float* dst, const float* src, int row0, int rows) {
    for (int r = threadIdx.x; r < kTile; r += blockDim.x)
        dst[r] = row0 + r < rows ? src[row0 + r] : 0.0f;
}

// c[i][j] = sum_d A[ty*4+i][d] * B[tx+TX*j][d]  (A, B: (64, D) tiles)
template <int D>
__device__ __forceinline__ void dot_rows(float (&c)[4][Cfg<D>::NJ], const float* A,
                                         const float* B, int ty, int tx) {
    using C = Cfg<D>;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < C::NJ; ++j) c[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
        float a[4], b[C::NJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = A[(ty * 4 + i) * C::SD + d];
#pragma unroll
        for (int j = 0; j < C::NJ; ++j) b[j] = B[(tx + C::TX * j) * C::SD + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < C::NJ; ++j) c[i][j] = fmaf(a[i], b[j], c[i][j]);
    }
}

// acc[i][m] += sum_k P[ty*4+i][k] * B[k][tx+TX*m]  (P: (64, 64), B: (64, D))
template <int D>
__device__ __forceinline__ void mm_rows(float (&acc)[4][Cfg<D>::NM], const float* P,
                                        const float* B, int ty, int tx) {
    using C = Cfg<D>;
#pragma unroll 4
    for (int k = 0; k < kTile; ++k) {
        float p[4], b[C::NM];
#pragma unroll
        for (int i = 0; i < 4; ++i) p[i] = P[(ty * 4 + i) * C::SP + k];
#pragma unroll
        for (int m = 0; m < C::NM; ++m) b[m] = B[k * C::SD + tx + C::TX * m];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int m = 0; m < C::NM; ++m) acc[i][m] = fmaf(p[i], b[m], acc[i][m]);
    }
}

// acc[i][m] += sum_k P[k][ty*4+i] * B[k][tx+TX*m]  (P transposed)
template <int D>
__device__ __forceinline__ void mm_cols(float (&acc)[4][Cfg<D>::NM], const float* P,
                                        const float* B, int ty, int tx) {
    using C = Cfg<D>;
#pragma unroll 4
    for (int k = 0; k < kTile; ++k) {
        float p[4], b[C::NM];
#pragma unroll
        for (int i = 0; i < 4; ++i) p[i] = P[k * C::SP + ty * 4 + i];
#pragma unroll
        for (int m = 0; m < C::NM; ++m) b[m] = B[k * C::SD + tx + C::TX * m];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int m = 0; m < C::NM; ++m) acc[i][m] = fmaf(p[i], b[m], acc[i][m]);
    }
}

template <int TX>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
    for (int o = TX / 2; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

template <int TX>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
    for (int o = TX / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// ------------------------------------------------------------------ K4

template <typename T, int D>
__global__ void __launch_bounds__(Cfg<D>::NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, float* __restrict__ lse, int sq, int sk, int causal,
                 float scale_log2) {
    using C = Cfg<D>;
    extern __shared__ float smem[];
    float* Qs = smem;
    float* Ks = Qs + C::TILE_D;
    float* Vs = Ks + C::TILE_D;
    float* Ps = Vs + C::TILE_D;

    const int bh = blockIdx.y;
    const int qt = gridDim.x - 1 - blockIdx.x;  // causal: the longest rows start first
    const int q0 = qt * kTile;
    const int tx = threadIdx.x % C::TX, ty = threadIdx.x / C::TX;
    const T* qb = q + (size_t)bh * sq * D;
    const T* kb = k + (size_t)bh * sk * D;
    const T* vb = v + (size_t)bh * sk * D;

    load_tile<T, D>(Qs, qb, q0, sq);
    float m[4], l[4], acc[4][C::NM];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        m[i] = kNegInf;
        l[i] = 0.0f;
#pragma unroll
        for (int j = 0; j < C::NM; ++j) acc[i][j] = 0.0f;
    }
    const int n_kt = (sk + kTile - 1) / kTile;
    // keys past this query tile's last row see none of it (causal: sq == sk)
    const int kt_end = causal ? min(n_kt, qt + 1) : n_kt;
    for (int kt = 0; kt < kt_end; ++kt) {
        const int k0 = kt * kTile;
        __syncthreads();  // the previous tile's Ks/Vs/Ps are consumed
        load_tile<T, D>(Ks, kb, k0, sk);
        load_tile<T, D>(Vs, vb, k0, sk);
        __syncthreads();
        float s[4][C::NJ];
        dot_rows<D>(s, Qs, Ks, ty, tx);
        const bool masked = (causal && k0 + kTile - 1 > q0) || k0 + kTile > sk;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int j = 0; j < C::NJ; ++j) {
                s[i][j] *= scale_log2;
                if (masked) {
                    const int kpos = k0 + tx + C::TX * j, qpos = q0 + ty * 4 + i;
                    if (kpos >= sk || (causal && kpos > qpos)) s[i][j] = kNegInf;
                }
            }
            float mx = s[i][0];
#pragma unroll
            for (int j = 1; j < C::NJ; ++j) mx = fmaxf(mx, s[i][j]);
            const float m_new = fmaxf(m[i], group_max<C::TX>(mx));
            float sum = 0.0f;
#pragma unroll
            for (int j = 0; j < C::NJ; ++j) {
                const float p = exp2f(s[i][j] - m_new);
                sum += p;
                Ps[(ty * 4 + i) * C::SP + tx + C::TX * j] = Elt<T>::round(p);
            }
            const float corr = exp2f(m[i] - m_new);
            l[i] = l[i] * corr + group_sum<C::TX>(sum);
            m[i] = m_new;
#pragma unroll
            for (int j = 0; j < C::NM; ++j) acc[i][j] *= corr;
        }
        __syncthreads();
        mm_rows<D>(acc, Ps, Vs, ty, tx);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int row = q0 + ty * 4 + i;
        if (row >= sq) continue;
        const float lf = fmaxf(l[i], 1e-30f);
        T* o = out + ((size_t)bh * sq + row) * D;
#pragma unroll
        for (int j = 0; j < C::NM; ++j) Elt<T>::store(o + tx + C::TX * j, acc[i][j] / lf);
        if (tx == 0) lse[(size_t)bh * sq + row] = m[i] + log2f(lf);
    }
}

// ------------------------------------------------------------------ K5, K6b

// One block per (b*h, key tile), sweeping the query tiles: dK and dV in
// registers; with WITH_DQ (K5) each query tile's dQ contribution is added
// into dq_acc (f32) with atomics, without it (K6b) dQ is left to K6a.
template <typename T, int D, bool WITH_DQ>
__global__ void __launch_bounds__(Cfg<D>::NT)
flash_bwd_kv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq_acc,
                    T* __restrict__ dk, T* __restrict__ dv, int sq, int sk, int causal,
                    float scale_log2, float scale) {
    using C = Cfg<D>;
    extern __shared__ float smem[];
    float* Ks = smem;
    float* Vs = Ks + C::TILE_D;
    float* Qs = Vs + C::TILE_D;
    float* Os = Qs + C::TILE_D;  // dO
    float* Ps = Os + C::TILE_D;  // p^T rounded, (key, query)
    float* Ss = Ps + C::TILE_P;  // dS^T rounded, (key, query)
    float* Ls = Ss + C::TILE_P;  // lse (base 2) of the query tile
    float* Dl = Ls + kTile;      // delta of the query tile

    const int bh = blockIdx.y;
    const int kt = blockIdx.x;  // causal: the first key tiles see the most queries
    const int k0 = kt * kTile;
    const int tx = threadIdx.x % C::TX, ty = threadIdx.x / C::TX;
    const size_t qoff = (size_t)bh * sq, koff = (size_t)bh * sk;

    load_tile<T, D>(Ks, k + koff * D, k0, sk);
    load_tile<T, D>(Vs, v + koff * D, k0, sk);
    float dk_acc[4][C::NM], dv_acc[4][C::NM];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < C::NM; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.0f;

    const int n_qt = (sq + kTile - 1) / kTile;
    // query tiles wholly before this key tile see none of it
    for (int qt = causal ? kt : 0; qt < n_qt; ++qt) {
        const int q0 = qt * kTile;
        __syncthreads();
        load_tile<T, D>(Qs, q + qoff * D, q0, sq);
        load_tile<T, D>(Os, dout + qoff * D, q0, sq);
        load_rows(Ls, lse + qoff, q0, sq);
        load_rows(Dl, delta + qoff, q0, sq);
        __syncthreads();
        // scores transposed, (key, query): rows are this block's keys
        float p[4][C::NJ];
        dot_rows<D>(p, Ks, Qs, ty, tx);
        const bool masked =
            (causal && k0 + kTile - 1 > q0) || q0 + kTile > sq || k0 + kTile > sk;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < C::NJ; ++j) {
                const int col = tx + C::TX * j;
                float s = p[i][j] * scale_log2;
                if (masked) {
                    const int kpos = k0 + ty * 4 + i, qpos = q0 + col;
                    if (qpos >= sq || kpos >= sk || (causal && kpos > qpos)) s = kNegInf;
                }
                p[i][j] = exp2f(s - Ls[col]);
                Ps[(ty * 4 + i) * C::SP + col] = Elt<T>::round(p[i][j]);
            }
        float dp[4][C::NJ];
        dot_rows<D>(dp, Vs, Os, ty, tx);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < C::NJ; ++j) {
                const int col = tx + C::TX * j;
                const float ds = (p[i][j] * (dp[i][j] - Dl[col])) * scale;
                Ss[(ty * 4 + i) * C::SP + col] = Elt<T>::round(ds);
            }
        __syncthreads();
        mm_rows<D>(dv_acc, Ps, Os, ty, tx);  // dV += p^T dO
        mm_rows<D>(dk_acc, Ss, Qs, ty, tx);  // dK += dS^T Q
        if (WITH_DQ) {
            float dq[4][C::NM];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < C::NM; ++j) dq[i][j] = 0.0f;
            mm_cols<D>(dq, Ss, Ks, ty, tx);  // dQ = dS K, rows are queries
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int row = q0 + ty * 4 + i;
                if (row >= sq) continue;
                float* dst = dq_acc + (qoff + row) * D;
#pragma unroll
                for (int j = 0; j < C::NM; ++j) atomicAdd(dst + tx + C::TX * j, dq[i][j]);
            }
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int row = k0 + ty * 4 + i;
        if (row >= sk) continue;
#pragma unroll
        for (int j = 0; j < C::NM; ++j) {
            Elt<T>::store(dk + (koff + row) * D + tx + C::TX * j, dk_acc[i][j]);
            Elt<T>::store(dv + (koff + row) * D + tx + C::TX * j, dv_acc[i][j]);
        }
    }
}

// ------------------------------------------------------------------ K6a

template <typename T, int D>
__global__ void __launch_bounds__(Cfg<D>::NT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int sq, int sk,
                    int causal, float scale_log2, float scale) {
    using C = Cfg<D>;
    extern __shared__ float smem[];
    float* Qs = smem;
    float* Os = Qs + C::TILE_D;  // dO
    float* Ks = Os + C::TILE_D;
    float* Vs = Ks + C::TILE_D;
    float* Ss = Vs + C::TILE_D;  // dS rounded, (query, key)

    const int bh = blockIdx.y;
    const int qt = gridDim.x - 1 - blockIdx.x;
    const int q0 = qt * kTile;
    const int tx = threadIdx.x % C::TX, ty = threadIdx.x / C::TX;
    const size_t qoff = (size_t)bh * sq, koff = (size_t)bh * sk;

    load_tile<T, D>(Qs, q + qoff * D, q0, sq);
    load_tile<T, D>(Os, dout + qoff * D, q0, sq);
    float lse_r[4], delta_r[4], acc[4][C::NM];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int row = q0 + ty * 4 + i;
        lse_r[i] = row < sq ? lse[qoff + row] : 0.0f;
        delta_r[i] = row < sq ? delta[qoff + row] : 0.0f;
#pragma unroll
        for (int j = 0; j < C::NM; ++j) acc[i][j] = 0.0f;
    }
    const int n_kt = (sk + kTile - 1) / kTile;
    const int kt_end = causal ? min(n_kt, qt + 1) : n_kt;
    for (int kt = 0; kt < kt_end; ++kt) {
        const int k0 = kt * kTile;
        __syncthreads();
        load_tile<T, D>(Ks, k + koff * D, k0, sk);
        load_tile<T, D>(Vs, v + koff * D, k0, sk);
        __syncthreads();
        float p[4][C::NJ];
        dot_rows<D>(p, Qs, Ks, ty, tx);
        const bool masked =
            (causal && k0 + kTile - 1 > q0) || k0 + kTile > sk || q0 + kTile > sq;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < C::NJ; ++j) {
                float s = p[i][j] * scale_log2;
                if (masked) {
                    const int kpos = k0 + tx + C::TX * j, qpos = q0 + ty * 4 + i;
                    if (qpos >= sq || kpos >= sk || (causal && kpos > qpos)) s = kNegInf;
                }
                p[i][j] = exp2f(s - lse_r[i]);
            }
        float dp[4][C::NJ];
        dot_rows<D>(dp, Os, Vs, ty, tx);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < C::NJ; ++j) {
                const float ds = (p[i][j] * (dp[i][j] - delta_r[i])) * scale;
                Ss[(ty * 4 + i) * C::SP + tx + C::TX * j] = Elt<T>::round(ds);
            }
        __syncthreads();
        mm_rows<D>(acc, Ss, Ks, ty, tx);  // dQ += dS K
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int row = q0 + ty * 4 + i;
        if (row >= sq) continue;
#pragma unroll
        for (int j = 0; j < C::NM; ++j)
            Elt<T>::store(dq + (qoff + row) * D + tx + C::TX * j, acc[i][j]);
    }
}

// ------------------------------------------------------------------ launchers

template <typename K>
int launch_prep(K kernel, size_t smem) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    return (int)e;
}

inline bool bad_shape(int bh, int sq, int sk) {
    return bh < 0 || bh > 65535 || sq < 0 || sk < 0;
}

struct Args {
    const void *q, *k, *v, *dout;
    const float *lse, *delta;
    void *out, *dq, *dk, *dv;
    float* lse_out;
    float* dq_acc;
    int bh, sq, sk, causal;
    float scale_log2, scale;
    cudaStream_t stream;
};

template <typename T, int D>
int run_fwd(const Args& a) {
    using C = Cfg<D>;
    const size_t smem = (3 * C::TILE_D + C::TILE_P) * sizeof(float);
    auto kern = flash_fwd_kernel<T, D>;
    int e = launch_prep(kern, smem);
    if (e) return e;
    dim3 grid((a.sq + kTile - 1) / kTile, a.bh);
    kern<<<grid, C::NT, smem, a.stream>>>((const T*)a.q, (const T*)a.k, (const T*)a.v,
                                          (T*)a.out, a.lse_out, a.sq, a.sk, a.causal,
                                          a.scale_log2);
    return (int)cudaGetLastError();
}

template <typename T, int D, bool WITH_DQ>
int run_bwd_kv(const Args& a) {
    using C = Cfg<D>;
    const size_t smem = (4 * C::TILE_D + 2 * C::TILE_P + 2 * kTile) * sizeof(float);
    auto kern = flash_bwd_kv_kernel<T, D, WITH_DQ>;
    int e = launch_prep(kern, smem);
    if (e) return e;
    dim3 grid((a.sk + kTile - 1) / kTile, a.bh);
    kern<<<grid, C::NT, smem, a.stream>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout, a.lse, a.delta,
        a.dq_acc, (T*)a.dk, (T*)a.dv, a.sq, a.sk, a.causal, a.scale_log2, a.scale);
    return (int)cudaGetLastError();
}

template <typename T, int D>
int run_bwd_dq(const Args& a) {
    using C = Cfg<D>;
    const size_t smem = (4 * C::TILE_D + C::TILE_P) * sizeof(float);
    auto kern = flash_bwd_dq_kernel<T, D>;
    int e = launch_prep(kern, smem);
    if (e) return e;
    dim3 grid((a.sq + kTile - 1) / kTile, a.bh);
    kern<<<grid, C::NT, smem, a.stream>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout, a.lse, a.delta,
        (T*)a.dq, a.sq, a.sk, a.causal, a.scale_log2, a.scale);
    return (int)cudaGetLastError();
}

enum Which { kFwd, kBwdFused, kBwdDq, kBwdDkv };

template <typename T, int D>
int run_one(Which w, const Args& a) {
    switch (w) {
        case kFwd: return run_fwd<T, D>(a);
        case kBwdFused: return run_bwd_kv<T, D, true>(a);
        case kBwdDq: return run_bwd_dq<T, D>(a);
        case kBwdDkv: return run_bwd_kv<T, D, false>(a);
    }
    return (int)cudaErrorInvalidValue;
}

template <typename T>
int run_d(Which w, int d, const Args& a) {
    switch (d) {
        case 8: return run_one<T, 8>(w, a);
        case 16: return run_one<T, 16>(w, a);
        case 32: return run_one<T, 32>(w, a);
        case 64: return run_one<T, 64>(w, a);
        case 128: return run_one<T, 128>(w, a);
    }
    return (int)cudaErrorInvalidValue;
}

// dtype: 0 = float32 (bfloat16, 1, takes the tensor-core kernels of
// flash_fwd_tc.cu and flash_bwd_tc.cu: no instance here)
int dispatch(Which w, int dtype, int d, const Args& a) {
    if (bad_shape(a.bh, a.sq, a.sk)) return (int)cudaErrorInvalidValue;
    if (a.bh == 0 || a.sq == 0 || a.sk == 0) return (int)cudaGetLastError();
    if (dtype == 0) return run_d<float>(w, d, a);
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// float32 (dtype 0) only; bfloat16 returns cudaErrorInvalidValue
extern "C" int dmt_flash_fwd(const void* q, const void* k, const void* v, void* out,
                             float* lse, int bh, int sq, int sk, int d, int causal, int dtype,
                             float scale_log2, void* stream) {
    Args a{};
    a.q = q; a.k = k; a.v = v; a.out = out; a.lse_out = lse;
    a.bh = bh; a.sq = sq; a.sk = sk; a.causal = causal;
    a.scale_log2 = scale_log2; a.stream = (cudaStream_t)stream;
    return dispatch(kFwd, dtype, d, a);
}

// float32 (dtype 0) only; bfloat16 returns cudaErrorInvalidValue
extern "C" int dmt_flash_bwd_fused(const void* q, const void* k, const void* v,
                                   const void* dout, const float* lse, const float* delta,
                                   float* dq_acc, void* dk, void* dv, int bh, int sq, int sk,
                                   int d, int causal, int dtype, float scale_log2, float scale,
                                   void* stream) {
    Args a{};
    a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse = lse; a.delta = delta;
    a.dq_acc = dq_acc; a.dk = dk; a.dv = dv;
    a.bh = bh; a.sq = sq; a.sk = sk; a.causal = causal;
    a.scale_log2 = scale_log2; a.scale = scale; a.stream = (cudaStream_t)stream;
    return dispatch(kBwdFused, dtype, d, a);
}

// float32 (dtype 0) only; bfloat16 returns cudaErrorInvalidValue
extern "C" int dmt_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const float* lse, const float* delta,
                                void* dq, int bh, int sq, int sk, int d, int causal, int dtype,
                                float scale_log2, float scale, void* stream) {
    Args a{};
    a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse = lse; a.delta = delta; a.dq = dq;
    a.bh = bh; a.sq = sq; a.sk = sk; a.causal = causal;
    a.scale_log2 = scale_log2; a.scale = scale; a.stream = (cudaStream_t)stream;
    return dispatch(kBwdDq, dtype, d, a);
}

// float32 (dtype 0) only; bfloat16 returns cudaErrorInvalidValue
extern "C" int dmt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const float* lse, const float* delta,
                                 void* dk, void* dv, int bh, int sq, int sk, int d, int causal,
                                 int dtype, float scale_log2, float scale, void* stream) {
    Args a{};
    a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse = lse; a.delta = delta;
    a.dk = dk; a.dv = dv;
    a.bh = bh; a.sq = sq; a.sk = sk; a.causal = causal;
    a.scale_log2 = scale_log2; a.scale = scale; a.stream = (cudaStream_t)stream;
    return dispatch(kBwdDkv, dtype, d, a);
}
