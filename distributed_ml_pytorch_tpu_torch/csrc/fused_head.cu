// fused_head: the lm_head SGD update W += alpha * dl^T h with
// dl = (softmax(logits) - onehot(labels)) * gscale, dl never in memory (K7).
//
// Replaces: distributed_ml_pytorch_tpu/ops/fused_head.py, _head_update_pallas
//   (pallas_call at :105, body _head_update_kernel at :59) — the dW matmul and
//   W update of the restructured lm_head train step under use_kernel=True.
// Layout: the port keeps lm_head.weight as (V, D), so W[v, d] += alpha *
//   sum_n dl[n, v] * h[n, d]; the TPU kernel's W is (D, V). h is (N, D) and
//   logits (N, V), both in the activation dtype; lse and gscale (N,) float32;
//   labels (N,) int64; alpha = -lr.
// Bound on an H100: operations at GPT-2-small widths. At N = 16384, D = 768,
//   V = 50304 the product is 2*N*D*V = 1.27 TFLOP (1.28 ms at 989 TFLOP/s,
//   bf16 tensor cores) against 1.98 GB to move (logits once, h once, W read
//   and written, 0.59 ms at 3.35 TB/s).
// Design. The TPU kernel walks a grid (vocab tile, token chunk) with the
//   token axis sequential, carrying the (D, BLOCK_V) sum in VMEM scratch. On
//   the card the sequential axis becomes a loop inside one block: a block
//   owns a (BV x BD) tile of W, loops over N in chunks of BN tokens, and per
//   chunk computes the (BN x BV) tile of dl from the logits, lse, gscale and
//   labels in float32, rounds it to the activation dtype (as the TPU kernel
//   and the XLA formulation round dl to h's dtype before the product), stages
//   it and the (BN x BD) tile of h in shared memory, and accumulates dl^T h
//   in float32. W is read and written once, at the end. Rows n >= N and
//   columns v >= V (the ragged vocabulary, which the TPU kernel masks) and
//   d >= D are masked, so any N, V and D run; the TPU kernel needed
//   N % 1024 == 0. dl is recomputed for each of the ceil(D / BD) d-tiles of
//   a vocab tile (neighbouring blocks, so the logits tile comes from L2).
//   - bfloat16: BV = BD = 128, BN = 32, eight warps, each accumulating a
//     32 x 64 sub-tile with nvcuda::wmma m16n16k16 bf16 products into f32
//     fragments (dl^T is the col-major A operand, h the row-major B). When V
//     and D are multiples of 8 (GPT-2-small's are) each thread loads 16-byte
//     vectors, and the next chunk's loads are issued before this chunk's
//     products, so the global latency hides behind the tensor cores; two
//     blocks share an SM. Any other shape takes element loads, one chunk at
//     a time.
//   - float32: scalar FMAs, BV = BD = 64, BN = 16, a 4 x 4 micro-tile per
//     thread (a float32 product must not round through TF32).
//   TMA, wgmma and a pipelined ring of tiles are later work.
// Numerics: p = expf(logit - lse) (the accurate expf, as torch.exp),
//   dl = (p - [label == v]) * gscale, one rounding to the activation dtype;
//   products of two bfloat16 values are exact in float32 and summed in
//   float32 in another order than cuBLAS's; the update is W + (alpha * acc)
//   with two roundings, as the plain version's W - lr * dW.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

// ---------------------------------------------------------------- bfloat16

constexpr int kBV = 128;
constexpr int kBD = 128;
constexpr int kBN = 32;
constexpr int kLd = 128 + 8;  // shared row stride (a multiple of 8 bf16 values)
constexpr int kThreadsMma = 256;

using AccTile = wmma::fragment<wmma::accumulator, 16, 16, 16, float>[2][4];

// this chunk's dl^T h into the warp's 32 x 64 sub-tile of acc: dl is the
// col-major A operand (its (n, v) tile is (v, n) column-major), h the
// row-major B
__device__ __forceinline__ void mma_chunk(AccTile& acc, const __nv_bfloat16* sA,
                                          const __nv_bfloat16* sB, int warp_v, int warp_d) {
#pragma unroll
    for (int kk = 0; kk < kBN; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> a[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
            wmma::load_matrix_sync(a[i], sA + kk * kLd + warp_v * 32 + i * 16, kLd);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
            wmma::load_matrix_sync(b, sB + kk * kLd + warp_d * 64 + j * 16, kLd);
#pragma unroll
            for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], a[i], b, acc[i][j]);
        }
    }
}

// each fragment through the warp's 16 x 16 staging tile, then W = W +
// alpha * acc where (v, d) is in range
__device__ __forceinline__ void write_back(AccTile& acc, float* stage, float* W, float alpha,
                                           int v_base, int d_base, int D, int V, int lane) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            wmma::store_matrix_sync(stage, acc[i][j], 16, wmma::mem_row_major);
            __syncwarp();
#pragma unroll
            for (int t = 0; t < 8; ++t) {
                const int e = lane + 32 * t;
                const int v = v_base + i * 16 + e / 16;
                const int d = d_base + j * 16 + e % 16;
                if (v < V && d < D) {
                    float* w = W + (long long)v * D + d;
                    *w = __fadd_rn(*w, __fmul_rn(alpha, stage[e]));
                }
            }
            __syncwarp();
        }
    }
}

__device__ __forceinline__ float dlogit(float logit, float lse, long long label, int v,
                                        float scale) {
    const float p = expf(__fsub_rn(logit, lse));
    const float onehot = label == v ? 1.0f : 0.0f;
    return __fmul_rn(__fsub_rn(p, onehot), scale);
}

// V and D multiples of 8, logits and h 16-byte aligned: each thread moves
// two 16-byte vectors of logits and two of h per chunk, and the next
// chunk's loads are in flight while the warps run this chunk's products.
// Held to 128 registers so that two blocks share an SM and one's dl pass
// overlaps the other's products (chip_smoke.py phase 11 on an H100 SXM at
// 700 W, GPT-2-small b8 x 2048: 168 registers and one block per SM 13.9 ms,
// two blocks 11.5 ms)
__global__ void __launch_bounds__(kThreadsMma, 2)
    head_update_bf16_vec_kernel(float* __restrict__ W, const __nv_bfloat16* __restrict__ h,
                                const __nv_bfloat16* __restrict__ logits,
                                const float* __restrict__ lse,
                                const long long* __restrict__ labels,
                                const float* __restrict__ gscale, float alpha, int N, int D,
                                int V) {
    __shared__ __align__(32) __nv_bfloat16 sA[kBN * kLd];  // dl, (n, v)
    __shared__ __align__(32) __nv_bfloat16 sB[kBN * kLd];  // h, (n, d)
    __shared__ __align__(32) float sStage[8][16 * 16];

    const int tid = threadIdx.x;
    const int warp = tid / 32, lane = tid % 32;
    const int warp_v = warp % 4;  // 4 x 32 rows of v
    const int warp_d = warp / 4;  // 2 x 64 columns of d
    const int d0 = blockIdx.x * kBD;
    const int v0 = blockIdx.y * kBV;

    AccTile acc;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

    // slot r of this thread: 8 values at row nl = e / 16, columns
    // cl .. cl + 7 with cl = (e % 16) * 8, where e = tid + 256 r
    uint4 rl[2], rh[2];
    float rlse[2], rsc[2];
    long long rlab[2];
    bool rvalid[2];
    const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);

    auto load = [&](int n0) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const int e = tid + kThreadsMma * r;
            const int n = n0 + e / 16, cl = (e % 16) * 8;
            const bool in_n = n < N;
            rvalid[r] = in_n && v0 + cl < V;
            rl[r] = rvalid[r] ? *reinterpret_cast<const uint4*>(logits + (long long)n * V + v0 + cl)
                              : zero4;
            rh[r] = in_n && d0 + cl < D
                        ? *reinterpret_cast<const uint4*>(h + (long long)n * D + d0 + cl)
                        : zero4;
            rlse[r] = in_n ? lse[n] : 0.0f;
            rsc[r] = in_n ? gscale[n] : 0.0f;
            rlab[r] = in_n ? labels[n] : -1;
        }
    };

    load(0);
    for (int n0 = 0; n0 < N; n0 += kBN) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const int e = tid + kThreadsMma * r;
            const int nl = e / 16, cl = (e % 16) * 8;
            // a 32-bit word holds values 2k (low half) and 2k + 1 (high half);
            // a bfloat16's float32 value is its bits shifted up by 16
            const unsigned in[4] = {rl[r].x, rl[r].y, rl[r].z, rl[r].w};
            unsigned out[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                float dl[2] = {0.0f, 0.0f};
                if (rvalid[r]) {
                    const float lo = __uint_as_float(in[k] << 16);
                    const float hi = __uint_as_float(in[k] & 0xffff0000u);
                    dl[0] = dlogit(lo, rlse[r], rlab[r], v0 + cl + 2 * k, rsc[r]);
                    dl[1] = dlogit(hi, rlse[r], rlab[r], v0 + cl + 2 * k + 1, rsc[r]);
                }
                out[k] = (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(dl[0])) |
                         ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(dl[1])) << 16);
            }
            *reinterpret_cast<uint4*>(sA + nl * kLd + cl) =
                make_uint4(out[0], out[1], out[2], out[3]);
            *reinterpret_cast<uint4*>(sB + nl * kLd + cl) = rh[r];
        }
        __syncthreads();
        if (n0 + kBN < N) load(n0 + kBN);
        mma_chunk(acc, sA, sB, warp_v, warp_d);
        __syncthreads();
    }
    write_back(acc, sStage[warp], W, alpha, v0 + warp_v * 32, d0 + warp_d * 64, D, V, lane);
}

// any V and D, any alignment: element loads, one chunk at a time
__global__ void __launch_bounds__(kThreadsMma)
    head_update_bf16_kernel(float* __restrict__ W, const __nv_bfloat16* __restrict__ h,
                            const __nv_bfloat16* __restrict__ logits,
                            const float* __restrict__ lse, const long long* __restrict__ labels,
                            const float* __restrict__ gscale, float alpha, int N, int D,
                            int V) {
    __shared__ __align__(32) __nv_bfloat16 sA[kBN * kLd];
    __shared__ __align__(32) __nv_bfloat16 sB[kBN * kLd];
    __shared__ __align__(32) float sStage[8][16 * 16];
    __shared__ float sLse[kBN], sScale[kBN];
    __shared__ long long sLabel[kBN];

    const int tid = threadIdx.x;
    const int warp = tid / 32, lane = tid % 32;
    const int warp_v = warp % 4;
    const int warp_d = warp / 4;
    const int d0 = blockIdx.x * kBD;
    const int v0 = blockIdx.y * kBV;
    const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);

    AccTile acc;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

    for (int n0 = 0; n0 < N; n0 += kBN) {
        if (tid < kBN) {
            const int n = n0 + tid;
            sLse[tid] = n < N ? lse[n] : 0.0f;
            sScale[tid] = n < N ? gscale[n] : 0.0f;
            sLabel[tid] = n < N ? labels[n] : -1;
        }
        __syncthreads();
        // 32 x 128 tiles, 16 elements per thread, the fast index along v (d)
#pragma unroll 4
        for (int r = 0; r < kBN * kBV / kThreadsMma; ++r) {
            const int e = tid + r * kThreadsMma;
            const int nl = e / kBV, cl = e % kBV;
            const int n = n0 + nl;
            const int v = v0 + cl;
            __nv_bfloat16 dl = zero;
            if (n < N && v < V)
                dl = __float2bfloat16_rn(dlogit(__bfloat162float(logits[(long long)n * V + v]),
                                                sLse[nl], sLabel[nl], v, sScale[nl]));
            sA[nl * kLd + cl] = dl;
            const int d = d0 + cl;
            sB[nl * kLd + cl] = (n < N && d < D) ? h[(long long)n * D + d] : zero;
        }
        __syncthreads();
        mma_chunk(acc, sA, sB, warp_v, warp_d);
        __syncthreads();
    }
    write_back(acc, sStage[warp], W, alpha, v0 + warp_v * 32, d0 + warp_d * 64, D, V, lane);
}

// ---------------------------------------------------------------- float32

constexpr int kSV = 64;
constexpr int kSD = 64;
constexpr int kSN = 16;
constexpr int kThreadsScalar = 256;

__global__ void __launch_bounds__(kThreadsScalar)
    head_update_f32_kernel(float* __restrict__ W, const float* __restrict__ h,
                           const float* __restrict__ logits, const float* __restrict__ lse,
                           const long long* __restrict__ labels,
                           const float* __restrict__ gscale, float alpha, int N, int D, int V) {
    __shared__ float sA[kSN][kSV];  // dl, (n, v)
    __shared__ float sB[kSN][kSD];  // h, (n, d)
    const int tid = threadIdx.x;
    const int ty = tid / 16, tx = tid % 16;  // rows ty + 16 i, columns tx + 16 j
    const int d0 = blockIdx.x * kSD;
    const int v0 = blockIdx.y * kSV;
    float acc[4][4] = {};

    for (int n0 = 0; n0 < N; n0 += kSN) {
#pragma unroll
        for (int r = 0; r < kSN * kSV / kThreadsScalar; ++r) {
            const int e = tid + r * kThreadsScalar;
            const int nl = e / kSV, cl = e % kSV;
            const int n = n0 + nl;
            const int v = v0 + cl;
            float dl = 0.0f;
            if (n < N && v < V) {
                const float p = expf(__fsub_rn(logits[(long long)n * V + v], lse[n]));
                const float onehot = labels[n] == v ? 1.0f : 0.0f;
                dl = __fmul_rn(__fsub_rn(p, onehot), gscale[n]);
            }
            sA[nl][cl] = dl;
            const int d = d0 + cl;
            sB[nl][cl] = (n < N && d < D) ? h[(long long)n * D + d] : 0.0f;
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < kSN; ++k) {
            float a[4], b[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = sA[k][ty + 16 * i];
#pragma unroll
            for (int j = 0; j < 4; ++j) b[j] = sB[k][tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
        __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int v = v0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int d = d0 + tx + 16 * j;
            if (v < V && d < D) {
                float* w = W + (long long)v * D + d;
                *w = __fadd_rn(*w, __fmul_rn(alpha, acc[i][j]));
            }
        }
    }
}

}  // namespace

// W (V, D) float32, updated in place; h (N, D) and logits (N, V) in the
// activation dtype (0 = float32, 1 = bfloat16); lse, gscale (N,) float32;
// labels (N,) int64
extern "C" int dmt_head_update(void* W, const void* h, const void* logits, const float* lse,
                               const long long* labels, const float* gscale, float alpha,
                               int N, int D, int V, int dtype, void* stream) {
    if (N <= 0 || D <= 0 || V <= 0) return (int)cudaGetLastError();
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    if (dtype == 1) {
        const dim3 grid((D + kBD - 1) / kBD, (V + kBV - 1) / kBV);
        const bool vec = V % 8 == 0 && D % 8 == 0 && ((uintptr_t)h & 15) == 0 &&
                         ((uintptr_t)logits & 15) == 0;
        auto kernel = vec ? head_update_bf16_vec_kernel : head_update_bf16_kernel;
        kernel<<<grid, kThreadsMma, 0, s>>>(
            static_cast<float*>(W), static_cast<const __nv_bfloat16*>(h),
            static_cast<const __nv_bfloat16*>(logits), lse, labels, gscale, alpha, N, D, V);
    } else if (dtype == 0) {
        const dim3 grid((D + kSD - 1) / kSD, (V + kSV - 1) / kSV);
        head_update_f32_kernel<<<grid, kThreadsScalar, 0, s>>>(
            static_cast<float*>(W), static_cast<const float*>(h),
            static_cast<const float*>(logits), lse, labels, gscale, alpha, N, D, V);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
