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
//   and written, 0.59 ms at 3.35 TB/s). Beside the product, every one of the
//   N*V = 824 M logits needs an exponential and a handful of instructions
//   (the JAX kernel's note, :68-72: "the epilogue is the kernel's bound").
// Routes (ops/fused_head.py::head_update_route picks one from the shapes):
//   - bfloat16 through TMA (head_update_bf16_tma_kernel), when V and D are
//     multiples of 8 and h and logits 16-byte aligned (TMA's row strides and
//     base), as GPT-2-small's are. What held the earlier design (a block
//     per 128 x 128 tile of W, nvcuda::wmma) back, and what this one does:
//     1. dl was computed once for every 128 columns of D, six times at D
//        768. Here a block owns 64 vocabulary rows across 768 columns of D,
//        so dl is computed once per logit at D <= 768 (ceil(D / 768) times
//        beyond, one pass of the grid's y axis each).
//     2. the products were synchronous, between two block barriers per
//        chunk. Here three consumer warpgroups each hold a 64 x 256 float32
//        sum in registers and issue wgmma asynchronously (each k16 step as
//        two m64n128k16, since a block of 512 threads is launched at 128
//        registers a thread and ptxas refuses an n256 product that needs
//        154): the dl pass of one stage runs while the tensor cores
//        multiply the last. setmaxnreg gives the consumers 160 registers
//        and the producer warpgroup 32.
//     3. loads were issued by the threads that compute, a chunk ahead.
//        Here a producer warpgroup (one thread of it) keeps a ring of 4
//        stages in flight with TMA, each stage BN = 32 tokens of the (BN x
//        64) logits tile and of the (BN x 768) h tile (twelve 64-column
//        boxes, 128-byte swizzle), under a "full" mbarrier per slot; each
//        consumer warpgroup releases a slot on its "empty" mbarrier once
//        its products on it are done, and the producer refills it.
//     The dl pass reads each 16-byte chunk of the logits tile and writes
//     the chunk of dl in place, so dl lands in the same swizzled layout:
//     (n, v) with v contiguous, the MN-major A operand of wgmma (transposed
//     by its bf16 transpose bit); h is the MN-major B operand. W is read and
//     written once, from the accumulator fragments, with no atomics, so two
//     launches give the same bits. h is still read once for every 64
//     vocabulary rows (V / 64 times, from L2).
//   - bfloat16, any other shape (head_update_bf16_kernel): a block owns a
//     (128 x 128) tile of W and loops over N in chunks of 32 tokens, with
//     element loads, the dl tile and the h tile staged in shared memory and
//     nvcuda::wmma m16n16k16 products (dl^T the col-major A operand).
//   - float32 (head_update_f32_kernel): the same loop with scalar FMAs, BV =
//     BD = 64, BN = 16, a 4 x 4 micro-tile per thread (a float32 product must
//     not round through TF32).
//   Rows n >= N and columns v >= V (the ragged vocabulary, which the TPU
//   kernel masks) and d >= D are masked in every route, so any N, V and D
//   run; the TPU kernel needed N % 1024 == 0.
// Numerics: dl = (p - [label == v]) * gscale with one rounding to the
//   activation dtype (as the TPU kernel and the XLA formulation round dl to
//   h's dtype before the product); p = exp2f((logit - lse) * log2 e) on the
//   TMA route, as the TPU kernel takes it, and the accurate expf elsewhere;
//   products of two bfloat16 values are exact in float32 and summed in
//   float32 in another order than cuBLAS's; the update is W + (alpha * acc)
//   with two roundings, as the plain version's W - lr * dW.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "hopper.cuh"

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

// ---------------------------------------------------------------- bfloat16, TMA + wgmma

constexpr int kTV = 64;                 // vocabulary rows of a block (wgmma's M)
constexpr int kConsumers = 3;           // consumer warpgroups, 256 columns of D each
constexpr int kDPass = 256 * kConsumers;  // columns of D a block covers
constexpr int kBoxes = kDPass / 64;     // 64-column boxes of h per stage
constexpr int kTBN = 32;                // tokens per stage
constexpr int kStages = 4;              // stages in the ring
constexpr int kConsumerThreads = 128 * kConsumers;
constexpr int kTmaThreads = 128 + kConsumerThreads;  // the producer warpgroup first
// registers a thread after setmaxnreg: 128 x 32 + 384 x 160 = 65536, the
// SM's file, for one block of 512 threads (launched at 128 each)
constexpr int kProducerRegs = 32;
constexpr int kConsumerRegs = 160;
constexpr int kTileBytes = kTBN * 128;  // one (kTBN x 64) bf16 box
constexpr int kStageBytes = kTileBytes * (1 + kBoxes);
constexpr int kBarOffset = kStages * kStageBytes;
constexpr int kTmaSmem = kBarOffset + 2 * kStages * 8 + 1024;  // + alignment to 1024
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kTBN % 16 == 0, "a stage is whole k16 steps");
static_assert(kTileBytes % 1024 == 0, "every box starts on a 1024-byte boundary");
static_assert(kTmaSmem <= 232448, "the ring must fit a block's 227 KB");
static_assert(128 * kProducerRegs + kConsumerThreads * kConsumerRegs <= 65536,
              "the register file");

// Shared memory (1024-aligned): stage s holds the logits box at s *
// kStageBytes (dl is written over it) and h's boxes after it; then a "full"
// and an "empty" mbarrier per slot: full completes when the stage's TMA
// bytes have landed, empty when every consumer warpgroup's products on it
// are done.
struct TmaSmem {
    uint8_t* base;
    __device__ uint8_t* stage(int s) const { return base + s * kStageBytes; }
    __device__ uint64_t* full(int s) const {
        return reinterpret_cast<uint64_t*>(base + kBarOffset) + s;
    }
    __device__ uint64_t* empty(int s) const { return full(kStages + s); }
};

// the producer: stage after stage into the ring, each slot once the
// consumers have released it
__device__ __forceinline__ void produce(const CUtensorMap* h_map, const CUtensorMap* logits_map,
                                        const TmaSmem& sm, int v0, int d0, int active,
                                        int n_stages) {
    hopper::tma_prefetch_map(h_map);
    hopper::tma_prefetch_map(logits_map);
    const uint32_t bytes = kTileBytes * (1 + 4 * active);
    for (int s = 0; s < n_stages; ++s) {
        const int slot = s % kStages, n0 = s * kTBN;
        if (s >= kStages) hopper::mbar_wait(sm.empty(slot), (s / kStages - 1) & 1);
        uint8_t* stage = sm.stage(slot);
        hopper::mbar_arrive_expect_tx(sm.full(slot), bytes);
        hopper::tma_load_2d(stage, logits_map, sm.full(slot), v0, n0);
        for (int j = 0; j < 4 * active; ++j)
            hopper::tma_load_2d(stage + kTileBytes * (1 + j), h_map, sm.full(slot), d0 + 64 * j,
                                n0);
    }
}

// consumer warpgroup c: its share of every stage's dl pass, then the whole
// dl tile times columns d0 + 256 c .. + 255 of h; W updated at the end
__device__ __forceinline__ void consume(float* __restrict__ W, const TmaSmem& sm,
                                        const float* __restrict__ lse,
                                        const long long* __restrict__ labels,
                                        const float* __restrict__ gscale, float alpha, int v0,
                                        int d0, int active, int n_stages, int N, int D, int V,
                                        int c) {
    const int t = threadIdx.x - 128;  // 0 .. kConsumerThreads - 1
    const bool mma = c < active;

    // chunk q = t + kConsumerThreads i of a stage's logits box is row r = q /
    // 8 at chunk position q % 8, which holds the 8 logits of columns 8 ((q %
    // 8) ^ (r % 8)) .. + 7 (the 128-byte swizzle); each thread keeps its
    // rows' lse, gscale and label one stage ahead in registers
    constexpr int kChunks = (kTBN * 8 + kConsumerThreads - 1) / kConsumerThreads;
    float m_lse[kChunks], m_scale[kChunks];
    int m_label[kChunks];
    auto fetch_meta = [&](int s) {
#pragma unroll
        for (int i = 0; i < kChunks; ++i) {
            const int n = s * kTBN + (t + kConsumerThreads * i) / 8;
            const bool in = n < N && s < n_stages;
            m_lse[i] = in ? lse[n] : 0.0f;
            m_scale[i] = in ? gscale[n] : 0.0f;
            m_label[i] = in ? (int)labels[n] : -1;
        }
    };
    fetch_meta(0);

    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.0f;

    for (int s = 0; s < n_stages; ++s) {
        const int slot = s % kStages;
        uint8_t* tile = sm.stage(slot);
        hopper::mbar_wait(sm.full(slot), (s / kStages) & 1);
        // dl in place over the logits box; V % 8 == 0, so a chunk is in
        // range or out of it whole
#pragma unroll
        for (int i = 0; i < kChunks; ++i) {
            const int q = t + kConsumerThreads * i;
            if (q >= kTBN * 8) break;
            const int r = q >> 3;
            const int v = v0 + (((q & 7) ^ (r & 7)) << 3);
            uint4* p = reinterpret_cast<uint4*>(tile + q * 16);
            uint4 out = make_uint4(0u, 0u, 0u, 0u);
            if (v < V) {
                const uint4 x = *p;
                const unsigned in[4] = {x.x, x.y, x.z, x.w};
                unsigned o[4];
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    // a 32-bit word holds values 2k (low half) and 2k + 1; a
                    // bfloat16's float32 value is its bits shifted up by 16
                    float dl[2];
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const float x1 = __uint_as_float(e ? in[k] & 0xffff0000u : in[k] << 16);
                        const float pr = exp2f(__fmul_rn(__fsub_rn(x1, m_lse[i]), kLog2e));
                        const float onehot = m_label[i] == v + 2 * k + e ? 1.0f : 0.0f;
                        dl[e] = __fmul_rn(__fsub_rn(pr, onehot), m_scale[i]);
                    }
                    const __nv_bfloat162 b2 = __floats2bfloat162_rn(dl[0], dl[1]);
                    o[k] = *reinterpret_cast<const unsigned*>(&b2);
                }
                out = make_uint4(o[0], o[1], o[2], o[3]);
            }
            *p = out;
        }
        fetch_meta(s + 1);
        hopper::fence_proxy_async();
        hopper::named_barrier(1, kConsumerThreads);  // the dl tile is whole
        if (mma) {
            // each k16 step as two n128 products (a single n256 one needs
            // more than the 128 registers a thread has at launch)
            const uint8_t* hb = tile + kTileBytes * (1 + 4 * c);
            hopper::wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < kTBN / 16; ++kk) {
                const uint64_t a = hopper::desc_sw128(tile + kk * 2048, kTileBytes, 1024);
                hopper::wgmma_m64n128k16_bf16<1, 1>(
                    acc, a, hopper::desc_sw128(hb + kk * 2048, kTileBytes, 1024));
                hopper::wgmma_m64n128k16_bf16<1, 1>(
                    acc + 64, a,
                    hopper::desc_sw128(hb + 2 * kTileBytes + kk * 2048, kTileBytes, 1024));
            }
            hopper::wgmma_commit();
        }
        // this warpgroup's products on the previous stage are done: release it
        hopper::wgmma_wait<1>();
        if (s > 0 && t % 128 == 0) hopper::mbar_arrive(sm.empty((s - 1) % kStages));
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    if (!mma) return;

    // W = W + alpha * acc: acc[64 h + 4 j + 2 i + e] is row 16 w + l / 4 +
    // 8 i, column 128 h + 8 j + 2 (l % 4) + e of the warpgroup's 64 x 256 tile
    const int w = (t % 128) / 32, lane = t % 32;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        const int col = d0 + 256 * c + 128 * half + 2 * (lane % 4);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int v = v0 + 16 * w + lane / 4 + 8 * i;
            if (v >= V) continue;
            float* row = W + (long long)v * D + col;
#pragma unroll
            for (int j = 0; j < 16; ++j) {
                if (col + 8 * j >= D) break;
                float2* pw = reinterpret_cast<float2*>(row + 8 * j);
                float2 wv = *pw;
                wv.x = __fadd_rn(wv.x, __fmul_rn(alpha, acc[64 * half + 4 * j + 2 * i]));
                wv.y = __fadd_rn(wv.y, __fmul_rn(alpha, acc[64 * half + 4 * j + 2 * i + 1]));
                *pw = wv;
            }
        }
    }
}

// one block per (64 vocabulary rows, 768 columns of D): warpgroup 0 the
// producer (one thread issues every load, the warpgroup gives its registers
// away), warpgroups 1-3 the consumers
__global__ void __launch_bounds__(kTmaThreads, 1)
    head_update_bf16_tma_kernel(const __grid_constant__ CUtensorMap h_map,
                                const __grid_constant__ CUtensorMap logits_map,
                                float* __restrict__ W, const float* __restrict__ lse,
                                const long long* __restrict__ labels,
                                const float* __restrict__ gscale, float alpha, int N, int D,
                                int V) {
    extern __shared__ uint8_t smem_raw[];
    const TmaSmem sm{reinterpret_cast<uint8_t*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023))};
    const int v0 = blockIdx.x * kTV;
    const int d0 = blockIdx.y * kDPass;
    const int active = min(kConsumers, (D - d0 + 255) / 256);  // warpgroups with columns
    const int n_stages = (N + kTBN - 1) / kTBN;

    if (threadIdx.x == 0) {
        for (int s = 0; s < kStages; ++s) {
            hopper::mbar_init(sm.full(s), 1);
            hopper::mbar_init(sm.empty(s), kConsumers);
        }
        hopper::mbar_fence_init();
    }
    __syncthreads();

    // warp-uniform in the compiler's eyes (a broadcast), as setmaxnreg needs
    const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
    if (wg == 0) {
        hopper::setmaxnreg_dec<kProducerRegs>();
        if (threadIdx.x == 0) produce(&h_map, &logits_map, sm, v0, d0, active, n_stages);
    } else {
        hopper::setmaxnreg_inc<kConsumerRegs>();
        consume(W, sm, lse, labels, gscale, alpha, v0, d0, active, n_stages, N, D, V, wg - 1);
    }
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
// activation dtype; lse, gscale (N,) float32; labels (N,) int64. route: 0 =
// float32, 1 = bfloat16 with element loads, 2 = bfloat16 through TMA (V and
// D multiples of 8, h and logits 16-byte aligned; anything else is refused
// with cudaErrorInvalidValue). The caller picks the route; nothing here
// falls back to another.
extern "C" int dmt_head_update(void* W, const void* h, const void* logits, const float* lse,
                               const long long* labels, const float* gscale, float alpha,
                               int N, int D, int V, int route, void* stream) {
    if (N <= 0 || D <= 0 || V <= 0) return (int)cudaGetLastError();
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    if (route == 2) {
        if (V % 8 != 0 || D % 8 != 0 || ((uintptr_t)h & 15) != 0 ||
            ((uintptr_t)logits & 15) != 0)
            return (int)cudaErrorInvalidValue;
        CUtensorMap h_map, logits_map;
        if (!hopper::encode_bf16_sw128(&h_map, h, N, D, kTBN) ||
            !hopper::encode_bf16_sw128(&logits_map, logits, N, V, kTBN))
            return (int)cudaErrorInvalidValue;
        const cudaError_t e = cudaFuncSetAttribute(
            head_update_bf16_tma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kTmaSmem);
        if (e != cudaSuccess) return (int)e;
        const dim3 grid((V + kTV - 1) / kTV, (D + kDPass - 1) / kDPass);
        head_update_bf16_tma_kernel<<<grid, kTmaThreads, kTmaSmem, s>>>(
            h_map, logits_map, static_cast<float*>(W), lse, labels, gscale, alpha, N, D, V);
    } else if (route == 1) {
        const dim3 grid((D + kBD - 1) / kBD, (V + kBV - 1) / kBV);
        head_update_bf16_kernel<<<grid, kThreadsMma, 0, s>>>(
            static_cast<float*>(W), static_cast<const __nv_bfloat16*>(h),
            static_cast<const __nv_bfloat16*>(logits), lse, labels, gscale, alpha, N, D, V);
    } else if (route == 0) {
        const dim3 grid((D + kSD - 1) / kSD, (V + kSV - 1) / kSV);
        head_update_f32_kernel<<<grid, kThreadsScalar, 0, s>>>(
            static_cast<float*>(W), static_cast<const float*>(h),
            static_cast<const float*>(logits), lse, labels, gscale, alpha, N, D, V);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
