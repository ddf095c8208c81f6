// Flash-attention forward (K4) on the tensor cores, bfloat16 in and out,
// float32 accumulate, at head_dim 16, 32, 64 and 128.
//
// Replaces: distributed_ml_pytorch_tpu/ops/attention.py
//   K4 _flash_fwd (pallas_call at :311, body _flash_kernel at :196)
// for bfloat16 inputs; float32 stays on the scalar flash_fwd_kernel of
// attention.cu (the tensor cores have no mode that keeps float32's numbers).
//
// Bound on an H100: operations. At the LM's shape (b8 h12 s2048 d64, causal)
// the forward does two products over the causal half of the score plane,
// 51.5 GFLOP, 0.052 ms at 989 TFLOP/s dense bf16, against 101 MB of q, k,
// v, out and lse (0.030 ms at 3.35 TB/s).
//
// Design (FlashAttention-2's, with mma.sync and cp.async):
//   - one block of 4 warps per (b*h, 64-query tile), causal tiles launched
//     longest first; each warp owns 16 query rows and keeps them to the end;
//   - Q is copied once into shared memory and then held in registers as
//     m16n8k16 A fragments (ldmatrix.x4);
//   - the key tiles (64 keys) stream through two shared-memory buffers per
//     operand: cp.async.cg 16-byte copies of tile j+1 are in flight while
//     tile j is computed; rows at or past sk are zero-filled by the copy
//     itself (source size 0), so no stale row of the other buffer survives;
//   - rows are padded by 8 bf16 (16 bytes), which puts the 8 rows of every
//     ldmatrix on 8 distinct 16-byte bank groups;
//   - S = Q K^T by mma.sync m16n8k16 (K stored (key, d) is the col-major B
//     operand: ldmatrix without .trans), scaled into log2 space;
//   - the online softmax stays in registers: each thread holds two rows
//     (g and g + 8 of its warp's 16), row maxima go across the 4 lanes of a
//     quad by __shfl_xor_sync 1 and 2, the row sums are kept per thread and
//     reduced once at the end; only the diagonal tile and the ragged last
//     tile pay for the mask, causally dead tiles are never visited;
//   - O += P V: the S accumulators, rounded to bf16 in registers, are the A
//     fragments of the second product (P never touches shared memory); V
//     comes through ldmatrix.trans;
//   - epilogue: O / max(l, 1e-30) in bf16, lse2 = m + log2(l) as (b*h, sq)
//     f32, rows at or past sq not stored.
// Numerics are the scalar kernel's: f32 scores, masked scores -1e30 (they
// underflow to exactly 0), p rounded to bf16 before the PV product, l summed
// from the unrounded f32 p.
//
// Tile shape: 4 warps x 64 keys. On an H100 (bench_k4_tiles.py at the LM
// shape) 8 warps (128 queries) tie with it, and 128-key tiles lose to
// register pressure (255 registers and spills at d128).
//
// Left for later: wgmma from TMA-fed shared memory with a producer warp
// (FlashAttention-3), once the fused backward (K5) has its tensor-core
// version on these fragments; and 16-byte output stores through shared
// memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tc_frag.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBM = 16 * kWarps;  // query rows per block, 16 per warp
constexpr int kBN = 64;           // keys per tile
constexpr float kNegInf = -1e30f;

template <int D>
struct TcCfg {
    static constexpr int LD = D + 8;                 // row stride in bf16 (16 B of padding)
    static constexpr int QTILE = kBM * LD;           // bf16 of the query tile
    static constexpr int KTILE = kBN * LD;           // bf16 of one key (value) tile
    static constexpr int SMEM = (QTILE + 4 * KTILE) * 2;  // bytes: Q, K x 2, V x 2
    static constexpr int KD = D / 16;                // k16 steps of Q K^T
    static constexpr int ND = D / 8;                 // n8 tiles of O
};

// rows row0 .. row0+ROWS-1 of a (rows, D) bf16 matrix into a padded shared
// tile by 16-byte cp.async; rows at or past `rows` are zero-filled
template <int D, int ROWS>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src, int row0,
                                                int rows) {
    constexpr int CH = D / 8;  // 16-byte chunks per row
    constexpr int N = (ROWS * CH + kThreads - 1) / kThreads;
#pragma unroll
    for (int i = 0; i < N; ++i) {
        const int idx = threadIdx.x + i * kThreads;
        if (ROWS * CH % kThreads != 0 && idx >= ROWS * CH) break;
        const int r = idx / CH, c = idx % CH;
        const int g = row0 + r;
        const bool ok = g < rows;
        tc::cp_async16(dst + r * TcCfg<D>::LD + c * 8, src + (size_t)(ok ? g : 0) * D + c * 8,
                       ok);
    }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ out,
                    float* __restrict__ lse, int sq, int sk, int causal, float scale_log2) {
    using C = TcCfg<D>;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
    bf16* Ks = Qs + C::QTILE;      // two buffers
    bf16* Vs = Ks + 2 * C::KTILE;  // two buffers

    const int bh = blockIdx.y;
    const int qt = gridDim.x - 1 - blockIdx.x;  // causal: the longest rows start first
    const int q0 = qt * kBM;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane >> 2, t = lane & 3;
    // ldmatrix row addressing: lane supplies a row of matrix lane / 8
    const int mi = lane >> 3, mr = lane & 7;
    const bf16* qb = q + (size_t)bh * sq * D;
    const bf16* kb = k + (size_t)bh * sk * D;
    const bf16* vb = v + (size_t)bh * sk * D;

    const int n_kt = (sk + kBN - 1) / kBN;
    // keys past this query tile's last row see none of it (causal: sq == sk)
    const int kt_end = causal ? min(n_kt, (q0 + kBM + kBN - 1) / kBN) : n_kt;

    load_tile_async<D, kBM>(Qs, qb, q0, sq);
    tc::cp_async_commit();
    load_tile_async<D, kBN>(Ks, kb, 0, sk);
    load_tile_async<D, kBN>(Vs, vb, 0, sk);
    tc::cp_async_commit();

    // Q as A fragments: rows warp*16 + (lane & 15), columns 16 kk + 8 (lane >> 4)
    tc::cp_async_wait<1>();
    __syncthreads();
    uint32_t qf[C::KD][4];
#pragma unroll
    for (int kk = 0; kk < C::KD; ++kk)
        tc::ldmatrix_x4(qf[kk], Qs + (warp * 16 + (lane & 15)) * C::LD + kk * 16 + (lane >> 4) * 8);

    float o[C::ND][4];
#pragma unroll
    for (int j = 0; j < C::ND; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
    const int row_a = q0 + warp * 16 + g;  // this thread's rows: row_a, row_a + 8

    for (int kt = 0; kt < kt_end; ++kt) {
        const int buf = kt & 1;
        if (kt + 1 < kt_end) {
            // the other buffers were released by the barrier ending kt - 1
            load_tile_async<D, kBN>(Ks + (buf ^ 1) * C::KTILE, kb, (kt + 1) * kBN, sk);
            load_tile_async<D, kBN>(Vs + (buf ^ 1) * C::KTILE, vb, (kt + 1) * kBN, sk);
            tc::cp_async_commit();
            tc::cp_async_wait<1>();
        } else {
            tc::cp_async_wait<0>();
        }
        __syncthreads();
        const bf16* Kt = Ks + buf * C::KTILE;
        const bf16* Vt = Vs + buf * C::KTILE;

        // S = Q K^T: kBN / 8 n8 tiles of keys; ldmatrix.x4 gives two of them
        // at one k16 step (matrices: keys +0/+8 by columns +0/+8)
        constexpr int NS = kBN / 8;
        float s[NS][4];
#pragma unroll
        for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
        for (int kk = 0; kk < C::KD; ++kk) {
#pragma unroll
            for (int np = 0; np < NS / 2; ++np) {
                uint32_t b[4];
                tc::ldmatrix_x4(b, Kt + (np * 16 + (mi >> 1) * 8 + mr) * C::LD + kk * 16 +
                                       (mi & 1) * 8);
                tc::mma_bf16(s[2 * np], qf[kk], b[0], b[1]);
                tc::mma_bf16(s[2 * np + 1], qf[kk], b[2], b[3]);
            }
        }

        const int k0 = kt * kBN;
        const bool masked = (causal && k0 + kBN - 1 > q0) || k0 + kBN > sk;
        float mx[2] = {kNegInf, kNegInf};
#pragma unroll
        for (int j = 0; j < NS; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                float x = s[j][e] * scale_log2;
                if (masked) {
                    const int kpos = k0 + j * 8 + 2 * t + (e & 1);
                    const int qpos = row_a + (e >> 1) * 8;
                    if (kpos >= sk || (causal && kpos > qpos)) x = kNegInf;
                }
                s[j][e] = x;
                mx[e >> 1] = fmaxf(mx[e >> 1], x);
            }
        }
        float corr[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
            mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
            const float m_new = fmaxf(m[i], mx[i]);
            corr[i] = exp2f(m[i] - m_new);
            m[i] = m_new;
        }
        float sum[2] = {0.0f, 0.0f};
#pragma unroll
        for (int j = 0; j < NS; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float p = exp2f(s[j][e] - m[e >> 1]);
                sum[e >> 1] += p;
                s[j][e] = p;
            }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + sum[i];
#pragma unroll
        for (int j = 0; j < C::ND; ++j) {
            o[j][0] *= corr[0];
            o[j][1] *= corr[0];
            o[j][2] *= corr[1];
            o[j][3] *= corr[1];
        }

        // O += P V: P's k16 steps are pairs of S tiles, in registers; V
        // through ldmatrix.trans (matrices: keys +0/+8 by columns +0/+8)
#pragma unroll
        for (int kk = 0; kk < kBN / 16; ++kk) {
            uint32_t a[4];
            tc::acc_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
            for (int dp = 0; dp < C::ND / 2; ++dp) {
                uint32_t b[4];
                tc::ldmatrix_x4_trans(b, Vt + (kk * 16 + (mi & 1) * 8 + mr) * C::LD + dp * 16 +
                                             (mi >> 1) * 8);
                tc::mma_bf16(o[2 * dp], a, b[0], b[1]);
                tc::mma_bf16(o[2 * dp + 1], a, b[2], b[3]);
            }
        }
        __syncthreads();  // this tile's buffers are free for tile kt + 2
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
        const int row = row_a + 8 * i;
        if (row >= sq) continue;
        const float lf = fmaxf(l[i], 1e-30f);
        bf16* orow = out + ((size_t)bh * sq + row) * D;
#pragma unroll
        for (int j = 0; j < C::ND; ++j) {
            const uint32_t pr = tc::pack_bf16(o[j][2 * i] / lf, o[j][2 * i + 1] / lf);
            *reinterpret_cast<uint32_t*>(orow + j * 8 + 2 * t) = pr;
        }
        if (t == 0) lse[(size_t)bh * sq + row] = m[i] + log2f(lf);
    }
}

template <int D>
int run(const bf16* q, const bf16* k, const bf16* v, bf16* out, float* lse, int bh, int sq,
        int sk, int causal, float scale_log2, cudaStream_t stream) {
    constexpr int smem = TcCfg<D>::SMEM;
    auto kern = flash_fwd_tc_kernel<D>;
    cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((sq + kBM - 1) / kBM, bh);
    kern<<<grid, kThreads, smem, stream>>>(q, k, v, out, lse, sq, sk, causal, scale_log2);
    return (int)cudaGetLastError();
}

}  // namespace

// The arguments of dmt_flash_fwd (attention.cu); dtype must be 1 (bfloat16).
// Every pointer must be 16-byte aligned (cp.async); the caller checks.
extern "C" int dmt_flash_fwd_tc(const void* q, const void* k, const void* v, void* out,
                                float* lse, int bh, int sq, int sk, int d, int causal,
                                int dtype, float scale_log2, void* stream) {
    if (dtype != 1 || bh < 0 || bh > 65535 || sq < 0 || sk < 0)
        return (int)cudaErrorInvalidValue;
    if (bh == 0 || sq == 0 || sk == 0) return (int)cudaGetLastError();
    const bf16 *qp = (const bf16*)q, *kp = (const bf16*)k, *vp = (const bf16*)v;
    bf16* op = (bf16*)out;
    cudaStream_t s = (cudaStream_t)stream;
    switch (d) {
        case 16: return run<16>(qp, kp, vp, op, lse, bh, sq, sk, causal, scale_log2, s);
        case 32: return run<32>(qp, kp, vp, op, lse, bh, sq, sk, causal, scale_log2, s);
        case 64: return run<64>(qp, kp, vp, op, lse, bh, sq, sk, causal, scale_log2, s);
        case 128: return run<128>(qp, kp, vp, op, lse, bh, sq, sk, causal, scale_log2, s);
    }
    return (int)cudaErrorInvalidValue;
}
