// Flash-attention fused backward (K5) and split dK/dV backward (K6b) on the
// tensor cores, bfloat16 in and out, float32 accumulate, at head_dim 16, 32,
// 64 and 128.
//
// Replaces: distributed_ml_pytorch_tpu/ops/attention.py
//   K5 _flash_bwd_core, fused branch (pallas_call at :563, body
//   _flash_bwd_fused_kernel at :428): flash_bwd_tc_kernel;
//   K6b _flash_bwd_core, split dK/dV (pallas_call at :605, body
//   _flash_dkv_kernel): flash_bwd_dkv_tc_kernel, the same body without its
//   dQ stretch (no dS^T tile, no second barrier, no atomics);
// for bfloat16 inputs; float32 stays on the scalar flash_bwd_kv_kernel of
// attention.cu (the tensor cores have no mode that keeps float32's numbers).
// K6b's dK and dV are K5's bit for bit: the same products, summed in the same
// order, with no atomics on either.
//
// Bound on an H100: operations. At the LM's shape (b8 h12 s2048 d64, causal)
// the backward does five products over the causal half of the score plane
// (S^T = K Q^T, dP^T = V dO^T, dV += P^T dO, dK += dS^T Q, dQ += dS K),
// 128.8 GFLOP, 0.130 ms at 989.4 TFLOP/s dense bf16, against 7 (b*h, s, d)
// tensors (q, k, v, dO in; dQ, dK, dV out) and 2 row vectors (lse, delta),
// about 0.05 ms at 3.35 TB/s. K6b does the first four products, 103 GFLOP,
// 0.104 ms.
//
// Design (FlashAttention-2's backward, Dao 2023, Algorithm 2, with mma.sync
// and cp.async, on the fragments of tc_frag.cuh):
//   - one block of 4 warps per (b*h, 64-key tile); blockIdx.x is the key
//     tile, so the causal tiles that see the most queries (kt = 0 sees all)
//     are launched first; each warp owns 16 keys for the whole block and
//     keeps their dK and dV, (16, d) f32 each, in registers to the end;
//   - K and V are copied once into shared memory; at d <= 64 each warp then
//     holds its 16 rows as m16n8k16 A fragments (ldmatrix.x4) for the whole
//     query loop, at d128 it rereads them per product (register pressure);
//   - the query tiles (64 rows of Q and dO, and their 64 lse and delta
//     values) stream through two shared-memory buffers: the cp.async copies
//     of tile i+1 are in flight while tile i is computed; rows at or past sq
//     are zero-filled by the copy itself (source size 0);
//   - rows are padded by 8 bf16 (16 bytes), which puts the 8 rows of every
//     ldmatrix on 8 distinct 16-byte bank groups;
//   - S^T = K Q^T and dP^T = V dO^T: A is the warp's K (V), B is Q (dO)
//     stored (query, d), the col-major B operand (ldmatrix without .trans);
//     the scores are transposed, (key, query), as the TPU kernel chose, so
//     that dV and dK are plain products and lse and delta are per column;
//   - p^T = exp2(s^T - lse) and dS^T = p^T (dP^T - delta) scale stay in
//     registers, from the unrounded f32 p; both are packed to bf16 as the A
//     fragments of dV += p^T dO and dK += dS^T Q (B: dO and Q through
//     ldmatrix.trans), so neither touches shared memory for those products;
//   - dQ = dS K contracts over the block's 64 keys, across the four warps:
//     each warp stores its bf16 dS^T (16 keys x 64 queries) into one padded
//     shared tile (72 bf16 a row: conflict-free 32-bit stores and ldmatrix),
//     a barrier, then each warp computes 16 query rows x d (A: dS through
//     ldmatrix.trans of the transposed tile, B: K through ldmatrix.trans,
//     in passes of at most 64 columns) and adds them into the caller's
//     zeroed f32 (b*h, sq, d) buffer with sm_90's float2 atomicAdd (each
//     thread holds column pairs; on an H100 at the LM shape the kernel takes
//     0.74 ms with it against 1.13 ms with scalar f32 atomics,
//     bench_k5_numerics.py); rows at or past sq add nothing;
//   - only the diagonal tile and the ragged tiles (q0 + 64 > sq or k0 + 64 >
//     sk) pay for the mask; query rows past sq and keys past sk are masked
//     by position, not by their zero-filled values (a zero row would give
//     s = 0, lse = 0, p = 1); causally dead tiles are never visited;
//   - epilogue: dK and dV rows below sk stored as bf16.
// Numerics are the scalar kernel's: f32 scores in log2 space, masked scores
// -1e30 (they underflow to exactly 0), p rounded to bf16 only as the A
// operand of P^T dO, dS from the unrounded p and rounded to bf16 only as the
// A operand of the dK and dQ products, dK and dV summed in f32 over the query
// tiles. dS = p (dP - delta) cancels where dP ~ delta: at a query that sees
// one key (every causal head's first) the exact dS is 0 and an f32 dP leaves
// only its own rounding noise, which the tensor cores' truncating
// accumulation makes larger than an f32 FMA chain's, and different. So dP is
// summed as k16 partials (each truncated on its own scale), and where
// |dP - delta| < 2^-16 |dP| the thread recomputes that dP as the plain
// version and the scalar kernels sum it, one FMA chain in order of d from
// shared memory, so the cancelled dS is theirs. On an H100
// (bench_k5_numerics.py), of 65,535 one-key heads at each d in 16-128 no dQ
// missed the bfloat16 tolerance against the plain version (2-445 did without
// the recompute); on the GPT-2-small step's own inputs 5,336 of 2.0e8 pairs
// are recomputed, 4 % of the kernel's time. dQ's additions come in an order
// that varies from run to run, as in the scalar kernel.
//
// Left for later: wgmma from TMA-fed shared memory with a producer warp
// (FlashAttention-3), dQ without atomics (a separate dQ pass, or a
// deterministic reduction of per-key-tile partials), and tile-shape tuning.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tc_frag.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBK = 16 * kWarps;  // keys per block, 16 per warp
constexpr int kBQ = 64;           // queries per tile
constexpr int kNS = kBQ / 8;      // n8 tiles of a (16-key, 64-query) score slab
constexpr float kNegInf = -1e30f;
// |dP - delta| below this share of |dP| is recomputed in order (see the header)
constexpr float kCancel = 1.0f / 65536.0f;

template <int D>
struct BwdCfg {
    static constexpr int LD = D + 8;            // row stride in bf16 (16 B of padding)
    static constexpr int TILE = 64 * LD;        // bf16 of one (64, D) tile
    static constexpr int LDS = kBQ + 8;         // row stride of the dS^T tile
    static constexpr int KD = D / 16;           // k16 steps over d
    static constexpr int ND = D / 8;            // n8 tiles over d
    static constexpr bool KV_REGS = D <= 64;    // K, V fragments kept in registers
    static constexpr int DQC = D < 64 ? D : 64; // dQ columns per pass
    // K, V, Q x 2, dO x 2; lse x 2 and delta x 2 (f32); then, for dQ, dS^T
    static constexpr int smem(bool with_dq) {
        return 6 * TILE * 2 + 4 * kBQ * 4 + (with_dq ? kBK * LDS * 2 : 0);
    }
};

// rows row0 .. row0+63 of a (rows, D) bf16 matrix into a padded shared tile
// by 16-byte cp.async; rows at or past `rows` are zero-filled
template <int D>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src, int row0,
                                                int rows) {
    constexpr int CH = D / 8;  // 16-byte chunks per row
    constexpr int N = (64 * CH + kThreads - 1) / kThreads;
#pragma unroll
    for (int i = 0; i < N; ++i) {
        const int idx = threadIdx.x + i * kThreads;
        if (64 * CH % kThreads != 0 && idx >= 64 * CH) break;
        const int r = idx / CH, c = idx % CH;
        const int g = row0 + r;
        const bool ok = g < rows;
        tc::cp_async16(dst + r * BwdCfg<D>::LD + c * 8, src + (size_t)(ok ? g : 0) * D + c * 8,
                       ok);
    }
}

// sum_d a[d] b[d] of two 16-byte aligned bf16 rows as one f32 FMA chain in
// order of d, 8 elements a load
template <int D>
__device__ __forceinline__ float dot_seq(const bf16* a, const bf16* b) {
    float acc = 0.0f;
#pragma unroll 1
    for (int c = 0; c < D; c += 8) {
        const uint4 ua = *reinterpret_cast<const uint4*>(a + c);
        const uint4 ub = *reinterpret_cast<const uint4*>(b + c);
        const bf16* xa = reinterpret_cast<const bf16*>(&ua);
        const bf16* xb = reinterpret_cast<const bf16*>(&ub);
#pragma unroll
        for (int i = 0; i < 8; ++i)
            acc = fmaf(__bfloat162float(xa[i]), __bfloat162float(xb[i]), acc);
    }
    return acc;
}

// one query tile's lse (threads 0-63) and delta (threads 64-127), 4 bytes a
// thread (a row of (b*h, sq) f32 need not start 16-byte aligned); zeros past
// `rows`
__device__ __forceinline__ void load_rows_async(float* ls, float* dl, const float* lse,
                                                const float* delta, int row0, int rows) {
    const int r = threadIdx.x & (kBQ - 1);
    const bool ok = row0 + r < rows;
    const float* src = threadIdx.x < kBQ ? lse : delta;
    float* dst = threadIdx.x < kBQ ? ls : dl;
    tc::cp_async4(dst + r, src + (ok ? row0 + r : 0), ok);
}

// One block's work, K5's with WITH_DQ, K6b's without (dq_acc unused).
template <int D, bool WITH_DQ>
__device__ __forceinline__ void bwd_block(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                          const bf16* __restrict__ v,
                                          const bf16* __restrict__ dout,
                                          const float* __restrict__ lse,
                                          const float* __restrict__ delta,
                                          float* __restrict__ dq_acc, bf16* __restrict__ dk,
                                          bf16* __restrict__ dv, int sq, int sk, int causal,
                                          float scale_log2, float scale) {
    using C = BwdCfg<D>;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
    bf16* Vs = Ks + C::TILE;
    bf16* Qs = Vs + C::TILE;      // two buffers
    bf16* Os = Qs + 2 * C::TILE;  // dO, two buffers
    float* Ls = reinterpret_cast<float*>(Os + 2 * C::TILE);  // lse, two buffers
    float* Dl = Ls + 2 * kBQ;                                 // delta, two buffers
    bf16* St = reinterpret_cast<bf16*>(Dl + 2 * kBQ);        // dS^T, (key, query): K5 only

    const int bh = blockIdx.y;
    const int k0 = blockIdx.x * kBK;  // causal: key tile 0 sees every query tile
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane >> 2, t = lane & 3;
    // ldmatrix row addressing: lane supplies a row of matrix lane / 8
    const int mi = lane >> 3, mr = lane & 7;
    const int kr = warp * 16;  // this warp's keys in the tile
    const size_t qoff = (size_t)bh * sq, koff = (size_t)bh * sk;
    const bf16* qb = q + qoff * D;
    const bf16* ob = dout + qoff * D;
    const float* lb = lse + qoff;
    const float* db = delta + qoff;

    const int n_qt = (sq + kBQ - 1) / kBQ;
    // query tiles wholly before this key tile see none of it (causal: sq == sk)
    const int qt_begin = causal ? blockIdx.x : 0;

    load_tile_async<D>(Ks, k + koff * D, k0, sk);
    load_tile_async<D>(Vs, v + koff * D, k0, sk);
    load_tile_async<D>(Qs, qb, qt_begin * kBQ, sq);
    load_tile_async<D>(Os, ob, qt_begin * kBQ, sq);
    load_rows_async(Ls, Dl, lb, db, qt_begin * kBQ, sq);
    tc::cp_async_commit();

    // K and V as A fragments: rows kr + (lane & 15), columns 16 kk + 8 (lane >> 4)
    const int a_off = (kr + (lane & 15)) * C::LD + (lane >> 4) * 8;
    uint32_t kf[C::KV_REGS ? C::KD : 1][4], vf[C::KV_REGS ? C::KD : 1][4];
    tc::cp_async_wait<0>();
    __syncthreads();
    if constexpr (C::KV_REGS) {
#pragma unroll
        for (int kk = 0; kk < C::KD; ++kk) {
            tc::ldmatrix_x4(kf[kk], Ks + a_off + kk * 16);
            tc::ldmatrix_x4(vf[kk], Vs + a_off + kk * 16);
        }
    }

    float dka[C::ND][4], dva[C::ND][4];
#pragma unroll
    for (int j = 0; j < C::ND; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.0f;
    const int key_a = k0 + kr + g;  // this thread's keys: key_a, key_a + 8

    for (int qt = qt_begin; qt < n_qt; ++qt) {
        const int buf = (qt - qt_begin) & 1;
        const int q0 = qt * kBQ;
        // tile qt has landed, and every warp is done with tile qt - 1: its
        // buffers and the dS^T tile are free
        tc::cp_async_wait<0>();
        __syncthreads();
        if (qt + 1 < n_qt) {
            const int nb = buf ^ 1;
            load_tile_async<D>(Qs + nb * C::TILE, qb, q0 + kBQ, sq);
            load_tile_async<D>(Os + nb * C::TILE, ob, q0 + kBQ, sq);
            load_rows_async(Ls + nb * kBQ, Dl + nb * kBQ, lb, db, q0 + kBQ, sq);
            tc::cp_async_commit();
        }
        const bf16* Qt = Qs + buf * C::TILE;
        const bf16* Ot = Os + buf * C::TILE;
        const float* Lt = Ls + buf * kBQ;
        const float* Dt = Dl + buf * kBQ;

        // S^T = K Q^T and dP^T = V dO^T, (16 keys, 64 queries) per warp;
        // ldmatrix.x4 of Q (dO) gives two n8 query tiles at one k16 step
        float s[kNS][4], dp[kNS][4];
#pragma unroll
        for (int j = 0; j < kNS; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
#pragma unroll
        for (int kk = 0; kk < C::KD; ++kk) {
            uint32_t ka[4], va[4];
            if constexpr (C::KV_REGS) {
#pragma unroll
                for (int r = 0; r < 4; ++r) ka[r] = kf[kk][r], va[r] = vf[kk][r];
            } else {
                tc::ldmatrix_x4(ka, Ks + a_off + kk * 16);
                tc::ldmatrix_x4(va, Vs + a_off + kk * 16);
            }
#pragma unroll
            for (int np = 0; np < kNS / 2; ++np) {
                const int off = (np * 16 + (mi >> 1) * 8 + mr) * C::LD + kk * 16 + (mi & 1) * 8;
                uint32_t b[4];
                tc::ldmatrix_x4(b, Qt + off);
                tc::mma_bf16(s[2 * np], ka, b[0], b[1]);
                tc::mma_bf16(s[2 * np + 1], ka, b[2], b[3]);
                // dP^T as k16 partials from zero, added in f32: the tensor
                // cores' accumulation into a running sum truncates, which
                // matters where dP - delta cancels (below)
                float p0[4] = {0.0f, 0.0f, 0.0f, 0.0f}, p1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
                tc::ldmatrix_x4(b, Ot + off);
                tc::mma_bf16(p0, va, b[0], b[1]);
                tc::mma_bf16(p1, va, b[2], b[3]);
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    dp[2 * np][e] += p0[e];
                    dp[2 * np + 1][e] += p1[e];
                }
            }
        }

        // p^T and dS^T in place, per element (key key_a + 8 (e >> 1), query
        // q0 + 8 j + 2 t + (e & 1))
        const bool masked =
            (causal && k0 + kBK - 1 > q0) || q0 + kBQ > sq || k0 + kBK > sk;
        uint32_t cancel = 0;  // bit 4 j + e: dP - delta cancelled, dP to redo
#pragma unroll
        for (int j = 0; j < kNS; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int qc = j * 8 + 2 * t + (e & 1);
                float x = s[j][e] * scale_log2;
                if (masked) {
                    const int qpos = q0 + qc, kpos = key_a + (e >> 1) * 8;
                    if (qpos >= sq || kpos >= sk || (causal && kpos > qpos)) x = kNegInf;
                }
                const float p = exp2f(x - Lt[qc]);
                const float dd = dp[j][e] - Dt[qc];
                if (p != 0.0f && fabsf(dd) < kCancel * fabsf(dp[j][e]))
                    cancel |= 1u << (4 * j + e);
                s[j][e] = p;
                dp[j][e] = (p * dd) * scale;
            }
        }
        if (cancel) {
            // rare (a query that sees one key cancels exactly): dP again in
            // the plain version's order, an f32 FMA chain over d
#pragma unroll
            for (int j = 0; j < kNS; ++j) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    if (!(cancel >> (4 * j + e) & 1u)) continue;
                    const int qc = j * 8 + 2 * t + (e & 1);
                    const float dpe = dot_seq<D>(Ot + qc * C::LD,
                                                 Vs + (kr + g + (e >> 1) * 8) * C::LD);
                    dp[j][e] = (s[j][e] * (dpe - Dt[qc])) * scale;
                }
            }
        }
        // bf16 A fragments: k16 step kk is the query pair of n8 tiles 2kk, 2kk+1
        uint32_t pa[kNS / 2][4], sa[kNS / 2][4];
#pragma unroll
        for (int kk = 0; kk < kNS / 2; ++kk) {
            tc::acc_to_a(pa[kk], s[2 * kk], s[2 * kk + 1]);
            tc::acc_to_a(sa[kk], dp[2 * kk], dp[2 * kk + 1]);
        }

        // dV += p^T dO and dK += dS^T Q: B through ldmatrix.trans (matrices:
        // queries +0/+8 by columns +0/+8)
#pragma unroll
        for (int kk = 0; kk < kNS / 2; ++kk) {
#pragma unroll
            for (int dq2 = 0; dq2 < C::ND / 2; ++dq2) {
                const int off = (kk * 16 + (mi & 1) * 8 + mr) * C::LD + dq2 * 16 + (mi >> 1) * 8;
                uint32_t b[4];
                tc::ldmatrix_x4_trans(b, Ot + off);
                tc::mma_bf16(dva[2 * dq2], pa[kk], b[0], b[1]);
                tc::mma_bf16(dva[2 * dq2 + 1], pa[kk], b[2], b[3]);
                tc::ldmatrix_x4_trans(b, Qt + off);
                tc::mma_bf16(dka[2 * dq2], sa[kk], b[0], b[1]);
                tc::mma_bf16(dka[2 * dq2 + 1], sa[kk], b[2], b[3]);
            }
        }

        // K6b is done with this query tile: dQ is K6a's
        if constexpr (!WITH_DQ) continue;

        // this warp's dS^T rows into the shared tile, for dQ across the warps
        bf16* srow = St + (kr + g) * C::LDS + 2 * t;
#pragma unroll
        for (int kk = 0; kk < kNS / 2; ++kk) {
            *reinterpret_cast<uint32_t*>(srow + kk * 16) = sa[kk][0];
            *reinterpret_cast<uint32_t*>(srow + 8 * C::LDS + kk * 16) = sa[kk][1];
            *reinterpret_cast<uint32_t*>(srow + kk * 16 + 8) = sa[kk][2];
            *reinterpret_cast<uint32_t*>(srow + 8 * C::LDS + kk * 16 + 8) = sa[kk][3];
        }
        __syncthreads();

        // dQ = dS K for query rows warp * 16 .. + 15: A is dS read from the
        // transposed tile (matrices: queries +0/+8 by keys +0/+8), B is K
        // (matrices: keys +0/+8 by columns +0/+8), both through .trans
        const int row_a = q0 + kr + g;  // this thread's dQ rows: row_a, row_a + 8
#pragma unroll
        for (int dh = 0; dh < D; dh += C::DQC) {
            float dq[C::DQC / 8][4];
#pragma unroll
            for (int j = 0; j < C::DQC / 8; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.0f;
#pragma unroll
            for (int kk = 0; kk < kBK / 16; ++kk) {
                uint32_t a[4];
                tc::ldmatrix_x4_trans(a, St + (kk * 16 + (mi >> 1) * 8 + mr) * C::LDS + kr +
                                             (mi & 1) * 8);
#pragma unroll
                for (int dq2 = 0; dq2 < C::DQC / 16; ++dq2) {
                    uint32_t b[4];
                    tc::ldmatrix_x4_trans(b, Ks + (kk * 16 + (mi & 1) * 8 + mr) * C::LD + dh +
                                                 dq2 * 16 + (mi >> 1) * 8);
                    tc::mma_bf16(dq[2 * dq2], a, b[0], b[1]);
                    tc::mma_bf16(dq[2 * dq2 + 1], a, b[2], b[3]);
                }
            }
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                const int row = row_a + 8 * i;
                if (row >= sq) continue;
                float* dst = dq_acc + (qoff + row) * D + dh + 2 * t;
#pragma unroll
                for (int j = 0; j < C::DQC / 8; ++j) {
                    atomicAdd(reinterpret_cast<float2*>(dst + j * 8),
                              make_float2(dq[j][2 * i], dq[j][2 * i + 1]));
                }
            }
        }
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int row = key_a + 8 * i;
        if (row >= sk) continue;
        bf16* dkrow = dk + (koff + row) * D + 2 * t;
        bf16* dvrow = dv + (koff + row) * D + 2 * t;
#pragma unroll
        for (int j = 0; j < C::ND; ++j) {
            *reinterpret_cast<uint32_t*>(dkrow + j * 8) =
                tc::pack_bf16(dka[j][2 * i], dka[j][2 * i + 1]);
            *reinterpret_cast<uint32_t*>(dvrow + j * 8) =
                tc::pack_bf16(dva[j][2 * i], dva[j][2 * i + 1]);
        }
    }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dq_acc, bf16* __restrict__ dk, bf16* __restrict__ dv,
                    int sq, int sk, int causal, float scale_log2, float scale) {
    bwd_block<D, true>(q, k, v, dout, lse, delta, dq_acc, dk, dv, sq, sk, causal, scale_log2,
                       scale);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        bf16* __restrict__ dk, bf16* __restrict__ dv, int sq, int sk,
                        int causal, float scale_log2, float scale) {
    bwd_block<D, false>(q, k, v, dout, lse, delta, nullptr, dk, dv, sq, sk, causal,
                        scale_log2, scale);
}

template <int D, bool WITH_DQ>
int run(const bf16* q, const bf16* k, const bf16* v, const bf16* dout, const float* lse,
        const float* delta, float* dq_acc, bf16* dk, bf16* dv, int bh, int sq, int sk,
        int causal, float scale_log2, float scale, cudaStream_t stream) {
    constexpr int smem = BwdCfg<D>::smem(WITH_DQ);
    const dim3 grid((sk + kBK - 1) / kBK, bh);
    cudaError_t e;
    if constexpr (WITH_DQ) {
        e = cudaFuncSetAttribute(flash_bwd_tc_kernel<D>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return (int)e;
        flash_bwd_tc_kernel<D><<<grid, kThreads, smem, stream>>>(
            q, k, v, dout, lse, delta, dq_acc, dk, dv, sq, sk, causal, scale_log2, scale);
    } else {
        e = cudaFuncSetAttribute(flash_bwd_dkv_tc_kernel<D>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return (int)e;
        flash_bwd_dkv_tc_kernel<D><<<grid, kThreads, smem, stream>>>(
            q, k, v, dout, lse, delta, dk, dv, sq, sk, causal, scale_log2, scale);
    }
    return (int)cudaGetLastError();
}

template <bool WITH_DQ>
int dispatch(const void* q, const void* k, const void* v, const void* dout, const float* lse,
             const float* delta, float* dq_acc, void* dk, void* dv, int bh, int sq, int sk,
             int d, int causal, int dtype, float scale_log2, float scale, void* stream) {
    if (dtype != 1 || bh < 0 || bh > 65535 || sq < 0 || sk < 0)
        return (int)cudaErrorInvalidValue;
    if (bh == 0 || sq == 0 || sk == 0) return (int)cudaGetLastError();
    const bf16 *qp = (const bf16*)q, *kp = (const bf16*)k, *vp = (const bf16*)v,
               *op = (const bf16*)dout;
    bf16 *dkp = (bf16*)dk, *dvp = (bf16*)dv;
    cudaStream_t s = (cudaStream_t)stream;
    switch (d) {
        case 16:
            return run<16, WITH_DQ>(qp, kp, vp, op, lse, delta, dq_acc, dkp, dvp, bh, sq, sk,
                                    causal, scale_log2, scale, s);
        case 32:
            return run<32, WITH_DQ>(qp, kp, vp, op, lse, delta, dq_acc, dkp, dvp, bh, sq, sk,
                                    causal, scale_log2, scale, s);
        case 64:
            return run<64, WITH_DQ>(qp, kp, vp, op, lse, delta, dq_acc, dkp, dvp, bh, sq, sk,
                                    causal, scale_log2, scale, s);
        case 128:
            return run<128, WITH_DQ>(qp, kp, vp, op, lse, delta, dq_acc, dkp, dvp, bh, sq, sk,
                                     causal, scale_log2, scale, s);
    }
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// The arguments of dmt_flash_bwd_fused (attention.cu); dtype must be 1
// (bfloat16). q, k, v and dout must be 16-byte aligned (cp.async); the
// caller checks. dq_acc is a zeroed f32 (b*h, sq, d) buffer that the kernel
// adds into.
extern "C" int dmt_flash_bwd_tc(const void* q, const void* k, const void* v, const void* dout,
                                const float* lse, const float* delta, float* dq_acc, void* dk,
                                void* dv, int bh, int sq, int sk, int d, int causal, int dtype,
                                float scale_log2, float scale, void* stream) {
    return dispatch<true>(q, k, v, dout, lse, delta, dq_acc, dk, dv, bh, sq, sk, d, causal,
                          dtype, scale_log2, scale, stream);
}

// K6b: the arguments of dmt_flash_bwd_dkv (attention.cu); dtype must be 1
// (bfloat16), and q, k, v and dout 16-byte aligned, as above.
extern "C" int dmt_flash_bwd_dkv_tc(const void* q, const void* k, const void* v,
                                    const void* dout, const float* lse, const float* delta,
                                    void* dk, void* dv, int bh, int sq, int sk, int d,
                                    int causal, int dtype, float scale_log2, float scale,
                                    void* stream) {
    return dispatch<false>(q, k, v, dout, lse, delta, nullptr, dk, dv, bh, sq, sk, d, causal,
                           dtype, scale_log2, scale, stream);
}
