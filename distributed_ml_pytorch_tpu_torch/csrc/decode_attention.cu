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
// Design (flash-decoding on a thread-block cluster). The TPU kernel ran one
// grid instance per batch row with the heads unrolled and the whole context
// in VMEM (hence its 4096-key gate); here the keys are a loop, so any context
// length runs, and two things keep the loads of that loop in flight:
//   - Loads ahead of the reduction. A key is taken by a group of LPK
//     adjacent lanes, each loading 16 bytes of the K row and 16 of the V row
//     (LPK = D * sizeof(elem) / 16: 8 lanes at d64 bf16, 4 at d64 int8, 1 at
//     d16 int8, 32 at d128 f32), so a warp reads 32/LPK whole rows per load
//     with 128-bit loads. Each group issues the loads of U keys (a chunk: 4,
//     2 under int8) before any arithmetic, forms their U scores (a few
//     __shfl_xor_sync steps each, interleaved), then does one max update and
//     one rescale of its online-softmax state for the chunk. No key takes a
//     branch that depends on the data: a masked key's score is -inf and its
//     weight 0. Few loads wait on another: q, t and ring_base are read at
//     once at entry, and the ring's first pass is issued with the big
//     cache's first chunk, so a block at the decode shape waits on three
//     rounds of device memory (its state, the first chunk, the second).
//   - Keys split over a thread-block cluster. The grid is S * B * H blocks of
//     kWarps warps, one cluster of S consecutive blocks per (b, h) (S in
//     1, 2, 4, 8, the portable cluster sizes; the wrapper picks S from the
//     shapes alone, so that a small batch still fills the card in one wave).
//     Rank r folds its share of the big cache's keys [0, ring_base); rank
//     S - 1 also folds the ring and the fresh token. Each warp merges its groups'
//     states by shuffles, the block merges its warps' in shared memory (and,
//     alone in its cluster, writes the output), and after cluster.sync()
//     rank 0 reads the other ranks' (acc[D], m, l)
//     through distributed shared memory (map_shared_rank), merges them in
//     rank order and writes the output; a second cluster.sync() keeps the
//     other blocks' shared memory alive until that read is done. One launch,
//     no global scratch, no atomics: deterministic, and graph-capturable.
//
// Masks and per-row state: t and ring_base are (B,) int32 device tensors read
// by each block through their row stride, 0 where every row shares one value
// (no host sync, no copy). Keys at or past ring_base in the big cache,
// and ring slots at or past t, are not read at all — the reference masks them
// to -inf, which contributes exactly 0. A rank whose share is empty (every
// rank but the last when ring_base = 0) holds m = -inf, l = 0: every merge
// subtracts a finite reference max (0 where all maxima are -inf), so its
// weight is exp(-inf) = 0, never exp(-inf - -inf) = NaN.
//
// Numerics: scores = dot(q, k) in f32, times scale_k under int8, divided by
// sqrt(d); the fresh token is always present, so the softmax never sees an
// empty row. The value sum is in f32 with p * scale_v folded into the weight.
// The reference rounds p (times scale_v) to the activation dtype before its
// P·V products; this kernel keeps p in f32 — under bf16 that rounding is the
// whole difference between the two. The split changes only the order of the
// f32 sums.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBlocksPerSM = 3;  // 80 registers a thread at most
constexpr int kSlots = 2 * kWarps;  // warp states: big cache, then (int8) ring
constexpr int kMaxSplits = 8;       // the largest portable cluster
constexpr unsigned kFull = 0xffffffffu;

// 16 bytes of a row, as raw bits (loaded ahead) and converted to f32.
template <typename E>
struct Vec;

template <>
struct Vec<float> {
    static constexpr int N = 4;
    __device__ static void cvt(const uint4& u, float* o) {
        o[0] = __uint_as_float(u.x); o[1] = __uint_as_float(u.y);
        o[2] = __uint_as_float(u.z); o[3] = __uint_as_float(u.w);
    }
};

template <>
struct Vec<__nv_bfloat16> {
    static constexpr int N = 8;
    __device__ static void cvt(const uint4& u, float* o) {
        const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            // a bf16 is the high half of the f32 with the same bits
            o[2 * i] = __uint_as_float(w[i] << 16);
            o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
        }
    }
};

template <>
struct Vec<int8_t> {
    static constexpr int N = 16;
    __device__ static void cvt(const uint4& u, float* o) {
        const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int i = 0; i < 16; ++i)
            o[i] = static_cast<float>(static_cast<int8_t>(w[i / 4] >> (8 * (i % 4))));
    }
};

// Big-cache keys a lane group has in flight: 4, or 2 for int8 (whose 16
// converted elements a key would otherwise cost twice the registers).
template <typename E>
__host__ __device__ constexpr int unroll() {
    return sizeof(E) == 1 ? 2 : 4;
}

__device__ __forceinline__ uint4 ld16(const void* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// The max that a merge subtracts: finite, so a state with m = -inf gets
// weight exp(-inf) = 0 even when every state's m is -inf.
__device__ __forceinline__ float ref_max(float m) { return m == -INFINITY ? 0.f : m; }

// Where the keys of one fold live: rows j < n - 1 (all rows when k_last is
// null) are k + j * ks; with k_last set, row n - 1 is k_last. Under kScale
// each score is multiplied by sk[j * sks] and each weight by sv[j * svs].
template <typename E>
struct Keys {
    const E* k;
    long long ks;
    const E* v;
    long long vs;
    const E* k_last;
    const E* v_last;
    const float* sk;
    long long sks;
    const float* sv;
    long long svs;
};

// Lane-group geometry of a fold over element type E at head_dim D.
template <typename E, int D>
struct Lanes {
    static constexpr int N = Vec<E>::N;    // elements a lane holds
    static constexpr int LPK = D / N;      // lanes per key
    static constexpr int KPW = 32 / LPK;   // keys a warp reads per load
    static constexpr int G = kWarps * KPW; // lane groups in the block
};

// One lane's share of U keys, loaded before any of them is reduced.
template <int U>
struct Chunk {
    uint4 k[U], v[U];
    float sc[U], wv[U];
};

// One lane's online-softmax state: max m, sum l, its N columns of the
// weighted value sum.
template <int N>
struct State {
    float m = -INFINITY, l = 0.f, acc[N] = {};
};

// Issue the loads of keys base + u * G + gid (u < U) below n.
template <typename E, int D, bool kScale, int U>
__device__ __forceinline__ void issue(Chunk<U>& c, const Keys<E>& src, int base, int n) {
    using L = Lanes<E, D>;
    const int lane = threadIdx.x % 32;
    const int gid = (threadIdx.x / 32) * L::KPW + lane / L::LPK;
    const int col = (lane % L::LPK) * L::N;
#pragma unroll
    for (int u = 0; u < U; ++u) {
        const int j = base + u * L::G + gid;
        c.k[u] = c.v[u] = make_uint4(0u, 0u, 0u, 0u);
        c.sc[u] = c.wv[u] = 1.f;
        if (j < n) {
            const bool last = src.k_last != nullptr && j == n - 1;
            c.k[u] = ld16((last ? src.k_last : src.k + j * src.ks) + col);
            c.v[u] = ld16((last ? src.v_last : src.v + j * src.vs) + col);
            if (kScale) {
                c.sc[u] = __ldg(src.sk + j * src.sks);
                c.wv[u] = __ldg(src.sv + j * src.svs);
            }
        }
    }
}

// Fold the chunk's keys (those below n) into st: U scores, their group sums
// interleaved, then one max update and one rescale for the chunk; a masked
// key (never loaded: its values are 0) has score -inf and weight 0, with no
// branch on the data.
template <typename E, int D, bool kScale, int U>
__device__ __forceinline__ void consume(const Chunk<U>& c, int base, int n, const float* qv,
                                        float sqrt_d, State<Lanes<E, D>::N>& st) {
    using L = Lanes<E, D>;
    constexpr int N = L::N;
    const int lane = threadIdx.x % 32;
    const int gid = (threadIdx.x / 32) * L::KPW + lane / L::LPK;
    float s[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
        float f[N];
        Vec<E>::cvt(c.k[u], f);
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < N; ++i) part = fmaf(qv[i], f[i], part);
        s[u] = part;
    }
#pragma unroll
    for (int off = L::LPK / 2; off > 0; off >>= 1)
#pragma unroll
        for (int u = 0; u < U; ++u) s[u] += __shfl_xor_sync(kFull, s[u], off);
    float mc = st.m;
#pragma unroll
    for (int u = 0; u < U; ++u) {
        s[u] = base + u * L::G + gid < n ? s[u] * c.sc[u] / sqrt_d : -INFINITY;
        mc = fmaxf(mc, s[u]);
    }
    const float mr = ref_max(mc);
    const float r = expf(st.m - mr);
    st.l *= r;
#pragma unroll
    for (int i = 0; i < N; ++i) st.acc[i] *= r;
    st.m = mc;
#pragma unroll
    for (int u = 0; u < U; ++u) {
        const float p = expf(s[u] - mr);
        st.l += p;
        const float pw = p * c.wv[u];
        float f[N];
        Vec<E>::cvt(c.v[u], f);
#pragma unroll
        for (int i = 0; i < N; ++i) st.acc[i] = fmaf(pw, f[i], st.acc[i]);
    }
}

// Merge the states of a warp's lane groups (lanes sub, sub + LPK, ...) by a
// butterfly of shuffles, then write group 0's (the warp's) to shared slot
// `slot`.
template <typename E, int D>
__device__ void warp_state_to_slot(State<Lanes<E, D>::N> st, int slot, float* m_s, float* l_s,
                                   float* acc_s) {
    using L = Lanes<E, D>;
#pragma unroll
    for (int off = L::LPK; off < 32; off <<= 1) {
        const float mo = __shfl_xor_sync(kFull, st.m, off);
        const float lo = __shfl_xor_sync(kFull, st.l, off);
        const float mr = ref_max(fmaxf(st.m, mo));
        const float a = expf(st.m - mr), b = expf(mo - mr);
        st.l = fmaf(lo, b, st.l * a);
#pragma unroll
        for (int i = 0; i < L::N; ++i) {
            const float ao = __shfl_xor_sync(kFull, st.acc[i], off);
            st.acc[i] = fmaf(ao, b, st.acc[i] * a);
        }
        st.m = fmaxf(st.m, mo);
    }
    const int lane = threadIdx.x % 32;
    if (lane < L::LPK) {
#pragma unroll
        for (int i = 0; i < L::N; ++i) acc_s[slot * D + lane * L::N + i] = st.acc[i];
    }
    if (lane == 0) {
        m_s[slot] = st.m;
        l_s[slot] = st.l;
    }
}

// a when kFirst, else b (two names for one object where types agree)
template <bool kFirst, typename A, typename B>
__device__ __forceinline__ auto& pick(A& a, B& b) {
    if constexpr (kFirst) return a;
    else return b;
}

// This lane's N columns of q, in f32.
template <typename E, int D, typename T>
__device__ __forceinline__ void load_q(const T* q, float* qv) {
    using L = Lanes<E, D>;
    const int col = (threadIdx.x % 32 % L::LPK) * L::N;
#pragma unroll
    for (int i = 0; i < L::N; ++i) qv[i] = to_f32(q[col + i]);
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
    // element strides (b, h[, position]) of q, kn, vn, bk, bv, rk, rv, sk, sv;
    // then of t and ring_base (0 for a value every row shares)
    long long q_b, q_h, kn_b, kn_h, vn_b, vn_h;
    long long bk_b, bk_h, bk_c, bv_b, bv_h, bv_c;
    long long rk_b, rk_h, rk_t, rv_b, rv_h, rv_t;
    long long sk_b, sk_h, sk_c, sv_b, sv_h, sv_c;
    long long t_b, rb_b;
    int B, H, C, T;
    int splits;  // blocks per (b, h): the cluster size
    float sqrt_d;
};

// T: activation dtype (q, ring, fresh token, output); S: big-cache storage.
template <typename T, typename S, int D>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
decode_attention_kernel(const Params p) {
    constexpr bool kQuant = sizeof(S) == 1;
    constexpr int UB = unroll<S>();  // big-cache keys per group in flight
    using LB = Lanes<S, D>;
    using LR = Lanes<T, D>;
    __shared__ float m_s[kSlots];
    __shared__ float l_s[kSlots];
    __shared__ float acc_s[kSlots * D];
    __shared__ float blk[D + 2];  // this block's state: acc[D], m, l

    cg::cluster_group cluster = cg::this_cluster();
    const int rank = blockIdx.x % p.splits;  // == cluster.block_rank()
    const int bh = blockIdx.x / p.splits;
    const int b = bh / p.H;
    const int h = bh % p.H;
    const int warp = threadIdx.x / 32;
    const bool ring = rank == p.splits - 1;  // this rank also folds the ring

    // every small load at once: the row's state and q
    const int rb_raw = p.ring_base[b * p.rb_b];
    const int t_raw = p.t[b * p.t_b];
    const T* q = static_cast<const T*>(p.q) + b * p.q_b + h * p.q_h;
    // the ring's lanes hold other columns than the big cache's only under
    // int8; otherwise the ring folds into the big cache's state
    float qb[LB::N], qr[LR::N];
    load_q<S, D>(q, qb);
    if constexpr (kQuant) load_q<T, D>(q, qr);
    const auto& q_ring = pick<kQuant>(qr, qb);
    State<LB::N> sb;
    State<LR::N> sr;
    auto& s_ring = pick<kQuant>(sr, sb);

    const Keys<S> big{static_cast<const S*>(p.bk) + b * p.bk_b + h * p.bk_h, p.bk_c,
                      static_cast<const S*>(p.bv) + b * p.bv_b + h * p.bv_h, p.bv_c,
                      nullptr, nullptr,
                      kQuant ? p.sk + b * p.sk_b + h * p.sk_h : nullptr, p.sk_c,
                      kQuant ? p.sv + b * p.sv_b + h * p.sv_h : nullptr, p.sv_c};
    const Keys<T> rng{static_cast<const T*>(p.rk) + b * p.rk_b + h * p.rk_h, p.rk_t,
                      static_cast<const T*>(p.rv) + b * p.rv_b + h * p.rv_h, p.rv_t,
                      static_cast<const T*>(p.kn) + b * p.kn_b + h * p.kn_h,
                      static_cast<const T*>(p.vn) + b * p.vn_b + h * p.vn_h,
                      nullptr, 0, nullptr, 0};
    // this rank's share of the big cache's live keys; the ring's filled
    // slots and the fresh token (ring rank only)
    const int nb = max(0, min(rb_raw, p.C));
    const int per = (nb + p.splits - 1) / p.splits;
    const int j0 = min(nb, rank * per);
    const int j1 = min(nb, j0 + per);
    const int nr = ring ? max(0, min(t_raw, p.T)) + 1 : 0;

    // the ring's first pass and the big cache's first chunk in flight together
    Chunk<1> cr;
    issue<T, D, false, 1>(cr, rng, 0, nr);
    Chunk<UB> cb;
    issue<S, D, kQuant, UB>(cb, big, j0, j1);
    consume<T, D, false, 1>(cr, 0, nr, q_ring, p.sqrt_d, s_ring);
    for (int base = LR::G; base < nr; base += LR::G) {  // a ring longer than G
        issue<T, D, false, 1>(cr, rng, base, nr);
        consume<T, D, false, 1>(cr, base, nr, q_ring, p.sqrt_d, s_ring);
    }
    for (int base = j0; base < j1; base += LB::G * UB) {
        if (base != j0) issue<S, D, kQuant, UB>(cb, big, base, j1);
        consume<S, D, kQuant, UB>(cb, base, j1, qb, p.sqrt_d, sb);
    }
    warp_state_to_slot<S, D>(sb, warp, m_s, l_s, acc_s);
    const bool ring_slots = kQuant && ring;
    if (ring_slots) warp_state_to_slot<T, D>(sr, kWarps + warp, m_s, l_s, acc_s);
    __syncthreads();

    // the block's warps, merged in slot order; one block per (b, h) writes
    // the output here
    const int slots = ring_slots ? kSlots : kWarps;
    const int d = threadIdx.x;
    T* out = static_cast<T*>(p.out) + static_cast<long long>(bh) * D;
    if (d < D) {
        float mx = -INFINITY;
#pragma unroll
        for (int s = 0; s < kSlots; ++s)
            if (s < slots) mx = fmaxf(mx, m_s[s]);
        const float mr = ref_max(mx);
        float l = 0.f, o = 0.f;
#pragma unroll
        for (int s = 0; s < kSlots; ++s) {
            if (s < slots) {
                const float w = expf(m_s[s] - mr);
                l = fmaf(l_s[s], w, l);
                o = fmaf(acc_s[s * D + d], w, o);
            }
        }
        if (p.splits == 1) store(out + d, o / l);
        blk[d] = o;
        if (d == 0) {
            blk[D] = mx;
            blk[D + 1] = l;
        }
    }
    if (p.splits == 1) return;  // the same for every block: no cluster to wait on
    cluster.sync();

    // rank 0 merges the cluster's blocks in rank order, every remote read
    // issued before the first is used
    if (rank == 0 && d < D) {
        float mo[kMaxSplits], lo[kMaxSplits], ao[kMaxSplits];
#pragma unroll
        for (int r = 0; r < kMaxSplits; ++r) {
            mo[r] = -INFINITY;
            lo[r] = ao[r] = 0.f;
            if (r < p.splits) {
                const float* other = cluster.map_shared_rank(blk, r);
                mo[r] = other[D];
                lo[r] = other[D + 1];
                ao[r] = other[d];
            }
        }
        float mx = -INFINITY;
#pragma unroll
        for (int r = 0; r < kMaxSplits; ++r) mx = fmaxf(mx, mo[r]);
        const float mr = ref_max(mx);
        float l = 0.f, o = 0.f;
#pragma unroll
        for (int r = 0; r < kMaxSplits; ++r) {
            const float w = expf(mo[r] - mr);
            l = fmaf(lo[r], w, l);
            o = fmaf(ao[r], w, o);
        }
        store(out + d, o / l);
    }
    // the other ranks' shared memory stays until rank 0 has read it
    cluster.sync();
}

template <typename T, typename S>
cudaError_t launch_d(const Params& p, int d, cudaStream_t s) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(p.splits * p.B * p.H);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = p.splits;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    cudaError_t e;
    switch (d) {
        case 16: e = cudaLaunchKernelEx(&cfg, decode_attention_kernel<T, S, 16>, p); break;
        case 32: e = cudaLaunchKernelEx(&cfg, decode_attention_kernel<T, S, 32>, p); break;
        case 64: e = cudaLaunchKernelEx(&cfg, decode_attention_kernel<T, S, 64>, p); break;
        case 128: e = cudaLaunchKernelEx(&cfg, decode_attention_kernel<T, S, 128>, p); break;
        default: return cudaErrorInvalidValue;
    }
    return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace

// ptrs: q, k_new, v_new, big_k, big_v, ring_k, ring_v, scale_k, scale_v, t,
//   ring_base, out (scales null unless quant).
// strides: the 26 element strides of Params, in its order.
// dims: B, H, C, T, D, act dtype (0 float32, 1 bfloat16), quant (0/1),
//   splits (1, 2, 4 or 8: blocks per (b, h), launched as one cluster).
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for a
// head_dim, dtype or split count the kernel is not built for).
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
    p.t_b = st[24]; p.rb_b = st[25];
    p.B = dims[0]; p.H = dims[1]; p.C = dims[2]; p.T = dims[3];
    p.splits = dims[7];
    p.sqrt_d = sqrt_d;
    const int d = dims[4], act = dims[5], quant = dims[6];
    if (p.splits != 1 && p.splits != 2 && p.splits != 4 && p.splits != 8)
        return (int)cudaErrorInvalidValue;
    if (static_cast<long long>(p.B) * p.H * p.splits > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
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
