// Flash attention over [B, T, H, D], forward and backward, causal or not.
//
// Replaces the Pallas TPU flash-attention kernels that
// `ddl_tpu/ops/attention.py::flash_attention_bthd` reaches through JAX's
// bundled `jax/experimental/pallas/ops/tpu/flash_attention.py`:
//
//   forward   `_flash_attention_impl`     O = softmax(Q K^T * scale + mask) V
//   dK, dV    `_flash_attention_bwd_dkv`  recomputes P from the saved rows
//   dQ        `_flash_attention_bwd_dq`   recomputes P from the saved rows
//
// The forward saves one fp32 log-sum-exp per query row (LSE [B, H, T]) in
// place of the TPU kernel's separate row max `m` and row sum `l`; both
// backward kernels recompute P = exp(S * scale - LSE). The backward takes
// delta = rowsum(dO * O) in fp32 from the caller, as the JAX code computes
// it in plain jnp outside its kernels. dK/dV and dQ are two kernels with
// no atomics, so the gradients are deterministic (bit-equal on a repeat).
//
// Layout: q, k, v, o, dO and the gradients are read and written in the
// model's [B, T, H, D] layout through the strides the caller passes (batch,
// row and head stride; the D elements of a row are contiguous), so there is
// no transpose copy. The TPU wrapper transposes to [B, H, T, D] and back.
//
// What bounds them on Hopper: operations. Each score costs 2*D flops per
// product; at the LM's shape [4, 2048, 8, 64] the causal half is 67M
// (query, key) pairs, far above the card's operations-per-byte balance.
//
// Forward (`flash_fwd_kernel`): every product on the CUDA cores in plain
// fp32 FMAs; its bound is the fp32 CUDA-core peak (67 TFLOP/s on an H100
// SXM). A block of 128 threads owns a 64-row query tile and loops over key
// tiles; operands are staged reduction-index-major with 4 floats of row
// padding, so a product step reads each thread's operands with 16-byte
// loads; the 16 x 8 thread grid puts the 8 threads of a row in one warp,
// so the online softmax reduces rows with shuffles.
//
// Backward (`flash_bwd_dkv_kernel`, `flash_bwd_dq_kernel`): every product
// on the TF32 tensor cores (mma.sync m16n8k8, tf32_mma.cuh) to fp32
// accuracy, "3xTF32": each fp32 operand is split into hi = tf32(x) and
// lo = tf32(x - hi), and a b = a_lo b_hi + a_hi b_lo + a_hi b_hi. One TF32
// pass would keep about 3 decimal digits, too few for the fp32 gradients'
// gates. bf16 inputs widen to exact TF32 values (lo = 0), so the products
// of two inputs (S, dP) take one pass and those with P or dS two. The
// bound is thus 3 x products over the TF32 tensor-core rate (495 TFLOP/s
// dense), not the CUDA cores. The design:
//
// - Warps own rows. A block of 4 warps owns 64 rows of the outer index
//   (keys for dK/dV, queries for dQ), 16 rows a warp, and loops over tiles
//   of 32 rows of the inner index (16 for dK/dV at D = 128, so that its
//   16 x 128 dK and dV accumulators, 128 registers a thread, fit). Each
//   warp computes its 16 x 32 tiles of S and dP, forms P and dS in the
//   accumulator layout (causal and ragged masks, lse and delta applied
//   there), and multiplies them on into its 16 x D gradient accumulators:
//   no shared-memory round trip for P or dS.
// - Sums kept short. The tensor cores' fp32 sums truncate instead of
//   rounding to nearest, and a chain of thousands of products into one
//   accumulator drifts (2e-5 relative at the LM's shape, enough to fail
//   the flash-vs-plain training gate). So S and dP keep the small TF32
//   terms in an accumulator of their own, and each 16 x 8 gradient tile
//   sums one inner tile in a fresh accumulator that is added to the running
//   one in IEEE fp32: the gradients are then as accurate as the plain fp32
//   version.
// - P and dS go from the accumulator layout to the A-operand layout without
//   shuffles: the second product's reduction index is permuted inside each
//   group of 8 (k = t <-> column 2t, k = t + 4 <-> column 2t + 1), so the A
//   fragment is (c0, c2, c1, c3) of the accumulator, and the B operand's
//   rows follow the same permutation (rows 2t and 2t + 1).
// - One copy of each tile, staged as it lies in memory (row-major, in the
//   inputs' type) with 16 bytes of padding a row. The fragment loads along
//   D (bank 4 row + col) and, thanks to the permutation, those along rows
//   (bank 8 t + g) are both free of bank conflicts at that one pad.
// - The streamed tiles (Q, dO, lse, delta for dK/dV; K, V for dQ) are
//   double-buffered with cp.async: tile i + 1 loads while tile i multiplies.
// - Causal load balance: the grid's fast index runs over (batch, head) and
//   its slow index over tiles, heaviest first (the key tile at 0 for dK/dV,
//   the last query tile for dQ), so the longest blocks start first. A warp
//   whose 16 rows see none of a tile skips it.
//
// Each launcher launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() of its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRowGroups = 16;  // threadIdx.x / 8: which 4 rows a thread owns
constexpr int kColGroups = 8;   // threadIdx.x % 8: which column run (lanes of one warp)
constexpr int kPad = 4;         // floats of padding per shared row (keeps 16-byte alignment)
constexpr int kOuter = 64;      // rows of the outer tile a block owns

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename E>
__device__ __forceinline__ E from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
    return __float2bfloat16_rn(x);
}

// N consecutive floats from shared memory, with 16-byte (or 8-byte) loads.
template <int N>
__device__ __forceinline__ void lds(float (&dst)[N], const float* src) {
    if constexpr (N % 4 == 0) {
#pragma unroll
        for (int i = 0; i < N; i += 4) {
            const float4 t = *reinterpret_cast<const float4*>(src + i);
            dst[i] = t.x;
            dst[i + 1] = t.y;
            dst[i + 2] = t.z;
            dst[i + 3] = t.w;
        }
    } else {
        static_assert(N % 2 == 0, "runs of an even number of floats");
#pragma unroll
        for (int i = 0; i < N; i += 2) {
            const float2 t = *reinterpret_cast<const float2*>(src + i);
            dst[i] = t.x;
            dst[i + 1] = t.y;
        }
    }
}

// acc[i][j] += sum_{r < R} A[r * lda + i] * B[r * ldb + j]. Both operands
// are stored reduction-index-major, so each step reads TM and TN
// consecutive floats and does TM * TN FMAs.
template <int TM, int TN, int R>
__device__ __forceinline__ void rr_product(float (&acc)[TM][TN], const float* A, int lda,
                                           const float* B, int ldb) {
#pragma unroll 4
    for (int r = 0; r < R; ++r) {
        float a[TM], b[TN];
        lds(a, A + r * lda);
        lds(b, B + r * ldb);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
#pragma unroll
            for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
    }
}

// Rows [row0, row0 + ROWS) of one (batch, head) slice, all D columns, into
// shared memory as fp32: row-major into `rm` ([ROWS][D + kPad]) and/or
// transposed into `tr` ([D][ROWS + kPad]). Rows at or past T read as zero.
template <int ROWS, int D, typename E>
__device__ __forceinline__ void load_tile(float* rm, float* tr, const E* src,
                                          int64_t row_stride, int row0, int T) {
    for (int idx = threadIdx.x; idx < ROWS * D; idx += kThreads) {
        const int r = idx / D, d = idx % D;
        float x = 0.f;
        if (row0 + r < T) x = to_f32(src[(int64_t)(row0 + r) * row_stride + d]);
        if (rm != nullptr) rm[r * (D + kPad) + d] = x;
        if (tr != nullptr) tr[d * (ROWS + kPad) + r] = x;
    }
}

__device__ __forceinline__ bool visible(int qi, int kj, int T, int causal) {
    return qi < T && kj < T && (!causal || kj <= qi);
}

// ---------------------------------------------------------------- forward

template <int D>
struct FwdTile {
    static constexpr int BM = kOuter, BN = 64;
    static constexpr int LQ = BM + kPad, LK = BN + kPad, LV = D + kPad;
    // Qt [D][LQ], Kt [D][LK], V [BN][LV], Pt [BN][LQ]
    static constexpr int kFloats = D * LQ + D * LK + BN * LV + BN * LQ;
};

template <typename E, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const E* __restrict__ q, const E* __restrict__ k, const E* __restrict__ v,
                     E* __restrict__ o, float* __restrict__ lse, int T, int H, int64_t sB,
                     int64_t sT, int64_t sH, float scale, int causal) {
    using S = FwdTile<D>;
    constexpr int TM = S::BM / kRowGroups, TN = S::BN / kColGroups, TD = D / kColGroups;
    extern __shared__ float4 smem4[];
    float* Qt = reinterpret_cast<float*>(smem4);
    float* Kt = Qt + D * S::LQ;
    float* Vs = Kt + D * S::LK;
    float* Pt = Vs + S::BN * S::LV;

    const int ty = threadIdx.x / kColGroups, tx = threadIdx.x % kColGroups;
    const int m0 = blockIdx.x * S::BM, h = blockIdx.y, b = blockIdx.z;
    const int64_t base = (int64_t)b * sB + (int64_t)h * sH;
    load_tile<S::BM, D>(nullptr, Qt, q + base, sT, m0, T);

    float m_run[TM], l_run[TM], acc[TM][TD];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
        m_run[i] = -INFINITY;
        l_run[i] = 0.f;
#pragma unroll
        for (int e = 0; e < TD; ++e) acc[i][e] = 0.f;
    }
    const int n_end = causal ? min(T, m0 + S::BM) : T;
    for (int n0 = 0; n0 < n_end; n0 += S::BN) {
        __syncthreads();  // the last tile's readers are done with Kt, V and Pt
        load_tile<S::BN, D>(nullptr, Kt, k + base, sT, n0, T);
        load_tile<S::BN, D>(Vs, nullptr, v + base, sT, n0, T);
        __syncthreads();
        float s[TM][TN] = {};
        rr_product<TM, TN, D>(s, Qt + ty * TM, S::LQ, Kt + tx * TN, S::LK);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
            const int qi = m0 + ty * TM + i;
            float mx = -INFINITY;
#pragma unroll
            for (int j = 0; j < TN; ++j) {
                // Rows past T see nothing and are never stored.
                s[i][j] = visible(qi, n0 + tx * TN + j, T, causal) ? s[i][j] * scale : -INFINITY;
                mx = fmaxf(mx, s[i][j]);
            }
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
            const float m_new = fmaxf(m_run[i], mx);
            const float alpha = m_run[i] == -INFINITY ? 0.f : expf(m_run[i] - m_new);
            m_run[i] = m_new;
            l_run[i] *= alpha;
#pragma unroll
            for (int e = 0; e < TD; ++e) acc[i][e] *= alpha;
#pragma unroll
            for (int j = 0; j < TN; ++j) {
                const float p = s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - m_new);
                l_run[i] += p;
                Pt[(tx * TN + j) * S::LQ + ty * TM + i] = p;
            }
        }
        __syncthreads();
        rr_product<TM, TD, S::BN>(acc, Pt + ty * TM, S::LQ, Vs + tx * TD, S::LV);
    }
    float* lse_row = lse + ((int64_t)b * H + h) * T;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
        float l = l_run[i];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        l += __shfl_xor_sync(0xffffffffu, l, 4);
        const int qi = m0 + ty * TM + i;
        if (qi < T) {
            E* orow = o + base + (int64_t)qi * sT + tx * TD;
#pragma unroll
            for (int e = 0; e < TD; ++e) orow[e] = from_f32<E>(acc[i][e] / l);
            if (tx == 0) lse_row[qi] = m_run[i] + logf(l);
        }
    }
}

// ------------------------------------------------------------------ backward

constexpr int kWarpRows = 16;  // rows of the outer tile a warp owns (mma's M)
constexpr int kInner = 32;     // rows of an inner (streamed) tile

// Shared rows of D elements of type E padded by 16 bytes.
template <typename E, int D>
__host__ __device__ constexpr int padded_row() {
    return D + 16 / (int)sizeof(E);
}

__device__ __forceinline__ float lds1(const float* p) { return *p; }
__device__ __forceinline__ float lds1(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// Rows [row0, row0 + ROWS) of one (batch, head) slice, all D columns, into
// shared memory row-major ([ROWS][LD]) with 16-byte cp.async copies; rows
// at or past T are zero-filled.
template <int ROWS, int D, typename E>
__device__ __forceinline__ void async_tile(E* dst, const E* src, int64_t row_stride, int row0,
                                           int T) {
    constexpr int LD = padded_row<E, D>(), PER = 16 / (int)sizeof(E), CH = D / PER;
    for (int idx = threadIdx.x; idx < ROWS * CH; idx += kThreads) {
        const int r = idx / CH, c = idx % CH;
        const bool in = row0 + r < T;
        tc::cp_async16(dst + r * LD + c * PER,
                       src + (in ? (int64_t)(row0 + r) * row_stride + c * PER : 0), in);
    }
}

// ROWS fp32 values of a row array (lse or delta) from row0; zero past T.
template <int ROWS>
__device__ __forceinline__ void async_rows(float* dst, const float* src, int row0, int T) {
    for (int r = threadIdx.x; r < ROWS; r += kThreads) {
        const bool in = row0 + r < T;
        tc::cp_async4(dst + r, src + (in ? row0 + r : 0), in);
    }
}

// A fragment of rows r0 + {g, g + 8}, columns c0 + {t, t + 4} of a
// row-major shared tile (the operand of S = Q K^T and dP = dO V^T that runs
// along D). Bank 4 row + col: conflict-free at the 16-byte pad.
template <int LD, typename E>
__device__ __forceinline__ void frag_a(float (&a)[4], const E* s, int r0, int c0, int g, int t) {
    const E* p = s + (r0 + g) * LD + c0 + t;
    a[0] = lds1(p);
    a[1] = lds1(p + 8 * LD);
    a[2] = lds1(p + 4);
    a[3] = lds1(p + 8 * LD + 4);
}

// B fragment with k along D and n along rows: (k = c0 + t, n = r0 + g) and
// (k = c0 + t + 4, n = r0 + g).
template <int LD, typename E>
__device__ __forceinline__ void frag_b_cols(float (&b)[2], const E* s, int r0, int c0, int g,
                                            int t) {
    const E* p = s + (r0 + g) * LD + c0 + t;
    b[0] = lds1(p);
    b[1] = lds1(p + 4);
}

// B fragment with k along rows, in the permuted order that matches an A
// fragment taken from an accumulator (k = t <-> row r0 + 2t, k = t + 4 <->
// row r0 + 2t + 1), and n along D (column c0 + g). Bank 8 t + g (fp32;
// bf16 pairs share words): conflict-free at the 16-byte pad.
template <int LD, typename E>
__device__ __forceinline__ void frag_b_rows(float (&b)[2], const E* s, int r0, int c0, int g,
                                            int t) {
    const E* p = s + (r0 + 2 * t) * LD + c0 + g;
    b[0] = lds1(p);
    b[1] = lds1(p + LD);
}

// The A fragment of a 16 x 8 accumulator tile in the permuted k order.
__device__ __forceinline__ tc::Split<4> acc_as_a(const float (&c)[4]) {
    const float a[4] = {c[0], c[2], c[1], c[3]};
    return tc::split<false>(a);
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
    *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// The 16 x D gradient accumulator of a warp, times `mul`, to rows
// row0 + {g, g + 8} (those below T).
template <int D, typename E>
__device__ __forceinline__ void store_rows(E* dst, const float (&acc)[D / 8][4], float mul,
                                           int64_t base, int64_t row_stride, int row0, int T,
                                           int g, int t) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        const int r = row0 + g + 8 * half;
        if (r >= T) continue;
        E* row = dst + base + (int64_t)r * row_stride + 2 * t;
#pragma unroll
        for (int nd = 0; nd < D / 8; ++nd)
            store2(row + 8 * nd, acc[nd][2 * half] * mul, acc[nd][2 * half + 1] * mul);
    }
}

// ------------------------------------------------------------------ dK, dV

template <typename E, int D>
struct BwdKVTile {
    // At D = 128 the inner tile is 16 rows, so that the 16 x 128 dK and dV
    // accumulators (128 registers a thread) and S, dP fit without spills.
    static constexpr int BK = kOuter, BQ = D == 128 ? kInner / 2 : kInner;
    static constexpr int LD = padded_row<E, D>();
    // K, V [BK][LD]; two stages of Q, dO [BQ][LD]; two stages of lse, delta [BQ]
    static constexpr int kBytes =
        (2 * BK * LD + 4 * BQ * LD) * (int)sizeof(E) + 4 * BQ * (int)sizeof(float);
};

template <typename E, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const E* __restrict__ q, const E* __restrict__ k,
                         const E* __restrict__ v, const E* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         E* __restrict__ dk, E* __restrict__ dv, int T, int H, int64_t sB,
                         int64_t sT, int64_t sH, float scale, int causal) {
    using S = BwdKVTile<E, D>;
    constexpr int BQ = S::BQ, LD = S::LD;
    constexpr bool kExact = sizeof(E) == 2;  // bf16 values are exact in TF32
    extern __shared__ float4 smem4[];
    E* Ks = reinterpret_cast<E*>(smem4);
    E* Vs = Ks + S::BK * LD;
    E* Qs = Vs + S::BK * LD;   // [2][BQ][LD]
    E* dOs = Qs + 2 * BQ * LD;  // [2][BQ][LD]
    float* lse_s = reinterpret_cast<float*>(dOs + 2 * BQ * LD);  // [2][BQ]
    float* dl_s = lse_s + 2 * BQ;

    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
    // Slow grid index = key tile, heaviest first: under causality the tile
    // at 0 sees every query.
    const int n0 = blockIdx.y * S::BK, bh = blockIdx.x, b = bh / H, h = bh % H;
    const int64_t base = (int64_t)b * sB + (int64_t)h * sH;
    const int64_t rows = (int64_t)bh * T;
    const int kr = n0 + warp * kWarpRows;  // this warp's first key
    // Causal: query tiles wholly before this key tile see none of it.
    const int q_begin = causal ? n0 : 0;
    const int n_tiles = (T - q_begin + BQ - 1) / BQ;

    auto stage = [&](int i) {
        const int q0 = q_begin + i * BQ, buf = i & 1;
        async_tile<BQ, D>(Qs + buf * BQ * LD, q + base, sT, q0, T);
        async_tile<BQ, D>(dOs + buf * BQ * LD, dout + base, sT, q0, T);
        async_rows<BQ>(lse_s + buf * BQ, lse + rows, q0, T);
        async_rows<BQ>(dl_s + buf * BQ, delta + rows, q0, T);
        tc::cp_async_commit();
    };
    async_tile<S::BK, D>(Ks, k + base, sT, n0, T);
    async_tile<S::BK, D>(Vs, v + base, sT, n0, T);
    stage(0);  // one group with K and V

    float dk_acc[D / 8][4] = {}, dv_acc[D / 8][4] = {};
    for (int i = 0; i < n_tiles; ++i) {
        if (i + 1 < n_tiles) {
            stage(i + 1);
            tc::cp_async_wait<1>();
        } else {
            tc::cp_async_wait<0>();
        }
        __syncthreads();  // tile i (and K, V) visible to every warp
        const int q0 = q_begin + i * BQ, buf = i & 1;
        const E* Qb = Qs + buf * BQ * LD;
        const E* dOb = dOs + buf * BQ * LD;
        const float* lse_b = lse_s + buf * BQ;
        const float* dl_b = dl_s + buf * BQ;
        // Skip when this warp's keys are all past T or all after the
        // tile's last query (warp-uniform).
        if (kr < T && (!causal || kr <= q0 + BQ - 1)) {
            // S^T = K Q^T and dP^T = V dO^T: [16 keys][BQ queries].
            float s[BQ / 8][4] = {}, dp[BQ / 8][4] = {};
            float s_lo[BQ / 8][4] = {}, dp_lo[BQ / 8][4] = {};
#pragma unroll
            for (int kk = 0; kk < D / 8; ++kk) {
                float x[4];
                frag_a<LD>(x, Ks, warp * kWarpRows, 8 * kk, g, t);
                const tc::Split<4> ka = tc::split<kExact>(x);
                frag_a<LD>(x, Vs, warp * kWarpRows, 8 * kk, g, t);
                const tc::Split<4> va = tc::split<kExact>(x);
#pragma unroll
                for (int j = 0; j < BQ / 8; ++j) {
                    float y[2];
                    frag_b_cols<LD>(y, Qb, 8 * j, 8 * kk, g, t);
                    tc::mma_f32_2acc<kExact, kExact>(s[j], s_lo[j], ka, tc::split<kExact>(y));
                    frag_b_cols<LD>(y, dOb, 8 * j, 8 * kk, g, t);
                    tc::mma_f32_2acc<kExact, kExact>(dp[j], dp_lo[j], va, tc::split<kExact>(y));
                }
            }
            if constexpr (!kExact) {
#pragma unroll
                for (int j = 0; j < BQ / 8; ++j) {
                    tc::add4(s[j], s_lo[j]);
                    tc::add4(dp[j], dp_lo[j]);
                }
            }
            // P^T and dS^T in the accumulator layout: row key, column query.
#pragma unroll
            for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int c = 8 * j + 2 * t + (e & 1);
                    const bool vis = visible(q0 + c, kr + g + 8 * (e >> 1), T, causal);
                    const float p = vis ? expf(s[j][e] * scale - lse_b[c]) : 0.f;
                    s[j][e] = p;
                    dp[j][e] = vis ? p * (dp[j][e] - dl_b[c]) : 0.f;
                }
            }
            // dV += P^T dO and dK += dS^T Q, reducing over the tile's
            // queries: each 16 x 8 output tile sums the whole inner tile in
            // a fresh accumulator, added to the running one in IEEE fp32.
            tc::Split<4> pa[BQ / 8], sa[BQ / 8];
#pragma unroll
            for (int j = 0; j < BQ / 8; ++j) {
                pa[j] = acc_as_a(s[j]);
                sa[j] = acc_as_a(dp[j]);
            }
#pragma unroll
            for (int nd = 0; nd < D / 8; ++nd) {
                float tv[4] = {}, tk[4] = {};
#pragma unroll
                for (int j = 0; j < BQ / 8; ++j) {
                    float y[2];
                    frag_b_rows<LD>(y, dOb, 8 * j, 8 * nd, g, t);
                    tc::mma_f32<false, kExact>(tv, pa[j], tc::split<kExact>(y));
                    frag_b_rows<LD>(y, Qb, 8 * j, 8 * nd, g, t);
                    tc::mma_f32<false, kExact>(tk, sa[j], tc::split<kExact>(y));
                }
                tc::add4(dv_acc[nd], tv);
                tc::add4(dk_acc[nd], tk);
            }
        }
        __syncthreads();  // every warp is done with buffer i & 1 before it reloads
    }
    store_rows<D>(dk, dk_acc, scale, base, sT, kr, T, g, t);
    store_rows<D>(dv, dv_acc, 1.f, base, sT, kr, T, g, t);
}

// ---------------------------------------------------------------------- dQ

template <typename E, int D>
struct BwdQTile {
    static constexpr int BQ = kOuter, BK = kInner, LD = padded_row<E, D>();
    // Q, dO [BQ][LD]; two stages of K, V [BK][LD]
    static constexpr int kBytes = (2 * BQ * LD + 4 * BK * LD) * (int)sizeof(E);
};

template <typename E, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const E* __restrict__ q, const E* __restrict__ k,
                        const E* __restrict__ v, const E* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        E* __restrict__ dq, int T, int H, int64_t sB, int64_t sT, int64_t sH,
                        float scale, int causal) {
    using S = BwdQTile<E, D>;
    constexpr int BK = S::BK, LD = S::LD;
    constexpr bool kExact = sizeof(E) == 2;
    extern __shared__ float4 smem4[];
    E* Qs = reinterpret_cast<E*>(smem4);
    E* dOs = Qs + S::BQ * LD;
    E* Ks = dOs + S::BQ * LD;  // [2][BK][LD]
    E* Vs = Ks + 2 * BK * LD;  // [2][BK][LD]

    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
    // Slow grid index = query tile, heaviest first: under causality the
    // last tile sees every key.
    const int m0 = (gridDim.y - 1 - blockIdx.y) * S::BQ, bh = blockIdx.x, b = bh / H,
              h = bh % H;
    const int64_t base = (int64_t)b * sB + (int64_t)h * sH;
    const int64_t rows = (int64_t)bh * T;
    const int qr = m0 + warp * kWarpRows;  // this warp's first query
    const int k_end = causal ? min(T, m0 + S::BQ) : T;
    const int n_tiles = (k_end + BK - 1) / BK;

    auto stage = [&](int i) {
        const int buf = i & 1;
        async_tile<BK, D>(Ks + buf * BK * LD, k + base, sT, i * BK, T);
        async_tile<BK, D>(Vs + buf * BK * LD, v + base, sT, i * BK, T);
        tc::cp_async_commit();
    };
    async_tile<S::BQ, D>(Qs, q + base, sT, m0, T);
    async_tile<S::BQ, D>(dOs, dout + base, sT, m0, T);
    stage(0);  // one group with Q and dO

    // lse and delta of this lane's rows qr + g and qr + g + 8.
    float lse_r[2], dl_r[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        const int r = qr + g + 8 * half;
        lse_r[half] = r < T ? lse[rows + r] : 0.f;
        dl_r[half] = r < T ? delta[rows + r] : 0.f;
    }

    float acc[D / 8][4] = {};
    for (int i = 0; i < n_tiles; ++i) {
        if (i + 1 < n_tiles) {
            stage(i + 1);
            tc::cp_async_wait<1>();
        } else {
            tc::cp_async_wait<0>();
        }
        __syncthreads();
        const int k0 = i * BK, buf = i & 1;
        const E* Kb = Ks + buf * BK * LD;
        const E* Vb = Vs + buf * BK * LD;
        // Skip when this warp's queries are all past T or all before the
        // tile's first key (warp-uniform).
        if (qr < T && (!causal || k0 <= qr + kWarpRows - 1)) {
            // S = Q K^T and dP = dO V^T: [16 queries][BK keys].
            float s[BK / 8][4] = {}, dp[BK / 8][4] = {};
            float s_lo[BK / 8][4] = {}, dp_lo[BK / 8][4] = {};
#pragma unroll
            for (int kk = 0; kk < D / 8; ++kk) {
                float x[4];
                frag_a<LD>(x, Qs, warp * kWarpRows, 8 * kk, g, t);
                const tc::Split<4> qa = tc::split<kExact>(x);
                frag_a<LD>(x, dOs, warp * kWarpRows, 8 * kk, g, t);
                const tc::Split<4> oa = tc::split<kExact>(x);
#pragma unroll
                for (int j = 0; j < BK / 8; ++j) {
                    float y[2];
                    frag_b_cols<LD>(y, Kb, 8 * j, 8 * kk, g, t);
                    tc::mma_f32_2acc<kExact, kExact>(s[j], s_lo[j], qa, tc::split<kExact>(y));
                    frag_b_cols<LD>(y, Vb, 8 * j, 8 * kk, g, t);
                    tc::mma_f32_2acc<kExact, kExact>(dp[j], dp_lo[j], oa, tc::split<kExact>(y));
                }
            }
            if constexpr (!kExact) {
#pragma unroll
                for (int j = 0; j < BK / 8; ++j) {
                    tc::add4(s[j], s_lo[j]);
                    tc::add4(dp[j], dp_lo[j]);
                }
            }
            // dS in the accumulator layout: row query, column key.
#pragma unroll
            for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int half = e >> 1;
                    const bool vis =
                        visible(qr + g + 8 * half, k0 + 8 * j + 2 * t + (e & 1), T, causal);
                    const float p = vis ? expf(s[j][e] * scale - lse_r[half]) : 0.f;
                    dp[j][e] = vis ? p * (dp[j][e] - dl_r[half]) : 0.f;
                }
            }
            // dQ += dS K, reducing over the tile's keys, a fresh
            // accumulator per output tile as above.
            tc::Split<4> sa[BK / 8];
#pragma unroll
            for (int j = 0; j < BK / 8; ++j) sa[j] = acc_as_a(dp[j]);
#pragma unroll
            for (int nd = 0; nd < D / 8; ++nd) {
                float tq[4] = {};
#pragma unroll
                for (int j = 0; j < BK / 8; ++j) {
                    float y[2];
                    frag_b_rows<LD>(y, Kb, 8 * j, 8 * nd, g, t);
                    tc::mma_f32<false, kExact>(tq, sa[j], tc::split<kExact>(y));
                }
                tc::add4(acc[nd], tq);
            }
        }
        __syncthreads();
    }
    store_rows<D>(dq, acc, scale, base, sT, qr, T, g, t);
}

// ------------------------------------------------------------------ launch

struct Args {
    const void* q;
    const void* k;
    const void* v;
    const void* dout;
    void* o;
    float* lse;
    const float* delta;
    void* dq;
    void* dk;
    void* dv;
    int B, T, H;
    int64_t sB, sT, sH;
    float scale;
    int causal;
    cudaStream_t stream;
};

enum Which { kFwd, kBwdKV, kBwdQ };

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// The backward kernels copy 16-byte chunks with cp.async: every operand
// and every stride must keep that alignment.
template <typename E>
bool aligned16(const Args& a) {
    uintptr_t bits = (uintptr_t)a.q | (uintptr_t)a.k | (uintptr_t)a.v | (uintptr_t)a.dout;
    bits |= (uintptr_t)((a.sB | a.sT | a.sH) * (int64_t)sizeof(E));
    return bits % 16 == 0;
}

template <typename E, int D>
int smem_bytes(Which which) {
    if (which == kFwd) return FwdTile<D>::kFloats * (int)sizeof(float);
    return which == kBwdKV ? BwdKVTile<E, D>::kBytes : BwdQTile<E, D>::kBytes;
}

template <typename E, int D>
cudaError_t launch(Which which, const Args& a) {
    const E* q = static_cast<const E*>(a.q);
    const E* k = static_cast<const E*>(a.k);
    const E* v = static_cast<const E*>(a.v);
    const E* dout = static_cast<const E*>(a.dout);
    const int tiles = (a.T + kOuter - 1) / kOuter;
    cudaError_t err = cudaSuccess;
    if (which == kFwd) {
        const dim3 grid(tiles, a.H, a.B);
        const int bytes = smem_bytes<E, D>(kFwd);
        err = allow_smem(flash_fwd_kernel<E, D>, bytes);
        if (err != cudaSuccess) return err;
        flash_fwd_kernel<E, D><<<grid, kThreads, bytes, a.stream>>>(
            q, k, v, static_cast<E*>(a.o), a.lse, a.T, a.H, a.sB, a.sT, a.sH, a.scale,
            a.causal);
        return cudaGetLastError();
    }
    if (!aligned16<E>(a)) return cudaErrorMisalignedAddress;
    // (batch, head) fast, tiles slow: each kernel maps the slow index to
    // its tiles heaviest first.
    if ((int64_t)a.B * a.H > 0x7fffffff || tiles > 65535) return cudaErrorInvalidValue;
    const dim3 grid(a.B * a.H, tiles);
    if (which == kBwdKV) {
        const int bytes = smem_bytes<E, D>(kBwdKV);
        err = allow_smem(flash_bwd_dkv_kernel<E, D>, bytes);
        if (err != cudaSuccess) return err;
        flash_bwd_dkv_kernel<E, D><<<grid, kThreads, bytes, a.stream>>>(
            q, k, v, dout, a.lse, a.delta, static_cast<E*>(a.dk), static_cast<E*>(a.dv), a.T,
            a.H, a.sB, a.sT, a.sH, a.scale, a.causal);
    } else {
        const int bytes = smem_bytes<E, D>(kBwdQ);
        err = allow_smem(flash_bwd_dq_kernel<E, D>, bytes);
        if (err != cudaSuccess) return err;
        flash_bwd_dq_kernel<E, D><<<grid, kThreads, bytes, a.stream>>>(
            q, k, v, dout, a.lse, a.delta, static_cast<E*>(a.dq), a.T, a.H, a.sB, a.sT, a.sH,
            a.scale, a.causal);
    }
    return cudaGetLastError();
}

template <typename E>
int smem_bytes_dim(Which which, int D) {
    switch (D) {
        case 16: return smem_bytes<E, 16>(which);
        case 32: return smem_bytes<E, 32>(which);
        case 64: return smem_bytes<E, 64>(which);
        case 128: return smem_bytes<E, 128>(which);
        default: return -1;
    }
}

template <typename E>
cudaError_t launch_dim(Which which, int D, const Args& a) {
    switch (D) {
        case 16: return launch<E, 16>(which, a);
        case 32: return launch<E, 32>(which, a);
        case 64: return launch<E, 64>(which, a);
        case 128: return launch<E, 128>(which, a);
        default: return cudaErrorInvalidValue;
    }
}

// dtype 0 = float32, 1 = bfloat16.
int dispatch(Which which, int dtype, int D, int device, const Args& a) {
    if (a.B <= 0 || a.T <= 0 || a.H <= 0) return 0;
    // This library links its own CUDA runtime; point it at the caller's
    // device before launching on the caller's stream.
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (dtype == 0) return (int)launch_dim<float>(which, D, a);
    if (dtype == 1) return (int)launch_dim<__nv_bfloat16>(which, D, a);
    return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Forward: o [B, T, H, D] in the inputs' type and lse [B, H, T] float32.
// sB, sT, sH are the element strides of q, k, v and o (all alike).
int ddl_flash_fwd(int dtype, const void* q, const void* k, const void* v, void* o, float* lse,
                  int B, int T, int H, int D, int64_t sB, int64_t sT, int64_t sH, float scale,
                  int causal, int device, void* stream) {
    const Args a{q, k, v, nullptr, o, lse, nullptr, nullptr, nullptr, nullptr, B, T, H,
                 sB, sT, sH, scale, causal, static_cast<cudaStream_t>(stream)};
    return dispatch(kFwd, dtype, D, device, a);
}

// dK and dV from q, k, v, dO, the forward's lse and delta = rowsum(dO * O)
// ([B, H, T] float32 each).
int ddl_flash_bwd_dkv(int dtype, const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, void* dk, void* dv, int B, int T,
                      int H, int D, int64_t sB, int64_t sT, int64_t sH, float scale, int causal,
                      int device, void* stream) {
    const Args a{q, k, v, dout, nullptr, const_cast<float*>(lse), delta, nullptr, dk, dv, B, T,
                 H, sB, sT, sH, scale, causal, static_cast<cudaStream_t>(stream)};
    return dispatch(kBwdKV, dtype, D, device, a);
}

// dQ from the same inputs as ddl_flash_bwd_dkv.
int ddl_flash_bwd_dq(int dtype, const void* q, const void* k, const void* v, const void* dout,
                     const float* lse, const float* delta, void* dq, int B, int T, int H, int D,
                     int64_t sB, int64_t sT, int64_t sH, float scale, int causal, int device,
                     void* stream) {
    const Args a{q, k, v, dout, nullptr, const_cast<float*>(lse), delta, dq, nullptr, nullptr,
                 B, T, H, sB, sT, sH, scale, causal, static_cast<cudaStream_t>(stream)};
    return dispatch(kBwdQ, dtype, D, device, a);
}

// Dynamic shared memory of one block of kernel `which` (0 forward, 1 dK/dV,
// 2 dQ) at dtype and D, in bytes; -1 for no such instance.
int ddl_flash_smem_bytes(int which, int dtype, int D) {
    if (which < kFwd || which > kBwdQ) return -1;
    if (dtype == 0) return smem_bytes_dim<float>(static_cast<Which>(which), D);
    if (dtype == 1) return smem_bytes_dim<__nv_bfloat16>(static_cast<Which>(which), D);
    return -1;
}

const char* ddl_cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
