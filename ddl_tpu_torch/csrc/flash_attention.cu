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
// Forward (`flash_fwd_kernel`, replaces `_flash_attention_impl`): both
// products, S = Q K^T and P V, on the tensor cores. In fp32 they run on the
// TF32 tensor cores to fp32 accuracy (3xTF32, mma.sync m16n8k8, as the
// backward below); its bound is 3 x products over the TF32 rate. In bf16
// they run on the bf16 tensor cores (mma.sync m16n8k16, fp32 sums): S in
// one pass (bf16 products are exact), P V in two, with P split into two
// bf16 parts (hi = bf16(p), lo = bf16(p - hi)), since P rounded once to
// bf16 takes most of O's bf16 tolerance; its bound is the products over
// the bf16 rate (3 passes where 2 would do). The design:
//
// - Warps own query rows: a block of 4 warps owns 64 rows, 16 a warp, and
//   loops over key tiles of 64. Each warp keeps its 16 x D O accumulator
//   and each row's running max m and sum l in registers, in the mma
//   accumulator layout (a lane holds rows g and g + 8); row maxima reduce
//   over the 4 lanes of a quad with two shuffles.
// - Q is staged once and its fragments stay in registers for the whole key
//   loop (fp32: split into TF32 parts once, up to D = 64).
// - P stays in registers: fp32 P feeds P V straight from the accumulator
//   layout through the permuted reduction index described below; in bf16
//   two adjacent 16 x 8 accumulator tiles are one A fragment of m16n8k16.
//   bf16 K and V fragments come from their row-major tiles by ldmatrix (V
//   transposed). No shared round trip for P.
// - Short, independent tensor-core sums: P V loops over the tile's keys
//   outside and up to 8 output tiles of 8 columns inside, each in a fresh
//   accumulator, so 8 mma chains run side by side and none runs past the
//   tile; then O = alpha O + tile in IEEE fp32 (alpha = 2^(m_old - m_new)).
//   The softmax works in base 2 (c = scale * log2 e, P = 2^(S c - m) with
//   one fma, ex2.approx) and masks only the tiles that hold a masked or
//   ragged entry. At the end O / l, and LSE = m ln 2 + log l in natural
//   units.
// - K and V tiles are double-buffered with cp.async, one row-major padded
//   copy each, as in the backward; the grid starts the last query tile,
//   which under causality sees every key, first; no atomics.
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
constexpr int kOuter = 64;  // rows of the outer tile a block owns
constexpr float kLn2 = 0.693147180559945309f;
constexpr double kLog2e = 1.44269504088896340736;

__device__ __forceinline__ bool visible(int qi, int kj, int T, int causal) {
    return qi < T && kj < T && (!causal || kj <= qi);
}

// ------------------------------------------------- tiles and fragments

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

// The 16 x D accumulator of a warp, times `mul`, to rows row0 + {g, g + 8}
// (those below T).
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

// A bf16 A fragment of m16n8k16 from a row-major shared tile: rows
// r0 + {g, g + 8}, columns c0 + 2t + {0, 1} and c0 + 2t + {8, 9}, one 32-bit
// load each (bank 4 row + t at the 16-byte pad: conflict-free).
template <int LD>
__device__ __forceinline__ void frag_a16(uint32_t (&a)[4], const __nv_bfloat16* s, int r0, int c0,
                                         int g, int t) {
    const uint32_t* p = reinterpret_cast<const uint32_t*>(s + (r0 + g) * LD + c0 + 2 * t);
    a[0] = p[0];
    a[1] = p[4 * LD];
    a[2] = p[4];
    a[3] = p[4 * LD + 4];
}

// ----------------------------------------------------------------- forward

template <typename E, int D>
struct FwdTile {
    // Keys of a streamed tile: 64 (faster than 32 on the H100 in both
    // types, PERF.md).
    static constexpr int BQ = kOuter, BK = 64;
    static constexpr int LD = padded_row<E, D>();
    // Q [BQ][LD]; two stages of K, V [BK][LD]
    static constexpr int kBytes = (BQ * LD + 4 * BK * LD) * (int)sizeof(E);
};

// o = alpha o + x in IEEE fp32 (one rounding an element), alpha per row
// half: elements 0, 1 are row g, 2, 3 row g + 8.
__device__ __forceinline__ void rescale_add(float (&o)[4], const float (&alpha)[2],
                                            const float (&x)[4]) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[e] = __fmaf_rn(alpha[e >> 1], o[e], x[e]);
}

// The products of one warp (16 query rows) and one key tile, by input type.
template <typename E, int D, int BK, int LD>
struct FwdOps;

// fp32: on the TF32 tensor cores to fp32 accuracy (3xTF32, m16n8k8).
template <int D, int BK, int LD>
struct FwdOps<float, D, BK, LD> {
    // Q's fragments, split into TF32 parts once for the whole key loop (D
    // registers a thread), up to D = 64; at D = 128, whose O accumulator
    // takes 64 registers, they are re-read and split each tile.
    static constexpr bool kQRegs = D <= 64;
    struct Q {
        tc::Split<4> a[kQRegs ? D / 8 : 1];
    };

    static __device__ __forceinline__ tc::Split<4> q_frag(const float* Qs, int r0, int kk, int g,
                                                          int t) {
        float x[4];
        frag_a<LD>(x, Qs, r0, 8 * kk, g, t);
        return tc::split<false>(x);
    }

    static __device__ __forceinline__ void load_q(Q& q, const float* Qs, int r0, int g, int t) {
        if constexpr (kQRegs) {
#pragma unroll
            for (int kk = 0; kk < D / 8; ++kk) q.a[kk] = q_frag(Qs, r0, kk, g, t);
        }
    }

    // s = Q K^T, the small TF32 terms in an accumulator of their own.
    static __device__ __forceinline__ void scores(float (&s)[BK / 8][4], const Q& q,
                                                  const float* Qs, const float* Kb, int r0, int g,
                                                  int t, int /*lane*/) {
        float s_lo[BK / 8][4] = {};
#pragma unroll
        for (int kk = 0; kk < D / 8; ++kk) {
            tc::Split<4> qa;
            if constexpr (kQRegs) {
                qa = q.a[kk];
            } else {
                qa = q_frag(Qs, r0, kk, g, t);
            }
#pragma unroll
            for (int j = 0; j < BK / 8; ++j) {
                float y[2];
                frag_b_cols<LD>(y, Kb, 8 * j, 8 * kk, g, t);
                tc::mma_f32_2acc<false, false>(s[j], s_lo[j], qa, tc::split<false>(y));
            }
        }
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) tc::add4(s[j], s_lo[j]);
    }

    // o = alpha o + P V: P from the accumulator layout (permuted k). The
    // key tile is the outer loop and up to 8 output tiles of 8 columns
    // take fresh accumulators at once, so their mma chains are independent.
    static __device__ __forceinline__ void pv(float (&o)[D / 8][4], const float (&p)[BK / 8][4],
                                              const float (&alpha)[2], const float* Vb, int g,
                                              int t, int /*lane*/) {
        constexpr int NG = D / 8 < 8 ? D / 8 : 8;
        tc::Split<4> pa[BK / 8];
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) pa[j] = acc_as_a(p[j]);
#pragma unroll
        for (int n0 = 0; n0 < D / 8; n0 += NG) {
            float x[NG][4] = {};
#pragma unroll
            for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
                for (int nd = 0; nd < NG; ++nd) {
                    float y[2];
                    frag_b_rows<LD>(y, Vb, 8 * j, 8 * (n0 + nd), g, t);
                    tc::mma_f32<false, false>(x[nd], pa[j], tc::split<false>(y));
                }
            }
#pragma unroll
            for (int nd = 0; nd < NG; ++nd) rescale_add(o[n0 + nd], alpha, x[nd]);
        }
    }
};

// bf16: on the bf16 tensor cores (m16n8k16, fp32 sums).
template <int D, int BK, int LD>
struct FwdOps<__nv_bfloat16, D, BK, LD> {
    struct Q {
        uint32_t a[D / 16][4];
    };

    static __device__ __forceinline__ void load_q(Q& q, const __nv_bfloat16* Qs, int r0, int g,
                                                  int t) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) frag_a16<LD>(q.a[kk], Qs, r0, 16 * kk, g, t);
    }

    // s = Q K^T in one pass: products of bf16 values are exact.
    static __device__ __forceinline__ void scores(float (&s)[BK / 8][4], const Q& q,
                                                  const __nv_bfloat16* /*Qs*/,
                                                  const __nv_bfloat16* Kb, int /*r0*/, int /*g*/,
                                                  int /*t*/, int lane) {
        // ldmatrix tiles 0..3: keys +0 / +8 (tiles 0, 1 / 2, 3) of columns
        // +0 / +8 (tiles 0, 2 / 1, 3): the B fragments of two key blocks.
        const __nv_bfloat16* krow =
            Kb + ((lane & 7) + 8 * (lane >> 4)) * LD + 8 * ((lane >> 3) & 1);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
            for (int jp = 0; jp < BK / 16; ++jp) {
                uint32_t y[4];
                tc::ldmatrix_x4(y, krow + 16 * jp * LD + 16 * kk);
                const uint32_t b0[2] = {y[0], y[1]}, b1[2] = {y[2], y[3]};
                tc::mma_bf16(s[2 * jp], q.a[kk], b0);
                tc::mma_bf16(s[2 * jp + 1], q.a[kk], b1);
            }
        }
    }

    // o = alpha o + P V with P in two bf16 parts (lo first, then hi) and V's
    // B fragments transposed out of its row-major tile, two output tiles of
    // 8 columns a load. As in fp32, the key tile is the outer loop and up to
    // 8 output tiles take fresh accumulators at once.
    static __device__ __forceinline__ void pv(float (&o)[D / 8][4], const float (&p)[BK / 8][4],
                                              const float (&alpha)[2], const __nv_bfloat16* Vb,
                                              int /*g*/, int /*t*/, int lane) {
        constexpr int NP = D / 16 < 4 ? D / 16 : 4;  // pairs of output tiles at once
        // Keys 16 jj..16 jj + 15: the accumulator tiles 2 jj and 2 jj + 1.
        uint32_t ph[BK / 16][4], pl[BK / 16][4];
#pragma unroll
        for (int jj = 0; jj < BK / 16; ++jj) {
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                const int j = 2 * jj + (r >> 1), e = 2 * (r & 1);
                tc::split_bf16(ph[jj][r], pl[jj][r], p[j][e], p[j][e + 1]);
            }
        }
        // This lane's row address for ldmatrix: tiles 0..3 are keys +0 / +8
        // of columns +0 (tiles 0, 1) and +8 (tiles 2, 3).
        const __nv_bfloat16* vrow =
            Vb + ((lane & 7) + 8 * ((lane >> 3) & 1)) * LD + 8 * (lane >> 4);
#pragma unroll
        for (int p0 = 0; p0 < D / 16; p0 += NP) {
            float x[2 * NP][4] = {};
#pragma unroll
            for (int jj = 0; jj < BK / 16; ++jj) {
#pragma unroll
                for (int np = 0; np < NP; ++np) {
                    uint32_t y[4];
                    tc::ldmatrix_x4_trans(y, vrow + 16 * jj * LD + 16 * (p0 + np));
                    const uint32_t b0[2] = {y[0], y[1]}, b1[2] = {y[2], y[3]};
                    tc::mma_bf16(x[2 * np], pl[jj], b0);
                    tc::mma_bf16(x[2 * np], ph[jj], b0);
                    tc::mma_bf16(x[2 * np + 1], pl[jj], b1);
                    tc::mma_bf16(x[2 * np + 1], ph[jj], b1);
                }
            }
#pragma unroll
            for (int i = 0; i < 2 * NP; ++i) rescale_add(o[2 * p0 + i], alpha, x[i]);
        }
    }
};

// One key tile's online softmax in the accumulator layout (this lane's rows
// qr + g and qr + g + 8, keys n0 + 8j + 2t + {0, 1}), in base 2 with c =
// scale * log2(e): raises the running row max m of S c (masking S where
// MASK), turns S into P = 2^(S c - m) with one fma, so that the exponent
// is rounded once near the max, and returns alpha = 2^(m_old - m) with l =
// alpha l + this lane's share of the row's sum of P. A row that has seen
// nothing keeps m = -inf and subtracts 0 instead, so that its alpha is 0,
// not NaN.
template <int BK, bool MASK>
__device__ __forceinline__ void online_softmax(float (&s)[BK / 8][4], float (&m)[2],
                                               float (&l)[2], float (&alpha)[2], int qr, int n0,
                                               int T, int causal, float c, int g, int t) {
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int half = e >> 1;
            if constexpr (MASK) {
                if (!visible(qr + g + 8 * half, n0 + 8 * j + 2 * t + (e & 1), T, causal))
                    s[j][e] = -INFINITY;
            }
            // A masked score's -inf times a negative c would be +inf.
            mx[half] = fmaxf(mx[half], MASK && s[j][e] == -INFINITY ? -INFINITY : s[j][e] * c);
        }
    }
    float ref[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        float x = mx[half];
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
        const float m_new = fmaxf(m[half], x);
        ref[half] = m_new == -INFINITY ? 0.f : m_new;
        alpha[half] = tc::exp2_ftz(m[half] - ref[half]);
        m[half] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int half = e >> 1;
            const float p = tc::exp2_ftz(__fmaf_rn(s[j][e], c, -ref[half]));
            s[j][e] = MASK && s[j][e] == -INFINITY ? 0.f : p;
            sum[half] = __fadd_rn(sum[half], s[j][e]);
        }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) l[half] = __fmaf_rn(alpha[half], l[half], sum[half]);
}

template <typename E, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const E* __restrict__ q, const E* __restrict__ k, const E* __restrict__ v,
                     E* __restrict__ o, float* __restrict__ lse, int T, int H, int64_t sB,
                     int64_t sT, int64_t sH, float c, int causal) {
    using S = FwdTile<E, D>;
    using Ops = FwdOps<E, D, S::BK, S::LD>;
    constexpr int BK = S::BK, LD = S::LD;
    extern __shared__ float4 smem4[];
    E* Qs = reinterpret_cast<E*>(smem4);
    E* Ks = Qs + S::BQ * LD;   // [2][BK][LD]
    E* Vs = Ks + 2 * BK * LD;  // [2][BK][LD]

    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
    // Slow grid index = query tile, heaviest first: under causality the
    // last tile sees every key.
    const int m0 = (gridDim.y - 1 - blockIdx.y) * S::BQ, bh = blockIdx.x, b = bh / H,
              h = bh % H;
    const int64_t base = (int64_t)b * sB + (int64_t)h * sH;
    const int r0 = warp * kWarpRows, qr = m0 + r0;  // this warp's first query
    const int k_end = causal ? min(T, m0 + S::BQ) : T;
    const int n_tiles = (k_end + BK - 1) / BK;

    auto stage = [&](int i) {
        const int buf = i & 1;
        async_tile<BK, D>(Ks + buf * BK * LD, k + base, sT, i * BK, T);
        async_tile<BK, D>(Vs + buf * BK * LD, v + base, sT, i * BK, T);
        tc::cp_async_commit();
    };
    async_tile<S::BQ, D>(Qs, q + base, sT, m0, T);
    tc::cp_async_commit();
    stage(0);
    tc::cp_async_wait<1>();
    __syncthreads();  // Q visible to every warp
    typename Ops::Q qf;
    Ops::load_q(qf, Qs, r0, g, t);

    float acc[D / 8][4] = {};
    float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
    for (int i = 0; i < n_tiles; ++i) {
        if (i + 1 < n_tiles) {
            stage(i + 1);
            tc::cp_async_wait<1>();
        } else {
            tc::cp_async_wait<0>();
        }
        __syncthreads();  // tile i visible to every warp
        const int n0 = i * BK, buf = i & 1;
        // Skip when this warp's queries are all past T or all before the
        // tile's first key (warp-uniform).
        if (qr < T && (!causal || n0 <= qr + kWarpRows - 1)) {
            float s[BK / 8][4] = {};
            Ops::scores(s, qf, Qs, Ks + buf * BK * LD, r0, g, t, lane);
            float alpha[2];
            // Masks only where the tile holds a key after one of the warp's
            // queries, a key past T or a query past T (warp-uniform).
            if ((causal && n0 + BK - 1 > qr) || n0 + BK > T || qr + kWarpRows > T) {
                online_softmax<BK, true>(s, m_run, l_run, alpha, qr, n0, T, causal, c, g, t);
            } else {
                online_softmax<BK, false>(s, m_run, l_run, alpha, qr, n0, T, causal, c, g, t);
            }
            Ops::pv(acc, s, alpha, Vs + buf * BK * LD, g, t, lane);
        }
        __syncthreads();  // every warp is done with buffer i & 1 before it reloads
    }
    // Rows past T saw nothing (l = 0) and are never stored.
    float* lse_row = lse + (int64_t)bh * T;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        float l = l_run[half];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        const int r = qr + g + 8 * half;
        // m is in base 2: LSE = m ln 2 + log l, in natural units.
        if (t == 0 && r < T) lse_row[r] = __fmaf_rn(m_run[half], kLn2, logf(l));
#pragma unroll
        for (int nd = 0; nd < D / 8; ++nd) {
            acc[nd][2 * half] /= l;
            acc[nd][2 * half + 1] /= l;
        }
    }
    store_rows<D>(o, acc, 1.f, base, sT, qr, T, g, t);
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

// Every kernel copies 16-byte chunks with cp.async: every operand and every
// stride must keep that alignment.
template <typename E>
bool aligned16(const Args& a) {
    uintptr_t bits = (uintptr_t)a.q | (uintptr_t)a.k | (uintptr_t)a.v | (uintptr_t)a.dout;
    bits |= (uintptr_t)((a.sB | a.sT | a.sH) * (int64_t)sizeof(E));
    return bits % 16 == 0;
}

template <typename E, int D>
int smem_bytes(Which which) {
    if (which == kFwd) return FwdTile<E, D>::kBytes;
    return which == kBwdKV ? BwdKVTile<E, D>::kBytes : BwdQTile<E, D>::kBytes;
}

template <typename E, int D>
cudaError_t launch(Which which, const Args& a) {
    const E* q = static_cast<const E*>(a.q);
    const E* k = static_cast<const E*>(a.k);
    const E* v = static_cast<const E*>(a.v);
    const E* dout = static_cast<const E*>(a.dout);
    const int tiles = (a.T + kOuter - 1) / kOuter;
    if (!aligned16<E>(a)) return cudaErrorMisalignedAddress;
    // (batch, head) fast, tiles slow: each kernel maps the slow index to
    // its tiles heaviest first.
    if ((int64_t)a.B * a.H > 0x7fffffff || tiles > 65535) return cudaErrorInvalidValue;
    const dim3 grid(a.B * a.H, tiles);
    const int bytes = smem_bytes<E, D>(which);
    cudaError_t err = cudaSuccess;
    if (which == kFwd) {
        err = allow_smem(flash_fwd_kernel<E, D>, bytes);
        if (err != cudaSuccess) return err;
        flash_fwd_kernel<E, D><<<grid, kThreads, bytes, a.stream>>>(
            q, k, v, static_cast<E*>(a.o), a.lse, a.T, a.H, a.sB, a.sT, a.sH,
            (float)(a.scale * kLog2e), a.causal);
    } else if (which == kBwdKV) {
        err = allow_smem(flash_bwd_dkv_kernel<E, D>, bytes);
        if (err != cudaSuccess) return err;
        flash_bwd_dkv_kernel<E, D><<<grid, kThreads, bytes, a.stream>>>(
            q, k, v, dout, a.lse, a.delta, static_cast<E*>(a.dk), static_cast<E*>(a.dv), a.T,
            a.H, a.sB, a.sT, a.sH, a.scale, a.causal);
    } else {
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
