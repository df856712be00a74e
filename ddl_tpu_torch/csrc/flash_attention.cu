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
// fp32 backward below); its bound is 3 x products over the TF32 rate. In
// bf16 they run on the bf16 tensor cores (mma.sync m16n8k16, fp32 sums): S in
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
// Backward (`flash_bwd_dkv_kernel`, `flash_bwd_dq_kernel`): two kernels,
// no atomics. Each warp owns 16 rows of the outer index (keys for dK/dV,
// queries for dQ), a block of 4 warps 64, and loops over tiles of the
// inner index. Per tile it recomputes S and dP on the tensor cores, forms
// P and dS in the accumulator layout, and multiplies them on into its
// 16 x D gradient accumulators: dK/dV runs 4 products (S^T, dP^T, P^T dO,
// dS^T Q), dQ 3 (S, dP, dS K). The body depends on the inputs' type; the
// two share the tile staging, the loop and the stores, no arithmetic.
//
// bf16 (the LM's training path): every product in one pass of mma.sync
// m16n8k16 on the bf16 tensor cores, fp32 sums. Its bound is the products
// over the bf16 rate (989 TFLOP/s dense), and with mma.sync, whose operands
// come from registers, the shared-memory reads that feed them: every B
// fragment (16 x 8, 256 bytes) feeds one mma of its warp. The design:
//
// - Every fragment by ldmatrix, 4 8 x 8 tiles an instruction, from the
//   row-major tiles staged in shared memory: S^T = K Q^T and dP^T = V dO^T
//   take Q's and dO's B fragments as stored (k along D), P^T dO and dS^T Q
//   transposed (.trans, k along the rows), as the forward takes K and V.
//   The warp's own rows are A fragments: K's and V's stay in registers for
//   the whole loop up to D = 64; Q's and dO's are re-read each tile, which
//   leaves dQ 128-170 registers and more blocks a multiprocessor.
// - P = 2^(S c - lse log2 e) with c = scale log2 e: one fma and ex2.approx
//   an element, as in the forward. dS = P (dP - delta) in fp32. P and dS
//   are then rounded to bf16 in registers, two adjacent 16 x 8 accumulator
//   tiles packed into one A fragment of m16n8k16 (as the forward's P): no
//   shared round trip. Rounding them is what JAX's TPU kernel and
//   FlashAttention-2 feed their products; its 2^-9 relative error is far
//   inside the bf16 gradients' tolerance.
// - Masks only the tiles that hold a masked or ragged entry (the diagonal
//   tiles under causality, the last tile of a ragged T); the rest skip the
//   test.
// - Tiles: dQ streams 64 keys a tile; dK/dV stages up to 128 queries a
//   tile (one sync and one copy of lse and delta for all of them) and works
//   through them in chunks of 64 or 32, as many as its registers allow
//   beside the 16 x D dK and dV accumulators (BwdKVTile, BwdKVOps).
//   Every instance compiles without spills.
//
// fp32: every product on the TF32 tensor cores (mma.sync m16n8k8,
// tf32_mma.cuh) to fp32 accuracy, "3xTF32": each fp32 operand is split
// into hi = tf32(x) and lo = tf32(x - hi), and a b = a_lo b_hi + a_hi b_lo
// + a_hi b_hi. One TF32 pass would keep about 3 decimal digits, too few for
// the fp32 gradients' gates. The bound is thus 3 x products over the TF32
// tensor-core rate (495 TFLOP/s dense), not the CUDA cores. The design:
//
// - Inner tiles of 32 rows (16 for dK/dV at D = 128, so that its 16 x 128
//   dK and dV accumulators, 128 registers a thread, fit). Causal and
//   ragged masks, lse and delta applied to every tile.
// - P and dS go from the accumulator layout to the A-operand layout without
//   shuffles: the second product's reduction index is permuted inside each
//   group of 8 (k = t <-> column 2t, k = t + 4 <-> column 2t + 1), so the A
//   fragment is (c0, c2, c1, c3) of the accumulator, and the B operand's
//   rows follow the same permutation (rows 2t and 2t + 1).
// - Fragments are read a value at a time from the tiles as stored; the
//   loads along D (bank 4 row + col) and, thanks to the permutation, those
//   along rows (bank 8 t + g) are both free of bank conflicts at the pad.
//
// Both types:
//
// - Sums kept short. The tensor cores' fp32 sums truncate instead of
//   rounding to nearest, and a chain of thousands of products into one
//   accumulator drifts (2e-5 relative at the LM's shape, enough to fail
//   the flash-vs-plain training gate). So each 16 x 8 gradient tile sums
//   one inner tile in a fresh accumulator that is added to the running one
//   in IEEE fp32 (and in fp32, S and dP keep the small TF32 terms in an
//   accumulator of their own): the gradients are then as accurate as the
//   plain version in the inputs' type.
// - One copy of each tile, staged as it lies in memory (row-major, in the
//   inputs' type) with 16 bytes of padding a row, which keeps ldmatrix's
//   eight 16-byte rows on distinct banks.
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

// Rows [row0, row0 + ROWS) of one (batch, head) slice, all D columns, into
// shared memory row-major ([ROWS][LD]) with 16-byte cp.async copies; rows
// at or past T are zero-filled.
template <int ROWS, int D, typename E>
__device__ __forceinline__ void async_tile(E* dst, const E* src, int64_t row_stride, int row0,
                                           int T) {
    constexpr int LD = padded_row<E, D>(), PER = 16 / (int)sizeof(E), CH = D / PER;
    static_assert(kThreads % CH == 0, "a thread copies one column of chunks");
    // A thread's column is the same on every row it copies: computed once,
    // so that the compiler keeps one offset live across the tile loop.
    const int c = threadIdx.x % CH;
    for (int r = threadIdx.x / CH; r < ROWS; r += kThreads / CH) {
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
template <int LD>
__device__ __forceinline__ void frag_a(float (&a)[4], const float* s, int r0, int c0, int g,
                                       int t) {
    const float* p = s + (r0 + g) * LD + c0 + t;
    a[0] = p[0];
    a[1] = p[8 * LD];
    a[2] = p[4];
    a[3] = p[8 * LD + 4];
}

// B fragment with k along D and n along rows: (k = c0 + t, n = r0 + g) and
// (k = c0 + t + 4, n = r0 + g).
template <int LD>
__device__ __forceinline__ void frag_b_cols(float (&b)[2], const float* s, int r0, int c0, int g,
                                            int t) {
    const float* p = s + (r0 + g) * LD + c0 + t;
    b[0] = p[0];
    b[1] = p[4];
}

// B fragment with k along rows, in the permuted order that matches an A
// fragment taken from an accumulator (k = t <-> row r0 + 2t, k = t + 4 <->
// row r0 + 2t + 1), and n along D (column c0 + g). Bank 8 t + g:
// conflict-free at the 16-byte pad.
template <int LD>
__device__ __forceinline__ void frag_b_rows(float (&b)[2], const float* s, int r0, int c0, int g,
                                            int t) {
    const float* p = s + (r0 + 2 * t) * LD + c0 + g;
    b[0] = p[0];
    b[1] = p[LD];
}

// The A fragment of a 16 x 8 accumulator tile in the permuted k order.
__device__ __forceinline__ tc::Split<4> acc_as_a(const float (&c)[4]) {
    const float a[4] = {c[0], c[2], c[1], c[3]};
    return tc::split(a);
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
        return tc::split(x);
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
                tc::mma_f32_2acc(s[j], s_lo[j], qa, tc::split(y));
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
                    tc::mma_f32(x[nd], pa[j], tc::split(y));
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
    // Queries of a streamed tile. fp32: 32, or 16 at D = 128, so that the
    // 16 x 128 dK and dV accumulators (128 registers a thread) and S, dP
    // with their lo parts fit without spills. bf16 (chunks below): 128 at
    // D = 64, 64 at D = 32 and 128, 32 at D = 16; fewer syncs a query than
    // smaller tiles, and the fastest on the H100 (PERF.md) of the tiles that
    // compile without spills.
    static constexpr int BK = kOuter;
    static constexpr int BQ = sizeof(E) == 2 ? (D == 64 ? 128 : D == 16 ? 32 : 64)
                                             : (D == 128 ? kInner / 2 : kInner);
    static constexpr int LD = padded_row<E, D>();
    // K, V [BK][LD]; two stages of Q, dO [BQ][LD]; two stages of lse, delta [BQ]
    static constexpr int kBytes =
        (2 * BK * LD + 4 * BQ * LD) * (int)sizeof(E) + 4 * BQ * (int)sizeof(float);
};

// This lane's row address for ldmatrix of a 16 x 16 block at (r0, 0) of a
// row-major bf16 tile. ROWS_MINOR: tiles 0..3 are rows +0 / +8 (tiles 0, 1
// / 2, 3) of columns +0 / +8 (tiles 0, 2 / 1, 3): an A fragment, or with
// .trans the B fragments of two output blocks with k along the rows.
// Otherwise tiles 0..3 are columns +0 / +8 (tiles 0, 2 / 1, 3) of rows +0
// / +8 (tiles 0, 1 / 2, 3): the B fragments of two blocks of rows, with k
// along the columns.
template <int LD, bool ROWS_MINOR>
__device__ __forceinline__ const __nv_bfloat16* ldsm_row(const __nv_bfloat16* s, int r0,
                                                         int lane) {
    const int hi = lane >> 4, mid = (lane >> 3) & 1;
    const int row = r0 + (lane & 7) + 8 * (ROWS_MINOR ? mid : hi);
    return s + row * LD + 8 * (ROWS_MINOR ? hi : mid);
}

// P = 2^(S c - lse log2 e) and dS = P (dP - delta) in place, in the
// accumulator layout of a 16-row tile: element e of tile j sits at row
// half e >> 1, column 8 j + 2 t + (e & 1). nlse(j, half, col) gives
// -lse log2 e and delta(j, half, col) delta of that entry; visible_at(j,
// half, col), read only with MASK, whether it is unmasked and inside T.
template <int N, bool MASK, typename Nlse, typename Delta, typename Visible>
__device__ __forceinline__ void probs_bf16(float (&s)[N][4], float (&dp)[N][4], float c,
                                           Nlse nlse, Delta delta, Visible visible_at) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int half = e >> 1, col = e & 1;
            float p = tc::exp2_ftz(__fmaf_rn(s[j][e], c, nlse(j, half, col)));
            if constexpr (MASK) {
                if (!visible_at(j, half, col)) p = 0.f;
            }
            s[j][e] = p;
            dp[j][e] = p * (dp[j][e] - delta(j, half, col));
        }
    }
}

// Two adjacent 16 x 8 accumulator tiles (16 columns) rounded to bf16: the
// A fragment of m16n8k16 whose k runs over those columns.
__device__ __forceinline__ void pack_a16(uint32_t (&a)[4], const float (&x0)[4],
                                         const float (&x1)[4]) {
    a[0] = tc::pack_bf16(x0[0], x0[1]);
    a[1] = tc::pack_bf16(x0[2], x0[3]);
    a[2] = tc::pack_bf16(x1[0], x1[1]);
    a[3] = tc::pack_bf16(x1[2], x1[3]);
}

// The products of one warp (16 keys) and one query tile, by input type:
// S^T = K Q^T and dP^T = V dO^T, then P^T and dS^T in the accumulator
// layout (row key, column query), then dV += P^T dO and dK += dS^T Q,
// reducing over the tile's queries: each 16 x 8 output tile sums the tile
// (in bf16 a chunk of it) in a fresh accumulator, added to the running one
// in IEEE fp32.
template <typename E, int D, int BQ, int LD>
struct BwdKVOps;

// fp32: on the TF32 tensor cores to fp32 accuracy (3xTF32, m16n8k8).
template <int D, int BQ, int LD>
struct BwdKVOps<float, D, BQ, LD> {
    struct KV {};
    static __device__ __forceinline__ void load_kv(KV&, const float*, const float*, int, int) {}

    static __device__ __forceinline__ void tile(float (&dk_acc)[D / 8][4],
                                                float (&dv_acc)[D / 8][4], const KV&,
                                                const float* Ks, const float* Vs, const float* Qb,
                                                const float* dOb, const float* lse_b,
                                                const float* dl_b, int q0, int kr, int warp,
                                                int T, int causal, float scale, int g, int t,
                                                int /*lane*/) {
        // S^T = K Q^T and dP^T = V dO^T: [16 keys][BQ queries].
        float s[BQ / 8][4] = {}, dp[BQ / 8][4] = {};
        float s_lo[BQ / 8][4] = {}, dp_lo[BQ / 8][4] = {};
#pragma unroll
        for (int kk = 0; kk < D / 8; ++kk) {
            float x[4];
            frag_a<LD>(x, Ks, warp * kWarpRows, 8 * kk, g, t);
            const tc::Split<4> ka = tc::split(x);
            frag_a<LD>(x, Vs, warp * kWarpRows, 8 * kk, g, t);
            const tc::Split<4> va = tc::split(x);
#pragma unroll
            for (int j = 0; j < BQ / 8; ++j) {
                float y[2];
                frag_b_cols<LD>(y, Qb, 8 * j, 8 * kk, g, t);
                tc::mma_f32_2acc(s[j], s_lo[j], ka, tc::split(y));
                frag_b_cols<LD>(y, dOb, 8 * j, 8 * kk, g, t);
                tc::mma_f32_2acc(dp[j], dp_lo[j], va, tc::split(y));
            }
        }
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j) {
            tc::add4(s[j], s_lo[j]);
            tc::add4(dp[j], dp_lo[j]);
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
                tc::mma_f32(tv, pa[j], tc::split(y));
                frag_b_rows<LD>(y, Qb, 8 * j, 8 * nd, g, t);
                tc::mma_f32(tk, sa[j], tc::split(y));
            }
            tc::add4(dv_acc[nd], tv);
            tc::add4(dk_acc[nd], tk);
        }
    }
};

// bf16: on the bf16 tensor cores (m16n8k16, fp32 sums), one pass a
// product, every fragment by ldmatrix; P^T and dS^T rounded to bf16.
template <int D, int BQ, int LD>
struct BwdKVOps<__nv_bfloat16, D, BQ, LD> {
    using bf16 = __nv_bfloat16;
    // K's and V's A fragments (the warp's 16 keys), loaded once for the
    // whole query loop up to D = 64 (D / 2 registers a thread); at D = 128,
    // whose dK and dV accumulators take 128 registers, re-read each chunk.
    static constexpr bool kRegs = D <= 64;
    // The streamed tile runs in chunks of CH queries: S^T, dP^T, P^T, dS^T
    // of a chunk, then its products, each output tile summed over the chunk
    // in a fresh accumulator. 64 at D = 64, else 32: the chunk's S^T and dP^T
    // (CH / 2 registers a thread each) beside the dK and dV accumulators
    // (D / 2 each).
    static constexpr int CH = D == 64 ? 64 : 32;
    static_assert(BQ % CH == 0, "a streamed tile is whole chunks");
    struct KV {
        uint32_t k[kRegs ? D / 16 : 1][4], v[kRegs ? D / 16 : 1][4];
    };

    static __device__ __forceinline__ void load_kv(KV& kv, const bf16* Ks, const bf16* Vs,
                                                   int r0, int lane) {
        if constexpr (kRegs) {
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk) {
                tc::ldmatrix_x4(kv.k[kk], ldsm_row<LD, true>(Ks, r0, lane) + 16 * kk);
                tc::ldmatrix_x4(kv.v[kk], ldsm_row<LD, true>(Vs, r0, lane) + 16 * kk);
            }
        }
    }

    static __device__ __forceinline__ void tile(float (&dk_acc)[D / 8][4],
                                                float (&dv_acc)[D / 8][4], const KV& kv,
                                                const bf16* Ks, const bf16* Vs, const bf16* Qb,
                                                const bf16* dOb, const float* lse_b,
                                                const float* dl_b, int q0, int kr, int warp,
                                                int T, int causal, float scale, int g, int t,
                                                int lane) {
        const int r0 = warp * kWarpRows;
        const float c = (float)(scale * kLog2e);
#pragma unroll
        for (int c0 = 0; c0 < BQ; c0 += CH) {
            const int qc = q0 + c0;  // the chunk's first query
            // Skip a chunk wholly before the warp's keys or past T.
            if ((causal && kr > qc + CH - 1) || qc >= T) continue;
            float s[CH / 8][4] = {}, dp[CH / 8][4] = {};
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk) {
                uint32_t ka[4], va[4];
                if constexpr (kRegs) {
#pragma unroll
                    for (int r = 0; r < 4; ++r) ka[r] = kv.k[kk][r], va[r] = kv.v[kk][r];
                } else {
                    tc::ldmatrix_x4(ka, ldsm_row<LD, true>(Ks, r0, lane) + 16 * kk);
                    tc::ldmatrix_x4(va, ldsm_row<LD, true>(Vs, r0, lane) + 16 * kk);
                }
#pragma unroll
                for (int jp = 0; jp < CH / 16; ++jp) {
                    uint32_t y[4];
                    tc::ldmatrix_x4(y, ldsm_row<LD, false>(Qb, c0 + 16 * jp, lane) + 16 * kk);
                    const uint32_t q0b[2] = {y[0], y[1]}, q1b[2] = {y[2], y[3]};
                    tc::mma_bf16(s[2 * jp], ka, q0b);
                    tc::mma_bf16(s[2 * jp + 1], ka, q1b);
                    tc::ldmatrix_x4(y, ldsm_row<LD, false>(dOb, c0 + 16 * jp, lane) + 16 * kk);
                    const uint32_t o0b[2] = {y[0], y[1]}, o1b[2] = {y[2], y[3]};
                    tc::mma_bf16(dp[2 * jp], va, o0b);
                    tc::mma_bf16(dp[2 * jp + 1], va, o1b);
                }
            }
            // Column (query) qc + 8 j + 2 t + col; row (key) kr + g + 8 half.
            auto nlse = [&](int j, int, int col) {
                return -lse_b[c0 + 8 * j + 2 * t + col] * (float)kLog2e;
            };
            auto delta = [&](int j, int, int col) { return dl_b[c0 + 8 * j + 2 * t + col]; };
            auto vis = [&](int j, int half, int col) {
                return visible(qc + 8 * j + 2 * t + col, kr + g + 8 * half, T, causal);
            };
            // Masks only where the chunk holds a query before one of the
            // warp's keys, or a query or a key past T (warp-uniform).
            if ((causal && qc < kr + kWarpRows - 1) || qc + CH > T || kr + kWarpRows > T) {
                probs_bf16<CH / 8, true>(s, dp, c, nlse, delta, vis);
            } else {
                probs_bf16<CH / 8, false>(s, dp, c, nlse, delta, vis);
            }
            uint32_t pa[CH / 16][4], sa[CH / 16][4];
#pragma unroll
            for (int jj = 0; jj < CH / 16; ++jj) {
                pack_a16(pa[jj], s[2 * jj], s[2 * jj + 1]);
                pack_a16(sa[jj], dp[2 * jj], dp[2 * jj + 1]);
            }
            // dV += P^T dO and dK += dS^T Q: dO's and Q's B fragments
            // transposed out of their row-major tiles, two output tiles of 8
            // columns a load, the chunk summed in fresh accumulators.
#pragma unroll
            for (int np = 0; np < D / 16; ++np) {
                float tv[2][4] = {}, tk[2][4] = {};
#pragma unroll
                for (int jj = 0; jj < CH / 16; ++jj) {
                    uint32_t y[4];
                    tc::ldmatrix_x4_trans(y, ldsm_row<LD, true>(dOb, c0 + 16 * jj, lane) + 16 * np);
                    const uint32_t o0b[2] = {y[0], y[1]}, o1b[2] = {y[2], y[3]};
                    tc::mma_bf16(tv[0], pa[jj], o0b);
                    tc::mma_bf16(tv[1], pa[jj], o1b);
                    tc::ldmatrix_x4_trans(y, ldsm_row<LD, true>(Qb, c0 + 16 * jj, lane) + 16 * np);
                    const uint32_t q0b[2] = {y[0], y[1]}, q1b[2] = {y[2], y[3]};
                    tc::mma_bf16(tk[0], sa[jj], q0b);
                    tc::mma_bf16(tk[1], sa[jj], q1b);
                }
#pragma unroll
                for (int i = 0; i < 2; ++i) {
                    tc::add4(dv_acc[2 * np + i], tv[i]);
                    tc::add4(dk_acc[2 * np + i], tk[i]);
                }
            }
        }
    }
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
    using Ops = BwdKVOps<E, D, BQ, LD>;
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
    tc::cp_async_commit();
    stage(0);
    tc::cp_async_wait<1>();
    __syncthreads();  // K and V visible to every warp
    typename Ops::KV kv;
    Ops::load_kv(kv, Ks, Vs, warp * kWarpRows, lane);

    float dk_acc[D / 8][4] = {}, dv_acc[D / 8][4] = {};
    for (int i = 0; i < n_tiles; ++i) {
        if (i + 1 < n_tiles) {
            stage(i + 1);
            tc::cp_async_wait<1>();
        } else {
            tc::cp_async_wait<0>();
        }
        __syncthreads();  // tile i visible to every warp
        const int q0 = q_begin + i * BQ, buf = i & 1;
        // Skip when this warp's keys are all past T or all after the
        // tile's last query (warp-uniform).
        if (kr < T && (!causal || kr <= q0 + BQ - 1)) {
            Ops::tile(dk_acc, dv_acc, kv, Ks, Vs, Qs + buf * BQ * LD, dOs + buf * BQ * LD,
                      lse_s + buf * BQ, dl_s + buf * BQ, q0, kr, warp, T, causal, scale, g, t,
                      lane);
        }
        __syncthreads();  // every warp is done with buffer i & 1 before it reloads
    }
    store_rows<D>(dk, dk_acc, scale, base, sT, kr, T, g, t);
    store_rows<D>(dv, dv_acc, 1.f, base, sT, kr, T, g, t);
}

// ---------------------------------------------------------------------- dQ

template <typename E, int D>
struct BwdQTile {
    // Keys of a streamed tile: 32 in fp32, 64 in bf16 (faster on the H100,
    // PERF.md).
    static constexpr int BQ = kOuter, BK = sizeof(E) == 2 ? 64 : kInner;
    static constexpr int LD = padded_row<E, D>();
    // Q, dO [BQ][LD]; two stages of K, V [BK][LD]
    static constexpr int kBytes = (2 * BQ * LD + 4 * BK * LD) * (int)sizeof(E);
};

// The products of one warp (16 queries) and one key tile, by input type:
// S = Q K^T and dP = dO V^T, dS in the accumulator layout (row query,
// column key), then dQ += dS K, reducing over the tile's keys, a fresh
// accumulator per output tile as in dK/dV.
template <typename E, int D, int BK, int LD>
struct BwdQOps;

// fp32: 3xTF32, as dK/dV.
template <int D, int BK, int LD>
struct BwdQOps<float, D, BK, LD> {
    static __device__ __forceinline__ void tile(float (&acc)[D / 8][4], const float* Qs,
                                                const float* dOs,
                                                const float* Kb, const float* Vb,
                                                const float (&lse_r)[2], const float (&dl_r)[2],
                                                int k0, int qr, int warp, int T, int causal,
                                                float scale, int g, int t, int /*lane*/) {
        // S = Q K^T and dP = dO V^T: [16 queries][BK keys].
        float s[BK / 8][4] = {}, dp[BK / 8][4] = {};
        float s_lo[BK / 8][4] = {}, dp_lo[BK / 8][4] = {};
#pragma unroll
        for (int kk = 0; kk < D / 8; ++kk) {
            float x[4];
            frag_a<LD>(x, Qs, warp * kWarpRows, 8 * kk, g, t);
            const tc::Split<4> qa = tc::split(x);
            frag_a<LD>(x, dOs, warp * kWarpRows, 8 * kk, g, t);
            const tc::Split<4> oa = tc::split(x);
#pragma unroll
            for (int j = 0; j < BK / 8; ++j) {
                float y[2];
                frag_b_cols<LD>(y, Kb, 8 * j, 8 * kk, g, t);
                tc::mma_f32_2acc(s[j], s_lo[j], qa, tc::split(y));
                frag_b_cols<LD>(y, Vb, 8 * j, 8 * kk, g, t);
                tc::mma_f32_2acc(dp[j], dp_lo[j], oa, tc::split(y));
            }
        }
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
            tc::add4(s[j], s_lo[j]);
            tc::add4(dp[j], dp_lo[j]);
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
                tc::mma_f32(tq, sa[j], tc::split(y));
            }
            tc::add4(acc[nd], tq);
        }
    }
};

// bf16: one m16n8k16 pass a product, as dK/dV; dS rounded to bf16. Q's
// and dO's A fragments are re-read each tile: held for the whole loop,
// they cost 32 registers (64 at D = 128) and blocks a multiprocessor.
template <int D, int BK, int LD>
struct BwdQOps<__nv_bfloat16, D, BK, LD> {
    using bf16 = __nv_bfloat16;

    static __device__ __forceinline__ void tile(float (&acc)[D / 8][4], const bf16* Qs,
                                                const bf16* dOs, const bf16* Kb, const bf16* Vb,
                                                const float (&lse_r)[2], const float (&dl_r)[2],
                                                int k0, int qr, int warp, int T, int causal,
                                                float scale, int g, int t, int lane) {
        float s[BK / 8][4] = {}, dp[BK / 8][4] = {};
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
            uint32_t qa[4], oa[4];
            tc::ldmatrix_x4(qa, ldsm_row<LD, true>(Qs, warp * kWarpRows, lane) + 16 * kk);
            tc::ldmatrix_x4(oa, ldsm_row<LD, true>(dOs, warp * kWarpRows, lane) + 16 * kk);
#pragma unroll
            for (int jp = 0; jp < BK / 16; ++jp) {
                uint32_t y[4];
                tc::ldmatrix_x4(y, ldsm_row<LD, false>(Kb, 16 * jp, lane) + 16 * kk);
                const uint32_t k0b[2] = {y[0], y[1]}, k1b[2] = {y[2], y[3]};
                tc::mma_bf16(s[2 * jp], qa, k0b);
                tc::mma_bf16(s[2 * jp + 1], qa, k1b);
                tc::ldmatrix_x4(y, ldsm_row<LD, false>(Vb, 16 * jp, lane) + 16 * kk);
                const uint32_t v0b[2] = {y[0], y[1]}, v1b[2] = {y[2], y[3]};
                tc::mma_bf16(dp[2 * jp], oa, v0b);
                tc::mma_bf16(dp[2 * jp + 1], oa, v1b);
            }
        }
        // Row (query) qr + g + 8 half; column (key) k0 + 8 j + 2 t + col.
        const float c = (float)(scale * kLog2e);
        const float nl[2] = {-lse_r[0] * (float)kLog2e, -lse_r[1] * (float)kLog2e};
        auto nlse = [&](int, int half, int) { return nl[half]; };
        auto delta = [&](int, int half, int) { return dl_r[half]; };
        auto vis = [&](int j, int half, int col) {
            return visible(qr + g + 8 * half, k0 + 8 * j + 2 * t + col, T, causal);
        };
        // Masks only where the tile holds a key after one of the warp's
        // queries, or a key or a query past T (warp-uniform).
        if ((causal && k0 + BK - 1 > qr) || k0 + BK > T || qr + kWarpRows > T) {
            probs_bf16<BK / 8, true>(s, dp, c, nlse, delta, vis);
        } else {
            probs_bf16<BK / 8, false>(s, dp, c, nlse, delta, vis);
        }
        uint32_t sa[BK / 16][4];
#pragma unroll
        for (int jj = 0; jj < BK / 16; ++jj) pack_a16(sa[jj], dp[2 * jj], dp[2 * jj + 1]);
        // K's B fragments transposed out of its row-major tile, two output
        // tiles of 8 columns a load.
#pragma unroll
        for (int np = 0; np < D / 16; ++np) {
            float x[2][4] = {};
#pragma unroll
            for (int jj = 0; jj < BK / 16; ++jj) {
                uint32_t y[4];
                tc::ldmatrix_x4_trans(y, ldsm_row<LD, true>(Kb, 16 * jj, lane) + 16 * np);
                const uint32_t b0[2] = {y[0], y[1]}, b1[2] = {y[2], y[3]};
                tc::mma_bf16(x[0], sa[jj], b0);
                tc::mma_bf16(x[1], sa[jj], b1);
            }
            tc::add4(acc[2 * np], x[0]);
            tc::add4(acc[2 * np + 1], x[1]);
        }
    }
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
    using Ops = BwdQOps<E, D, BK, LD>;
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
        // Skip when this warp's queries are all past T or all before the
        // tile's first key (warp-uniform).
        if (qr < T && (!causal || k0 <= qr + kWarpRows - 1)) {
            Ops::tile(acc, Qs, dOs, Ks + buf * BK * LD, Vs + buf * BK * LD, lse_r, dl_r, k0, qr,
                      warp, T, causal, scale, g, t, lane);
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
