// Hopper building blocks for tensor-core products, fp32-accurate on the
// TF32 tensor cores ("3xTF32") or in bf16, and for asynchronous tile
// copies. Used by the flash attention kernels (flash_attention.cu).
//
// Fragment layouts of mma.sync.m16n8k8 (TF32), for lane = 4 g + t:
//   A (16 x 8, row-major)  a0 = (g, t)   a1 = (g + 8, t)   a2 = (g, t + 4)   a3 = (g + 8, t + 4)
//   B (8 x 8, k x n)       b0 = (k = t, n = g)   b1 = (k = t + 4, n = g)
//   C (16 x 8)             c0 = (g, 2t)  c1 = (g, 2t + 1)  c2 = (g + 8, 2t)  c3 = (g + 8, 2t + 1)
//
// mma.sync.m16n8k16 (bf16) holds two values a register, the lower k in the
// low half; C as above:
//   A (16 x 16)  a0 = (g, 2t..2t+1)  a1 = (g + 8, 2t..2t+1)  a2 = (g, 2t+8..2t+9)  a3 = (g + 8, 2t+8..2t+9)
//   B (16 x 8)   b0 = (k = 2t..2t+1, n = g)  b1 = (k = 2t+8..2t+9, n = g)

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tc {

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero; the low 13 bits of the result are zero. For finite x this is the
// result of cvt.rna.tf32.f32: half a TF32 ulp is added to the magnitude
// bits (a carry moves into the exponent, as rounding up should) and the
// low bits are cleared. Two integer instructions; on sm_90a the cvt
// compiles to four (with NaN and infinity checks), which made the split
// half of the backward kernels' instructions.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
    return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// An operand fragment split as x = hi + lo + O(2^-22 |x|): hi = tf32(x),
// lo = tf32(x - hi). x - hi is exact in fp32 (__fsub_rn: never contracted).
// EXACT: x is already a TF32 value (a widened bf16), so lo = 0 and unused.
template <int N>
struct Split {
    uint32_t hi[N], lo[N];
};

template <bool EXACT, int N>
__device__ __forceinline__ Split<N> split(const float (&x)[N]) {
    Split<N> s;
#pragma unroll
    for (int i = 0; i < N; ++i) {
        if constexpr (EXACT) {
            s.hi[i] = __float_as_uint(x[i]);
            s.lo[i] = 0u;
        } else {
            s.hi[i] = tf32_rna(x[i]);
            s.lo[i] = tf32_rna(__fsub_rn(x[i], __uint_as_float(s.hi[i])));
        }
    }
    return s;
}

// c += a b on the tensor cores, one m16n8k8 TF32 product, fp32 sums.
// The tensor cores' fp32 sums truncate rather than round to nearest, so a
// long chain of these into one accumulator drifts toward zero: callers
// keep chains short and add their results in IEEE fp32 (add4).
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b to fp32 accuracy: a_lo b_hi + a_hi b_lo + a_hi b_hi, small terms
// first (the a_lo b_lo term, O(2^-22), is dropped). An exact operand has no
// lo part, so its term is skipped: 2 products when one side is exact, 1
// when both are.
template <bool A_EXACT, bool B_EXACT>
__device__ __forceinline__ void mma_f32(float (&c)[4], const Split<4>& a, const Split<2>& b) {
    if constexpr (!A_EXACT) mma_tf32(c, a.lo, b.hi);
    if constexpr (!B_EXACT) mma_tf32(c, a.hi, b.lo);
    mma_tf32(c, a.hi, b.hi);
}

// The same product with the small terms in an accumulator of their own
// (2^-11 the size of the sum), so the main chain holds a_hi b_hi alone:
// c_hi += a_hi b_hi, c_lo += a_lo b_hi + a_hi b_lo. The caller adds c_lo
// to c_hi in IEEE fp32 at the end of the chain.
template <bool A_EXACT, bool B_EXACT>
__device__ __forceinline__ void mma_f32_2acc(float (&c_hi)[4], float (&c_lo)[4],
                                             const Split<4>& a, const Split<2>& b) {
    if constexpr (!A_EXACT) mma_tf32(c_lo, a.lo, b.hi);
    if constexpr (!B_EXACT) mma_tf32(c_lo, a.hi, b.lo);
    mma_tf32(c_hi, a.hi, b.hi);
}

// c += x in IEEE fp32 (never contracted).
__device__ __forceinline__ void add4(float (&c)[4], const float (&x)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) c[i] = __fadd_rn(c[i], x[i]);
}

// c += a b on the tensor cores, one m16n8k16 bf16 product, fp32 sums (which
// truncate, as above).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 2^x (ex2.approx.ftz: relative error about 2^-22, as exp2f's; results
// below 2^-126 flush to zero, which exp2f spends extra instructions on).
__device__ __forceinline__ float exp2_ftz(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// x and y, each split into two bf16 parts as x = hi + lo + O(2^-16 |x|):
// hi = bf16(x), lo = bf16(x - hi), both rounded to nearest even. Each
// register holds the x part in its low half. x - hi is exact in fp32.
__device__ __forceinline__ void split_bf16(uint32_t& hi, uint32_t& lo, float x, float y) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    const __nv_bfloat162 l =
        __floats2bfloat162_rn(__fsub_rn(x, __low2float(h)), __fsub_rn(y, __high2float(h)));
    hi = *reinterpret_cast<const uint32_t*>(&h);
    lo = *reinterpret_cast<const uint32_t*>(&l);
}

// Four 8 x 8 tiles of 16-bit values from shared memory (ldmatrix): lanes
// 8i..8i+7 pass the addresses of rows 0..7 of tile i (16 bytes each,
// 16-byte aligned), and lane 4 g + t receives in r[i] tile i's elements
// (row g, columns 2t and 2t + 1), the first in the low half: a B fragment
// of m16n8k16 with k along the columns.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
    const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(row));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(s));
}

// The same tiles transposed (ldmatrix .trans): lane 4 g + t receives in
// r[i] tile i's elements (row 2t, column g) and (row 2t + 1, column g), the
// first in the low half: a B fragment of m16n8k16 with k along the rows.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
    const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(row));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(s));
}

// Asynchronous global -> shared copies (cp.async). With valid false the
// destination is zero-filled and nothing is read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
    const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(src),
                 "r"(valid ? 16 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
    const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(s), "l"(src),
                 "r"(valid ? 4 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

}  // namespace tc
