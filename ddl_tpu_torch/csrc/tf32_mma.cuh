// Hopper building blocks for fp32-accurate products on the TF32 tensor
// cores ("3xTF32") and for asynchronous tile copies. Used by the flash
// attention backward kernels (flash_attention.cu).
//
// Fragment layouts of mma.sync.m16n8k8 (TF32), for lane = 4 g + t:
//   A (16 x 8, row-major)  a0 = (g, t)   a1 = (g + 8, t)   a2 = (g, t + 4)   a3 = (g + 8, t + 4)
//   B (8 x 8, k x n)       b0 = (k = t, n = g)   b1 = (k = t + 4, n = g)
//   C (16 x 8)             c0 = (g, 2t)  c1 = (g, 2t + 1)  c2 = (g + 8, 2t)  c3 = (g + 8, 2t + 1)

#pragma once

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
