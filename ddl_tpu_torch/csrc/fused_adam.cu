// One TF1-semantics Adam step over flat float32 vectors, in place.
//
// Replaces the Pallas TPU kernel `adam_flat_fused` (ddl_tpu/ops/pallas_adam.py,
// body `_adam_kernel`), which the ZeRO-1 sharded sync step runs on each
// device's owned slice of the flat parameter vector when `fused_adam` is set:
//
//     m' = b1*m + (1-b1)*g
//     v' = b2*v + (1-b2)*g*g
//     p' = p - lr_t * m' / (sqrt(v') + eps)
//
// What bounds it on Hopper: bytes. Each element reads g, m, v, p and writes
// p', m', v' (28 bytes) for about ten floating-point operations, far below
// the card's operations-per-byte balance. So the design is one pass over
// HBM: a grid-stride loop over float4 (16-byte) loads and stores, with
// neighbouring threads on neighbouring addresses, and a scalar tail for
// n % 4. The Pallas kernel's (512, 128) VMEM tiles have no counterpart:
// every element is independent, so nothing is staged in shared memory.
//
// Numerics: every operation is written with a round-to-nearest intrinsic
// (__fmul_rn, __fadd_rn, ...), which the compiler never contracts into an
// FMA, and sqrt and division are IEEE. The kernel therefore rounds exactly
// as the plain PyTorch chain (`adam_flat_reference`) does, operation by
// operation. Build without --use_fast_math.
//
// lr_t is read from a one-element device buffer, so a launch needs no host
// sync and can later be captured in a CUDA graph. The launcher uses the
// caller's stream and returns cudaGetLastError() of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct AdamCoeffs {
    float b1, c1;  // c1 = 1 - b1, rounded to float on the host
    float b2, c2;  // c2 = 1 - b2
    float eps;
};

__device__ __forceinline__ void adam_one(float& p, float& m, float& v, float g,
                                         float lr_t, const AdamCoeffs& k) {
    m = __fadd_rn(__fmul_rn(k.b1, m), __fmul_rn(k.c1, g));
    v = __fadd_rn(__fmul_rn(k.b2, v), __fmul_rn(__fmul_rn(k.c2, g), g));
    p = __fsub_rn(p, __fdiv_rn(__fmul_rn(lr_t, m), __fadd_rn(__fsqrt_rn(v), k.eps)));
}

template <bool kVec4>
__global__ void adam_flat_kernel(float* __restrict__ p, float* __restrict__ m,
                                 float* __restrict__ v, const float* __restrict__ g,
                                 const float* __restrict__ lr_ptr, int64_t n,
                                 AdamCoeffs k) {
    const float lr_t = __ldg(lr_ptr);
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    int64_t done = 0;
    if (kVec4) {
        const int64_t n4 = n / 4;
        float4* p4 = reinterpret_cast<float4*>(p);
        float4* m4 = reinterpret_cast<float4*>(m);
        float4* v4 = reinterpret_cast<float4*>(v);
        const float4* g4 = reinterpret_cast<const float4*>(g);
        for (int64_t i = tid; i < n4; i += stride) {
            const float4 gi = __ldg(g4 + i);
            float4 pi = p4[i], mi = m4[i], vi = v4[i];
            adam_one(pi.x, mi.x, vi.x, gi.x, lr_t, k);
            adam_one(pi.y, mi.y, vi.y, gi.y, lr_t, k);
            adam_one(pi.z, mi.z, vi.z, gi.z, lr_t, k);
            adam_one(pi.w, mi.w, vi.w, gi.w, lr_t, k);
            p4[i] = pi;
            m4[i] = mi;
            v4[i] = vi;
        }
        done = n4 * 4;
    }
    for (int64_t i = done + tid; i < n; i += stride) {
        float pi = p[i], mi = m[i], vi = v[i];
        adam_one(pi, mi, vi, __ldg(g + i), lr_t, k);
        p[i] = pi;
        m[i] = mi;
        v[i] = vi;
    }
}

constexpr int kThreads = 256;

}  // namespace

extern "C" {

// Launch one Adam step over n elements on `stream` of CUDA device `device`.
// `vec4` selects the float4 path; the caller sets it only when all four data
// pointers are 16-byte aligned. `max_blocks` caps the grid (the grid-stride
// loop covers the rest). Returns the launch's cudaError_t as an int
// (0 = success).
int ddl_adam_flat_f32(float* p, float* m, float* v, const float* g,
                      const float* lr_t, int64_t n, float b1, float c1, float b2,
                      float c2, float eps, int vec4, int max_blocks, int device,
                      void* stream) {
    if (n <= 0) return 0;
    // This library links its own CUDA runtime; point it at the caller's
    // device before launching on the caller's stream.
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const AdamCoeffs k{b1, c1, b2, c2, eps};
    const int64_t work = vec4 ? (n / 4 + n % 4) : n;
    int64_t blocks = (work + kThreads - 1) / kThreads;
    if (blocks > max_blocks) blocks = max_blocks;
    if (blocks < 1) blocks = 1;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (vec4) {
        adam_flat_kernel<true><<<(unsigned)blocks, kThreads, 0, s>>>(p, m, v, g, lr_t, n, k);
    } else {
        adam_flat_kernel<false><<<(unsigned)blocks, kThreads, 0, s>>>(p, m, v, g, lr_t, n, k);
    }
    return (int)cudaGetLastError();
}

const char* ddl_cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
