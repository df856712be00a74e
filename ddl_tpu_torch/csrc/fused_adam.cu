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
// the card's operations-per-byte balance. The design's job is to keep HBM
// busy from the first cycle to the last:
//
// - One resident wave. The wrapper (ops/fused_adam.py, `launch_plan`) sizes
//   the grid from the occupancy this library reports for the compiled
//   kernel (`ddl_adam_blocks_per_sm`): at most one wave of blocks, so no
//   block waits for a slot.
// - The grid sweeps the arrays together: in each sweep block b takes the
//   b-th tile of kThreads adjacent units (float4s, or floats on the scalar
//   path), so at any time the whole grid reads one advancing window of each
//   array. Giving each block one contiguous range instead puts hundreds of
//   streams across the arrays at once, and measured 1.7-5.8 us slower on
//   the H100 (PERF.md).
// - Bytes in flight: the TMA ring (`adam_flat_ring_kernel`, float4 path).
//   One producer thread streams tiles of g, p, m and v into a ring of
//   shared-memory stages with cp.async.bulk; the consumers compute from
//   shared memory and store straight to global memory. Up to 64 KB of
//   copies are in flight per block for one thread's instructions. It read
//   faster cold and hot than a plain sweep with 1, 2, 4 or 8 float4s of
//   every operand a thread, all loads first (PERF.md).
// - Cache policy for the step around it. g is read once: it is loaded
//   evict-first. m' and v' are not read again until the next step, but
//   storing them evict-first makes the L2 write them back during the
//   kernel, and measured slower hot; they are stored, like p' (which the
//   next forward or the all-gather reads first), with the default policy.
// - The float4 path runs only when all four pointers are 16-byte aligned
//   (the wrapper checks; so do the bulk copies); the n % 4 elements past
//   the last float4 are done by block 0's first threads. Otherwise the
//   scalar kernel (`adam_flat_scalar_kernel`) sweeps one float of every
//   operand a thread. Neighbouring threads take neighbouring units, so
//   every load and store is coalesced.
//
// The Pallas kernel's (512, 128) VMEM tiles have no counterpart: every
// element is independent, and shared memory only stages the TMA's copies.
//
// Numerics: every operation is written with a round-to-nearest intrinsic
// (__fmul_rn, __fadd_rn, ...), which the compiler never contracts into an
// FMA, and sqrt and division are IEEE. Both kernels therefore round exactly
// as the plain PyTorch chain (`adam_flat_reference`) does, operation by
// operation: bit-equal. Build without --use_fast_math.
//
// lr_t is read from a one-element device buffer, so a launch needs no host
// sync and can be captured in a CUDA graph. The launcher uses the caller's
// stream and returns cudaGetLastError() of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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

// The scalar path: one float of every operand a thread and sweep, g loaded
// evict-first; the grid sweeps the arrays together in tiles of kThreads.
__global__ void __launch_bounds__(kThreads)
adam_flat_scalar_kernel(float* __restrict__ p, float* __restrict__ m, float* __restrict__ v,
                        const float* __restrict__ g, const float* __restrict__ lr_ptr,
                        int64_t n, AdamCoeffs k) {
    const float lr_t = __ldg(lr_ptr);
    const int64_t step = (int64_t)gridDim.x * kThreads;
    for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n; i += step) {
        float pi = p[i], mi = m[i], vi = v[i];
        adam_one(pi, mi, vi, __ldcs(g + i), lr_t, k);
        p[i] = pi;
        m[i] = mi;
        v[i] = vi;
    }
}

// The TMA ring: the update with its loads done by the Tensor Memory
// Accelerator. One producer thread streams tiles of kThreads float4s of g,
// p, m and v into a ring of kRingStages stages in shared memory
// (cp.async.bulk, completion counted in bytes on a "full" mbarrier; g with
// an evict-first L2 policy); kThreads consumer threads take one float4 of
// each operand per tile from shared memory, update it and store p', m', v'
// straight to global memory, then release the stage on its "empty"
// mbarrier (one arrival a warp). Block b's tiles start at float4s
// (b + t * gridDim.x) * kThreads, t = 0, 1, ...
constexpr int kRingStages = 4;
constexpr int kRingThreads = kThreads + 32;  // the consumers and one producer warp

struct RingSmem {
    float4 g[kRingStages][kThreads], p[kRingStages][kThreads];
    float4 m[kRingStages][kThreads], v[kRingStages][kThreads];
    uint64_t full[kRingStages], empty[kRingStages];
};

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
                 : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
                 "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    asm volatile(
        "{\n"
        ".reg .pred P1;\n"
        "LAB_WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
        "@P1 bra DONE;\n"
        "bra LAB_WAIT;\n"
        "DONE:\n"
        "}\n" ::"r"(smem_u32(bar)),
        "r"(parity)
        : "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
        ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
        : "memory");
}

// A bulk load under an L2 cache policy (createpolicy).
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar, uint64_t policy) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint "
        "[%0], [%1], %2, [%3], %4;" ::"r"(smem_u32(dst)),
        "l"(src), "r"(bytes), "r"(smem_u32(bar)), "l"(policy)
        : "memory");
}

__global__ void __launch_bounds__(kRingThreads)
adam_flat_ring_kernel(float* __restrict__ p, float* __restrict__ m, float* __restrict__ v,
                      const float* __restrict__ g, const float* __restrict__ lr_ptr, int64_t n,
                      AdamCoeffs k) {
    extern __shared__ __align__(128) unsigned char smem_raw[];
    RingSmem& sm = *reinterpret_cast<RingSmem*>(smem_raw);
    // Bulk copies need no more than 16-byte alignment, so a tile may start
    // at any float4.
    const int64_t units = n / 4;
    const int64_t first = (int64_t)blockIdx.x * kThreads;
    const int64_t step = (int64_t)gridDim.x * kThreads;
    const int64_t tiles = first < units ? (units - first + step - 1) / step : 0;
    float4* p4 = reinterpret_cast<float4*>(p);
    float4* m4 = reinterpret_cast<float4*>(m);
    float4* v4 = reinterpret_cast<float4*>(v);
    const float4* g4 = reinterpret_cast<const float4*>(g);
    if (threadIdx.x == 0) {
        for (int i = 0; i < kRingStages; ++i) {
            mbar_init(&sm.full[i], 1);
            mbar_init(&sm.empty[i], kThreads / 32);
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x >= kThreads) {  // the producer warp: one thread issues every copy
        if (threadIdx.x != kThreads) return;
        uint64_t evict_first;
        asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(evict_first));
        for (int64_t t = 0; t < tiles; ++t) {
            const int st = (int)(t % kRingStages);
            mbar_wait(&sm.empty[st], (uint32_t)((t / kRingStages) & 1) ^ 1u);
            const int64_t at = first + t * step;
            const int64_t left = units - at;
            const uint32_t bytes = (uint32_t)((left < kThreads ? left : kThreads) * 16);
            mbar_expect_tx(&sm.full[st], 4 * bytes);
            bulk_load(sm.g[st], g4 + at, bytes, &sm.full[st], evict_first);
            bulk_load(sm.p[st], p4 + at, bytes, &sm.full[st]);
            bulk_load(sm.m[st], m4 + at, bytes, &sm.full[st]);
            bulk_load(sm.v[st], v4 + at, bytes, &sm.full[st]);
        }
        return;
    }
    const float lr_t = __ldg(lr_ptr);
    for (int64_t t = 0; t < tiles; ++t) {
        const int st = (int)(t % kRingStages);
        mbar_wait(&sm.full[st], (uint32_t)((t / kRingStages) & 1));
        const int64_t e = first + t * step + threadIdx.x;
        if (e < units) {
            float4 pi = sm.p[st][threadIdx.x], mi = sm.m[st][threadIdx.x];
            float4 vi = sm.v[st][threadIdx.x];
            const float4 gi = sm.g[st][threadIdx.x];
            adam_one(pi.x, mi.x, vi.x, gi.x, lr_t, k);
            adam_one(pi.y, mi.y, vi.y, gi.y, lr_t, k);
            adam_one(pi.z, mi.z, vi.z, gi.z, lr_t, k);
            adam_one(pi.w, mi.w, vi.w, gi.w, lr_t, k);
            p4[e] = pi;
            m4[e] = mi;
            v4[e] = vi;
        }
        __syncwarp();
        if (threadIdx.x % 32 == 0) mbar_arrive(&sm.empty[st]);
    }
    // The n % 4 elements past the last float4, block 0's.
    const int64_t i = units * 4 + threadIdx.x;
    if (blockIdx.x == 0 && i < n) {
        float pi = p[i], mi = m[i], vi = v[i];
        adam_one(pi, mi, vi, __ldcs(g + i), lr_t, k);
        p[i] = pi;
        m[i] = mi;
        v[i] = vi;
    }
}

// The kernel of a path, its threads a block and its dynamic shared memory.
struct Instance {
    const void* fn;
    int threads;
    size_t smem;
};

Instance instance(int vec4) {
    if (vec4) return {(const void*)adam_flat_ring_kernel, kRingThreads, sizeof(RingSmem)};
    return {(const void*)adam_flat_scalar_kernel, kThreads, 0};
}

cudaError_t prepare(const Instance& in) {
    if (in.smem == 0) return cudaSuccess;
    return cudaFuncSetAttribute(in.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)in.smem);
}

}  // namespace

extern "C" {

// The units (float4s or floats) of a tile: one a consumer thread. The
// wrapper plans its grid in tiles.
int ddl_adam_threads() { return kThreads; }

// How many blocks of the float4 (`vec4`) or the scalar kernel one SM holds
// at once, as the CUDA runtime computes it for the compiled kernel
// (registers, shared memory, threads). Writes it to *out; returns a
// cudaError_t as an int.
int ddl_adam_blocks_per_sm(int vec4, int device, int* out) {
    const Instance in = instance(vec4);
    cudaError_t err = cudaSetDevice(device);
    if (err == cudaSuccess) err = prepare(in);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, in.fn, in.threads, in.smem);
}

// Launch one Adam step over n elements on `stream` of CUDA device `device`
// as `blocks` blocks (the wrapper's launch plan). `vec4` (the TMA ring) may
// be set only when all four data pointers are 16-byte aligned. Returns the
// launch's cudaError_t as an int (0 = success).
int ddl_adam_flat_f32(float* p, float* m, float* v, const float* g,
                      const float* lr_t, int64_t n, float b1, float c1, float b2,
                      float c2, float eps, int vec4, int blocks, int device, void* stream) {
    if (n <= 0) return 0;
    if (blocks < 1) return (int)cudaErrorInvalidValue;
    const Instance in = instance(vec4);
    // This library links its own CUDA runtime; point it at the caller's
    // device before launching on the caller's stream.
    cudaError_t err = cudaSetDevice(device);
    if (err == cudaSuccess) err = prepare(in);
    if (err != cudaSuccess) return (int)err;
    AdamCoeffs k{b1, c1, b2, c2, eps};
    void* args[] = {&p, &m, &v, (void*)&g, (void*)&lr_t, &n, &k};
    err = cudaLaunchKernel(in.fn, dim3((unsigned)blocks), dim3(in.threads), args, in.smem,
                           static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

const char* ddl_cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
