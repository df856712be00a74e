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
// no atomics, so the gradients are deterministic.
//
// Layout: q, k, v, o, dO and the gradients are read and written in the
// model's [B, T, H, D] layout through the strides the caller passes (batch,
// row and head stride; the D elements of a row are contiguous), so there is
// no transpose copy. The TPU wrapper transposes to [B, H, T, D] and back.
//
// What bounds it on Hopper: operations. Each score costs 2*D flops per
// product; at the LM's shape [4, 2048, 8, 64] the forward does 17.2 GFLOP
// on the causal half against 67 MB of inputs and outputs, far above the
// card's operations-per-byte balance. This first version runs every
// product on the CUDA cores in plain fp32 FMAs (no TF32, so the results
// match the fp32 reference to rounding): its bound is the fp32 CUDA-core
// peak (67 TFLOP/s on an H100 SXM), not the tensor cores. Tensor cores
// (mma.sync / wgmma), TMA loads and a pipelined producer warp are later
// work.
//
// Design. A block of 128 threads owns one 64-row tile of the outer index
// (query rows for the forward and dQ, key rows for dK/dV) of one
// (batch, head) and loops over tiles of the inner index, stopping at the
// diagonal when causal. Tiles are staged in shared memory as fp32 (bf16
// inputs are widened on load), every operand stored
// reduction-index-major with 4 floats of row padding, so a product step
// reads each thread's operands with 16-byte vector loads. The threads form
// a 16 x 8 grid: a thread owns 4 consecutive rows and a run of consecutive
// columns of each tile product; the 8 threads that share a row are lanes of
// one warp, so the forward's online softmax (running max, running sum,
// fp32 accumulator) reduces rows with warp shuffles. Rows past T (ragged
// T) load as zero and are masked, as are keys after the query when causal.
//
// Each launcher launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() of its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

// lse and delta of rows [row0, row0 + ROWS) into shared memory; zero past T.
template <int ROWS>
__device__ __forceinline__ void load_rows(float* lse_s, float* dl_s, const float* lse,
                                          const float* delta, int row0, int T) {
    for (int r = threadIdx.x; r < ROWS; r += kThreads) {
        const bool in = row0 + r < T;
        lse_s[r] = in ? lse[row0 + r] : 0.f;
        dl_s[r] = in ? delta[row0 + r] : 0.f;
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

// ------------------------------------------------------------------ dK, dV

template <int D>
struct BwdKVTile {
    static constexpr int BK = kOuter, BQ = 32;
    static constexpr int LK = BK + kPad, LQ = BQ + kPad, LR = D + kPad;
    // Kt, Vt [D][LK]; Qt, dOt [D][LQ]; Q, dO [BQ][LR]; Pt, dSt [BQ][LK]; lse, delta [BQ]
    static constexpr int kFloats = 2 * D * LK + 2 * D * LQ + 2 * BQ * LR + 2 * BQ * LK + 2 * BQ;
};

template <typename E, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const E* __restrict__ q, const E* __restrict__ k,
                         const E* __restrict__ v, const E* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         E* __restrict__ dk, E* __restrict__ dv, int T, int H, int64_t sB,
                         int64_t sT, int64_t sH, float scale, int causal) {
    using S = BwdKVTile<D>;
    constexpr int TM = S::BK / kRowGroups, TN = S::BQ / kColGroups, TD = D / kColGroups;
    extern __shared__ float4 smem4[];
    float* Kt = reinterpret_cast<float*>(smem4);
    float* Vt = Kt + D * S::LK;
    float* Qt = Vt + D * S::LK;
    float* dOt = Qt + D * S::LQ;
    float* Qs = dOt + D * S::LQ;
    float* dOs = Qs + S::BQ * S::LR;
    float* Pt = dOs + S::BQ * S::LR;
    float* dSt = Pt + S::BQ * S::LK;
    float* lse_s = dSt + S::BQ * S::LK;
    float* dl_s = lse_s + S::BQ;

    const int ty = threadIdx.x / kColGroups, tx = threadIdx.x % kColGroups;
    const int n0 = blockIdx.x * S::BK, h = blockIdx.y, b = blockIdx.z;
    const int64_t base = (int64_t)b * sB + (int64_t)h * sH;
    const int64_t rows = ((int64_t)b * H + h) * T;
    load_tile<S::BK, D>(nullptr, Kt, k + base, sT, n0, T);
    load_tile<S::BK, D>(nullptr, Vt, v + base, sT, n0, T);

    float dk_acc[TM][TD] = {}, dv_acc[TM][TD] = {};
    // Causal: query tiles wholly before this key tile see none of it.
    for (int q0 = causal ? n0 : 0; q0 < T; q0 += S::BQ) {
        __syncthreads();  // the last tile's readers are done
        load_tile<S::BQ, D>(Qs, Qt, q + base, sT, q0, T);
        load_tile<S::BQ, D>(dOs, dOt, dout + base, sT, q0, T);
        load_rows<S::BQ>(lse_s, dl_s, lse + rows, delta + rows, q0, T);
        __syncthreads();
        // Transposed tiles: s[i][j] = S[q0 + tx*TN + j][n0 + ty*TM + i].
        float s[TM][TN] = {}, dp[TM][TN] = {};
        rr_product<TM, TN, D>(s, Kt + ty * TM, S::LK, Qt + tx * TN, S::LQ);
        rr_product<TM, TN, D>(dp, Vt + ty * TM, S::LK, dOt + tx * TN, S::LQ);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
#pragma unroll
            for (int j = 0; j < TN; ++j) {
                const int c = tx * TN + j;
                const float p = visible(q0 + c, n0 + ty * TM + i, T, causal)
                                    ? expf(s[i][j] * scale - lse_s[c])
                                    : 0.f;
                Pt[c * S::LK + ty * TM + i] = p;
                dSt[c * S::LK + ty * TM + i] = p * (dp[i][j] - dl_s[c]);
            }
        }
        __syncthreads();
        rr_product<TM, TD, S::BQ>(dv_acc, Pt + ty * TM, S::LK, dOs + tx * TD, S::LR);
        rr_product<TM, TD, S::BQ>(dk_acc, dSt + ty * TM, S::LK, Qs + tx * TD, S::LR);
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const int kj = n0 + ty * TM + i;
        if (kj < T) {
            const int64_t off = base + (int64_t)kj * sT + tx * TD;
#pragma unroll
            for (int e = 0; e < TD; ++e) {
                dk[off + e] = from_f32<E>(dk_acc[i][e] * scale);
                dv[off + e] = from_f32<E>(dv_acc[i][e]);
            }
        }
    }
}

// ---------------------------------------------------------------------- dQ

template <int D>
struct BwdQTile {
    static constexpr int BQ = kOuter, BK = 32;
    static constexpr int LQ = BQ + kPad, LK = BK + kPad, LR = D + kPad;
    // Qt, dOt [D][LQ]; Kt, Vt [D][LK]; K [BK][LR]; dSt [BK][LQ]; lse, delta [BQ]
    static constexpr int kFloats = 2 * D * LQ + 2 * D * LK + BK * LR + BK * LQ + 2 * BQ;
};

template <typename E, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const E* __restrict__ q, const E* __restrict__ k,
                        const E* __restrict__ v, const E* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        E* __restrict__ dq, int T, int H, int64_t sB, int64_t sT, int64_t sH,
                        float scale, int causal) {
    using S = BwdQTile<D>;
    constexpr int TM = S::BQ / kRowGroups, TN = S::BK / kColGroups, TD = D / kColGroups;
    extern __shared__ float4 smem4[];
    float* Qt = reinterpret_cast<float*>(smem4);
    float* dOt = Qt + D * S::LQ;
    float* Kt = dOt + D * S::LQ;
    float* Vt = Kt + D * S::LK;
    float* Ks = Vt + D * S::LK;
    float* dSt = Ks + S::BK * S::LR;
    float* lse_s = dSt + S::BK * S::LQ;
    float* dl_s = lse_s + S::BQ;

    const int ty = threadIdx.x / kColGroups, tx = threadIdx.x % kColGroups;
    const int m0 = blockIdx.x * S::BQ, h = blockIdx.y, b = blockIdx.z;
    const int64_t base = (int64_t)b * sB + (int64_t)h * sH;
    const int64_t rows = ((int64_t)b * H + h) * T;
    load_tile<S::BQ, D>(nullptr, Qt, q + base, sT, m0, T);
    load_tile<S::BQ, D>(nullptr, dOt, dout + base, sT, m0, T);
    load_rows<S::BQ>(lse_s, dl_s, lse + rows, delta + rows, m0, T);

    float acc[TM][TD] = {};
    const int k_end = causal ? min(T, m0 + S::BQ) : T;
    for (int k0 = 0; k0 < k_end; k0 += S::BK) {
        __syncthreads();  // the last tile's readers are done (and the rows above are stored)
        load_tile<S::BK, D>(Ks, Kt, k + base, sT, k0, T);
        load_tile<S::BK, D>(nullptr, Vt, v + base, sT, k0, T);
        __syncthreads();
        float s[TM][TN] = {}, dp[TM][TN] = {};
        rr_product<TM, TN, D>(s, Qt + ty * TM, S::LQ, Kt + tx * TN, S::LK);
        rr_product<TM, TN, D>(dp, dOt + ty * TM, S::LQ, Vt + tx * TN, S::LK);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
            const int r = ty * TM + i;
#pragma unroll
            for (int j = 0; j < TN; ++j) {
                const int c = tx * TN + j;
                const float p = visible(m0 + r, k0 + c, T, causal)
                                    ? expf(s[i][j] * scale - lse_s[r])
                                    : 0.f;
                dSt[c * S::LQ + r] = p * (dp[i][j] - dl_s[r]);
            }
        }
        __syncthreads();
        rr_product<TM, TD, S::BK>(acc, dSt + ty * TM, S::LQ, Ks + tx * TD, S::LR);
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const int qi = m0 + ty * TM + i;
        if (qi < T) {
            E* row = dq + base + (int64_t)qi * sT + tx * TD;
#pragma unroll
            for (int e = 0; e < TD; ++e) row[e] = from_f32<E>(acc[i][e] * scale);
        }
    }
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
cudaError_t allow_smem(Kernel kernel, int floats) {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                floats * (int)sizeof(float));
}

template <typename E, int D>
cudaError_t launch(Which which, const Args& a) {
    const dim3 grid((a.T + kOuter - 1) / kOuter, a.H, a.B);
    const E* q = static_cast<const E*>(a.q);
    const E* k = static_cast<const E*>(a.k);
    const E* v = static_cast<const E*>(a.v);
    const E* dout = static_cast<const E*>(a.dout);
    cudaError_t err = cudaSuccess;
    if (which == kFwd) {
        const int floats = FwdTile<D>::kFloats;
        err = allow_smem(flash_fwd_kernel<E, D>, floats);
        if (err != cudaSuccess) return err;
        flash_fwd_kernel<E, D><<<grid, kThreads, floats * sizeof(float), a.stream>>>(
            q, k, v, static_cast<E*>(a.o), a.lse, a.T, a.H, a.sB, a.sT, a.sH, a.scale,
            a.causal);
    } else if (which == kBwdKV) {
        const int floats = BwdKVTile<D>::kFloats;
        err = allow_smem(flash_bwd_dkv_kernel<E, D>, floats);
        if (err != cudaSuccess) return err;
        flash_bwd_dkv_kernel<E, D><<<grid, kThreads, floats * sizeof(float), a.stream>>>(
            q, k, v, dout, a.lse, a.delta, static_cast<E*>(a.dk), static_cast<E*>(a.dv), a.T,
            a.H, a.sB, a.sT, a.sH, a.scale, a.causal);
    } else {
        const int floats = BwdQTile<D>::kFloats;
        err = allow_smem(flash_bwd_dq_kernel<E, D>, floats);
        if (err != cudaSuccess) return err;
        flash_bwd_dq_kernel<E, D><<<grid, kThreads, floats * sizeof(float), a.stream>>>(
            q, k, v, dout, a.lse, a.delta, static_cast<E*>(a.dq), a.T, a.H, a.sB, a.sT, a.sH,
            a.scale, a.causal);
    }
    return cudaGetLastError();
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

const char* ddl_cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
