// K1: the U-phase megakernel of the partial-reference, purity and
// unsupervised solves, for Hopper.
//
// Replaces the Pallas kernel demethify_tpu/ops/pallas_kernels.py
// :: _u_phase_grams_kernel (called through u_phase_grams_packed and
// u_phase_grams). One outer iteration of the solve makes ONE pass over
// the CpG axis:
//
//   per site i (one thread each), with dres_s = d_is y_is - d_is (a1' rt_i)_s
//   (just d_is y_is when there is no known block, n_ct = 0):
//     n_steps FISTA steps on u_i in registers:
//       beta = min((a-1)/a', 0.9999 sqrt(l_prev/l_w))
//       u_t  = u + beta (u - u_prev)
//       g    = u_t, or the OLD u when `lagged` (the reference's unsupervised
//              quirk: the gradient is taken at the previous iterate)
//       u    = clip(u_t + grad(g) / l_w, 0, 1)
//     with grad(g) in one of the TPU kernel's two dataflows, chosen by the
//     caller with the same rule (gram form where n_u^2 <= 3 n_s):
//       gram form:   grad = C - M g,  C[u] = sum_s a2[u,s] dres_s,
//                    M[u][v] = sum_s (a2[u,s] a2[v,s]) d_is  (in registers)
//       direct form: model_s = sum_u a2[u,s] g_u,
//                    grad[u] = sum_s a2[u,s] (dres_s - d_is model_s)
//                    (dres kept in shared memory)
//     (this is the plain form of ops/fista.fista_u_gram; the TPU kernel's
//      1/l_w pre-scaled form rounds differently and is not used)
//   per block, with the NEW u:
//     gu[s,u,q] = sum_i u_iu d_is [Rt | u]_iq,  b_u[u,s] = sum_i u_iu d_is y_is,
//     usq = sum_i sum_u u_iu^2
//
// What bounds it on an H100: memory traffic at the partial-reference
// schedule. At 1M sites x 10 samples, 5 + 1 cell types in float32 it reads
// Y, D, Rt, u, u_prev (~108 MB) and writes u, u_prev (~8 MB) per outer
// iteration, ~35 us at 3.35 TB/s; the arithmetic is a few hundred flops
// per site. The purity schedule (500 steps) makes it bound by instruction
// issue: ~65 instructions per warp and step in the n_u = 1 gram form,
// most of them the scalar momentum chain (two IEEE divisions, two square
// roots) that every thread replays beside its ~10 flops.
//
// What the design does about it:
//   - the big arrays stay in the transposed (rows, N) layout, so the
//     threads of a warp read neighbouring addresses of every row once;
//   - C, M (its upper triangle: M is symmetric) and the FISTA state live
//     in registers (n_u is a template parameter, 1..8), so the n_steps loop
//     of the gram form touches no memory;
//   - the site columns a block read are staged in shared memory (row
//     stride T + 1 against bank conflicts) and reused for the Gram sums,
//     so Y, D and Rt are read from device memory exactly once;
//   - blocks run in no order, so the TPU kernel's in-order accumulation
//     across its grid becomes per-block partial sums (one column per
//     block of an (E, n_blocks) buffer) and a second kernel that sums each
//     row in a FIXED order. No float atomics: the trajectory is the same
//     from run to run, which |delta cost| < tol termination needs;
//   - the ragged tail is masked (zero columns contribute nothing);
//     nothing is padded.
// The staging, the per-site gram-form arithmetic, the Gram partial sums
// and the reduction pass live in u_phase_common.cuh, shared with K4.
//
// bf16 storage (the JAX kernel's bf16 blocks with a float32 state,
// pallas_kernels.py:255-265 with data_dt = state_dt): Y, D and Rt arrive
// as __nv_bfloat16 (TD) with a float32 state (T); each value is converted
// once as it is staged, and the staged rows stay float32 in shared memory
// (u_phase_common.cuh says why), so the bf16 form runs the float32 form's
// arithmetic on the converted values and needs the float32 form's shared
// memory. It halves the bytes of the data rows: at the shape above ~66 MB
// per outer iteration instead of ~116 MB, ~20 us at 3.35 TB/s.
// bf16_compute (BF16C, gram form only) additionally rounds to bf16 at the
// JAX kernel's bf16_compute points (u_phase_common.cuh) and stages the raw
// new u in NU more shared rows for sum u^2, since the Gram rows of s_r
// then hold bf16(u). The direct form with bf16_compute is not built: the
// wrapper raises for it.
//
// The Nesterov scalar and l_w_prev live in a small device vector `scal`
// (slot 0: a, 1: l_w, 2: l_w_prev) that every thread reads; the reduction
// kernel advances them after the main pass, so the host never syncs.
//
// Plain C interface (ctypes): pointers and the stream as void*, launches
// on that stream, allocates nothing, returns cudaGetLastError(). Pointers
// of an empty known block (n_ct = 0) are never dereferenced.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "u_phase_common.cuh"

namespace {

using dm::kLd;
using dm::kRedThreads;
using dm::kSites;
using dm::min_nan;
using dm::nesterov;
using dm::sqrt_t;

// The n_steps FISTA loop of the direct form: dres (the known-block
// residual) and d of this thread's site in shared memory, row stride kLd.
template <typename T, int NU, bool LAG>
__device__ __forceinline__ void direct_steps(
        T (&u)[NU], T (&up)[NU], const T* __restrict__ s_a2,
        const T* __restrict__ s_res, const T* __restrict__ s_d, int n_s,
        T a, T l_prev, const T l_w, int n_steps) {
    for (int step = 0; step < n_steps; ++step) {
        const T a1n = nesterov(a);
        const T beta = min_nan((a - T(1)) / a1n,
                               T(0.9999) * sqrt_t(l_prev / l_w));
        T ut[NU], gr[NU];
#pragma unroll
        for (int v = 0; v < NU; ++v) {
            ut[v] = u[v] + beta * (u[v] - up[v]);
            gr[v] = T(0);
        }
        for (int s = 0; s < n_s; ++s) {
            T model = T(0);
#pragma unroll
            for (int w = 0; w < NU; ++w)
                model += s_a2[w * n_s + s] * (LAG ? u[w] : ut[w]);
            const T res = s_res[s * kLd] - s_d[s * kLd] * model;
#pragma unroll
            for (int v = 0; v < NU; ++v) gr[v] += s_a2[v * n_s + s] * res;
        }
#pragma unroll
        for (int v = 0; v < NU; ++v) {
            up[v] = u[v];
            u[v] = dm::clip01(ut[v] + gr[v] / l_w);
        }
        a = a1n;
        l_prev = l_w;
    }
}

template <typename T, typename TD, int NU, bool DIRECT, bool BF16C>
__global__ void __launch_bounds__(kSites)
u_phase_grams_kernel(const TD* __restrict__ ydt, const TD* __restrict__ rtt,
                     const T* __restrict__ a1b, const T* __restrict__ a2b,
                     T* __restrict__ uut, const T* __restrict__ scal,
                     T* __restrict__ partials, int64_t n, int n_s, int n_ct,
                     int n_steps, int n_blocks, int lagged) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* s_y = reinterpret_cast<T*>(smem_raw);   // n_s rows
    T* s_d = s_y + n_s * kLd;                   // n_s rows
    T* s_r = s_d + n_s * kLd;                   // n_ct + NU rows: [Rt | u]
    T* s_a1 = s_r + (n_ct + NU) * kLd;          // (n_ct, n_s)
    T* s_a2 = s_a1 + n_ct * n_s;                // (NU, n_s)
    T* s_res = s_a2 + NU * n_s;                 // direct form: n_s rows
    T* s_xu = s_a2 + NU * n_s;                  // BF16C: NU rows, raw u

    const int tid = threadIdx.x;
    for (int k = tid; k < n_ct * n_s; k += kSites) s_a1[k] = a1b[k];
    for (int k = tid; k < NU * n_s; k += kSites) s_a2[k] = a2b[k];

    const int64_t i = static_cast<int64_t>(blockIdx.x) * kSites + tid;
    const bool live = i < n;
    dm::stage_sites(s_y, s_d, s_r, ydt, rtt, i, live, n, n_s, n_ct, tid);
    __syncthreads();

    T u[NU], up[NU];
#pragma unroll
    for (int v = 0; v < NU; ++v) {
        u[v] = live ? uut[v * n + i] : T(0);
        up[v] = live ? uut[(NU + v) * n + i] : T(0);
    }
    const T a = scal[dm::kAU];
    const T l_w = scal[dm::kLW];
    const T l_prev = scal[dm::kLWPrev];

    if constexpr (!DIRECT) {
        // ---- C and M for this site, then the whole U FISTA loop, in
        // registers
        T cc[NU], m[NU * (NU + 1) / 2];
        dm::build_cm<T, NU, BF16C>(cc, m, s_y, s_d, s_r, s_a1, s_a2, n_s,
                                   n_ct, tid);
        if (lagged)
            dm::gram_steps<T, NU, true>(u, up, cc, m, a, l_prev, l_w,
                                        n_steps);
        else
            dm::gram_steps<T, NU, false>(u, up, cc, m, a, l_prev, l_w,
                                         n_steps);
    } else {
        // ---- the known-block residual, kept in shared memory ----------
        for (int s = 0; s < n_s; ++s) {
            const T y = s_y[s * kLd + tid];
            const T d = s_d[s * kLd + tid];
            s_res[s * kLd + tid] = dm::known_resid(y, d, s_r, s_a1, s, n_s,
                                                   n_ct, tid);
        }

        // ---- the whole U FISTA loop, direct form ----------------------
        if (lagged)
            direct_steps<T, NU, true>(u, up, s_a2, s_res + tid, s_d + tid,
                                      n_s, a, l_prev, l_w, n_steps);
        else
            direct_steps<T, NU, false>(u, up, s_a2, s_res + tid, s_d + tid,
                                       n_s, a, l_prev, l_w, n_steps);
    }
#pragma unroll
    for (int v = 0; v < NU; ++v) {
        if (live) {
            uut[v * n + i] = u[v];
            uut[(NU + v) * n + i] = up[v];
        }
        if constexpr (BF16C) {
            s_r[(n_ct + v) * kLd + tid] = live ? dm::bf16r(u[v]) : T(0);
            s_xu[v * kLd + tid] = live ? u[v] : T(0);
        } else {
            s_r[(n_ct + v) * kLd + tid] = live ? u[v] : T(0);
        }
    }
    __syncthreads();

    // ---- this block's Gram partial sums with the new u ----------------
    dm::gram_partials<T, NU, false, BF16C>(s_y, s_d, s_r, n_s, n_ct, tid,
                                           partials + blockIdx.x, n_blocks,
                                           s_xu);
}

// shared memory of the main pass; itemsize is the state's (the staged
// data rows are of the state type whatever the data's)
size_t smem_bytes(size_t itemsize, int n_s, int n_ct, int n_u, bool direct,
                  bool bf16c) {
    const size_t p = static_cast<size_t>(n_ct + n_u);
    const size_t rows = 2 * static_cast<size_t>(n_s) + p
                        + (direct ? static_cast<size_t>(n_s) : 0)
                        + (bf16c ? static_cast<size_t>(n_u) : 0);
    return itemsize * (rows * kLd + p * n_s);
}

template <typename T, typename TD, int NU, bool DIRECT, bool BF16C>
int launch(const void* ydt, const void* rtt, const void* a1b, const void* a2b,
           void* uut, void* scal, void* partials, void* out, int64_t n,
           int n_s, int n_ct, int n_steps, int lagged, cudaStream_t stream) {
    const int n_blocks = static_cast<int>((n + kSites - 1) / kSites);
    const int n_entries = dm::gram_entries(n_s, n_ct, NU);
    const size_t smem = smem_bytes(sizeof(T), n_s, n_ct, NU, DIRECT, BF16C);
    auto kern = u_phase_grams_kernel<T, TD, NU, DIRECT, BF16C>;
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    kern<<<n_blocks, kSites, smem, stream>>>(
        static_cast<const TD*>(ydt), static_cast<const TD*>(rtt),
        static_cast<const T*>(a1b), static_cast<const T*>(a2b),
        static_cast<T*>(uut), static_cast<const T*>(scal),
        static_cast<T*>(partials), n, n_s, n_ct, n_steps, n_blocks, lagged);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    dm::reduce_partials_kernel<T, false>
        <<<n_entries, kRedThreads, 0, stream>>>(
            static_cast<const T*>(partials), static_cast<T*>(out),
            static_cast<T*>(scal), n_blocks, n_steps, n_entries, 0);
    return static_cast<int>(cudaGetLastError());
}

template <typename T, typename TD, bool DIRECT, bool BF16C>
int dispatch_nu(const void* ydt, const void* rtt, const void* a1b,
                const void* a2b, void* uut, void* scal, void* partials,
                void* out, int64_t n, int n_s, int n_ct, int n_u,
                int n_steps, int lagged, cudaStream_t st) {
#define DM_K1_CASE(NU)                                                      \
    case NU:                                                                \
        return launch<T, TD, NU, DIRECT, BF16C>(                            \
            ydt, rtt, a1b, a2b, uut, scal, partials, out, n, n_s, n_ct,     \
            n_steps, lagged, st);
    switch (n_u) {
        DM_K1_CASE(2) DM_K1_CASE(3) DM_K1_CASE(4) DM_K1_CASE(5)
        DM_K1_CASE(6) DM_K1_CASE(7) DM_K1_CASE(8)
        case 1:
            // n_u = 1 always takes the gram form (1 <= 3 n_s)
            if constexpr (!DIRECT)
                return launch<T, TD, 1, false, BF16C>(
                    ydt, rtt, a1b, a2b, uut, scal, partials, out, n, n_s,
                    n_ct, n_steps, lagged, st);
            return static_cast<int>(cudaErrorInvalidValue);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
#undef DM_K1_CASE
}

// TD = T (float32, float64) or __nv_bfloat16 with T = float; BF16C only
// in the gram form
template <typename T, typename TD>
int dispatch(const void* ydt, const void* rtt, const void* a1b,
             const void* a2b, void* uut, void* scal, void* partials,
             void* out, int64_t n, int n_s, int n_ct, int n_u, int n_steps,
             int lagged, int direct, int bf16c, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if constexpr (std::is_same<TD, __nv_bfloat16>::value) {
        if (bf16c) {
            if (direct) return static_cast<int>(cudaErrorInvalidValue);
            return dispatch_nu<T, TD, false, true>(
                ydt, rtt, a1b, a2b, uut, scal, partials, out, n, n_s, n_ct,
                n_u, n_steps, lagged, st);
        }
    }
    if (direct)
        return dispatch_nu<T, TD, true, false>(
            ydt, rtt, a1b, a2b, uut, scal, partials, out, n, n_s, n_ct, n_u,
            n_steps, lagged, st);
    return dispatch_nu<T, TD, false, false>(
        ydt, rtt, a1b, a2b, uut, scal, partials, out, n, n_s, n_ct, n_u,
        n_steps, lagged, st);
}

}  // namespace

extern "C" {

// Shared memory the main pass needs, in bytes (the wrapper checks it
// against the card's limit before launching).
// itemsize is the state's: the staged data rows are of the state type.
long long dm_u_phase_grams_smem(int itemsize, int n_s, int n_ct, int n_u,
                                int direct, int bf16c) {
    return static_cast<long long>(
        smem_bytes(itemsize, n_s, n_ct, n_u, direct != 0, bf16c != 0));
}

int dm_u_phase_grams_blocks(long long n) {
    return static_cast<int>((n + kSites - 1) / kSites);
}

int dm_u_phase_grams_f32(const void* ydt, const void* rtt, const void* a1b,
                         const void* a2b, void* uut, void* scal,
                         void* partials, void* out, long long n, int n_s,
                         int n_ct, int n_u, int n_steps, int lagged,
                         int direct, void* stream) {
    return dispatch<float, float>(ydt, rtt, a1b, a2b, uut, scal, partials,
                                  out, n, n_s, n_ct, n_u, n_steps, lagged,
                                  direct, 0, stream);
}

int dm_u_phase_grams_f64(const void* ydt, const void* rtt, const void* a1b,
                         const void* a2b, void* uut, void* scal,
                         void* partials, void* out, long long n, int n_s,
                         int n_ct, int n_u, int n_steps, int lagged,
                         int direct, void* stream) {
    return dispatch<double, double>(ydt, rtt, a1b, a2b, uut, scal, partials,
                                    out, n, n_s, n_ct, n_u, n_steps, lagged,
                                    direct, 0, stream);
}

// bf16 data (ydt, rtt) with a float32 state; bf16c: the bf16_compute form
// (gram form only: with direct it returns cudaErrorInvalidValue)
int dm_u_phase_grams_bf16(const void* ydt, const void* rtt, const void* a1b,
                          const void* a2b, void* uut, void* scal,
                          void* partials, void* out, long long n, int n_s,
                          int n_ct, int n_u, int n_steps, int lagged,
                          int direct, int bf16c, void* stream) {
    return dispatch<float, __nv_bfloat16>(ydt, rtt, a1b, a2b, uut, scal,
                                          partials, out, n, n_s, n_ct, n_u,
                                          n_steps, lagged, direct, bf16c,
                                          stream);
}

}  // extern "C"
