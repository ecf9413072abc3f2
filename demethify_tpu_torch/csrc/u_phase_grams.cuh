// K1: the U-phase megakernel of the partial-reference, purity and
// unsupervised solves, for Hopper. This header holds the kernel and its
// launch, templated on the shared-memory layout; u_phase_grams.cu builds
// the resident layout and u_phase_grams_wide.cu the wide one
// (u_phase_common.cuh), each with its own C entry points, so the two
// compile in parallel.
//
// Replaces the Pallas kernel demethify_tpu/ops/pallas_kernels.py
// :: _u_phase_grams_kernel (called through u_phase_grams_packed and
// u_phase_grams). One outer iteration of the solve makes ONE pass over
// the CpG axis:
//
//   per site i (one thread each), with dres_s = d_is y_is - d_is (a1' rt_i)_s
//   (just d_is y_is when there is no known block, n_ct = 0):
//     n_steps FISTA steps on u_i:
//       beta = min((a-1)/a', 0.9999 sqrt(l_prev/l_w))
//       u_t  = u + beta (u - u_prev)
//       g    = u_t, or the OLD u when `lagged` (the reference's unsupervised
//              quirk: the gradient is taken at the previous iterate)
//       u    = clip(u_t + grad(g) / l_w, 0, 1)
//     with grad(g) in one of the TPU kernel's two dataflows, chosen by the
//     caller with the same rule (gram form where n_u^2 <= 3 n_s):
//       gram form:   grad = C - M g,  C[u] = sum_s a2[u,s] dres_s,
//                    M[u][v] = sum_s (a2[u,s] a2[v,s]) d_is
//       direct form: model_s = sum_u a2[u,s] g_u,
//                    grad[u] = sum_s a2[u,s] (dres_s - d_is model_s)
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
// roots) that every thread replays beside its ~10 flops. At wide shapes
// (hundreds of samples, 25 known types) the Gram stage dominates: n_s n_u p
// entries per block, each a 128-term sum over shared rows.
//
// What the design does about it:
//   - the big arrays stay in the transposed (rows, N) layout, so the
//     threads of a warp read neighbouring addresses of every row once;
//   - C, M (its upper triangle: M is symmetric) and the FISTA state live
//     in registers (n_u is a template parameter, 1..8), so the n_steps loop
//     of the gram form touches no memory; above n_u = 8 one form keeps
//     them in a scratch column per site (u_phase_common.cuh);
//   - resident layout: the site columns a block reads are staged in
//     shared memory (row stride T + 1 against bank conflicts) and reused
//     for the Gram sums, so Y, D and Rt are read from device memory
//     exactly once; the wide layout (chosen by the wrapper where the
//     resident one does not fit or fits less than half its blocks per SM)
//     stages Y and D in chunks of samples and reads them twice, with the
//     same sums in the same orders;
//   - blocks run in no order, so the TPU kernel's in-order accumulation
//     across its grid becomes per-block partial sums (one column per
//     block of an (E, n_blocks) buffer) and a second kernel that sums each
//     row in a FIXED order. No float atomics: the trajectory is the same
//     from run to run, which |delta cost| < tol termination needs;
//   - the ragged tail is masked (zero columns contribute nothing);
//     nothing is padded.
//
// bf16 storage (the JAX kernel's bf16 blocks with a float32 state,
// pallas_kernels.py:255-265 with data_dt = state_dt): Y, D and Rt arrive
// as __nv_bfloat16 (TD) with a float32 state (T); each value is converted
// once as it is read, and from there on the float32 form's arithmetic
// runs on the converted values. It halves the bytes of the data rows: at
// the shape above ~66 MB per outer iteration instead of ~116 MB, ~20 us
// at 3.35 TB/s. bf16_compute rounds at the JAX kernel's bf16_compute
// points: the gram form all of them (RND = kRoundAll; it also stages the
// raw new u in n_u more shared rows for sum u^2, since the Gram rows of
// s_r then hold bf16(u)), the direct form d y alone (kRoundDy), as the
// JAX kernel's direct-form fallback (pallas_kernels.py:299-311).
//
// Rt folded into the data block (the JAX wrapper's rt_folded layout,
// pallas_kernels.py:650-674): the wrapper points rtt at row 2 n_s of
// [Y.T; D.T; Rt.T]; the kernel is the same.
//
// The Nesterov scalar and l_w_prev live in a small device vector `scal`
// (slot 0: a, 1: l_w, 2: l_w_prev) that every thread reads; the reduction
// kernel advances them after the main pass, so the host never syncs.
//
// Plain C interface (ctypes): pointers and the stream as void*, launches
// on that stream, allocates nothing, returns cudaGetLastError(). Pointers
// of an empty known block (n_ct = 0) are never dereferenced; `scratch` is
// read only by the n_u > 8 form.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "u_phase_common.cuh"

namespace {

using dm::ColVec;
using dm::kChunk;
using dm::kLd;
using dm::kRedThreads;
using dm::kSites;
using dm::min_nan;
using dm::nesterov;
using dm::RegVec;
using dm::sqrt_t;

// The n_steps FISTA loop of the direct form. Resident layout: dres (the
// known-block residual) and d of this thread's site in shared rows
// (res, d; stride kLd). Wide: y and d read from the data rows (stride
// ld) and dres rebuilt each step (the same arithmetic as the resident
// layout's one build). ut, gr are step temporaries.
template <typename T, int NU, bool LAG, bool WIDE, int RND, typename TY,
          class VU, class VT>
__device__ __forceinline__ void direct_steps(
        VU& u, VU& up, VT& ut, VT& gr, int n_u, const T* __restrict__ a1,
        const T* __restrict__ a2, const T* __restrict__ res,
        const TY* __restrict__ y, const TY* __restrict__ d, int64_t ld,
        const T* __restrict__ rt, int n_s, int n_ct, T a, T l_prev,
        const T l_w, int n_steps) {
    const int nu = NU > 0 ? NU : n_u;
    for (int step = 0; step < n_steps; ++step) {
        const T a1n = nesterov(a);
        const T beta = min_nan((a - T(1)) / a1n,
                               T(0.9999) * sqrt_t(l_prev / l_w));
#pragma unroll
        for (int v = 0; v < nu; ++v) {
            ut[v] = u[v] + beta * (u[v] - up[v]);
            gr[v] = T(0);
        }
        for (int s = 0; s < n_s; ++s) {
            T model = T(0);
#pragma unroll
            for (int w = 0; w < nu; ++w)
                model += a2[w * n_s + s] * (LAG ? u[w] : ut[w]);
            T r;
            if constexpr (WIDE) {
                const T dv = dm::to_state(d[s * ld]);
                r = dm::known_resid<RND>(dm::to_state(y[s * ld]), dv, rt, a1,
                                         s, n_s, n_ct)
                    - dv * model;
            } else {
                r = res[s * kLd] - d[s * ld] * model;
            }
#pragma unroll
            for (int v = 0; v < nu; ++v) gr[v] += a2[v * n_s + s] * r;
        }
#pragma unroll
        for (int v = 0; v < nu; ++v) {
            up[v] = u[v];
            u[v] = dm::clip01(ut[v] + gr[v] / l_w);
        }
        a = a1n;
        l_prev = l_w;
    }
}

// One site's whole U phase on its state vectors u, up (registers, or
// columns of the state rows) with the temporaries cc, m, t1, t2: the
// C/M build and the gram steps, or the direct steps (t1, t2: ut, gr).
template <typename T, int NU, bool DIRECT, int RND, bool WIDE, typename TY,
          class VU, class VC, class VM>
__device__ __forceinline__ void site_phase(
        VU& u, VU& up, VC& cc, VM& m, VC& t1, VC& t2, int n_u,
        const TY* __restrict__ y, const TY* __restrict__ d, int64_t ld,
        const T* __restrict__ rt, const T* __restrict__ a1,
        const T* __restrict__ a2, T* __restrict__ res, int n_s, int n_ct,
        T a, T l_prev, T l_w, int n_steps, bool lagged) {
    if constexpr (!DIRECT) {
        dm::build_cm<T, NU, RND>(cc, m, t1, n_u, y, d, ld, rt, a1, a2, n_s,
                                 n_ct);
        if (lagged)
            dm::gram_steps<T, NU, true>(u, up, cc, m, t1, t2, n_u, a,
                                        l_prev, l_w, n_steps);
        else
            dm::gram_steps<T, NU, false>(u, up, cc, m, t1, t2, n_u, a,
                                         l_prev, l_w, n_steps);
    } else {
        if constexpr (!WIDE) {
            // the known-block residual, kept in shared memory
            for (int s = 0; s < n_s; ++s)
                res[s * kLd] = dm::known_resid<RND>(y[s * ld], d[s * ld], rt,
                                                    a1, s, n_s, n_ct);
        }
        if (lagged)
            direct_steps<T, NU, true, WIDE, RND>(u, up, t1, t2, n_u, a1, a2,
                                                 res, y, d, ld, rt, n_s,
                                                 n_ct, a, l_prev, l_w,
                                                 n_steps);
        else
            direct_steps<T, NU, false, WIDE, RND>(u, up, t1, t2, n_u, a1, a2,
                                                  res, y, d, ld, rt, n_s,
                                                  n_ct, a, l_prev, l_w,
                                                  n_steps);
    }
}

template <typename T, typename TD, int NU, bool DIRECT, int RND, bool WIDE>
__global__ void __launch_bounds__(kSites)
u_phase_grams_kernel(const TD* __restrict__ ydt, const TD* __restrict__ rtt,
                     const T* __restrict__ a1b, const T* __restrict__ a2b,
                     T* __restrict__ uut, const T* __restrict__ scal,
                     T* __restrict__ partials, T* __restrict__ scratch,
                     int64_t n, int n_s, int n_ct, int n_u, int n_steps,
                     int n_blocks, int lagged) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int nu = NU > 0 ? NU : n_u;
    const int p = n_ct + nu;
    // staged Y (and D) rows
    const int rows = WIDE ? dm::chunk_rows(n_s) : n_s;
    T* s_y = reinterpret_cast<T*>(smem_raw);
    T* s_d = s_y + rows * kLd;
    T* s_r = s_d + rows * kLd;                  // p rows: [Rt | u]
    T* s_a1 = s_r + p * kLd;                    // resident: (n_ct, n_s)
    T* s_a2 = s_a1 + n_ct * n_s;                // resident: (nu, n_s)
    // resident direct form: n_s rows of dres; kRoundAll: nu rows, raw u
    T* s_x = WIDE ? s_a1 : s_a2 + nu * n_s;

    const int tid = threadIdx.x;
    const int64_t i = static_cast<int64_t>(blockIdx.x) * kSites + tid;
    const bool live = i < n;
    const T* a1 = a1b;
    const T* a2 = a2b;
    if constexpr (!WIDE) {
        for (int k = tid; k < n_ct * n_s; k += kSites) s_a1[k] = a1b[k];
        for (int k = tid; k < nu * n_s; k += kSites) s_a2[k] = a2b[k];
        a1 = s_a1;
        a2 = s_a2;
        dm::stage_rows(s_y, ydt, 0, n_s, i, live, n, tid);
        dm::stage_rows(s_d, ydt + static_cast<int64_t>(n_s) * n, 0, n_s, i,
                       live, n, tid);
    }
    dm::stage_rows(s_r, rtt, 0, n_ct, i, live, n, tid);
    __syncthreads();

    const T a = scal[dm::kAU];
    const T l_w = scal[dm::kLW];
    const T l_prev = scal[dm::kLWPrev];
    T* u_rows = s_r + n_ct * kLd + tid;
    if (live) {
        auto run = [&](auto& u, auto& up, auto& cc, auto& m, auto& t1,
                       auto& t2) {
            if constexpr (WIDE)
                site_phase<T, NU, DIRECT, RND, WIDE>(
                    u, up, cc, m, t1, t2, n_u, ydt + i,
                    ydt + static_cast<int64_t>(n_s) * n + i, n, s_r + tid,
                    a1, a2, s_x + tid, n_s, n_ct, a, l_prev, l_w, n_steps,
                    lagged);
            else
                site_phase<T, NU, DIRECT, RND, WIDE>(
                    u, up, cc, m, t1, t2, n_u, s_y + tid, s_d + tid,
                    int64_t(kLd), s_r + tid, a1, a2, s_x + tid, n_s, n_ct, a,
                    l_prev, l_w, n_steps, lagged);
#pragma unroll
            for (int v = 0; v < nu; ++v) {
                if constexpr (RND == dm::kRoundAll) {
                    u_rows[v * kLd] = dm::bf16r(u[v]);
                    s_x[v * kLd + tid] = u[v];
                } else {
                    u_rows[v * kLd] = u[v];
                }
            }
        };
        if constexpr (NU > 0) {
            RegVec<T, NU> u, up, cc, t1, t2;
            RegVec<T, NU * (NU + 1) / 2> m;
#pragma unroll
            for (int v = 0; v < NU; ++v) {
                u[v] = uut[v * n + i];
                up[v] = uut[(NU + v) * n + i];
            }
            run(u, up, cc, m, t1, t2);
#pragma unroll
            for (int v = 0; v < NU; ++v) {
                uut[v * n + i] = u[v];
                uut[(NU + v) * n + i] = up[v];
            }
        } else {
            // u, u_prev updated in place in the state rows; C, M and the
            // temporaries in this site's scratch column
            const int nm = nu * (nu + 1) / 2;
            ColVec<T> u{uut + i, n}, up{uut + static_cast<int64_t>(nu) * n + i,
                                        n};
            ColVec<T> cc{scratch + i, n};
            ColVec<T> m{scratch + static_cast<int64_t>(DIRECT ? 0 : nu) * n
                            + i, n};
            ColVec<T> t1{scratch
                             + static_cast<int64_t>(DIRECT ? 0 : nu + nm) * n
                             + i, n};
            ColVec<T> t2{t1.p + static_cast<int64_t>(nu) * n, n};
            run(u, up, cc, m, t1, t2);
        }
    } else {
#pragma unroll
        for (int v = 0; v < nu; ++v) {
            u_rows[v * kLd] = T(0);
            if constexpr (RND == dm::kRoundAll) s_x[v * kLd + tid] = T(0);
        }
    }
    __syncthreads();

    // ---- this block's Gram partial sums with the new u ----------------
    if constexpr (WIDE)
        dm::gram_partials_chunked<T, TD, NU, false, RND>(
            s_y, s_d, s_r, ydt, i, live, n, n_s, n_ct, nu, tid,
            partials + blockIdx.x, n_blocks, s_x);
    else
        dm::gram_partials<T, NU, false, RND>(
            s_y, s_d, s_r, n_s, 0, n_s, true, n_ct, nu, tid,
            partials + blockIdx.x, n_blocks, s_x);
}

// shared memory of the main pass; itemsize is the state's (the staged
// data rows are of the state type whatever the data's)
size_t smem_bytes(bool wide, size_t itemsize, int n_s, int n_ct, int n_u,
                  bool direct, int rnd) {
    const size_t p = static_cast<size_t>(n_ct + n_u);
    const size_t x_rows = rnd == dm::kRoundAll ? n_u : 0;
    if (wide)
        return itemsize
               * ((2 * dm::chunk_rows(n_s) + p + x_rows) * kLd);
    const size_t rows = 2 * static_cast<size_t>(n_s) + p
                        + (direct ? static_cast<size_t>(n_s) : 0) + x_rows;
    return itemsize * (rows * kLd + p * n_s);
}

template <typename T, typename TD, int NU, bool DIRECT, int RND, bool WIDE>
int launch(const void* ydt, const void* rtt, const void* a1b, const void* a2b,
           void* uut, void* scal, void* partials, void* out, void* scratch,
           int64_t n, int n_s, int n_ct, int n_u, int n_steps, int lagged,
           cudaStream_t stream) {
    const int n_blocks = static_cast<int>((n + kSites - 1) / kSites);
    const int n_entries = dm::gram_entries(n_s, n_ct, n_u);
    const size_t smem = smem_bytes(WIDE, sizeof(T), n_s, n_ct, n_u, DIRECT,
                                   RND);
    auto kern = u_phase_grams_kernel<T, TD, NU, DIRECT, RND, WIDE>;
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
        static_cast<T*>(partials), static_cast<T*>(scratch), n, n_s, n_ct,
        n_u, n_steps, n_blocks, lagged);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    dm::reduce_partials_kernel<T, false>
        <<<n_entries, kRedThreads, 0, stream>>>(
            static_cast<const T*>(partials), static_cast<T*>(out),
            static_cast<T*>(scal), n_blocks, n_steps, n_entries, 0);
    return static_cast<int>(cudaGetLastError());
}

template <typename T, typename TD, bool DIRECT, int RND, bool WIDE>
int dispatch_nu(const void* ydt, const void* rtt, const void* a1b,
                const void* a2b, void* uut, void* scal, void* partials,
                void* out, void* scratch, int64_t n, int n_s, int n_ct,
                int n_u, int n_steps, int lagged, cudaStream_t st) {
#define DM_K1_CASE(NU)                                                      \
    case NU:                                                                \
        return launch<T, TD, NU, DIRECT, RND, WIDE>(                        \
            ydt, rtt, a1b, a2b, uut, scal, partials, out, scratch, n, n_s,  \
            n_ct, n_u, n_steps, lagged, st);
    switch (n_u) {
        DM_K1_CASE(2) DM_K1_CASE(3) DM_K1_CASE(4) DM_K1_CASE(5)
        DM_K1_CASE(6) DM_K1_CASE(7) DM_K1_CASE(8)
        case 1:
            // n_u = 1 always takes the gram form (1 <= 3 n_s)
            if constexpr (!DIRECT)
                return launch<T, TD, 1, false, RND, WIDE>(
                    ydt, rtt, a1b, a2b, uut, scal, partials, out, scratch, n,
                    n_s, n_ct, n_u, n_steps, lagged, st);
            return static_cast<int>(cudaErrorInvalidValue);
        default:
            if (n_u < 1 || scratch == nullptr)
                return static_cast<int>(cudaErrorInvalidValue);
            return launch<T, TD, 0, DIRECT, RND, WIDE>(
                ydt, rtt, a1b, a2b, uut, scal, partials, out, scratch, n,
                n_s, n_ct, n_u, n_steps, lagged, st);
    }
#undef DM_K1_CASE
}

// TD = T (float32, float64) or __nv_bfloat16 with T = float; bf16c (bf16
// data only): kRoundAll in the gram form, kRoundDy in the direct form
template <typename T, typename TD, bool WIDE>
int dispatch(const void* ydt, const void* rtt, const void* a1b,
             const void* a2b, void* uut, void* scal, void* partials,
             void* out, void* scratch, int64_t n, int n_s, int n_ct, int n_u,
             int n_steps, int lagged, int direct, int bf16c, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if constexpr (std::is_same<TD, __nv_bfloat16>::value) {
        if (bf16c) {
            if (direct)
                return dispatch_nu<T, TD, true, dm::kRoundDy, WIDE>(
                    ydt, rtt, a1b, a2b, uut, scal, partials, out, scratch, n,
                    n_s, n_ct, n_u, n_steps, lagged, st);
            return dispatch_nu<T, TD, false, dm::kRoundAll, WIDE>(
                ydt, rtt, a1b, a2b, uut, scal, partials, out, scratch, n,
                n_s, n_ct, n_u, n_steps, lagged, st);
        }
    }
    if (direct)
        return dispatch_nu<T, TD, true, dm::kRoundNone, WIDE>(
            ydt, rtt, a1b, a2b, uut, scal, partials, out, scratch, n, n_s,
            n_ct, n_u, n_steps, lagged, st);
    return dispatch_nu<T, TD, false, dm::kRoundNone, WIDE>(
        ydt, rtt, a1b, a2b, uut, scal, partials, out, scratch, n, n_s, n_ct,
        n_u, n_steps, lagged, st);
}

}  // namespace

// The C entry points of one layout (PREFIX dm_u_phase_grams or
// dm_u_phase_grams_wide):
//   PREFIX_smem(itemsize, n_s, n_ct, n_u, direct, bf16c): the main pass's
//     shared memory in bytes (itemsize is the state's), which the wrapper
//     checks against the card's limit before launching;
//   PREFIX_{f32,f64}(ydt, rtt, a1b, a2b, uut, scal, partials, out,
//     scratch, n, n_s, n_ct, n_u, n_steps, lagged, direct, stream);
//   PREFIX_bf16(..., direct, bf16c, stream): bf16 data with a float32
//     state; bf16c the bf16_compute form.
#define DM_K1_EXPORTS(PREFIX, WIDE)                                          \
    extern "C" {                                                             \
    long long PREFIX##_smem(int itemsize, int n_s, int n_ct, int n_u,        \
                            int direct, int bf16c) {                         \
        const int rnd = !bf16c ? dm::kRoundNone                              \
                               : (direct ? dm::kRoundDy : dm::kRoundAll);    \
        return static_cast<long long>(smem_bytes(WIDE, itemsize, n_s, n_ct,  \
                                                 n_u, direct != 0, rnd));    \
    }                                                                        \
    int PREFIX##_f32(const void* ydt, const void* rtt, const void* a1b,      \
                     const void* a2b, void* uut, void* scal, void* partials, \
                     void* out, void* scratch, long long n, int n_s,         \
                     int n_ct, int n_u, int n_steps, int lagged, int direct, \
                     void* stream) {                                         \
        return dispatch<float, float, WIDE>(ydt, rtt, a1b, a2b, uut, scal,   \
                                            partials, out, scratch, n, n_s,  \
                                            n_ct, n_u, n_steps, lagged,      \
                                            direct, 0, stream);              \
    }                                                                        \
    int PREFIX##_f64(const void* ydt, const void* rtt, const void* a1b,      \
                     const void* a2b, void* uut, void* scal, void* partials, \
                     void* out, void* scratch, long long n, int n_s,         \
                     int n_ct, int n_u, int n_steps, int lagged, int direct, \
                     void* stream) {                                         \
        return dispatch<double, double, WIDE>(ydt, rtt, a1b, a2b, uut, scal, \
                                              partials, out, scratch, n,     \
                                              n_s, n_ct, n_u, n_steps,       \
                                              lagged, direct, 0, stream);    \
    }                                                                        \
    int PREFIX##_bf16(const void* ydt, const void* rtt, const void* a1b,     \
                      const void* a2b, void* uut, void* scal,                \
                      void* partials, void* out, void* scratch, long long n, \
                      int n_s, int n_ct, int n_u, int n_steps, int lagged,   \
                      int direct, int bf16c, void* stream) {                 \
        return dispatch<float, __nv_bfloat16, WIDE>(                         \
            ydt, rtt, a1b, a2b, uut, scal, partials, out, scratch, n, n_s,   \
            n_ct, n_u, n_steps, lagged, direct, bf16c, stream);              \
    }                                                                        \
    }
