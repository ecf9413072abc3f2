// K1: the U-phase megakernel of the partial-reference, purity and
// unsupervised solves, for Hopper. This header holds the kernel and its
// launch, templated on the shared-memory layout; u_phase_grams.cu builds
// the resident layout, u_phase_grams_wide.cu the wide one and
// u_phase_grams_global{,_f64,_bf16}.cu the global one, a source a data
// type (u_phase_common.cuh), each with its own C entry points, so they
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
// What bounds it on an H100 (measured on an NVIDIA H100 80GB HBM3 at
// 700 W; chip_smoke.time_steps and profile_kernels, PERF.md):
//   - at the partial-reference schedule, its fixed cost: at 1M sites x
//     10 samples, 5 + 1 cell types in float32 it must move ~116 MB per
//     outer iteration (Y, D, Rt, u, u_prev read; u, u_prev written),
//     ~35 us at 3.35 TB/s, but a launch with no step takes ~0.11 ms:
//     each block stages its columns, then computes, and the blocks of an
//     SM do not overlap the two well; the 20 steps add ~0.02 ms;
//   - at the purity schedule (500 steps), the step loop: ~0.88 us a step
//     at that shape, instruction issue (an IEEE division a step and
//     site is most of it);
//   - at wide shapes (100 samples, 25 + 4) the Gram stage: n_s n_u p
//     entries per block, each a 128-term sum over shared rows, about
//     11.6 G products at 1M x 100 (two instructions each: the build keeps
//     --fmad=false, so every rounding is the twin's), and the (E,
//     n_blocks) buffer of per-block partial sums (375 MB there).
//
// What the design does about it:
//   - the momentum chain runs once per launch: a one-warp prologue
//     (momentum_table_kernel, u_phase_common.cuh) writes the steps' betas
//     and the advanced Nesterov scalar into a small buffer, and every
//     thread reads beta_k from it one step ahead; the same arithmetic on
//     the same inputs, so the same bits. The buffer is device memory
//     beside the partials: K1's shared memory, which the layout rule
//     reads, does not change;
//   - the big arrays stay in the transposed (rows, N) layout, so the
//     threads of a warp read neighbouring addresses of every row once;
//   - C, M (its upper triangle: M is symmetric) and the FISTA state live
//     in registers (n_u is a template parameter, 1..8), so the n_steps loop
//     of the gram form touches no memory; above n_u = 8 one form keeps
//     them in a per-thread column of a state region in shared memory and
//     sums their products in register tiles (u_phase_common.cuh, "the
//     n_u > 8 form"; direct_steps_rows here);
//   - resident layout: the site columns a block reads are staged in
//     shared memory (row stride T + 1 against bank conflicts, cp.async
//     for float32 and float64) and reused for the Gram sums, so Y, D and
//     Rt are read from device memory exactly once; the wide layout
//     (chosen by the wrapper where the resident one does not fit or fits
//     less than half its blocks per SM) stages Y and D in chunks of
//     samples and reads them twice, with the same sums in the same
//     orders;
//   - the Gram stage follows the block's entry count (gram_plan): one
//     entry per thread up to 128 entries (the main shape's 71), register
//     micro-tiles of 4 left factors x 4 rows above (about half a shared
//     load per product at the cohort shape, against three), every entry
//     summed in site order, so the bits do not move. Tensor cores are
//     not used: TF32 keeps 10 mantissa bits, which the float32 Gram
//     tolerance rules out, and 3xTF32 or float64 DMMA would reorder each
//     entry's sum (PERF.md and ROADMAP queue a tensor-core stage with
//     its reckoning);
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
// (slot 0: a, 1: l_w, 2: l_w_prev): the prologue reads them into the
// momentum table, every thread reads l_w, and the reduction kernel
// advances a and l_w_prev after the main pass, so the host never syncs.
//
// Plain C interface (ctypes): pointers and the stream as void*, launches
// on that stream, allocates nothing, returns cudaGetLastError(). Pointers
// of an empty known block (n_ct = 0) are never dereferenced; `state` is
// read only by the n_u > 8 form in the global layout, where its state
// region passes the card's shared memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "u_phase_common.cuh"

namespace {

using dm::kChunk;
using dm::kLd;
using dm::kRedThreads;
using dm::kSites;
using dm::RegVec;

// The n_steps FISTA loop of the direct form. Resident and global layouts:
// dres (the known-block residual) of this thread's site in shared rows
// (res, stride kLd), d from its rows (stride ld: staged, or the data
// itself). REBUILD (the wide layout): y and d read from the data rows and
// dres rebuilt each step (the same arithmetic as the one build of the
// rows). beta_tab is the launch's momentum table, read one step ahead;
// ut, gr are step temporaries.
template <typename T, int NU, bool LAG, bool REBUILD, int RND, typename TY,
          class VU, class VT, typename RT>
__device__ __forceinline__ void direct_steps(
        VU& u, VU& up, VT& ut, VT& gr, int n_u, const T* __restrict__ a1,
        const T* __restrict__ a2, const T* __restrict__ res,
        const TY* __restrict__ y, const TY* __restrict__ d, int64_t ld,
        RT rt, int n_s, int n_ct, const T* __restrict__ beta_tab,
        const T l_w, int n_steps) {
    const int nu = NU > 0 ? NU : n_u;
    T beta_next = beta_tab[0];
    for (int step = 0; step < n_steps; ++step) {
        const T beta = beta_next;
        beta_next = beta_tab[step + 1];
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
            if constexpr (REBUILD) {
                const T dv = dm::to_state(d[s * ld]);
                r = dm::known_resid<RND>(dm::to_state(y[s * ld]), dv, rt, a1,
                                         s, n_s, n_ct)
                    - dv * model;
            } else {
                r = res[s * kLd] - dm::to_state(d[s * ld]) * model;
            }
#pragma unroll
            for (int v = 0; v < nu; ++v) gr[v] += a2[v * n_s + s] * r;
        }
#pragma unroll
        for (int v = 0; v < nu; ++v) {
            up[v] = u[v];
            u[v] = dm::clip01(ut[v] + gr[v] / l_w);
        }
    }
}

// The n_steps FISTA loop of the direct form on the state rows of the
// n_u > 8 form (u in u vector 0, u_prev in 1; u_phase_common.cuh), in
// direct_steps' orders: u_t overwrites u_prev in place; then, chunk by
// chunk of direct_chunk samples, each sample's model (summed over the
// unknowns in order, kTile samples at a time in registers) and residual
// into the residual rows, and each gradient entry summed over the chunk's
// samples in order (kTile unknowns at a time) from its value after the
// last chunk (the gradient rows), the last chunk writing the new u over
// u_t. The two u vectors then swap. Returns the vectors holding u and
// u_prev. In the resident layout a2 is the block's alpha table, rows of
// pad4(n_s) values on 16 bytes, so the model reads four samples' alphas
// in one load and the gradient four samples' alphas of an unknown (a
// step reads each alpha twice, and these broadcast loads were most of
// its shared-memory traffic); in the wide and global layouts a2 is the
// (n_u, n_s) block in device memory, read one value at a time. SRC says
// where the residual comes from: kSrcTable (resident: the residual rows
// res and the alpha table), kSrcRebuild (wide: rebuilt each step from the
// data rows, as direct_steps), kSrcGlobal (global: the residual rows where
// the plan keeps them, res not null, else rebuilt).
constexpr int kSrcTable = 0, kSrcRebuild = 1, kSrcGlobal = 2;

template <typename T, bool LAG, int SRC, int RND, typename TY, typename RT>
__device__ __forceinline__ int2 direct_steps_rows(
        T* __restrict__ st, int nu, const T* __restrict__ a1,
        const T* __restrict__ a2, const T* __restrict__ res,
        const TY* __restrict__ y, const TY* __restrict__ d, int64_t ld,
        RT rt, int n_s, int n_ct, const T* __restrict__ beta_tab,
        const T l_w, int n_steps) {
    using dm::kTile;
    static_assert(kTile == 4, "the alpha table is read four values a load");
    constexpr bool TABLE = SRC == kSrcTable;
    const int ch = dm::direct_chunk(n_s);
    const int lda = TABLE ? dm::pad4(n_s) : n_s;
    T* rr = st + 2 * nu * kLd;              // residuals of the chunk
    T* gg = rr + ch * kLd;                  // gradient, past one chunk
    int a = 0;                              // u in vector a, u_prev in 1 - a
    T beta_next = beta_tab[0];
    for (int step = 0; step < n_steps; ++step) {
        const T beta = beta_next;
        beta_next = beta_tab[step + 1];
        const T* ua = st + a * nu * kLd;
        T* ub = st + (1 - a) * nu * kLd;
        for (int v = 0; v < nu; ++v) {
            const T u = ua[v * kLd];
            ub[v * kLd] = u + beta * (u - ub[v * kLd]);
        }
        const T* g = LAG ? ua : ub;
        for (int c0 = 0; c0 < n_s; c0 += ch) {
            const int n_c = n_s - c0 < ch ? n_s - c0 : ch;
            const bool first = c0 == 0, last = c0 + n_c == n_s;
            for (int s0 = 0; s0 < n_c; s0 += kTile) {
                T model[kTile];
#pragma unroll
                for (int j = 0; j < kTile; ++j) model[j] = T(0);
                if constexpr (!TABLE) {
                    int sj[kTile];
#pragma unroll
                    for (int j = 0; j < kTile; ++j)
                        sj[j] = c0 + (s0 + j < n_c ? s0 + j : n_c - 1);
                    for (int w = 0; w < nu; ++w) {
                        const T gw = g[w * kLd];
                        const T* aw = a2 + w * lda;
#pragma unroll
                        for (int j = 0; j < kTile; ++j)
                            model[j] += aw[sj[j]] * gw;
                    }
                } else {
                    // the table's padding past n_s feeds lanes never kept
                    for (int w = 0; w < nu; ++w) {
                        const T gw = g[w * kLd];
                        T aw[kTile];
                        dm::load4(a2 + w * lda + c0 + s0, aw);
#pragma unroll
                        for (int j = 0; j < kTile; ++j) model[j] += aw[j] * gw;
                    }
                }
#pragma unroll
                for (int j = 0; j < kTile; ++j) {
                    if (s0 + j < n_c) {
                        const int s = c0 + s0 + j;
                        const T dv = dm::to_state(d[s * ld]);
                        T r;
                        if constexpr (SRC == kSrcTable)
                            r = res[s * kLd] - dv * model[j];
                        else if constexpr (SRC == kSrcRebuild)
                            r = dm::known_resid<RND>(dm::to_state(y[s * ld]),
                                                     dv, rt, a1, s, n_s, n_ct)
                                - dv * model[j];
                        else if (res != nullptr)
                            r = res[s * kLd] - dv * model[j];
                        else
                            r = dm::known_resid_at<RND>(
                                    dm::to_state(y[s * ld]), dv, rt, a1, s,
                                    n_s, n_ct)
                                - dv * model[j];
                        rr[(s0 + j) * kLd] = r;
                    }
                }
            }
            for (int v0 = 0; v0 < nu; v0 += kTile) {
                int vj[kTile];
                T gr[kTile];
#pragma unroll
                for (int j = 0; j < kTile; ++j) {
                    vj[j] = v0 + j < nu ? v0 + j : nu - 1;
                    gr[j] = first ? T(0) : gg[vj[j] * kLd];
                }
                const T* a2c = a2 + c0;
                if constexpr (!TABLE) {
                    for (int s = 0; s < n_c; ++s) {
                        const T r = rr[s * kLd];
#pragma unroll
                        for (int j = 0; j < kTile; ++j)
                            gr[j] += a2c[vj[j] * lda + s] * r;
                    }
                } else {
                    // four samples a load; the chunk's last quad guarded,
                    // so each sum still adds its samples alone, in order
                    for (int s = 0; s < n_c; s += kTile) {
                        const bool full = s + kTile <= n_c;
                        T r[kTile];
#pragma unroll
                        for (int k = 0; k < kTile; ++k)
                            r[k] = (full || s + k < n_c) ? rr[(s + k) * kLd]
                                                         : T(0);
#pragma unroll
                        for (int j = 0; j < kTile; ++j) {
                            T aw[kTile];
                            dm::load4(a2c + vj[j] * lda + s, aw);
#pragma unroll
                            for (int k = 0; k < kTile; ++k)
                                if (full || s + k < n_c) gr[j] += aw[k] * r[k];
                        }
                    }
                }
#pragma unroll
                for (int j = 0; j < kTile; ++j) {
                    if (v0 + j < nu) {
                        if (last)
                            ub[vj[j] * kLd] = dm::clip01(ub[vj[j] * kLd]
                                                         + gr[j] / l_w);
                        else
                            gg[vj[j] * kLd] = gr[j];
                    }
                }
            }
        }
        a = 1 - a;
    }
    return make_int2(a, 1 - a);
}

// One site's U phase in the n_u > 8 form on its column st of the state
// region: the known-block residual rows (the resident direct form, and
// the global one where res is not null), u and u_prev loaded from the
// state rows uu (stride n), the C/M build and the gram steps, or the
// direct steps (SRC as direct_steps_rows). Returns the u vectors holding
// u and u_prev.
template <typename T, bool DIRECT, int RND, int SRC, typename TY,
          typename RT>
__device__ __forceinline__ int2 site_phase_rows_at(
        T* __restrict__ st, int nu, const T* __restrict__ uu, int64_t n,
        const TY* __restrict__ y, const TY* __restrict__ d, int64_t ld,
        RT rt, const T* __restrict__ a1, const T* __restrict__ a2,
        T* __restrict__ res, int n_s, int n_ct, const T* __restrict__ tab,
        T l_w, int n_steps, bool lagged) {
    if constexpr (!DIRECT)
        dm::build_cm_rows_at<T, RND>(st, nu, y, d, ld, rt, a1, a2, n_s,
                                     n_ct);
    else if constexpr (SRC == kSrcTable)
        dm::resid_rows<RND>(res, y, d, ld, rt, a1, n_s, n_ct);
    else if constexpr (SRC == kSrcGlobal) {
        if (res != nullptr)
            dm::resid_rows<RND>(res, y, d, ld, rt, a1, n_s, n_ct);
    }
    for (int v = 0; v < 2 * nu; ++v) st[v * kLd] = uu[v * n];
    if constexpr (!DIRECT)
        return lagged ? dm::gram_steps_rows<T, true>(st, nu, tab, l_w,
                                                     n_steps)
                      : dm::gram_steps_rows<T, false>(st, nu, tab, l_w,
                                                      n_steps);
    else
        return lagged ? direct_steps_rows<T, true, SRC, RND>(
                            st, nu, a1, a2, res, y, d, ld, rt, n_s, n_ct,
                            tab, l_w, n_steps)
                      : direct_steps_rows<T, false, SRC, RND>(
                            st, nu, a1, a2, res, y, d, ld, rt, n_s, n_ct,
                            tab, l_w, n_steps);
}

// site_phase_rows_at on a staged Rt column (the staged layouts' form:
// u_phase_common.cuh, known_resid's note)
template <typename T, bool DIRECT, int RND, int SRC, typename TY>
__device__ __forceinline__ int2 site_phase_rows(
        T* __restrict__ st, int nu, const T* __restrict__ uu, int64_t n,
        const TY* __restrict__ y, const TY* __restrict__ d, int64_t ld,
        const T* __restrict__ rt, const T* __restrict__ a1,
        const T* __restrict__ a2, T* __restrict__ res, int n_s, int n_ct,
        const T* __restrict__ tab, T l_w, int n_steps, bool lagged) {
    return site_phase_rows_at<T, DIRECT, RND, SRC>(
        st, nu, uu, n, y, d, ld, rt, a1, a2, res, n_s, n_ct, tab, l_w,
        n_steps, lagged);
}

// One site's whole U phase on its state vectors u, up (registers) with
// the temporaries cc, m, t1, t2: the C/M build and the gram steps, or the
// direct steps (t1, t2: ut, gr) on the residual rows res, or with REBUILD
// rebuilding the residual each step.
template <typename T, int NU, bool DIRECT, int RND, bool REBUILD,
          typename TY, class VU, class VC, class VM, typename RT>
__device__ __forceinline__ void site_phase_at(
        VU& u, VU& up, VC& cc, VM& m, VC& t1, VC& t2, int n_u,
        const TY* __restrict__ y, const TY* __restrict__ d, int64_t ld,
        RT rt, const T* __restrict__ a1, const T* __restrict__ a2,
        T* __restrict__ res, int n_s, int n_ct, const T* __restrict__ tab,
        T l_w, int n_steps, bool lagged) {
    if constexpr (!DIRECT) {
        dm::build_cm_at<T, NU, RND>(cc, m, t1, n_u, y, d, ld, rt, a1, a2,
                                    n_s, n_ct);
        if (lagged)
            dm::gram_steps<T, NU, true>(u, up, cc, m, t1, t2, n_u, tab,
                                        l_w, n_steps);
        else
            dm::gram_steps<T, NU, false>(u, up, cc, m, t1, t2, n_u, tab,
                                         l_w, n_steps);
    } else {
        // the known-block residual, kept in shared memory
        if constexpr (!REBUILD)
            dm::resid_rows<RND>(res, y, d, ld, rt, a1, n_s, n_ct);
        if (lagged)
            direct_steps<T, NU, true, REBUILD, RND>(u, up, t1, t2, n_u, a1,
                                                    a2, res, y, d, ld, rt,
                                                    n_s, n_ct, tab, l_w,
                                                    n_steps);
        else
            direct_steps<T, NU, false, REBUILD, RND>(u, up, t1, t2, n_u, a1,
                                                     a2, res, y, d, ld, rt,
                                                     n_s, n_ct, tab, l_w,
                                                     n_steps);
    }
}

// site_phase_at on a staged Rt column (the staged layouts' form:
// u_phase_common.cuh, known_resid's note)
template <typename T, int NU, bool DIRECT, int RND, bool REBUILD,
          typename TY, class VU, class VC, class VM>
__device__ __forceinline__ void site_phase(
        VU& u, VU& up, VC& cc, VM& m, VC& t1, VC& t2, int n_u,
        const TY* __restrict__ y, const TY* __restrict__ d, int64_t ld,
        const T* __restrict__ rt, const T* __restrict__ a1,
        const T* __restrict__ a2, T* __restrict__ res, int n_s, int n_ct,
        const T* __restrict__ tab, T l_w, int n_steps, bool lagged) {
    site_phase_at<T, NU, DIRECT, RND, REBUILD>(u, up, cc, m, t1, t2, n_u, y,
                                               d, ld, rt, a1, a2, res, n_s,
                                               n_ct, tab, l_w, n_steps,
                                               lagged);
}

// The global layout's main pass (u_phase_common.cuh, global_plan): the
// steps read Y, D and this site's Rt column where they lie in device
// memory (Rt through a DevRows), with the n_u > 8 form's state region at
// the bottom of shared memory (or in this block's part of the state
// buffer, kGlobalState) and the direct form's residual rows past it; the
// new u goes to the u rows at the top, then the Gram stage streams Y, D
// and Rt through the bottom rows (gram_partials_ring).
template <typename T, typename TD, int NU, bool DIRECT, int RND, int LAYOUT>
__device__ __forceinline__ void global_pass(
        const TD* __restrict__ ydt, const TD* __restrict__ rtt,
        const T* __restrict__ a1, const T* __restrict__ a2,
        T* __restrict__ uut, const T* __restrict__ scal,
        const T* __restrict__ tab, T* __restrict__ partials,
        T* __restrict__ state, int64_t n, int n_s, int n_ct, int n_u,
        int n_steps, int n_blocks, int lagged) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* smem = reinterpret_cast<T*>(smem_raw);
    const int nu = NU > 0 ? NU : n_u;
    constexpr bool RAW = RND == dm::kRoundAll;     // raw u rows for usq
    const int um = RAW ? 2 * nu : nu;
    const dm::GlobalPlan g = dm::global_plan(sizeof(T), n_s, n_ct, nu, DIRECT,
                                             um, 1);
    T* s_u = smem + (g.rows - um) * kLd;   // u (bf16(u) under kRoundAll)
    T* s_x = s_u + nu * kLd;               // kRoundAll: the raw u
    const int tid = threadIdx.x;
    const int64_t i = static_cast<int64_t>(blockIdx.x) * kSites + tid;
    const bool live = i < n;
    const TD* y = ydt + i;
    const TD* d = ydt + static_cast<int64_t>(n_s) * n + i;
    const dm::DevRows<TD> rt{rtt + i, n};
    const T l_w = scal[dm::kLW];
    T* u_rows = s_u + tid;
    // the register forms (but bf16_compute's gram form, whose C sums no
    // known products): the known sums into the bottom n_s rows first, a1
    // through the rows above them (every thread, between barriers)
    constexpr bool KROWS = NU > 0 && RND != dm::kRoundAll;
    if (KROWS && g.kc > 0)
        dm::known_rows(smem + tid, smem + n_s * kLd, a1, rt, live, n_s, n_ct,
                       g.kc, tid);
    auto put = [&](int v, T uv) {
        if constexpr (RAW) {
            u_rows[v * kLd] = dm::bf16r(uv);
            s_x[v * kLd + tid] = uv;
        } else {
            u_rows[v * kLd] = uv;
        }
    };
    if (live) {
        if constexpr (NU > 0) {
            RegVec<T, NU> u, up, cc, t1, t2;
            RegVec<T, NU * (NU + 1) / 2> m;
#pragma unroll
            for (int v = 0; v < NU; ++v) {
                u[v] = uut[v * n + i];
                up[v] = uut[(NU + v) * n + i];
            }
            // the direct form's residual rows: the bottom n_s rows (where
            // known_rows left the known sums)
            auto phase = [&](auto known) {
                site_phase_at<T, NU, DIRECT, RND, false>(
                    u, up, cc, m, t1, t2, n_u, y, d, n, known, a1, a2,
                    smem + tid, n_s, n_ct, tab, l_w, n_steps, lagged);
            };
            if constexpr (KROWS) {
                if (g.kc > 0)
                    phase(dm::KnownCol<T>{smem + tid});
                else
                    phase(rt);
            } else {
                phase(rt);
            }
#pragma unroll
            for (int v = 0; v < NU; ++v) {
                uut[v * n + i] = u[v];
                uut[(NU + v) * n + i] = up[v];
                put(v, u[v]);
            }
        } else {
            const int sr = dm::state_rows(n_s, nu, DIRECT);
            T* st = (LAYOUT == dm::kGlobalState
                         ? state + static_cast<int64_t>(blockIdx.x) * sr * kLd
                         : smem) + tid;
            T* res = DIRECT && g.res ? smem + sr * kLd + tid : nullptr;
            const int2 slot = site_phase_rows_at<T, DIRECT, RND, kSrcGlobal>(
                st, nu, uut + i, n, y, d, n, rt, a1, a2, res, n_s, n_ct, tab,
                l_w, n_steps, lagged);
            const T* u = st + slot.x * nu * kLd;
            const T* up = st + slot.y * nu * kLd;
            for (int v = 0; v < nu; ++v) {
                const T uv = u[v * kLd];
                uut[v * n + i] = uv;
                uut[(nu + v) * n + i] = up[v * kLd];
                put(v, uv);
            }
        }
    } else {
#pragma unroll
        for (int v = 0; v < nu; ++v) put(v, T(0));
    }
    dm::gram_partials_ring<T, TD, NU, RND>(smem, g, s_u, s_x, ydt, rtt, i,
                                           live, n, n_s, n_ct, nu, tid,
                                           partials + blockIdx.x, n_blocks);
}

// The main pass's body; u_phase_grams_kernel and, for the n_u > 8 gram
// form, u_phase_grams_state_kernel below are its two entry points.
template <typename T, typename TD, int NU, bool DIRECT, int RND, int LAYOUT>
__device__ __forceinline__ void main_pass(
        const TD* __restrict__ ydt, const TD* __restrict__ rtt,
        const T* __restrict__ a1b, const T* __restrict__ a2b,
        T* __restrict__ uut, const T* __restrict__ scal,
        const T* __restrict__ tab, T* __restrict__ partials,
        T* __restrict__ state, int64_t n, int n_s, int n_ct, int n_u,
        int n_steps, int n_blocks, int lagged) {
    if constexpr (LAYOUT >= dm::kGlobal) {
        global_pass<T, TD, NU, DIRECT, RND, LAYOUT>(
            ydt, rtt, a1b, a2b, uut, scal, tab, partials, state, n, n_s,
            n_ct, n_u, n_steps, n_blocks, lagged);
        return;
    }
    constexpr bool WIDE = LAYOUT == dm::kWide;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int nu = NU > 0 ? NU : n_u;
    const int p = n_ct + nu;
    // staged Y (and D) rows
    const int rows = WIDE ? dm::chunk_rows(n_s) : n_s;
    T* s_y = reinterpret_cast<T*>(smem_raw);
    // the resident direct form above n_u = 8 leads with its alpha table:
    // a2's rows padded to pad4(n_s) values, on 16 bytes (direct_steps_rows)
    constexpr bool TABLE = NU == 0 && DIRECT && !WIDE;
    if constexpr (TABLE) s_y += nu * dm::pad4(n_s);
    T* s_d = s_y + rows * kLd;
    T* s_r = s_d + rows * kLd;                  // p rows: [Rt | u]
    // above n_u = 8 the wide layout's staged rows are its lead rows, which
    // the state region overlays
    if constexpr (NU == 0 && WIDE)
        s_r = s_y + dm::lead_rows(n_s, nu, DIRECT) * kLd;
    T* s_a1 = s_r + p * kLd;                    // resident: (n_ct, n_s)
    T* s_a2 = s_a1 + n_ct * n_s;                // resident: (nu, n_s)
    // resident direct form: n_s rows of dres; kRoundAll: nu rows, raw u
    T* s_x = WIDE ? s_a1 : s_a2 + nu * n_s;
    if constexpr (TABLE) {
        s_a2 = reinterpret_cast<T*>(smem_raw);
        s_x = s_a1 + n_ct * n_s;
    }

    const int tid = threadIdx.x;
    const int64_t i = static_cast<int64_t>(blockIdx.x) * kSites + tid;
    const bool live = i < n;
    const T* a1 = a1b;
    const T* a2 = a2b;
    if constexpr (!WIDE) {
        for (int k = tid; k < n_ct * n_s; k += kSites) s_a1[k] = a1b[k];
        if constexpr (TABLE) {
            const int lda = dm::pad4(n_s);
            for (int k = tid; k < nu * lda; k += kSites) {
                const int s = k % lda;
                s_a2[k] = s < n_s ? a2b[(k / lda) * n_s + s] : T(0);
            }
        } else {
            for (int k = tid; k < nu * n_s; k += kSites) s_a2[k] = a2b[k];
        }
        a1 = s_a1;
        a2 = s_a2;
        dm::stage_rows(s_y, ydt, 0, n_s, i, live, n, tid);
        dm::stage_rows(s_d, ydt + static_cast<int64_t>(n_s) * n, 0, n_s, i,
                       live, n, tid);
    }
    dm::stage_rows(s_r, rtt, 0, n_ct, i, live, n, tid);
    dm::stage_wait();
    __syncthreads();

    const T l_w = scal[dm::kLW];
    T* u_rows = s_r + n_ct * kLd + tid;
    // (this site's Rt column is passed as s_r + tid at each call: a local
    // pointer that run captures cost the cohort's K1 7%, PERF.md)
    if (live) {
        auto run = [&](auto& u, auto& up, auto& cc, auto& m, auto& t1,
                       auto& t2) {
            if constexpr (WIDE)
                site_phase<T, NU, DIRECT, RND, WIDE>(
                    u, up, cc, m, t1, t2, n_u, ydt + i,
                    ydt + static_cast<int64_t>(n_s) * n + i, n, s_r + tid,
                    a1, a2, s_x + tid, n_s, n_ct, tab, l_w, n_steps, lagged);
            else
                site_phase<T, NU, DIRECT, RND, WIDE>(
                    u, up, cc, m, t1, t2, n_u, s_y + tid, s_d + tid,
                    int64_t(kLd), s_r + tid, a1, a2, s_x + tid, n_s, n_ct,
                    tab, l_w, n_steps, lagged);
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
            // the state in this thread's column of the state region: after
            // the resident layout's rows, or over the lead rows
            T* region;
            if constexpr (WIDE)
                region = s_y;
            else
                region = s_x + (DIRECT ? n_s
                                       : (RND == dm::kRoundAll ? nu : 0))
                                   * kLd;
            T* st = region + tid;
            int2 slot;
            if constexpr (WIDE)
                slot = site_phase_rows<T, DIRECT, RND, kSrcRebuild>(
                    st, nu, uut + i, n, ydt + i,
                    ydt + static_cast<int64_t>(n_s) * n + i, n, s_r + tid,
                    a1, a2, s_x + tid, n_s, n_ct, tab, l_w, n_steps, lagged);
            else
                slot = site_phase_rows<T, DIRECT, RND, kSrcTable>(
                    st, nu, uut + i, n, s_y + tid, s_d + tid, int64_t(kLd),
                    s_r + tid, a1, a2, s_x + tid, n_s, n_ct, tab, l_w,
                    n_steps, lagged);
            const T* u = st + slot.x * nu * kLd;
            const T* up = st + slot.y * nu * kLd;
            for (int v = 0; v < nu; ++v) {
                const T uv = u[v * kLd];
                uut[v * n + i] = uv;
                uut[(nu + v) * n + i] = up[v * kLd];
                if constexpr (RND == dm::kRoundAll) {
                    u_rows[v * kLd] = dm::bf16r(uv);
                    s_x[v * kLd + tid] = uv;
                } else {
                    u_rows[v * kLd] = uv;
                }
            }
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
        dm::gram_partials_chunked<T, TD, NU, RND>(
            s_y, s_d, s_r, ydt, i, live, n, n_s, n_ct, nu, tid,
            partials + blockIdx.x, n_blocks, s_x);
    else
        dm::gram_partials<T, NU, RND>(
            s_y, s_d, s_r, n_s, 0, n_s, true, n_ct, nu, tid,
            partials + blockIdx.x, n_blocks, s_x);
}

#define DM_K1_PARAMS                                                        \
    const TD *__restrict__ ydt, const TD *__restrict__ rtt,                 \
        const T *__restrict__ a1b, const T *__restrict__ a2b,               \
        T *__restrict__ uut, const T *__restrict__ scal,                    \
        const T *__restrict__ tab, T *__restrict__ partials,                \
        T *__restrict__ state, int64_t n, int n_s, int n_ct, int n_u,       \
        int n_steps, int n_blocks, int lagged
#define DM_K1_ARGS                                                          \
    ydt, rtt, a1b, a2b, uut, scal, tab, partials, state, n, n_s, n_ct, n_u, \
        n_steps, n_blocks, lagged

template <typename T, typename TD, int NU, bool DIRECT, int RND, int LAYOUT>
__global__ void __launch_bounds__(kSites) u_phase_grams_kernel(DM_K1_PARAMS) {
    main_pass<T, TD, NU, DIRECT, RND, LAYOUT>(DM_K1_ARGS);
}

// The n_u > 8 gram form's entry point: its state region and staged rows
// leave one to four blocks an SM (n_s = 100), so registers do not bound
// its occupancy, and telling ptxas so (a minimum of one block) lets it
// keep more of the C/M build's and the Gram stage's values in registers:
// on an H100 about 20% off K1 at n_u = 12 in float64, where the default
// allocation gave it 96 registers (chip_smoke.time_cases, table "state"; PERF.md).
// The direct form keeps the default: its resident layout fits up to six
// blocks, and the same attribute cost it 6% at n_u = 9. (K4's n_u > 8
// form gained 1-2% from it, and splitting K4's kernel moved three of its
// register forms' allocations, so K4 keeps one kernel.)
template <typename T, typename TD, int NU, bool DIRECT, int RND, int LAYOUT>
__global__ void __launch_bounds__(kSites, 1)
u_phase_grams_state_kernel(DM_K1_PARAMS) {
    main_pass<T, TD, NU, DIRECT, RND, LAYOUT>(DM_K1_ARGS);
}

#undef DM_K1_PARAMS
#undef DM_K1_ARGS

// shared memory of the main pass; itemsize is the state's (the staged
// data rows are of the state type whatever the data's). Above n_u = 8 the
// state region adds its rows: after the resident layout's, over the lead
// rows of the wide layout; the global layout's rows are global_plan's.
size_t smem_bytes(int layout, size_t itemsize, int n_s, int n_ct, int n_u,
                  bool direct, int rnd) {
    const size_t p = static_cast<size_t>(n_ct + n_u);
    const size_t x_rows = rnd == dm::kRoundAll ? n_u : 0;
    if (layout >= dm::kGlobal)
        return itemsize * kLd
               * dm::global_plan(itemsize, n_s, n_ct, n_u, direct,
                                 n_u + static_cast<int>(x_rows), 1).rows;
    const size_t lead = dm::lead_rows(n_s, n_u, direct);
    if (layout == dm::kWide)
        return itemsize * ((lead + p + x_rows) * kLd);
    const size_t rows = 2 * static_cast<size_t>(n_s) + p
                        + (direct ? static_cast<size_t>(n_s) : 0) + x_rows
                        + dm::state_rows(n_s, n_u, direct);
    // the alpha blocks; above n_u = 8 the direct form's a2 as its table
    const size_t alpha = direct && n_u > dm::kRegNU
                             ? static_cast<size_t>(n_ct) * n_s
                                   + static_cast<size_t>(n_u)
                                         * dm::pad4(n_s)
                             : p * n_s;
    return itemsize * (rows * kLd + alpha);
}

template <typename T, typename TD, int NU, bool DIRECT, int RND, int LAYOUT>
int launch(const void* ydt, const void* rtt, const void* a1b, const void* a2b,
           void* uut, void* scal, void* tab, void* partials, void* out,
           void* state, int64_t n, int n_s, int n_ct, int n_u, int n_steps,
           int lagged, cudaStream_t stream) {
    const int n_blocks = static_cast<int>((n + kSites - 1) / kSites);
    const int n_entries = dm::gram_entries(n_s, n_ct, n_u);
    int err0 = dm::launch_momentum_table<T, false>(
        static_cast<T*>(scal), 0, 1, static_cast<T*>(tab), n_steps, stream);
    if (err0 != 0) return err0;
    if (LAYOUT == dm::kGlobalState && state == nullptr)
        return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = smem_bytes(LAYOUT, sizeof(T), n_s, n_ct, n_u, DIRECT,
                                   RND);
    auto kern = [] {
        if constexpr (NU == 0 && !DIRECT)
            return u_phase_grams_state_kernel<T, TD, NU, DIRECT, RND,
                                              LAYOUT>;
        else
            return u_phase_grams_kernel<T, TD, NU, DIRECT, RND, LAYOUT>;
    }();
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
        static_cast<const T*>(tab), static_cast<T*>(partials),
        static_cast<T*>(state), n, n_s, n_ct, n_u, n_steps, n_blocks,
        lagged);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    dm::reduce_partials_kernel<T><<<n_entries, kRedThreads, 0, stream>>>(
        static_cast<const T*>(partials), static_cast<T*>(out),
        static_cast<T*>(scal), static_cast<const T*>(tab), n_blocks,
        n_steps);
    return static_cast<int>(cudaGetLastError());
}

template <typename T, typename TD, bool DIRECT, int RND, int LAYOUT>
int dispatch_nu(const void* ydt, const void* rtt, const void* a1b,
                const void* a2b, void* uut, void* scal, void* tab,
                void* partials, void* out, void* state, int64_t n, int n_s,
                int n_ct, int n_u, int n_steps, int lagged,
                cudaStream_t st) {
#define DM_K1_CASE(NU)                                                      \
    case NU:                                                                \
        return launch<T, TD, NU, DIRECT, RND, LAYOUT>(                      \
            ydt, rtt, a1b, a2b, uut, scal, tab, partials, out, state, n,    \
            n_s, n_ct, n_u, n_steps, lagged, st);
    switch (n_u) {
        DM_K1_CASE(2) DM_K1_CASE(3) DM_K1_CASE(4) DM_K1_CASE(5)
        DM_K1_CASE(6) DM_K1_CASE(7) DM_K1_CASE(8)
        case 1:
            // n_u = 1 always takes the gram form (1 <= 3 n_s)
            if constexpr (!DIRECT)
                return launch<T, TD, 1, false, RND, LAYOUT>(
                    ydt, rtt, a1b, a2b, uut, scal, tab, partials, out,
                    state, n, n_s, n_ct, n_u, n_steps, lagged, st);
            return static_cast<int>(cudaErrorInvalidValue);
        default:
            // n_u > 8: the state region in shared memory, or (global
            // layout, past the card's shared memory) in device memory
            if (n_u < 1) return static_cast<int>(cudaErrorInvalidValue);
            if constexpr (LAYOUT == dm::kGlobal) {
                if (dm::state_in_device(sizeof(T), n_s, n_u, DIRECT))
                    return launch<T, TD, 0, DIRECT, RND, dm::kGlobalState>(
                        ydt, rtt, a1b, a2b, uut, scal, tab, partials, out,
                        state, n, n_s, n_ct, n_u, n_steps, lagged, st);
            }
            return launch<T, TD, 0, DIRECT, RND, LAYOUT>(
                ydt, rtt, a1b, a2b, uut, scal, tab, partials, out, state, n,
                n_s, n_ct, n_u, n_steps, lagged, st);
    }
#undef DM_K1_CASE
}

// TD = T (float32, float64) or __nv_bfloat16 with T = float; bf16c (bf16
// data only): kRoundAll in the gram form, kRoundDy in the direct form
template <typename T, typename TD, int LAYOUT>
int dispatch(const void* ydt, const void* rtt, const void* a1b,
             const void* a2b, void* uut, void* scal, void* tab,
             void* partials, void* out, void* state, int64_t n, int n_s,
             int n_ct, int n_u, int n_steps, int lagged, int direct,
             int bf16c, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if constexpr (std::is_same<TD, __nv_bfloat16>::value) {
        if (bf16c) {
            if (direct)
                return dispatch_nu<T, TD, true, dm::kRoundDy, LAYOUT>(
                    ydt, rtt, a1b, a2b, uut, scal, tab, partials, out,
                    state, n, n_s, n_ct, n_u, n_steps, lagged, st);
            return dispatch_nu<T, TD, false, dm::kRoundAll, LAYOUT>(
                ydt, rtt, a1b, a2b, uut, scal, tab, partials, out, state, n,
                n_s, n_ct, n_u, n_steps, lagged, st);
        }
    }
    if (direct)
        return dispatch_nu<T, TD, true, dm::kRoundNone, LAYOUT>(
            ydt, rtt, a1b, a2b, uut, scal, tab, partials, out, state, n,
            n_s, n_ct, n_u, n_steps, lagged, st);
    return dispatch_nu<T, TD, false, dm::kRoundNone, LAYOUT>(
        ydt, rtt, a1b, a2b, uut, scal, tab, partials, out, state, n, n_s,
        n_ct, n_u, n_steps, lagged, st);
}

}  // namespace

// The C entry points of one layout (PREFIX dm_u_phase_grams,
// dm_u_phase_grams_wide or dm_u_phase_grams_global):
//   PREFIX_smem(itemsize, n_s, n_ct, n_u, direct, bf16c): the main pass's
//     shared memory in bytes (itemsize is the state's), which the wrapper
//     checks against the card's limit before launching;
//   PREFIX_{f32,f64}(ydt, rtt, a1b, a2b, uut, scal, tab, partials, out,
//     state, n, n_s, n_ct, n_u, n_steps, lagged, direct, stream): tab is
//     room for the momentum table, n_steps + 1 values of the state type;
//     state the n_u > 8 form's state regions where they live in device
//     memory (the global layout where dm_state_in_device says so; NULL
//     otherwise), n_blocks x dm_state_rows(...) x 129 values of the state
//     type;
//   PREFIX_bf16(..., direct, bf16c, stream): bf16 data with a float32
//     state; bf16c the bf16_compute form.
#define DM_K1_SMEM_EXPORT(PREFIX, LAYOUT)                                    \
    extern "C" long long PREFIX##_smem(int itemsize, int n_s, int n_ct,      \
                                       int n_u, int direct, int bf16c) {     \
        const int rnd = !bf16c ? dm::kRoundNone                              \
                               : (direct ? dm::kRoundDy : dm::kRoundAll);    \
        return static_cast<long long>(smem_bytes(LAYOUT, itemsize, n_s,      \
                                                 n_ct, n_u, direct != 0,     \
                                                 rnd));                      \
    }
#define DM_K1_F32_EXPORT(PREFIX, LAYOUT)                                     \
    extern "C" int PREFIX##_f32(                                             \
        const void* ydt, const void* rtt, const void* a1b, const void* a2b,  \
        void* uut, void* scal, void* tab, void* partials, void* out,         \
        void* state, long long n, int n_s, int n_ct, int n_u, int n_steps,   \
        int lagged, int direct, void* stream) {                              \
        return dispatch<float, float, LAYOUT>(                               \
            ydt, rtt, a1b, a2b, uut, scal, tab, partials, out, state, n,     \
            n_s, n_ct, n_u, n_steps, lagged, direct, 0, stream);             \
    }
#define DM_K1_F64_EXPORT(PREFIX, LAYOUT)                                     \
    extern "C" int PREFIX##_f64(                                             \
        const void* ydt, const void* rtt, const void* a1b, const void* a2b,  \
        void* uut, void* scal, void* tab, void* partials, void* out,         \
        void* state, long long n, int n_s, int n_ct, int n_u, int n_steps,   \
        int lagged, int direct, void* stream) {                              \
        return dispatch<double, double, LAYOUT>(                             \
            ydt, rtt, a1b, a2b, uut, scal, tab, partials, out, state, n,     \
            n_s, n_ct, n_u, n_steps, lagged, direct, 0, stream);             \
    }
#define DM_K1_BF16_EXPORT(PREFIX, LAYOUT)                                    \
    extern "C" int PREFIX##_bf16(                                            \
        const void* ydt, const void* rtt, const void* a1b, const void* a2b,  \
        void* uut, void* scal, void* tab, void* partials, void* out,         \
        void* state, long long n, int n_s, int n_ct, int n_u, int n_steps,   \
        int lagged, int direct, int bf16c, void* stream) {                   \
        return dispatch<float, __nv_bfloat16, LAYOUT>(                       \
            ydt, rtt, a1b, a2b, uut, scal, tab, partials, out, state, n,     \
            n_s, n_ct, n_u, n_steps, lagged, direct, bf16c, stream);         \
    }
// all of one layout's entry points in one source
#define DM_K1_EXPORTS(PREFIX, LAYOUT)                                        \
    DM_K1_SMEM_EXPORT(PREFIX, LAYOUT)                                        \
    DM_K1_F32_EXPORT(PREFIX, LAYOUT)                                         \
    DM_K1_F64_EXPORT(PREFIX, LAYOUT)                                         \
    DM_K1_BF16_EXPORT(PREFIX, LAYOUT)
