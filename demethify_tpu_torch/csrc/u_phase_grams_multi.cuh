// K4: the multi-member U-phase megakernel of the batched random restarts,
// for Hopper. This header holds the kernel and its launch, templated on
// the shared-memory layout (u_phase_common.cuh): u_phase_grams_multi.cu
// builds the resident layout, u_phase_grams_multi_wide.cu the wide one.
//
// Replaces the Pallas kernel demethify_tpu/ops/pallas_kernels.py
// :: _u_phase_grams_multi_kernel (called through u_phase_grams_multi).
// B restart members share Y, D and Rt; each has its own alpha blocks
// (a1_b, a2_b), its own u and u_prev and its own FISTA scalars. One outer
// iteration makes ONE pass over the CpG axis for all members: per site
// and per ACTIVE member b, K1's gram form (n_steps FISTA steps on u_i in
// registers, lagged or not), then member b's new-u Gram blocks
// gu_b (n_s, n_u, p), b_u_b (n_u, n_s) and usq_b. Inactive members
// (scalar slot kActive 0: the solver's per-member termination) are
// skipped: their u, u_prev, Nesterov scalar and l_w_prev stay as they are
// and their Gram outputs are not written (the solver does not read them).
// Gram form only, as the TPU kernel; the solver routes the direct form
// (n_u^2 > 3 n_s) to sequential single-member solves, as the JAX API does.
//
// Weighted form (W, the weighted bootstrap: one replicate per member):
// each member also has a row of per-site weights w_b (its resample's row
// multiplicities), which multiply the LEFT u of every Gram sum exactly
// once (gu = sum w u d [Rt | u], b_u = sum w u d y, usq = sum w u^2), as
// the TPU kernel folds its `weights` operand into the u rows of its Gram
// dots. The FISTA steps stay raw, so rows with w = 0 still move. Each
// thread forms its site's weighted rows w u_v once and stages them in NU
// more shared rows (s_wu) beside [Rt | u_b]: the Gram sums read the
// weighted row as their left u and the raw rows of s_r as their right
// [Rt | u], so the self block's right-hand u is not weighted a second
// time and each term costs the unweighted kernel's shared loads. Cost per
// site and member: one more read (itemsize bytes) and NU multiplies; with
// all weights 1 every sum equals the unweighted kernel's bit for bit
// (1 u = u).
//
// What bounds it on an H100: at the restart shapes it is bound by
// instruction issue, not memory. The bytes it must move per outer
// iteration at 1M sites x 10 samples, 5 + 1, B = 16, float32 are Y, D, Rt
// (100 MB, read once) and the members' u, u_prev (128 MB read, 128 MB
// written): ~356 MB, ~106 us at 3.35 TB/s. The work is B times K1's per
// site: the C/M build, n_steps dependent FISTA steps and the Gram
// partial sums over the block's sites. Each member's momentum chain (two
// IEEE divisions and two square roots a step, the same in every thread)
// is computed once per launch by the prologue, one thread per member,
// into a (B, n_steps + 1) table (momentum_table_kernel), which every
// thread reads as K1's threads do; the Gram stage follows K1's plan
// (gram_plan: one entry per thread, or register micro-tiles above 128
// entries a block).
//
// What the design does about it:
//   - one block per 128 sites, as K1: the block stages its sites' Y, D and
//     Rt columns in shared memory ONCE and then loops over the members, so
//     Y, D and Rt are read from device memory once for all B members (the
//     TPU kernel's member axis buys the same);
//   - per member the block loads that member's alpha blocks into shared
//     memory (the wide layout reads them from device memory), builds C
//     and M in registers (n_u <= 8; a scratch column per site above) and
//     runs the steps with K1's code (u_phase_common.cuh), so the
//     per-thread register footprint is K1's whatever B is and every
//     member follows K1's arithmetic bit for bit;
//   - the Gram partials go to per-block columns of a
//     (B x E, n_blocks) buffer (E = n_s n_u p + n_u n_s + 1 entries per
//     member) and K1's fixed-order reduction kernel sums each row and
//     advances each active member's scalars: no float atomics, so every
//     member's sums are K1's sums. The buffer is B E n_blocks itemsize
//     bytes, written and read back once an iteration: 35 MB at the shape
//     above (10% of the bytes the kernel must move);
//   - shared memory is K1's (one member's alpha blocks at a time), so it
//     does not grow with B. The wide layout re-stages Y and D in chunks
//     for each member's Gram sums, so it reads them 2 B times.
//
// bf16 storage (pallas_kernels.py:835-836, 853: the data converted at
// load, the state float32): Y, D and Rt arrive as __nv_bfloat16 (TD) with
// a float32 state and weight rows (T); each value is converted as it is
// read, and from there on every member runs the float32 form's
// arithmetic on the converted values (u_phase_common.cuh). It halves the
// bytes of Y, D and Rt (50 MB instead of 100 MB per outer iteration at the
// shape above), against a bound set by the operations, so the expected
// gain is small.
//
// Scalars: `scal` is (B, scal_stride) with K1's slots per member (kAU,
// kLW, kLWPrev read) plus kActive; `tab` is room for the members'
// momentum tables, B (n_steps + 1) values. Weights: `w` is (B, w_stride),
// NULL for the unweighted form.
//
// Plain C interface (ctypes): pointers and the stream as void*, launches
// on that stream, allocates nothing, returns cudaGetLastError(). Pointers
// of an empty known block (n_ct = 0) are never dereferenced.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "u_phase_common.cuh"

namespace {

using dm::ColVec;
using dm::kChunk;
using dm::kLd;
using dm::kRedThreads;
using dm::kSites;
using dm::RegVec;

template <typename T, typename TD, int NU, bool W, bool WIDE>
__global__ void __launch_bounds__(kSites)
u_phase_grams_multi_kernel(
        const TD* __restrict__ ydt, const TD* __restrict__ rtt,
        const T* __restrict__ a1b, int64_t a1_stride,
        const T* __restrict__ a2b, int64_t a2_stride, T* __restrict__ uut,
        const T* __restrict__ w, int64_t w_stride,
        const T* __restrict__ scal, int scal_stride,
        const T* __restrict__ tab, T* __restrict__ partials,
        T* __restrict__ scratch, int64_t n,
        int n_s, int n_ct, int n_u, int n_steps, int n_blocks,
        int n_members, int lagged) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int nu = NU > 0 ? NU : n_u;
    const int p = n_ct + nu;
    // staged Y (and D) rows
    const int rows = WIDE ? dm::chunk_rows(n_s) : n_s;
    T* s_y = reinterpret_cast<T*>(smem_raw);
    T* s_d = s_y + rows * kLd;
    T* s_r = s_d + rows * kLd;                  // p rows: [Rt | u_b]
    T* s_a1 = s_r + p * kLd;                    // resident: member b's a1
    T* s_a2 = s_a1 + n_ct * n_s;                // resident: member b's a2
    T* s_wu = WIDE ? s_a1 : s_a2 + nu * n_s;    // W: member b's w u rows

    const int tid = threadIdx.x;
    const int64_t i = static_cast<int64_t>(blockIdx.x) * kSites + tid;
    const bool live = i < n;
    if constexpr (!WIDE) {
        dm::stage_rows(s_y, ydt, 0, n_s, i, live, n, tid);
        dm::stage_rows(s_d, ydt + static_cast<int64_t>(n_s) * n, 0, n_s, i,
                       live, n, tid);
    }
    dm::stage_rows(s_r, rtt, 0, n_ct, i, live, n, tid);
    dm::stage_wait();
    const int n_entries = dm::gram_entries(n_s, n_ct, nu);
    T* u_rows = s_r + n_ct * kLd + tid;

    for (int b = 0; b < n_members; ++b) {
        const T* sc = scal + static_cast<int64_t>(b) * scal_stride;
        if (sc[dm::kActive] == T(0)) continue;      // uniform per block
        const T* tb = tab + static_cast<int64_t>(b) * (n_steps + 1);
        const T* a1 = a1b + b * a1_stride;
        const T* a2 = a2b + b * a2_stride;
        __syncthreads();     // the previous member's Gram sums are done
        if constexpr (!WIDE) {
            for (int k = tid; k < n_ct * n_s; k += kSites) s_a1[k] = a1[k];
            for (int k = tid; k < nu * n_s; k += kSites) s_a2[k] = a2[k];
            a1 = s_a1;
            a2 = s_a2;
        }
        __syncthreads();

        T* ub = uut + static_cast<int64_t>(b) * (2 * nu) * n;
        const T wi = (W && live) ? w[static_cast<int64_t>(b) * w_stride + i]
                                 : T(0);
        auto run = [&](auto& u, auto& up, auto& cc, auto& m, auto& t1,
                       auto& t2) {
            if constexpr (WIDE)
                dm::build_cm<T, NU, dm::kRoundNone>(
                    cc, m, t1, nu, ydt + i,
                    ydt + static_cast<int64_t>(n_s) * n + i, n, s_r + tid,
                    a1, a2, n_s, n_ct);
            else
                dm::build_cm<T, NU, dm::kRoundNone>(
                    cc, m, t1, nu, s_y + tid, s_d + tid, int64_t(kLd),
                    s_r + tid, a1, a2, n_s, n_ct);
            if (lagged)
                dm::gram_steps<T, NU, true>(u, up, cc, m, t1, t2, nu, tb,
                                            sc[dm::kLW], n_steps);
            else
                dm::gram_steps<T, NU, false>(u, up, cc, m, t1, t2, nu, tb,
                                             sc[dm::kLW], n_steps);
#pragma unroll
            for (int v = 0; v < nu; ++v) {
                u_rows[v * kLd] = u[v];
                if constexpr (W) s_wu[v * kLd + tid] = wi * u[v];
            }
        };
        if (live) {
            if constexpr (NU > 0) {
                RegVec<T, NU> u, up, cc, t1, t2;
                RegVec<T, NU * (NU + 1) / 2> m;
#pragma unroll
                for (int v = 0; v < NU; ++v) {
                    u[v] = ub[v * n + i];
                    up[v] = ub[(NU + v) * n + i];
                }
                run(u, up, cc, m, t1, t2);
#pragma unroll
                for (int v = 0; v < NU; ++v) {
                    ub[v * n + i] = u[v];
                    ub[(NU + v) * n + i] = up[v];
                }
            } else {
                // u, u_prev updated in place in the member's state rows;
                // C, M and the temporaries in this site's scratch column
                const int64_t nm = nu * (nu + 1) / 2;
                ColVec<T> u{ub + i, n}, up{ub + nu * n + i, n};
                ColVec<T> cc{scratch + i, n}, m{scratch + nu * n + i, n};
                ColVec<T> t1{scratch + (nu + nm) * n + i, n};
                ColVec<T> t2{scratch + (2 * nu + nm) * n + i, n};
                run(u, up, cc, m, t1, t2);
            }
        } else {
#pragma unroll
            for (int v = 0; v < nu; ++v) {
                u_rows[v * kLd] = T(0);
                if constexpr (W) s_wu[v * kLd + tid] = T(0);
            }
        }
        __syncthreads();
        T* out = partials + static_cast<int64_t>(b) * n_entries * n_blocks
                 + blockIdx.x;
        if constexpr (WIDE)
            dm::gram_partials_chunked<T, TD, NU, W, dm::kRoundNone>(
                s_y, s_d, s_r, ydt, i, live, n, n_s, n_ct, nu, tid, out,
                n_blocks, s_wu);
        else
            dm::gram_partials<T, NU, W, dm::kRoundNone>(
                s_y, s_d, s_r, n_s, 0, n_s, true, n_ct, nu, tid, out,
                n_blocks, s_wu);
    }
}

size_t smem_bytes(bool wide, size_t itemsize, int n_s, int n_ct, int n_u,
                  bool weighted) {
    const size_t p = static_cast<size_t>(n_ct + n_u);
    const size_t w_rows = weighted ? n_u : 0;
    if (wide)
        return itemsize
               * ((2 * dm::chunk_rows(n_s) + p + w_rows) * kLd);
    return itemsize * ((2 * static_cast<size_t>(n_s) + p + w_rows) * kLd
                       + p * n_s);
}

template <typename T, typename TD, int NU, bool W, bool WIDE>
int launch(const void* ydt, const void* rtt, const void* a1b,
           int64_t a1_stride, const void* a2b, int64_t a2_stride, void* uut,
           const void* w, int64_t w_stride, void* scal, int scal_stride,
           void* tab, void* partials, void* out, void* scratch, int64_t n,
           int n_s, int n_ct, int n_u, int n_steps, int n_members,
           int lagged, cudaStream_t stream) {
    const int n_blocks = static_cast<int>((n + kSites - 1) / kSites);
    int err0 = dm::launch_momentum_table<T, false>(
        static_cast<T*>(scal), scal_stride, n_members, static_cast<T*>(tab),
        n_steps, stream);
    if (err0 != 0) return err0;
    const int n_entries = dm::gram_entries(n_s, n_ct, n_u);
    const size_t smem = smem_bytes(WIDE, sizeof(T), n_s, n_ct, n_u, W);
    auto kern = u_phase_grams_multi_kernel<T, TD, NU, W, WIDE>;
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    kern<<<n_blocks, kSites, smem, stream>>>(
        static_cast<const TD*>(ydt), static_cast<const TD*>(rtt),
        static_cast<const T*>(a1b), a1_stride, static_cast<const T*>(a2b),
        a2_stride, static_cast<T*>(uut), static_cast<const T*>(w), w_stride,
        static_cast<const T*>(scal), scal_stride, static_cast<const T*>(tab),
        static_cast<T*>(partials), static_cast<T*>(scratch), n, n_s, n_ct,
        n_u, n_steps, n_blocks, n_members, lagged);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    dm::reduce_partials_kernel<T, true>
        <<<n_members * n_entries, kRedThreads, 0, stream>>>(
            static_cast<const T*>(partials), static_cast<T*>(out),
            static_cast<T*>(scal), static_cast<const T*>(tab), n_blocks,
            n_steps, n_entries, scal_stride);
    return static_cast<int>(cudaGetLastError());
}

template <typename T, typename TD, bool W, bool WIDE>
int dispatch_nu(const void* ydt, const void* rtt, const void* a1b,
                long long a1_stride, const void* a2b, long long a2_stride,
                void* uut, const void* w, long long w_stride, void* scal,
                int scal_stride, void* tab, void* partials, void* out,
                void* scratch, long long n, int n_s, int n_ct, int n_u,
                int n_steps, int n_members, int lagged, cudaStream_t st) {
#define DM_K4_CASE(NU)                                                      \
    case NU:                                                                \
        return launch<T, TD, NU, W, WIDE>(                                  \
            ydt, rtt, a1b, a1_stride, a2b, a2_stride, uut, w, w_stride,     \
            scal, scal_stride, tab, partials, out, scratch, n, n_s, n_ct,   \
            n_u, n_steps, n_members, lagged, st);
    switch (n_u) {
        DM_K4_CASE(1) DM_K4_CASE(2) DM_K4_CASE(3) DM_K4_CASE(4)
        DM_K4_CASE(5) DM_K4_CASE(6) DM_K4_CASE(7) DM_K4_CASE(8)
        default:
            if (n_u < 1 || scratch == nullptr)
                return static_cast<int>(cudaErrorInvalidValue);
            return launch<T, TD, 0, W, WIDE>(
                ydt, rtt, a1b, a1_stride, a2b, a2_stride, uut, w, w_stride,
                scal, scal_stride, tab, partials, out, scratch, n, n_s, n_ct,
                n_u, n_steps, n_members, lagged, st);
    }
#undef DM_K4_CASE
}

template <typename T, typename TD, bool WIDE>
int dispatch(const void* ydt, const void* rtt, const void* a1b,
             long long a1_stride, const void* a2b, long long a2_stride,
             void* uut, const void* w, long long w_stride, void* scal,
             int scal_stride, void* tab, void* partials, void* out,
             void* scratch, long long n, int n_s, int n_ct, int n_u,
             int n_steps, int n_members, int lagged, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (w != nullptr)
        return dispatch_nu<T, TD, true, WIDE>(
            ydt, rtt, a1b, a1_stride, a2b, a2_stride, uut, w, w_stride, scal,
            scal_stride, tab, partials, out, scratch, n, n_s, n_ct, n_u,
            n_steps, n_members, lagged, st);
    return dispatch_nu<T, TD, false, WIDE>(
        ydt, rtt, a1b, a1_stride, a2b, a2_stride, uut, w, w_stride, scal,
        scal_stride, tab, partials, out, scratch, n, n_s, n_ct, n_u,
        n_steps, n_members, lagged, st);
}

}  // namespace

// The C entry points of one layout (PREFIX dm_u_phase_grams_multi or
// dm_u_phase_grams_multi_wide):
//   PREFIX_smem(itemsize, n_s, n_ct, n_u, weighted): the main pass's
//     shared memory in bytes (independent of B);
//   PREFIX_{f32,f64,bf16}(ydt, rtt, a1b, a1_stride, a2b, a2_stride, uut,
//     w, w_stride, scal, scal_stride, tab, partials, out, scratch, n, n_s,
//     n_ct, n_u, n_steps, n_members, lagged, stream): w the members'
//     weight rows (B, w_stride) or NULL (unweighted); bf16: bf16 data
//     with a float32 state and float32 weight rows.
#define DM_K4_ENTRY(PREFIX, SUFFIX, T, TD, WIDE)                             \
    int PREFIX##SUFFIX(const void* ydt, const void* rtt, const void* a1b,    \
                       long long a1_stride, const void* a2b,                 \
                       long long a2_stride, void* uut, const void* w,        \
                       long long w_stride, void* scal, int scal_stride,      \
                       void* tab, void* partials, void* out, void* scratch,  \
                       long long n, int n_s, int n_ct, int n_u, int n_steps, \
                       int n_members, int lagged, void* stream) {            \
        return dispatch<T, TD, WIDE>(ydt, rtt, a1b, a1_stride, a2b,          \
                                     a2_stride, uut, w, w_stride, scal,      \
                                     scal_stride, tab, partials, out,        \
                                     scratch, n, n_s, n_ct, n_u, n_steps,    \
                                     n_members, lagged, stream);             \
    }
#define DM_K4_EXPORTS(PREFIX, WIDE)                                          \
    extern "C" {                                                             \
    long long PREFIX##_smem(int itemsize, int n_s, int n_ct, int n_u,        \
                            int weighted) {                                  \
        return static_cast<long long>(                                       \
            smem_bytes(WIDE, itemsize, n_s, n_ct, n_u, weighted != 0));      \
    }                                                                        \
    DM_K4_ENTRY(PREFIX, _f32, float, float, WIDE)                            \
    DM_K4_ENTRY(PREFIX, _f64, double, double, WIDE)                          \
    DM_K4_ENTRY(PREFIX, _bf16, float, __nv_bfloat16, WIDE)                   \
    }
