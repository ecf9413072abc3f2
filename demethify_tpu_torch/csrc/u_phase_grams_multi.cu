// K4: the multi-member U-phase megakernel of the batched random restarts,
// for Hopper.
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
// site: the C/M build, n_steps dependent FISTA steps (each replaying the
// momentum chain: two IEEE divisions and two square roots) and the Gram
// partial sums over the block's sites -- about 2,500 instructions a site
// and member at 20 steps.
//
// What the design does about it:
//   - one block per 128 sites, as K1: the block stages its sites' Y, D and
//     Rt columns in shared memory ONCE and then loops over the members, so
//     Y, D and Rt are read from device memory once for all B members (the
//     TPU kernel's member axis buys the same);
//   - per member the block loads that member's alpha blocks into shared
//     memory, builds C and M in registers and runs the steps with K1's
//     code (u_phase_common.cuh), so the per-thread register footprint is
//     K1's whatever B is and every member follows K1's arithmetic bit for
//     bit;
//   - the Gram partials go to per-block columns of a
//     (B x E, n_blocks) buffer (E = n_s n_u p + n_u n_s + 1 entries per
//     member) and K1's fixed-order reduction kernel sums each row and
//     advances each active member's scalars: no float atomics, so every
//     member's sums are K1's sums. The buffer is B E n_blocks itemsize
//     bytes, written and read back once an iteration: 35 MB at the shape
//     above (10% of the bytes the kernel must move);
//   - shared memory is K1's (one member's alpha blocks at a time), so it
//     does not grow with B.
//
// bf16 storage (pallas_kernels.py:835-836, 853: the data converted at
// load, the state float32): Y, D and Rt arrive as __nv_bfloat16 (TD) with
// a float32 state and weight rows (T); stage_sites converts each value
// once, and from there on every member runs the float32 form's
// arithmetic on the converted values (u_phase_common.cuh). It halves the
// bytes of Y, D and Rt (50 MB instead of 100 MB per outer iteration at the
// shape above), against a bound set by the operations, so the expected
// gain is small.
//
// Scalars: `scal` is (B, scal_stride) with K1's slots per member (kAU,
// kLW, kLWPrev read) plus kActive. Weights: `w` is (B, w_stride), NULL for
// the unweighted form.
//
// Plain C interface (ctypes): pointers and the stream as void*, launches
// on that stream, allocates nothing, returns cudaGetLastError(). Pointers
// of an empty known block (n_ct = 0) are never dereferenced.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "u_phase_common.cuh"

namespace {

using dm::kLd;
using dm::kRedThreads;
using dm::kSites;

template <typename T, typename TD, int NU, bool W>
__global__ void __launch_bounds__(kSites)
u_phase_grams_multi_kernel(
        const TD* __restrict__ ydt, const TD* __restrict__ rtt,
        const T* __restrict__ a1b, int64_t a1_stride,
        const T* __restrict__ a2b, int64_t a2_stride, T* __restrict__ uut,
        const T* __restrict__ w, int64_t w_stride,
        const T* __restrict__ scal, int scal_stride,
        T* __restrict__ partials, int64_t n, int n_s, int n_ct, int n_steps,
        int n_blocks, int n_members, int lagged) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* s_y = reinterpret_cast<T*>(smem_raw);   // n_s rows
    T* s_d = s_y + n_s * kLd;                   // n_s rows
    T* s_r = s_d + n_s * kLd;                   // n_ct + NU rows: [Rt | u_b]
    T* s_a1 = s_r + (n_ct + NU) * kLd;          // member b's (n_ct, n_s)
    T* s_a2 = s_a1 + n_ct * n_s;                // member b's (NU, n_s)
    T* s_wu = s_a2 + NU * n_s;                  // member b's w u rows (W)

    const int tid = threadIdx.x;
    const int64_t i = static_cast<int64_t>(blockIdx.x) * kSites + tid;
    const bool live = i < n;
    dm::stage_sites(s_y, s_d, s_r, ydt, rtt, i, live, n, n_s, n_ct, tid);
    const int n_entries = dm::gram_entries(n_s, n_ct, NU);

    for (int b = 0; b < n_members; ++b) {
        const T* sc = scal + static_cast<int64_t>(b) * scal_stride;
        if (sc[dm::kActive] == T(0)) continue;      // uniform per block
        __syncthreads();     // the previous member's Gram sums are done
        for (int k = tid; k < n_ct * n_s; k += kSites)
            s_a1[k] = a1b[b * a1_stride + k];
        for (int k = tid; k < NU * n_s; k += kSites)
            s_a2[k] = a2b[b * a2_stride + k];
        __syncthreads();

        T* ub = uut + static_cast<int64_t>(b) * (2 * NU) * n;
        T u[NU], up[NU];
#pragma unroll
        for (int v = 0; v < NU; ++v) {
            u[v] = live ? ub[v * n + i] : T(0);
            up[v] = live ? ub[(NU + v) * n + i] : T(0);
        }
        T cc[NU], m[NU * (NU + 1) / 2];
        dm::build_cm(cc, m, s_y, s_d, s_r, s_a1, s_a2, n_s, n_ct, tid);
        if (lagged)
            dm::gram_steps<T, NU, true>(u, up, cc, m, sc[dm::kAU],
                                        sc[dm::kLWPrev], sc[dm::kLW],
                                        n_steps);
        else
            dm::gram_steps<T, NU, false>(u, up, cc, m, sc[dm::kAU],
                                         sc[dm::kLWPrev], sc[dm::kLW],
                                         n_steps);
#pragma unroll
        for (int v = 0; v < NU; ++v) {
            if (live) {
                ub[v * n + i] = u[v];
                ub[(NU + v) * n + i] = up[v];
            }
            s_r[(n_ct + v) * kLd + tid] = live ? u[v] : T(0);
        }
        if constexpr (W) {
            const T wi = live ? w[static_cast<int64_t>(b) * w_stride + i]
                              : T(0);
#pragma unroll
            for (int v = 0; v < NU; ++v)
                s_wu[v * kLd + tid] = live ? wi * u[v] : T(0);
        }
        __syncthreads();
        dm::gram_partials<T, NU, W>(
            s_y, s_d, s_r, n_s, n_ct, tid,
            partials + static_cast<int64_t>(b) * n_entries * n_blocks
                + blockIdx.x,
            n_blocks, s_wu);
    }
}

size_t smem_bytes(size_t itemsize, int n_s, int n_ct, int n_u,
                  bool weighted) {
    const size_t p = static_cast<size_t>(n_ct + n_u);
    return itemsize * ((2 * static_cast<size_t>(n_s) + p) * kLd + p * n_s
                       + (weighted ? n_u * kLd : 0));
}

template <typename T, typename TD, int NU, bool W>
int launch(const void* ydt, const void* rtt, const void* a1b,
           int64_t a1_stride, const void* a2b, int64_t a2_stride, void* uut,
           const void* w, int64_t w_stride, void* scal, int scal_stride,
           void* partials, void* out, int64_t n, int n_s, int n_ct,
           int n_steps, int n_members, int lagged, cudaStream_t stream) {
    const int n_blocks = static_cast<int>((n + kSites - 1) / kSites);
    const int n_entries = dm::gram_entries(n_s, n_ct, NU);
    const size_t smem = smem_bytes(sizeof(T), n_s, n_ct, NU, W);
    auto kern = u_phase_grams_multi_kernel<T, TD, NU, W>;
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
        static_cast<const T*>(scal), scal_stride, static_cast<T*>(partials),
        n, n_s, n_ct, n_steps, n_blocks, n_members, lagged);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    dm::reduce_partials_kernel<T, true>
        <<<n_members * n_entries, kRedThreads, 0, stream>>>(
            static_cast<const T*>(partials), static_cast<T*>(out),
            static_cast<T*>(scal), n_blocks, n_steps, n_entries,
            scal_stride);
    return static_cast<int>(cudaGetLastError());
}

template <typename T, typename TD, bool W>
int dispatch_nu(const void* ydt, const void* rtt, const void* a1b,
                long long a1_stride, const void* a2b, long long a2_stride,
                void* uut, const void* w, long long w_stride, void* scal,
                int scal_stride, void* partials, void* out, long long n,
                int n_s, int n_ct, int n_u, int n_steps, int n_members,
                int lagged, cudaStream_t st) {
#define DM_K4_CASE(NU)                                                      \
    case NU:                                                                \
        return launch<T, TD, NU, W>(ydt, rtt, a1b, a1_stride, a2b,          \
                                    a2_stride, uut, w, w_stride, scal,      \
                                    scal_stride, partials, out, n, n_s,     \
                                    n_ct, n_steps, n_members, lagged, st);
    switch (n_u) {
        DM_K4_CASE(1) DM_K4_CASE(2) DM_K4_CASE(3) DM_K4_CASE(4)
        DM_K4_CASE(5) DM_K4_CASE(6) DM_K4_CASE(7) DM_K4_CASE(8)
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
#undef DM_K4_CASE
}

template <typename T, typename TD>
int dispatch(const void* ydt, const void* rtt, const void* a1b,
             long long a1_stride, const void* a2b, long long a2_stride,
             void* uut, const void* w, long long w_stride, void* scal,
             int scal_stride, void* partials, void* out, long long n,
             int n_s, int n_ct, int n_u, int n_steps, int n_members,
             int lagged, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (w != nullptr)
        return dispatch_nu<T, TD, true>(ydt, rtt, a1b, a1_stride, a2b,
                                    a2_stride, uut, w, w_stride, scal,
                                    scal_stride, partials, out, n, n_s, n_ct,
                                    n_u, n_steps, n_members, lagged, st);
    return dispatch_nu<T, TD, false>(ydt, rtt, a1b, a1_stride, a2b, a2_stride,
                                 uut, w, w_stride, scal, scal_stride,
                                 partials, out, n, n_s, n_ct, n_u, n_steps,
                                 n_members, lagged, st);
}

}  // namespace

extern "C" {

// Shared memory the main pass needs, in bytes (independent of B).
long long dm_u_phase_grams_multi_smem(int itemsize, int n_s, int n_ct,
                                      int n_u, int weighted) {
    return static_cast<long long>(
        smem_bytes(itemsize, n_s, n_ct, n_u, weighted != 0));
}

// w: the members' weight rows (B, w_stride), or NULL (unweighted).
int dm_u_phase_grams_multi_f32(const void* ydt, const void* rtt,
                               const void* a1b, long long a1_stride,
                               const void* a2b, long long a2_stride,
                               void* uut, const void* w, long long w_stride,
                               void* scal, int scal_stride, void* partials,
                               void* out, long long n, int n_s, int n_ct,
                               int n_u, int n_steps, int n_members,
                               int lagged, void* stream) {
    return dispatch<float, float>(ydt, rtt, a1b, a1_stride, a2b, a2_stride,
                                  uut, w, w_stride, scal, scal_stride,
                                  partials, out, n, n_s, n_ct, n_u, n_steps,
                                  n_members, lagged, stream);
}

int dm_u_phase_grams_multi_f64(const void* ydt, const void* rtt,
                               const void* a1b, long long a1_stride,
                               const void* a2b, long long a2_stride,
                               void* uut, const void* w, long long w_stride,
                               void* scal, int scal_stride, void* partials,
                               void* out, long long n, int n_s, int n_ct,
                               int n_u, int n_steps, int n_members,
                               int lagged, void* stream) {
    return dispatch<double, double>(ydt, rtt, a1b, a1_stride, a2b,
                                    a2_stride, uut, w, w_stride, scal,
                                    scal_stride, partials, out, n, n_s, n_ct,
                                    n_u, n_steps, n_members, lagged, stream);
}

// bf16 data (ydt, rtt) with a float32 state and float32 weight rows
int dm_u_phase_grams_multi_bf16(const void* ydt, const void* rtt,
                                const void* a1b, long long a1_stride,
                                const void* a2b, long long a2_stride,
                                void* uut, const void* w, long long w_stride,
                                void* scal, int scal_stride, void* partials,
                                void* out, long long n, int n_s, int n_ct,
                                int n_u, int n_steps, int n_members,
                                int lagged, void* stream) {
    return dispatch<float, __nv_bfloat16>(
        ydt, rtt, a1b, a1_stride, a2b, a2_stride, uut, w, w_stride, scal,
        scal_stride, partials, out, n, n_s, n_ct, n_u, n_steps, n_members,
        lagged, stream);
}

}  // extern "C"
