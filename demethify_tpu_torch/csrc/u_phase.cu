// K7: the single-phase U kernel, for Hopper.
//
// Replaces the Pallas kernel demethify_tpu/ops/pallas_kernels.py
// :: _u_phase_kernel (called through u_phase). One pass over the CpG
// axis, per site i (one thread each):
//
//   C[u] = sum_s a2[u,s] d_is (y_is - (a1' rt_i)_s)   (d_is y_is when there
//          is no known block), M[u][v] = sum_s (a2[u,s] a2[v,s]) d_is,
//   then n_steps FISTA steps on u_i:
//       beta = min((a-1)/a', 0.9999 sqrt(l_prev/l_w))
//       u_t  = u + beta (u - u_prev)
//       u    = clip(u_t + (C - M g) / l_w, 0, 1),  g = u_t, or the OLD u
//              when `lagged`
//
// This is K1's U phase (u_phase_common.cuh: the same C/M build and the
// same steps, dividing by l_w as pallas_kernels.py:103 does) with three
// differences that follow the JAX kernel: the known-block residual is
// associated d (y - a1' rt) (pallas_kernels.py:78-85; K1 forms
// d y - d (a1' rt)), the gram dataflow is taken at every n_u and n_s (the
// JAX kernel has no direct form), and there is no Gram stage: the new u
// and u_prev are written and nothing is summed across sites.
//
// What bounds it on an H100: memory traffic. It reads Y, D, Rt, u, u_prev
// once and writes u, u_prev: at 1M sites x 10 samples, 5 + 1 cell types
// in float32 ~116 MB, ~35 us at 3.35 TB/s; the arithmetic is a few
// hundred flops per site (the n_u^2 M terms per step dominate from
// n_u ~ 4).
//
// What the design does about it: one thread per site and 128 sites a
// block, the big arrays in the transposed (rows, N) layout so a warp's
// reads of each row are contiguous; C, M and the state in registers for
// n_u <= 8 (a template parameter); above, K1's n_u > 8 form
// (u_phase_common.cuh: build_cm_rows, gram_steps_rows) on this site's
// column of its block's state region, which lives in a device buffer the
// wrapper allocates (state_rows rows of kLd values a block), as K1's
// kGlobalState does: K7 keeps one layout, and no solver runs it. Only Rt is staged in shared memory (read n_s times per site by
// the residual); each site's Y and D are read straight from device
// memory, once, and the alpha entries as broadcasts. This is K1's wide
// layout. With no Gram stage nothing reuses staged Y and D, so K1's
// resident layout (Y, D and the alpha block staged too) bought nothing
// here: timed forced against this one on an H100 it was as fast or
// slower at every shape (PERF.md, K7), and it was removed. The momentum
// scalars, the same in every thread, come from K1's prologue
// (momentum_table_kernel, u_phase_common.cuh) on the single-phase slots:
// one thread writes the steps' betas into a small table that every thread
// reads one step ahead, and the advanced Nesterov scalar and previous
// Lipschitz constant into the scalar vector's output slots (kPhAOut,
// kPhLPrevOut), as the JAX wrapper replays them on the host after the
// call (pallas_kernels.py:196-204), so the host reads nothing. u and
// u_prev are read from their inputs and written to separate outputs, so
// the inputs stay as they were.
//
// bf16 storage (TD = __nv_bfloat16, T = float): each data value is
// converted once as it is read, and the float32 arithmetic follows, as
// the JAX kernel converts its blocks at load (pallas_kernels.py:73-74).
//
// Plain C interface (ctypes): pointers and the stream as void*, launches
// on that stream, allocates nothing, returns cudaGetLastError(). Pointers
// of an empty known block (n_ct = 0) are never dereferenced; `state` is
// read only by the n_u > 8 form.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "u_phase_common.cuh"

namespace {

using dm::kLd;
using dm::kSites;
using dm::RegVec;

template <typename T, typename TD, int NU>
__global__ void __launch_bounds__(kSites)
u_phase_kernel(const TD* __restrict__ yt, const TD* __restrict__ dt,
               const TD* __restrict__ rtt, const T* __restrict__ a1,
               const T* __restrict__ a2, const T* __restrict__ u_in,
               const T* __restrict__ up_in, T* __restrict__ u_out,
               T* __restrict__ up_out, const T* __restrict__ scal,
               const T* __restrict__ tab, T* __restrict__ state,
               int64_t n, int n_s, int n_ct,
               int n_u, int n_steps, int lagged) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* s_r = reinterpret_cast<T*>(smem_raw);    // n_ct rows: Rt

    const int tid = threadIdx.x;
    const int64_t i = static_cast<int64_t>(blockIdx.x) * kSites + tid;
    const bool live = i < n;
    dm::stage_rows(s_r, rtt, 0, n_ct, i, live, n, tid);
    dm::stage_wait();
    __syncthreads();
    if (!live) return;

    const T l_w = scal[dm::kPhL];
    auto run = [&](auto& u, auto& up, auto& cc, auto& m, auto& t1,
                   auto& t2) {
        dm::build_cm<T, NU, dm::kResidFirst>(cc, m, t1, n_u, yt + i, dt + i,
                                             n, s_r + tid, a1, a2, n_s,
                                             n_ct);
        if (lagged)
            dm::gram_steps<T, NU, true>(u, up, cc, m, t1, t2, n_u, tab, l_w,
                                        n_steps);
        else
            dm::gram_steps<T, NU, false>(u, up, cc, m, t1, t2, n_u, tab, l_w,
                                         n_steps);
    };
    if constexpr (NU > 0) {
        RegVec<T, NU> u, up, cc, t1, t2;
        RegVec<T, NU * (NU + 1) / 2> m;
#pragma unroll
        for (int v = 0; v < NU; ++v) {
            u[v] = u_in[v * n + i];
            up[v] = up_in[v * n + i];
        }
        run(u, up, cc, m, t1, t2);
#pragma unroll
        for (int v = 0; v < NU; ++v) {
            u_out[v * n + i] = u[v];
            up_out[v * n + i] = up[v];
        }
    } else {
        // this site's column of its block's state region: C and M built
        // first (the build stages its samples in the u vectors' rows),
        // then u and u_prev loaded into u vectors 0 and 1, the steps, and
        // the vectors that hold u and u_prev at the end written out
        T* st = state + static_cast<int64_t>(blockIdx.x)
                            * dm::state_rows(n_s, n_u, false) * kLd + tid;
        dm::build_cm_rows<T, dm::kResidFirst>(st, n_u, yt + i, dt + i, n,
                                              s_r + tid, a1, a2, n_s, n_ct);
        for (int v = 0; v < n_u; ++v) {
            st[v * kLd] = u_in[v * n + i];
            st[(n_u + v) * kLd] = up_in[v * n + i];
        }
        const int2 slot =
            lagged ? dm::gram_steps_rows<T, true>(st, n_u, tab, l_w, n_steps)
                   : dm::gram_steps_rows<T, false>(st, n_u, tab, l_w,
                                                   n_steps);
        for (int v = 0; v < n_u; ++v) {
            u_out[v * n + i] = st[(slot.x * n_u + v) * kLd];
            up_out[v * n + i] = st[(slot.y * n_u + v) * kLd];
        }
    }
}

// shared memory of the kernel: the n_ct staged rows of Rt; itemsize is
// the state's (the staged rows are of the state type whatever the data's)
size_t smem_bytes(size_t itemsize, int n_ct) {
    return itemsize * static_cast<size_t>(n_ct) * kLd;
}

template <typename T, typename TD, int NU>
int launch(const void* yt, const void* dt, const void* rtt, const void* a1b,
           const void* a2b, const void* u_in, const void* up_in, void* u_out,
           void* up_out, void* scal, void* tab, void* state, int64_t n,
           int n_s, int n_ct, int n_u, int n_steps, int lagged,
           cudaStream_t stream) {
    const int n_blocks = static_cast<int>((n + kSites - 1) / kSites);
    int err0 = dm::launch_momentum_table<T, true>(
        static_cast<T*>(scal), 0, 1, static_cast<T*>(tab), n_steps, stream);
    if (err0 != 0) return err0;
    const size_t smem = smem_bytes(sizeof(T), n_ct);
    auto kern = u_phase_kernel<T, TD, NU>;
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    kern<<<n_blocks, kSites, smem, stream>>>(
        static_cast<const TD*>(yt), static_cast<const TD*>(dt),
        static_cast<const TD*>(rtt), static_cast<const T*>(a1b),
        static_cast<const T*>(a2b), static_cast<const T*>(u_in),
        static_cast<const T*>(up_in), static_cast<T*>(u_out),
        static_cast<T*>(up_out), static_cast<const T*>(scal),
        static_cast<const T*>(tab), static_cast<T*>(state), n, n_s, n_ct,
        n_u, n_steps, lagged);
    return static_cast<int>(cudaGetLastError());
}

template <typename T, typename TD>
int dispatch(const void* yt, const void* dt, const void* rtt,
             const void* a1b, const void* a2b, const void* u_in,
             const void* up_in, void* u_out, void* up_out, void* scal,
             void* tab, void* state, int64_t n, int n_s, int n_ct, int n_u,
             int n_steps, int lagged, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
#define DM_K7_CASE(NU)                                                       \
    case NU:                                                                 \
        return launch<T, TD, NU>(yt, dt, rtt, a1b, a2b, u_in, up_in, u_out,  \
                                 up_out, scal, tab, state, n, n_s, n_ct,     \
                                 n_u, n_steps, lagged, st);
    switch (n_u) {
        DM_K7_CASE(1) DM_K7_CASE(2) DM_K7_CASE(3) DM_K7_CASE(4)
        DM_K7_CASE(5) DM_K7_CASE(6) DM_K7_CASE(7) DM_K7_CASE(8)
        default:
            if (n_u < 1 || state == nullptr)
                return static_cast<int>(cudaErrorInvalidValue);
            return launch<T, TD, 0>(yt, dt, rtt, a1b, a2b, u_in, up_in,
                                    u_out, up_out, scal, tab, state, n,
                                    n_s, n_ct, n_u, n_steps, lagged, st);
    }
#undef DM_K7_CASE
}

}  // namespace

// The C entry points:
//   dm_u_phase_smem(itemsize, n_ct): the kernel's shared memory in bytes
//     (itemsize is the state's), which the wrapper's plan matches;
//   dm_u_phase_{f32,f64,bf16}(yt, dt, rtt, a1b, a2b, u_in, up_in, u_out,
//     up_out, scal, tab, state, n, n_s, n_ct, n_u, n_steps, lagged,
//     stream): tab is room for the momentum table (n_steps + 1 values of
//     the state type); state (n_u > 8 only, NULL otherwise) n_blocks x
//     dm_state_rows(n_s, n_u, 0) x 129 values of the state type; bf16 is
//     bf16 data with a float32 state.
#define DM_K7_ENTRY(NAME, T, TD)                                             \
    int NAME(const void* yt, const void* dt, const void* rtt,                \
             const void* a1b, const void* a2b, const void* u_in,             \
             const void* up_in, void* u_out, void* up_out, void* scal,       \
             void* tab, void* state, long long n, int n_s, int n_ct,         \
             int n_u, int n_steps, int lagged, void* stream) {               \
        return dispatch<T, TD>(yt, dt, rtt, a1b, a2b, u_in, up_in, u_out,    \
                               up_out, scal, tab, state, n, n_s, n_ct,       \
                               n_u, n_steps, lagged, stream);                \
    }
extern "C" {
long long dm_u_phase_smem(int itemsize, int n_ct) {
    return static_cast<long long>(smem_bytes(itemsize, n_ct));
}
DM_K7_ENTRY(dm_u_phase_f32, float, float)
DM_K7_ENTRY(dm_u_phase_f64, double, double)
DM_K7_ENTRY(dm_u_phase_bf16, float, __nv_bfloat16)
}
#undef DM_K7_ENTRY
