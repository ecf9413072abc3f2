// K10: the Frank-Wolfe loop on an assembled per-sample Gram system, for
// Hopper.
//
// Replaces the Pallas kernel demethify_tpu/ops/pallas_small.py
// :: _fw_kernel (called through fw_phase; its schedule is _fw_run). In
// one launch: n_steps Frank-Wolfe steps on each column of
// alpha = [alpha1; alpha2] from precomputed G (n_s, p, p) and b (p, n_s):
// the gradient G_s a - b_s, the FIRST row of the smallest gradient in the
// known rows (q < p1, p1 = alpha1's rows) and in the unknown rows, the
// vertex purity_s e_idx1 + (1 - purity_s) e_idx2 and the step
// a = (1 - gamma) a + gamma vertex, gamma = 2 / (k + 2). Unlike K3 it
// assembles nothing and computes no cost.
//
// What bounds it on an H100: latency. The data is tiny and the schedule
// is a serial chain of steps (500 in the purity solve), each a
// matrix-vector product and two minima.
//
// What the design does about it: K3's loop (glue_steps.cuh) in one thread
// block, one warp per sample column: lane q holds row q of G_s, b_s and
// the column in registers (p <= 32), the product reads the column from
// the other lanes by shuffle and each block's minimum is a butterfly
// inside the warp, both over K3's row bucket (8, 16 or 32 lanes,
// dm::row_bucket), with the step sizes from a table divided once per
// launch, as K3; from 33 to 64 rows K3's two-row form, a block a column
// (lane q holds rows q and q + 32, the warp's G_s in its slab of
// shared memory at an odd row stride); above 64 rows the warp's column
// lives in its own slab of shared memory (the wide form, dm_glue_smem's
// size, one block). alpha1 and
// alpha2 are read from their inputs and written to separate outputs, so
// the inputs stay as they were and no stacked copy is made.
//
// Plain C interface (ctypes): pointers and the stream as void*, launches
// on that stream, allocates nothing, returns cudaGetLastError().

#include <cuda_runtime.h>

#include "glue_steps.cuh"
#include "small_common.cuh"

namespace {

using dm::kMaxP;

// alpha row q of column s: alpha1's rows first, then alpha2's
template <typename P>
__device__ __forceinline__ auto& alpha_at(P a1, P a2, int q, int s, int p1,
                                          int n_s) {
    return q < p1 ? a1[q * n_s + s] : a2[(q - p1) * n_s + s];
}

// the step-size table stays in shared memory up to this many bytes
constexpr size_t kTabSmem = 48 * 1024;

// P: the register form's row bucket (0 in the wide form)
template <typename T, bool WIDE, int P>
__global__ void fw_phase_kernel(
        const T* __restrict__ G, const T* __restrict__ b,
        const T* __restrict__ a1_in, const T* __restrict__ a2_in,
        T* __restrict__ a1, T* __restrict__ a2,
        const T* __restrict__ purity, int p, int p1, int n_s, int n_steps,
        int use_table) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int n_warps = blockDim.x >> 5;
    const bool row = lane < p;
    const long long pp = static_cast<long long>(p) * p;

    if constexpr (WIDE) {
        extern __shared__ __align__(16) unsigned char smem_raw[];
        T* sg = reinterpret_cast<T*>(smem_raw) + warp * dm::glue_warp_elems(p);
        T* sb = sg + pp;
        T* sal = sb + p;
        T* sgr = sal + p;
        for (int s = warp; s < n_s; s += n_warps) {
            for (long long k = lane; k < pp; k += 32) sg[k] = G[s * pp + k];
            for (int q = lane; q < p; q += 32) {
                sb[q] = b[q * n_s + s];
                sal[q] = alpha_at(a1_in, a2_in, q, s, p1, n_s);
            }
            __syncwarp();
            const T pur = purity[s];
            dm::fw_steps_wide(sg, sb, sal, sgr, lane, p, p1, pur, T(1) - pur,
                              n_steps);
            for (int q = lane; q < p; q += 32)
                alpha_at(a1, a2, q, s, p1, n_s) = sal[q];
            __syncwarp();    // the slab is free for the next column
        }
    } else {
        extern __shared__ __align__(16) unsigned char smem_raw[];
        T* tab = use_table ? reinterpret_cast<T*>(smem_raw) : nullptr;
        if (use_table) {
            dm::fw_gamma_table(tab, n_steps, static_cast<int>(threadIdx.x),
                               static_cast<int>(blockDim.x));
            __syncthreads();
        }
        for (int s = warp; s < n_s; s += n_warps) {
            T g[P];
#pragma unroll
            for (int r = 0; r < P; ++r)
                g[r] = (row && r < p) ? G[s * pp + lane * p + r] : T(0);
            const T bq = row ? b[lane * n_s + s] : T(0);
            T al = row ? alpha_at(a1_in, a2_in, lane, s, p1, n_s) : T(0);
            const T pur = purity[s];
            dm::fw_steps_reg(g, bq, al, lane, p, p1, pur, T(1) - pur, tab,
                             n_steps);
            if (row) alpha_at(a1, a2, lane, s, p1, n_s) = al;
        }
    }
}

// The two-row form (32 < p <= 64), K3's loop on a grid: block s is one
// warp running column s, the column's G_s in the slab of dynamic shared
// memory and the step-size table, where use_table, after the slab.
template <typename T>
__global__ void __launch_bounds__(32) fw_steps_two_row_kernel(
        const T* __restrict__ G, const T* __restrict__ b,
        const T* __restrict__ a1_in, const T* __restrict__ a2_in,
        T* __restrict__ a1, T* __restrict__ a2,
        const T* __restrict__ purity, int p, int p1, int n_s, int n_steps,
        int use_table) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int lane = threadIdx.x;
    const int s = blockIdx.x;
    const int q1 = lane + 32;
    const bool row1 = q1 < p;
    const int ld = dm::two_row_stride(p);
    const long long pp = static_cast<long long>(p) * p;

    T* sg = reinterpret_cast<T*>(smem_raw);
    for (int k = lane; k < pp; k += 32)
        sg[(k / p) * ld + k % p] = G[s * pp + k];
    const T b0 = b[lane * n_s + s];
    T al0 = alpha_at(a1_in, a2_in, lane, s, p1, n_s);
    T b1 = T(0), al1 = T(0);
    if (row1) {
        b1 = b[q1 * n_s + s];
        al1 = alpha_at(a1_in, a2_in, q1, s, p1, n_s);
    }
    T* tab = use_table ? sg + dm::two_row_elems(p) : nullptr;
    if (use_table) dm::fw_gamma_table(tab, n_steps, lane, 32);
    __syncwarp();                          // the slab and table are written
    const T pur = purity[s];
    dm::fw_steps_two_row(sg, b0, b1, al0, al1, lane, p, p1, pur, T(1) - pur,
                         tab, n_steps);
    alpha_at(a1, a2, lane, s, p1, n_s) = al0;
    if (row1) alpha_at(a1, a2, q1, s, p1, n_s) = al1;
}

template <typename T>
int launch_two_row(const void* G, const void* b, const void* a1_in,
                   const void* a2_in, void* a1, void* a2, const void* purity,
                   int p, int p1, int n_s, int n_steps, cudaStream_t stream) {
    auto kern = fw_steps_two_row_kernel<T>;
    size_t smem;
    int use_table;
    const int err = dm::two_row_smem(
        kern, sizeof(T), p, static_cast<size_t>(n_steps) * sizeof(T), smem,
        use_table);
    if (err != 0) return err;
    kern<<<n_s, 32, smem, stream>>>(
        static_cast<const T*>(G), static_cast<const T*>(b),
        static_cast<const T*>(a1_in), static_cast<const T*>(a2_in),
        static_cast<T*>(a1), static_cast<T*>(a2),
        static_cast<const T*>(purity), p, p1, n_s, n_steps, use_table);
    return static_cast<int>(cudaGetLastError());
}

template <typename T, bool WIDE, int P>
int launch_form(const void* G, const void* b, const void* a1_in,
                const void* a2_in, void* a1, void* a2, const void* purity,
                int p, int p1, int n_s, int n_steps, cudaStream_t stream) {
    auto kern = fw_phase_kernel<T, WIDE, P>;
    static const int max_warps = dm::max_block_warps(kern);
    int n_warps = n_s < 32 ? n_s : 32;
    n_warps = n_warps < max_warps ? n_warps : max_warps;
    size_t smem = 0;
    int use_table = 0;
    if constexpr (!WIDE) {
        const size_t tab = static_cast<size_t>(n_steps) * sizeof(T);
        use_table = tab <= kTabSmem;
        smem = use_table ? tab : 0;
    } else {
        const int fit = dm::glue_warps(sizeof(T), p, n_s);
        if (fit < 1) return static_cast<int>(cudaErrorInvalidValue);
        n_warps = fit < n_warps ? fit : n_warps;
        smem = n_warps * dm::glue_warp_elems(p) * sizeof(T);
        if (smem > 48 * 1024) {
            cudaError_t err = cudaFuncSetAttribute(
                kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                static_cast<int>(smem));
            if (err != cudaSuccess) return static_cast<int>(err);
        }
    }
    kern<<<1, 32 * n_warps, smem, stream>>>(
        static_cast<const T*>(G), static_cast<const T*>(b),
        static_cast<const T*>(a1_in), static_cast<const T*>(a2_in),
        static_cast<T*>(a1), static_cast<T*>(a2),
        static_cast<const T*>(purity), p, p1, n_s, n_steps, use_table);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* G, const void* b, const void* a1_in,
           const void* a2_in, void* a1, void* a2, const void* purity, int p,
           int p1, int n_s, int n_steps, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (p1 < 1 || p1 >= p || n_s < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    if (p > dm::kTwoRowP)
        return launch_form<T, true, 0>(G, b, a1_in, a2_in, a1, a2, purity, p,
                                       p1, n_s, n_steps, s);
    if (p > kMaxP)
        return launch_two_row<T>(G, b, a1_in, a2_in, a1, a2, purity, p, p1,
                                 n_s, n_steps, s);
    switch (dm::row_bucket(p)) {
        case 8:
            return launch_form<T, false, 8>(G, b, a1_in, a2_in, a1, a2,
                                            purity, p, p1, n_s, n_steps, s);
        case 16:
            return launch_form<T, false, 16>(G, b, a1_in, a2_in, a1, a2,
                                             purity, p, p1, n_s, n_steps, s);
        default:
            return launch_form<T, false, kMaxP>(G, b, a1_in, a2_in, a1, a2,
                                                purity, p, p1, n_s, n_steps,
                                                s);
    }
}

}  // namespace

extern "C" {

// G (n_s, p, p), b (p, n_s), alpha1 (p1, n_s) and alpha2 (p - p1, n_s)
// in and out, purity (n_s,)
int dm_fw_phase_f32(const void* G, const void* b, const void* a1_in,
                    const void* a2_in, void* a1, void* a2,
                    const void* purity, int p, int p1, int n_s, int n_steps,
                    void* stream) {
    return launch<float>(G, b, a1_in, a2_in, a1, a2, purity, p, p1, n_s,
                         n_steps, stream);
}

int dm_fw_phase_f64(const void* G, const void* b, const void* a1_in,
                    const void* a2_in, void* a1, void* a2,
                    const void* purity, int p, int p1, int n_s, int n_steps,
                    void* stream) {
    return launch<double>(G, b, a1_in, a2_in, a1, a2, purity, p, p1, n_s,
                          n_steps, stream);
}

}  // extern "C"
