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
// What the design does about it: K3's forms and loops, so a column's
// alpha is K3's in every form. To 32 rows K3's register loop
// (glue_steps.cuh) in one thread block, one warp per sample column: lane
// q holds row q of G_s, b_s and the column in registers, the product
// reads the column from the other lanes by shuffle and each block's
// minimum is a butterfly inside the warp, both over K3's row bucket (8,
// 16 or 32 lanes, dm::row_bucket), with the step sizes from a table
// divided once per launch. From 33 to 64 rows K3's two-row form, a block
// a column (lane q holds rows q and q + 32, the warp's G_s in its slab of
// shared memory at an odd row stride). Above 64 rows K3's column blocks
// (column_steps.cuh fw_column_steps): a block, or a thread-block cluster
// of C <= 16 blocks, a column, thread t of cluster block c owning row
// q = c R + t, G_s's rows transposed in the blocks' shared memory, the
// warps' minima folded through distributed shared memory (K3's plan,
// dm::fw_column_plan: one block to p = 168 in float64, 239 in float32,
// 16 to p = 670 and 946). Past 16 blocks K3's device rows: the same loop
// with each block's rows of G_s in its region of a device buffer the
// wrapper allocates (dm_fw_column_work elements), up to 1024 threads a
// block, a thread's rows' b and gradients in K3's rows of R values.
// Every form gives the one-warp wide loop's bits above 64 rows, and no
// shape is refused.
// alpha1 and alpha2 are read from their inputs and written to separate
// outputs, so the inputs stay as they were and no stacked copy is made.
//
// Plain C interface (ctypes): pointers and the stream as void*, launches
// on that stream, allocates nothing, returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "column_steps.cuh"
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

// The register form (p <= P <= 32): one block, a warp a column, the
// warps looping over the columns; the step sizes from a table in shared
// memory where use_table
template <typename T, int P>
__global__ void fw_phase_kernel(
        const T* __restrict__ G, const T* __restrict__ b,
        const T* __restrict__ a1_in, const T* __restrict__ a2_in,
        T* __restrict__ a1, T* __restrict__ a2,
        const T* __restrict__ purity, int p, int p1, int n_s, int n_steps,
        int use_table) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int n_warps = blockDim.x >> 5;
    const bool row = lane < p;
    const long long pp = static_cast<long long>(p) * p;
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

namespace cg = cooperative_groups;

// The column-block form (p > 64): cluster s of C = gridDim.x / n_s blocks
// runs column s, block c of it rows [c R, c R + R), one a thread, in K3's
// layout DEV (dm::fw_column_plan; G_s's rows in the block's region of
// `work` past 16 blocks, with the rows' b and gradients).
template <typename T, int DEV>
__global__ void __launch_bounds__(dm::column_threads(DEV))
fw_phase_columns_kernel(
        const T* __restrict__ G, const T* __restrict__ b,
        const T* __restrict__ a1_in, const T* __restrict__ a2_in,
        T* __restrict__ a1, T* __restrict__ a2,
        const T* __restrict__ purity, T* __restrict__ work, int p, int p1,
        int n_s, int n_steps, int rows) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    cg::cluster_group cluster = cg::this_cluster();
    const int n_blocks = static_cast<int>(cluster.num_blocks());
    const int s = blockIdx.x / n_blocks;
    const int tid = threadIdx.x;
    const int rank = static_cast<int>(cluster.block_rank());
    const int q0 = rank * rows;
    const int own = p - q0 < rows ? p - q0 : rows;
    const int q = q0 + tid;
    const bool row = tid < own;
    const long long pp = static_cast<long long>(p) * p;

    T* region = dm::column_region<DEV>(work, s, rank, n_blocks, rows, p,
                                       dm::kFwPRows, dm::kFwRRows);
    T* sg = dm::column_gram<DEV>(smem_raw, region);  // rows x p, transposed
    T* sal = dm::column_line<DEV>(smem_raw, region, rows, p);  // alpha (p)
    T* sb = sal + p;                                // the rows' b (DEV)
    T* sgr = sb + rows;                             // their gradients (DEV)
    for (int k = tid; k < own * p; k += blockDim.x) {
        const int t = k / p;
        const int r = k - t * p;
        sg[r * rows + t] = G[s * pp + static_cast<long long>(q0 + t) * p + r];
    }
    for (int r = tid; r < p; r += blockDim.x)
        sal[r] = alpha_at(a1_in, a2_in, r, s, p1, n_s);
    const T bq = row ? b[q * n_s + s] : T(0);
    if constexpr (DEV != dm::kSharedRows) {
        for (int t = tid; t < own; t += blockDim.x)
            sb[t] = b[(q0 + t) * n_s + s];
    }
    const T pur = purity[s];
    __shared__ dm::WarpMin<T> red[2][dm::column_threads(DEV) / 32];
    __syncthreads();
    dm::fw_column_steps<T, DEV>(cluster, n_blocks, red, sg, sal, bq, row,
                                q < p1, q0, tid, tid & 31, tid >> 5,
                                static_cast<int>(blockDim.x >> 5), p, rows,
                                pur, T(1) - pur, n_steps, sb, sgr, own, p1);
    const int per = dm::rows_per_thread<DEV>(rows, blockDim.x);
    for (int j = 0; j < per; ++j) {
        const int t = tid + j * static_cast<int>(blockDim.x);
        if (t < own) alpha_at(a1, a2, q0 + t, s, p1, n_s) = sal[q0 + t];
    }
    // no block leaves while another may still read its last minima
    if (n_blocks > 1) cluster.sync();
}

template <typename T, int P>
int launch_reg(const void* G, const void* b, const void* a1_in,
               const void* a2_in, void* a1, void* a2, const void* purity,
               int p, int p1, int n_s, int n_steps, cudaStream_t stream) {
    auto kern = fw_phase_kernel<T, P>;
    static const int max_warps = dm::max_block_warps(kern);
    const int w = n_s < 32 ? n_s : 32;
    const int n_warps = w < max_warps ? w : max_warps;
    const size_t tab = static_cast<size_t>(n_steps) * sizeof(T);
    const int use_table = tab <= kTabSmem;
    kern<<<1, 32 * n_warps, use_table ? tab : 0, stream>>>(
        static_cast<const T*>(G), static_cast<const T*>(b),
        static_cast<const T*>(a1_in), static_cast<const T*>(a2_in),
        static_cast<T*>(a1), static_cast<T*>(a2),
        static_cast<const T*>(purity), p, p1, n_s, n_steps, use_table);
    return static_cast<int>(cudaGetLastError());
}

// p > 64: K3's column blocks in K3's layout, past 16 blocks its device
// rows in `work` (dm_fw_column_work elements)
template <typename T, int DEV>
int launch_columns(const void* G, const void* b, const void* a1_in,
                   const void* a2_in, void* a1, void* a2, const void* purity,
                   void* work, int p, int p1, int n_s, int n_steps,
                   const dm::ColumnPlan& plan, cudaStream_t stream) {
    return dm::launch_column_blocks(
        fw_phase_columns_kernel<T, DEV>, plan, n_s, 1,
        static_cast<size_t>(plan.bytes), stream, static_cast<const T*>(G),
        static_cast<const T*>(b), static_cast<const T*>(a1_in),
        static_cast<const T*>(a2_in), static_cast<T*>(a1),
        static_cast<T*>(a2), static_cast<const T*>(purity),
        static_cast<T*>(work), p, p1, n_s, n_steps, plan.rows);
}

template <typename T>
int launch_wide(const void* G, const void* b, const void* a1_in,
                const void* a2_in, void* a1, void* a2, const void* purity,
                void* work, int p, int p1, int n_s, int n_steps,
                cudaStream_t stream) {
    const dm::ColumnPlan plan = dm::fw_column_plan(sizeof(T), p);
    if (plan.device != dm::kSharedRows && work == nullptr)
        return static_cast<int>(cudaErrorInvalidValue);
#define DM_K10_COLUMNS(DEV)                                                  \
    launch_columns<T, DEV>(G, b, a1_in, a2_in, a1, a2, purity, work, p, p1,  \
                           n_s, n_steps, plan, stream)
    if (plan.device == dm::kSharedRows) return DM_K10_COLUMNS(0);
    if (plan.device == dm::kDeviceRows) return DM_K10_COLUMNS(1);
    return DM_K10_COLUMNS(2);
#undef DM_K10_COLUMNS
}

template <typename T>
int launch(const void* G, const void* b, const void* a1_in,
           const void* a2_in, void* a1, void* a2, const void* purity,
           void* work, int p, int p1, int n_s, int n_steps, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (p1 < 1 || p1 >= p || n_s < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    if (p > dm::kTwoRowP)
        return launch_wide<T>(G, b, a1_in, a2_in, a1, a2, purity, work, p,
                              p1, n_s, n_steps, s);
    if (p > kMaxP)
        return launch_two_row<T>(G, b, a1_in, a2_in, a1, a2, purity, p, p1,
                                 n_s, n_steps, s);
    switch (dm::row_bucket(p)) {
        case 8:
            return launch_reg<T, 8>(G, b, a1_in, a2_in, a1, a2, purity, p,
                                    p1, n_s, n_steps, s);
        case 16:
            return launch_reg<T, 16>(G, b, a1_in, a2_in, a1, a2, purity, p,
                                     p1, n_s, n_steps, s);
        default:
            return launch_reg<T, kMaxP>(G, b, a1_in, a2_in, a1, a2, purity,
                                        p, p1, n_s, n_steps, s);
    }
}

}  // namespace

extern "C" {

// G (n_s, p, p), b (p, n_s), alpha1 (p1, n_s) and alpha2 (p - p1, n_s)
// in and out, purity (n_s,); work: the device rows' buffer past 16
// column blocks (dm_fw_phase_plan form 3; dm_fw_column_work elements),
// else unread
int dm_fw_phase_f32(const void* G, const void* b, const void* a1_in,
                    const void* a2_in, void* a1, void* a2,
                    const void* purity, void* work, int p, int p1, int n_s,
                    int n_steps, void* stream) {
    return launch<float>(G, b, a1_in, a2_in, a1, a2, purity, work, p, p1,
                         n_s, n_steps, stream);
}

int dm_fw_phase_f64(const void* G, const void* b, const void* a1_in,
                    const void* a2_in, void* a1, void* a2,
                    const void* purity, void* work, int p, int p1, int n_s,
                    int n_steps, void* stream) {
    return launch<double>(G, b, a1_in, a2_in, a1, a2, purity, work, p, p1,
                          n_s, n_steps, stream);
}

// K10's form at p rows of itemsize-byte values (dm::phase_plan on K3's
// column plan), as dm_alpha_phase_plan's (ops/cuda_small.phase_plan is its
// Python copy)
long long dm_fw_phase_plan(int itemsize, int p, int* out) {
    return dm::phase_plan(itemsize, p, dm::fw_column_plan(itemsize, p), out);
}

}  // extern "C"
