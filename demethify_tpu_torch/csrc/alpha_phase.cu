// K9: the alpha FISTA loop on an assembled per-sample Gram system, for
// Hopper.
//
// Replaces the Pallas kernel demethify_tpu/ops/pallas_small.py
// :: _alpha_kernel (called through alpha_phase). In one launch: n_steps
// alpha FISTA steps from precomputed G (n_s, p, p) and b (p, n_s), each a
// momentum-capped gradient step followed by the simplex projection of
// every column, with an optional (p,) row mask (rows not > 0 set to
// -1e30 before each projection, pallas_small.py:86-87). Unlike K2 it
// assembles nothing and computes no cost or Lipschitz constant: l_h comes
// in as a scalar.
//
// What bounds it on an H100: latency. The data is tiny (p ~ 6, n_s ~ 10)
// and the n_steps steps are serial.
//
// What the design does about it: K2's forms and loops, so a column's
// arithmetic is K2's in every form. To 32 rows K2's register loop
// (glue_steps.cuh), one warp per sample column: lane q holds row q of
// G_s, b_s and the column in registers (the loops run to the row bucket
// P, 8, 16 or 32, the smallest >= p, as K2's; one thread block, a warp
// looping over columns when n_s > 32 or the kernel's registers allow
// fewer warps). From 33 to 64 rows K2's two-row form, a block a column
// (lane q holds rows q and q + 32, the warp's G_s in its slab of shared
// memory at an odd row stride, the betas from a momentum table the block
// builds once). Above 64 rows K2's column blocks (column_steps.cuh
// alpha_column_steps): a block, or a thread-block cluster of C <= 16
// blocks, a column, thread t of cluster block c owning row q = c R + t,
// G_s's rows transposed in the blocks' shared memory, v ranked across
// the cluster through distributed shared memory (K2's plan,
// dm::alpha_column_plan: one block to p = 166 in float64, 237 in
// float32, 16 to p = 624 and 904). Past 16 blocks K2's device rows: the
// same loop with each block's rows of G_s in its region of a device
// buffer the wrapper allocates (dm_alpha_column_work elements), up to
// 1024 threads a block, the rows of p in shared memory while they fit.
// Every form gives the one-warp wide loop's bits above 64 rows, and no
// shape is refused.
// The scalar chain the JAX wrapper replays on the host after the call
// (pallas_small.py:137-142) is replayed by one thread on the device, so
// the call reads nothing back: the scalars arrive in a small device vector
// (slots kPhA, kPhL = l_h, kPhLPrev = l_h_prev) and the advanced a and
// l_h_prev are written to its slots kPhAOut and kPhLPrevOut. alpha and
// alpha_prev are read from their inputs and written to separate outputs,
// so the inputs stay as they were.
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

// The register form (p <= P <= 32): one block, a warp a column, the
// warps looping over the columns
template <typename T, int P>
__global__ void alpha_phase_kernel(
        const T* __restrict__ G, const T* __restrict__ b,
        const T* __restrict__ alpha_in, const T* __restrict__ alpha_prev_in,
        T* __restrict__ alpha, T* __restrict__ alpha_prev,
        T* __restrict__ scal, const T* __restrict__ mask, int p, int n_s,
        int n_steps) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int n_warps = blockDim.x >> 5;
    const bool row = lane < p;
    const T a0 = scal[dm::kPhA];
    const T l_h = scal[dm::kPhL];
    const T l_prev0 = scal[dm::kPhLPrev];
    const long long pp = static_cast<long long>(p) * p;
    const bool masked = mask != nullptr && row && !(mask[lane] > T(0));
    for (int s = warp; s < n_s; s += n_warps) {
        T g[P];
#pragma unroll
        for (int r = 0; r < P; ++r)
            g[r] = (row && r < p) ? G[s * pp + lane * p + r] : T(0);
        const T bq = row ? b[lane * n_s + s] : T(0);
        T al = row ? alpha_in[lane * n_s + s] : T(0);
        T ap = row ? alpha_prev_in[lane * n_s + s] : T(0);
        dm::alpha_steps_reg(g, bq, al, ap, masked, lane, p,
                            static_cast<const T*>(nullptr), a0, l_prev0, l_h,
                            n_steps);
        if (row) {
            alpha[lane * n_s + s] = al;
            alpha_prev[lane * n_s + s] = ap;
        }
    }
    if (threadIdx.x == 0) dm::phase_scalars_out(scal, n_steps);
}

// The two-row form (32 < p <= 64), K2's loop on a grid: block s is one
// warp running column s, the column's G_s in the slab of dynamic shared
// memory (two_row_elems(p) values) and the momentum table, where
// use_table, after the slab. Block 0's thread 0 writes the scalar outputs
// (other slots than the ones every block reads).
template <typename T>
__global__ void __launch_bounds__(32) alpha_steps_two_row_kernel(
        const T* __restrict__ G, const T* __restrict__ b,
        const T* __restrict__ alpha_in, const T* __restrict__ alpha_prev_in,
        T* __restrict__ alpha, T* __restrict__ alpha_prev,
        T* __restrict__ scal, const T* __restrict__ mask, int p, int n_s,
        int n_steps, int use_table) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int lane = threadIdx.x;
    const int s = blockIdx.x;
    const int q1 = lane + 32;
    const bool row1 = q1 < p;
    const int ld = dm::two_row_stride(p);
    const long long pp = static_cast<long long>(p) * p;
    const T a0 = scal[dm::kPhA];
    const T l_h = scal[dm::kPhL];
    const T l_prev0 = scal[dm::kPhLPrev];

    T* sg = reinterpret_cast<T*>(smem_raw);
    for (int k = lane; k < pp; k += 32)
        sg[(k / p) * ld + k % p] = G[s * pp + k];
    const T b0 = b[lane * n_s + s];
    T al0 = alpha_in[lane * n_s + s];
    T ap0 = alpha_prev_in[lane * n_s + s];
    T b1 = T(0), al1 = T(0), ap1 = T(0);
    if (row1) {
        b1 = b[q1 * n_s + s];
        al1 = alpha_in[q1 * n_s + s];
        ap1 = alpha_prev_in[q1 * n_s + s];
    }
    __syncwarp();                          // the slab is written
    T* tab = use_table ? sg + dm::two_row_elems(p) : nullptr;
    if (use_table)
        dm::momentum_table(tab, a0, l_prev0, l_h, n_steps, lane, 32,
                           [] { __syncwarp(); });
    const bool masked0 = mask != nullptr && !(mask[lane] > T(0));
    const bool masked1 = mask != nullptr && row1 && !(mask[q1] > T(0));
    dm::alpha_steps_two_row(sg, b0, b1, al0, al1, ap0, ap1, masked0, masked1,
                            lane, p, tab, a0, l_prev0, l_h, n_steps);
    alpha[lane * n_s + s] = al0;
    alpha_prev[lane * n_s + s] = ap0;
    if (row1) {
        alpha[q1 * n_s + s] = al1;
        alpha_prev[q1 * n_s + s] = ap1;
    }
    if (s == 0 && lane == 0) dm::phase_scalars_out(scal, n_steps);
}

template <typename T>
int launch_two_row(const void* G, const void* b, const void* alpha_in,
                   const void* alpha_prev_in, void* alpha, void* alpha_prev,
                   void* scal, const void* mask, int p, int n_s, int n_steps,
                   cudaStream_t stream) {
    auto kern = alpha_steps_two_row_kernel<T>;
    size_t smem;
    int use_table;
    const int err = dm::two_row_smem(
        kern, sizeof(T), p, (static_cast<size_t>(n_steps) + 1) * sizeof(T),
        smem, use_table);
    if (err != 0) return err;
    kern<<<n_s, 32, smem, stream>>>(
        static_cast<const T*>(G), static_cast<const T*>(b),
        static_cast<const T*>(alpha_in), static_cast<const T*>(alpha_prev_in),
        static_cast<T*>(alpha), static_cast<T*>(alpha_prev),
        static_cast<T*>(scal), static_cast<const T*>(mask), p, n_s, n_steps,
        use_table);
    return static_cast<int>(cudaGetLastError());
}

namespace cg = cooperative_groups;

// The column-block form (p > 64): cluster s of C = gridDim.x / n_s blocks
// runs column s, block c of it rows [c R, c R + R), in K2's layout DEV
// (dm::alpha_column_plan; G_s's rows in the block's region of `work`
// past 16 blocks; the momentum table after the plan's bytes where
// use_table). Block 0's thread 0 writes the scalar outputs.
template <typename T, int DEV>
__global__ void __launch_bounds__(dm::column_threads(DEV))
alpha_phase_columns_kernel(
        const T* __restrict__ G, const T* __restrict__ b,
        const T* __restrict__ alpha_in, const T* __restrict__ alpha_prev_in,
        T* __restrict__ alpha, T* __restrict__ alpha_prev,
        T* __restrict__ scal, const T* __restrict__ mask,
        T* __restrict__ work, int p, int n_s, int n_steps, int rows,
        int use_table) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    cg::cluster_group cluster = cg::this_cluster();
    const int n_blocks = static_cast<int>(cluster.num_blocks());
    const int rank = static_cast<int>(cluster.block_rank());
    const int s = blockIdx.x / n_blocks;
    const int tid = threadIdx.x;
    const int n_threads = blockDim.x;
    const int q0 = rank * rows;
    const int own = p - q0 < rows ? p - q0 : rows;
    const int q = q0 + tid;
    const bool row = tid < own;
    const long long pp = static_cast<long long>(p) * p;
    const T a0 = scal[dm::kPhA];
    const T l_h = scal[dm::kPhL];
    const T l_prev0 = scal[dm::kPhLPrev];

    const dm::AlphaColumn<T> c = dm::alpha_column<DEV>(
        smem_raw,
        dm::column_region<DEV>(work, s, rank, n_blocks, rows, p,
                               dm::kAlphaPRows, dm::kAlphaRRows),
        rows, p, use_table);
    for (int k = tid; k < own * p; k += n_threads) {
        const int t = k / p;
        const int r = k - t * p;
        c.sg[r * rows + t] = G[s * pp + static_cast<long long>(q0 + t) * p
                               + r];
    }
    for (int r = tid; r < p; r += n_threads) {
        c.sal[r] = alpha_in[r * n_s + s];
        c.sap[r] = alpha_prev_in[r * n_s + s];
    }
    // row q0 + t's b and mask; the column blocks keep their one row's in
    // registers, the device rows read them each step
    auto b_of = [&](int t) { return b[(q0 + t) * n_s + s]; };
    auto masked_of = [&](int t) {
        return mask != nullptr && !(mask[q0 + t] > T(0));
    };
    const T bq = row ? b_of(tid) : T(0);
    const bool masked = row && masked_of(tid);
    dm::alpha_column_steps<DEV>(
        cluster, c,
        [&](int t) { return DEV == dm::kSharedRows ? bq : b_of(t); },
        [&](int t) { return DEV == dm::kSharedRows ? masked : masked_of(t); },
        own, q0, p, rows, a0, l_prev0, l_h, n_steps);
    const int per = dm::rows_per_thread<DEV>(rows, n_threads);
    for (int j = 0; j < per; ++j) {
        const int t = tid + j * n_threads;
        if (t < own) {
            const int qq = q0 + t;
            alpha[qq * n_s + s] = c.sal[qq];
            alpha_prev[qq * n_s + s] = c.sap[qq];
        }
    }
    if (blockIdx.x == 0 && tid == 0) dm::phase_scalars_out(scal, n_steps);
}

template <typename T, int P>
int launch_reg(const void* G, const void* b, const void* alpha_in,
               const void* alpha_prev_in, void* alpha, void* alpha_prev,
               void* scal, const void* mask, int p, int n_s, int n_steps,
               cudaStream_t stream) {
    auto kern = alpha_phase_kernel<T, P>;
    static const int max_warps = dm::max_block_warps(kern);
    const int w = n_s < 32 ? n_s : 32;
    const int n_warps = w < max_warps ? w : max_warps;
    kern<<<1, 32 * n_warps, 0, stream>>>(
        static_cast<const T*>(G), static_cast<const T*>(b),
        static_cast<const T*>(alpha_in), static_cast<const T*>(alpha_prev_in),
        static_cast<T*>(alpha), static_cast<T*>(alpha_prev),
        static_cast<T*>(scal), static_cast<const T*>(mask), p, n_s, n_steps);
    return static_cast<int>(cudaGetLastError());
}

// p > 64: K2's column blocks in K2's layout, past 16 blocks its device
// rows in `work` (dm_alpha_column_work elements)
template <typename T, int DEV>
int launch_columns(const void* G, const void* b, const void* alpha_in,
                   const void* alpha_prev_in, void* alpha, void* alpha_prev,
                   void* scal, const void* mask, void* work, int p, int n_s,
                   int n_steps, const dm::ColumnPlan& plan,
                   cudaStream_t stream) {
    const size_t tab = (static_cast<size_t>(n_steps) + 1) * sizeof(T);
    const int use_table = dm::column_table_fits(plan, tab);
    return dm::launch_column_blocks(
        alpha_phase_columns_kernel<T, DEV>, plan, n_s, 1,
        static_cast<size_t>(plan.bytes) + (use_table ? tab : 0), stream,
        static_cast<const T*>(G), static_cast<const T*>(b),
        static_cast<const T*>(alpha_in), static_cast<const T*>(alpha_prev_in),
        static_cast<T*>(alpha), static_cast<T*>(alpha_prev),
        static_cast<T*>(scal), static_cast<const T*>(mask),
        static_cast<T*>(work), p, n_s, n_steps, plan.rows, use_table);
}

template <typename T>
int launch_wide(const void* G, const void* b, const void* alpha_in,
                const void* alpha_prev_in, void* alpha, void* alpha_prev,
                void* scal, const void* mask, void* work, int p, int n_s,
                int n_steps, cudaStream_t stream) {
    const dm::ColumnPlan plan = dm::alpha_column_plan(sizeof(T), p);
    if (plan.device != dm::kSharedRows && work == nullptr)
        return static_cast<int>(cudaErrorInvalidValue);
#define DM_K9_COLUMNS(DEV)                                                   \
    launch_columns<T, DEV>(G, b, alpha_in, alpha_prev_in, alpha, alpha_prev, \
                           scal, mask, work, p, n_s, n_steps, plan, stream)
    if (plan.device == dm::kSharedRows) return DM_K9_COLUMNS(0);
    if (plan.device == dm::kDeviceRows) return DM_K9_COLUMNS(1);
    return DM_K9_COLUMNS(2);
#undef DM_K9_COLUMNS
}

template <typename T>
int launch(const void* G, const void* b, const void* alpha_in,
           const void* alpha_prev_in, void* alpha, void* alpha_prev,
           void* scal, const void* mask, void* work, int p, int n_s,
           int n_steps, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (p < 1 || n_s < 1) return static_cast<int>(cudaErrorInvalidValue);
    if (p > dm::kTwoRowP)
        return launch_wide<T>(G, b, alpha_in, alpha_prev_in, alpha,
                              alpha_prev, scal, mask, work, p, n_s, n_steps,
                              s);
    if (p > kMaxP)
        return launch_two_row<T>(G, b, alpha_in, alpha_prev_in, alpha,
                                 alpha_prev, scal, mask, p, n_s, n_steps, s);
#define DM_K9_BUCKET(P)                                                      \
    if (p <= P)                                                              \
        return launch_reg<T, P>(G, b, alpha_in, alpha_prev_in, alpha,        \
                                alpha_prev, scal, mask, p, n_s, n_steps, s);
    DM_K9_BUCKET(8)
    DM_K9_BUCKET(16)
    DM_K9_BUCKET(32)
#undef DM_K9_BUCKET
    return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// G (n_s, p, p), b (p, n_s), alpha/alpha_prev in and out (p, n_s), scal
// the 5-slot scalar vector; mask: the (p,) row mask or NULL; work: the
// device rows' buffer past 16 column blocks (dm_alpha_phase_plan form 3;
// dm_alpha_column_work elements), else unread
int dm_alpha_phase_f32(const void* G, const void* b, const void* alpha_in,
                       const void* alpha_prev_in, void* alpha,
                       void* alpha_prev, void* scal, const void* mask,
                       void* work, int p, int n_s, int n_steps,
                       void* stream) {
    return launch<float>(G, b, alpha_in, alpha_prev_in, alpha, alpha_prev,
                         scal, mask, work, p, n_s, n_steps, stream);
}

int dm_alpha_phase_f64(const void* G, const void* b, const void* alpha_in,
                       const void* alpha_prev_in, void* alpha,
                       void* alpha_prev, void* scal, const void* mask,
                       void* work, int p, int n_s, int n_steps,
                       void* stream) {
    return launch<double>(G, b, alpha_in, alpha_prev_in, alpha, alpha_prev,
                          scal, mask, work, p, n_s, n_steps, stream);
}

// K9's form at p rows of itemsize-byte values (dm::phase_plan on K2's
// column plan): out[0] the form (0 register, 1 two-row, 2 column blocks,
// 3 device rows), out[1] the row bucket, out[2-5] the column blocks, rows,
// threads and where the values live; returns a block's dynamic shared
// memory before the momentum table (ops/cuda_small.phase_plan is its
// Python copy)
long long dm_alpha_phase_plan(int itemsize, int p, int* out) {
    return dm::phase_plan(itemsize, p, dm::alpha_column_plan(itemsize, p),
                          out);
}

}  // extern "C"
