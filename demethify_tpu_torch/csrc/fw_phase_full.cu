// K3 and K6: the Frank-Wolfe glue kernel of the purity-constrained
// solve, for Hopper; K6 is its member-gridded form for the batched random
// restarts.
//
// K3 replaces the Pallas kernel demethify_tpu/ops/pallas_small.py
// :: _fw_full_kernel (called through fw_phase_full), whose schedule is
// _fw_run; K6 replaces _fw_full_multi_kernel (called through
// fw_phase_full_multi). In one launch, for one member (K3) or for each of
// B restart members (K6):
//
//   - assemble the per-sample Grams from the loop-invariant known blocks
//     (shared by the members, or the member's own w-weighted blocks in
//     the weighted bootstrap) and the member's new-u blocks from K1 or K4
//     (as _assemble_G_b);
//   - n_steps Frank-Wolfe steps on each column of alpha = [known; unknown]
//     (the reference's frank_wolfe_nmf): the gradient G_s a - b_s, the
//     block linear minimisation -- the FIRST row of the smallest gradient
//     in the known rows (q < n_ct) and in the unknown rows (q >= n_ct) --,
//     the vertex purity_s e_idx1 + (1 - purity_s) e_idx2, and the step
//     a = (1 - gamma) a + gamma vertex with gamma = 2 / (k + 2);
//   - l_w = ||alpha_unknown||^2 dmax^2 and the Gram-identity cost
//     sum(ydy) - sum(b * alpha) - sum(alpha * (b - G alpha)).
//
// What bounds it on an H100: latency. The data is tiny (p ~ 6, n_s ~ 10)
// and the schedule is a serial chain of 500 steps by default (the purity
// solve's n_iter2), each a matrix-vector product, two minima and two
// ballots inside a warp.
//
// What the design does about it (measured on an NVIDIA H100 80GB HBM3 at
// 700 W, PERF.md). Register form (p <= 32): one warp per sample column,
// lane q holding row q of G_s, b_s and alpha in registers; the product
// reads a from the other lanes by shuffle; each block's minimum is a
// butterfly of NaN-propagating minima (padding lanes hold +inf, the other
// block's rows the TPU kernel's 3.4e38 mask), and the first row holding
// it is the lowest set bit of a ballot -- the tie rule of _fw_run and of
// argmin. As K2's alpha loop (alpha_phase_full.cu):
//   - the loop is templated on a row bucket P (8, 16 or 32: the smallest
//     >= p, ops/cuda_small.alpha_plan), so at p = 6 the product takes 8
//     shuffles, not 32, and each minimum 3 butterfly levels, not 5;
//   - the step sizes gamma_k = 2 / (k + 2) are divided once per launch
//     into a shared-memory table (past 48 KB of table, at thousands of
//     steps, each step divides: the same values), so no step divides;
//   - each column has its own warp: up to 16 columns one block, above
//     that blocks of 8 columns (a member's blocks on the grid's x axis,
//     K6's members on its y axis), and the cost and l_w are summed by the
//     member's last block in the fixed order of small_common.cuh
//     column_cost -- the one-block kernel's order wherever it had
//     min(n_s, 32) warps (every n_s in float32); where the register
//     count gave the one-block kernel fewer warps (float64 past 16
//     columns) the cost and l_w now sum in the new order.
// None of this changes an alpha value: the bits are those of the 32-lane
// loop (glue_steps.cuh fw_steps_reg). Nothing leaves registers until the
// epilogue.
// From 33 to 64 rows (e.g. the 25-type panel with 8 or more unknowns, or
// a 39-type atlas with one unknown) the two-row form (glue_steps.cuh):
// lane q holds rows q and q + 32 of alpha and b in registers, the warp's
// G_s sits in its slab of shared memory at an odd row stride, each
// block's minimum is the lanes' minimum over their two rows then a
// butterfly, its first row comes from two ballots, the step sizes from
// the table, and each column has its own block (K6's members on the
// grid's y axis), the cost summed by column_cost: alpha is the column
// blocks' bit for bit, the cost too wherever the one-block wide loop
// before them held min(n_s, 32) warps.
// Above 64 rows the column-block form: each column of each member has a
// thread block of its own (K6's members on the grid's y axis), or a
// thread-block cluster of C blocks where one block's shared memory cannot
// hold G_s. Thread t of cluster block c owns row q = c R + t (R =
// ceil(p / C) rows a block; threads past the rows take part in the
// reductions only). The block keeps its R rows of G_s in shared memory,
// transposed (entry r of row q at r R + t, so a warp reads consecutive
// words at each r), its own copy of alpha (read by broadcast) and its
// rows of b. A step (column_steps.cuh fw_column_steps, one body with
// K10's): each thread forms its row's gradient, summed over r
// in index order; each warp's (known, unknown) minima by butterfly and
// their first rows by ballot; after one barrier (a cluster barrier when
// C > 1, the warps' pairs double-buffered by step parity) every thread
// folds all the warps' pairs, read through distributed shared memory,
// into the same minima and first rows in every block, and each block
// updates its copy of alpha identically. A NaN-propagating minimum and
// the smallest row holding it do not depend on the order in which rows
// are visited, and each row's sum is the same sum whichever thread forms
// it, so alpha keeps the bits of the one-warp wide loop this form
// replaced (lane q taking rows q, q + 32, ...; the register and two-row
// forms keep them too). After the last step block 0 sums the column's
// cost terms as that loop did (lane l over rows l, l + 32, ..., then the
// shuffle-down tree), reading the other blocks' rows of b and G_s alpha
// through distributed shared memory, and the member's last block sums the
// columns in groups of that loop's warps (column_groups), so the cost and
// l_w keep their bits as well. C is the fewest blocks whose shared memory
// holds R rows of G_s, alpha and two rows of R (dm::fw_column_plan), at
// most 16, the largest cluster an H100 places: one block to p = 168 in
// float64 (239 in float32), up to 16 to p = 670 (946). Past that the
// device rows: 16 blocks a column, each block's R rows of G_s in its
// region of a device buffer the wrapper allocates (dm_fw_column_work
// elements a member), in the same transposed layout, up to 1024 threads a
// block (a thread owning rows t, t + 1024, ... past 16,384 rows, its
// gradients in the row of R values that holds G_s alpha for the cost),
// alpha and the rows of R values in shared memory while they fit (to
// p = 25,600 in float64, 51,200 in float32) and in the block's region
// past that -- the same body and the same bits at every p.

// Device scalars `scal` (shared with K1 and K4; one row per member):
// kLW and kCost (written), kDmax2 (read). K6 (MULTI) skips a member
// whose kActive slot is 0 and sets kActive for the next outer iteration
// from |new cost - old cost| >= kTol.
//
// The step loops live in glue_steps.cuh and, for the column blocks,
// column_steps.cuh, shared with K10 (fw_phase.cu), which runs them on an
// assembled G and b.
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

// the step-size table stays in shared memory up to this many bytes
constexpr size_t kTabSmem = 48 * 1024;

// Member mb's pointers (MULTI: K6's member grid; K3: all strides 0)
template <typename T>
struct Member {
    const T *gtt, *bt, *gu, *bu, *ydy;
    T *alpha, *scal;
};

template <typename T, bool MULTI>
__device__ __forceinline__ Member<T> member(
        long long mb, const T* gtt, const T* bt, const T* gu, const T* bu,
        const T* ydy, T* alpha, T* scal, const dm::MemberStrides& st) {
    if constexpr (!MULTI) mb = 0;
    return Member<T>{gtt + mb * st.gtt, bt + mb * st.bt, gu + mb * st.gu,
                     bu + mb * st.bu, ydy + mb * st.ydy,
                     alpha + mb * st.alpha, scal + mb * st.scal};
}

// The register form (p <= P <= 32): block (x, mb) runs columns
// [x * cols, (x + 1) * cols) of member mb, one warp each; colsum (3, n_s)
// per member receives each column's cost terms and tickets[mb] counts the
// member's finished blocks (zero between launches).
template <typename T, bool MULTI, int P>
__global__ void __launch_bounds__(512)
fw_phase_reg_kernel(const T* __restrict__ gtt, const T* __restrict__ bt,
                    const T* __restrict__ gu, const T* __restrict__ bu,
                    const T* __restrict__ ydy, T* __restrict__ alpha,
                    const T* __restrict__ purity, T* __restrict__ scal,
                    T* __restrict__ colsum, unsigned* __restrict__ tickets,
                    int n_s, int n_ct, int n_u, int n_steps, int cols,
                    int use_table, dm::MemberStrides st) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const long long mb = MULTI ? blockIdx.y : 0;
    const Member<T> m = member<T, MULTI>(mb, gtt, bt, gu, bu, ydy, alpha,
                                          scal, st);
    if constexpr (MULTI) {
        if (m.scal[dm::kActive] == T(0)) return;     // uniform per member
    }
    T* cs = colsum + mb * 3 * n_s;
    const int lane = threadIdx.x & 31;
    const int s = blockIdx.x * cols + (threadIdx.x >> 5);
    const int p = n_ct + n_u;
    const bool row = lane < p;
    const bool col = s < n_s;
    const T dmax2 = m.scal[dm::kDmax2];

    T g[P], b = T(0), al = T(0);
    if (col) {
        dm::load_gram_row(g, b, m.gtt, m.bt, m.gu, m.bu, s, lane, n_s, n_ct,
                          n_u);
        if (row) al = m.alpha[lane * n_s + s];
    }
    T* tab = use_table ? reinterpret_cast<T*>(smem_raw) : nullptr;
    if (use_table) {                       // uniform over the block
        dm::fw_gamma_table(tab, n_steps, static_cast<int>(threadIdx.x),
                           static_cast<int>(blockDim.x));
        __syncthreads();
    }
    if (col) {
        const T pur = purity[s];
        dm::fw_steps_reg(g, b, al, lane, p, n_ct, pur, T(1) - pur, tab,
                         n_steps);
        T ba = T(0), ag = T(0), lw = T(0);
        dm::add_column_sums(g, b, al, lane, p, n_u, ba, ag, lw);
        if (row) m.alpha[lane * n_s + s] = al;
        if (lane == 0) {
            cs[s] = ba;
            cs[n_s + s] = ag;
            cs[2 * n_s + s] = lw;
        }
    }
    // the member's last block sums the columns in the fixed order
    T cost, lw;
    if (!dm::column_cost(cs, m.ydy, n_s, dm::cost_groups(n_s),
                         tickets, mb, cost, lw)) return;
    m.scal[dm::kLW] = lw * dmax2;
    dm::set_cost<MULTI>(m.scal, cost);
}

// The two-row form (32 < p <= 64): block (s, mb) is one warp running
// column s of member mb, the column's G_s in the slab of dynamic shared
// memory and the step-size table, where use_table, after the slab; lane q
// holds rows q and q + 32 of b and alpha. colsum and tickets as the
// register form's.
template <typename T, bool MULTI>
__global__ void __launch_bounds__(32)
fw_phase_two_row_kernel(const T* __restrict__ gtt, const T* __restrict__ bt,
                        const T* __restrict__ gu, const T* __restrict__ bu,
                        const T* __restrict__ ydy, T* __restrict__ alpha,
                        const T* __restrict__ purity, T* __restrict__ scal,
                        T* __restrict__ colsum,
                        unsigned* __restrict__ tickets, int n_s, int n_ct,
                        int n_u, int n_steps, int use_table,
                        dm::MemberStrides st) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const long long mb = MULTI ? blockIdx.y : 0;
    const Member<T> m = member<T, MULTI>(mb, gtt, bt, gu, bu, ydy, alpha,
                                          scal, st);
    if constexpr (MULTI) {
        if (m.scal[dm::kActive] == T(0)) return;     // uniform per member
    }
    T* cs = colsum + mb * 3 * n_s;
    const int lane = threadIdx.x;
    const int s = blockIdx.x;
    const int p = n_ct + n_u;
    const int q1 = lane + 32;
    const bool row1 = q1 < p;
    const T dmax2 = m.scal[dm::kDmax2];

    T* sg = reinterpret_cast<T*>(smem_raw);
    T b0, b1, al1 = T(0);
    dm::load_gram_two_row(sg, b0, b1, m.gtt, m.bt, m.gu, m.bu, s, lane, n_s,
                          n_ct, n_u);
    T al0 = m.alpha[lane * n_s + s];
    if (row1) al1 = m.alpha[q1 * n_s + s];
    T* tab = use_table ? sg + dm::two_row_elems(p) : nullptr;
    if (use_table) dm::fw_gamma_table(tab, n_steps, lane, 32);
    __syncwarp();                          // the slab and table are written

    const T pur = purity[s];
    dm::fw_steps_two_row(sg, b0, b1, al0, al1, lane, p, n_ct, pur,
                         T(1) - pur, tab, n_steps);
    T ba, ag, lw;
    dm::column_sums_two_row(sg, b0, b1, al0, al1, lane, p, n_u, ba, ag, lw);
    m.alpha[lane * n_s + s] = al0;
    if (row1) m.alpha[q1 * n_s + s] = al1;
    if (lane == 0) {
        cs[s] = ba;
        cs[n_s + s] = ag;
        cs[2 * n_s + s] = lw;
    }
    // the member's last block sums the columns in the fixed order
    T cost;
    if (!dm::column_cost(cs, m.ydy, n_s, dm::cost_groups(n_s),
                         tickets, mb, cost, lw)) return;
    m.scal[dm::kLW] = lw * dmax2;
    dm::set_cost<MULTI>(m.scal, cost);
}

// ---- the column-block form (p > 64) ----------------------------------

namespace cg = cooperative_groups;

using dm::ColumnPlan;
using dm::column_row_dot;

// The cost's group count (dm::column_groups): the wide loop's kernels
// allowed 1024 threads a block in every instantiation but the float64
// device-slab ones, which took 72 registers a thread and allowed 896, 28
// warps (cudaFuncGetAttributes on an H100).
int column_groups(int itemsize, int p, int n_s) {
    return dm::column_groups(itemsize, p, n_s, itemsize == 8 ? 28 : 32);
}

// The column-block form: cluster (s, mb) of C = gridDim.x / n_s blocks
// runs column s of member mb, block c of it rows [c R, c R + R)
// (dm::fw_column_plan), in layout DEV: G_s's rows in the block's shared
// memory, or in its region of `work`; the steps column_steps.cuh
// fw_column_steps; colsum (3, n_s) per member receives each column's cost
// terms and tickets[mb] counts the member's finished blocks, as the
// register form's; `groups` is column_groups.
template <typename T, bool MULTI, int DEV>
__global__ void __launch_bounds__(dm::column_threads(DEV))
fw_phase_columns_kernel(const T* __restrict__ gtt, const T* __restrict__ bt,
                        const T* __restrict__ gu, const T* __restrict__ bu,
                        const T* __restrict__ ydy, T* __restrict__ alpha,
                        const T* __restrict__ purity, T* __restrict__ scal,
                        T* __restrict__ colsum,
                        unsigned* __restrict__ tickets, T* __restrict__ work,
                        int n_s, int n_ct, int n_u, int n_steps, int rows,
                        int groups, dm::MemberStrides st) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    cg::cluster_group cluster = cg::this_cluster();
    const long long mb = MULTI ? blockIdx.y : 0;
    const Member<T> m = member<T, MULTI>(mb, gtt, bt, gu, bu, ydy, alpha,
                                          scal, st);
    if constexpr (MULTI) {
        if (m.scal[dm::kActive] == T(0)) return;    // uniform per cluster
    }
    const int n_blocks = static_cast<int>(cluster.num_blocks());
    const int rank = static_cast<int>(cluster.block_rank());
    const int s = blockIdx.x / n_blocks;
    const int p = n_ct + n_u;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int q0 = rank * rows;                     // this block's rows
    const int own = p - q0 < rows ? p - q0 : rows;
    const int q = q0 + tid;
    const bool row = tid < own;
    const bool known = q < n_ct;
    T* cs = colsum + mb * 3 * n_s;
    const T dmax2 = m.scal[dm::kDmax2];

    T* region = dm::column_region<DEV>(work, mb * n_s + s, rank, n_blocks,
                                       rows, p, dm::kFwPRows, dm::kFwRRows);
    T* sg = dm::column_gram<DEV>(smem_raw, region);  // rows x p, transposed
    T* sal = dm::column_line<DEV>(smem_raw, region, rows, p);  // alpha (p)
    T* sb = sal + p;                                // b of the block's rows
    T* sga = sb + rows;                             // (G_s alpha) of them
    const long long stride =
        DEV == dm::kDeviceColumn
            ? dm::column_block_elems(DEV, rows, p, dm::kFwPRows,
                                     dm::kFwRRows)
            : 0;
    // G_s's rows by the assembly rule of load_gram_row, read along r
    for (int k = tid; k < own * p; k += blockDim.x) {
        const int t = k / p;
        const int r = k - t * p;
        const int qq = q0 + t;
        T x;
        if (qq >= n_ct)
            x = m.gu[(s * n_u + (qq - n_ct)) * p + r];
        else if (r >= n_ct)
            x = m.gu[(s * n_u + (r - n_ct)) * p + qq];
        else
            x = m.gtt[(s * n_ct + qq) * n_ct + r];
        sg[r * rows + t] = x;
    }
    for (int r = tid; r < p; r += blockDim.x) sal[r] = m.alpha[r * n_s + s];
    auto b_of = [&](int t) {
        const int qq = q0 + t;
        return qq < n_ct ? m.bt[qq * n_s + s] : m.bu[(qq - n_ct) * n_s + s];
    };
    const T b = row ? b_of(tid) : T(0);
    const int per = dm::rows_per_thread<DEV>(rows, blockDim.x);
    if constexpr (DEV != dm::kSharedRows) {     // the rows' b, once
        for (int t = tid; t < own; t += blockDim.x) sb[t] = b_of(t);
    }
    const T pur = purity[s];
    __shared__ dm::WarpMin<T> red[2][dm::column_threads(DEV) / 32];
    __syncthreads();
    dm::fw_column_steps<T, DEV>(cluster, n_blocks, red, sg, sal, b, row,
                                known, q0, tid, lane, warp,
                                static_cast<int>(blockDim.x >> 5), p, rows,
                                pur, T(1) - pur, n_steps, sb, sga, own,
                                n_ct);

    // the column's cost terms in the wide loop's order (column_cost_terms)
    for (int j = 0; j < per; ++j) {
        const int t = tid + j * static_cast<int>(blockDim.x);
        if (t < own) {
            const int qq = q0 + t;
            sga[t] = column_row_dot(sg, sal, rows, t, p);
            if (DEV == dm::kSharedRows) sb[t] = b;
            m.alpha[qq * n_s + s] = sal[qq];
        }
    }
    dm::column_sync<DEV>(cluster, n_blocks);
    if (rank == 0 && warp == 0)
        dm::column_cost_terms<DEV>(cluster, n_blocks, stride, sal, sb, sga,
                                   lane, rows, p, n_u, cs, s, n_s);
    // no block leaves while block 0 may still read its rows
    if (n_blocks > 1) cluster.sync();
    T cost, lw;
    if (!dm::column_cost(cs, m.ydy, n_s, groups, tickets, mb, cost, lw))
        return;
    m.scal[dm::kLW] = lw * dmax2;
    dm::set_cost<MULTI>(m.scal, cost);
}

template <typename T, bool MULTI, int P>
int launch_reg(const void* gtt, const void* bt, const void* gu,
               const void* bu, const void* ydy, void* alpha,
               const void* purity, void* scal, void* colsum, void* tickets,
               int n_s, int n_ct, int n_u, int n_steps, int cols,
               int n_members, dm::MemberStrides st, cudaStream_t stream) {
    auto kern = fw_phase_reg_kernel<T, MULTI, P>;
    static const int max_warps = dm::max_block_warps(kern);
    if (cols < 1 || cols > max_warps)
        return static_cast<int>(cudaErrorInvalidValue);
    const size_t tab = static_cast<size_t>(n_steps) * sizeof(T);
    const int use_table = tab <= kTabSmem;
    const dim3 grid((n_s + cols - 1) / cols, MULTI ? n_members : 1);
    kern<<<grid, 32 * cols, use_table ? tab : 0, stream>>>(
        static_cast<const T*>(gtt), static_cast<const T*>(bt),
        static_cast<const T*>(gu), static_cast<const T*>(bu),
        static_cast<const T*>(ydy), static_cast<T*>(alpha),
        static_cast<const T*>(purity), static_cast<T*>(scal),
        static_cast<T*>(colsum), static_cast<unsigned*>(tickets), n_s, n_ct,
        n_u, n_steps, cols, use_table, st);
    return static_cast<int>(cudaGetLastError());
}

// the two-row form: a warp a column, the step-size table after the slab
// where it fits
template <typename T, bool MULTI>
int launch_two_row(const void* gtt, const void* bt, const void* gu,
                   const void* bu, const void* ydy, void* alpha,
                   const void* purity, void* scal, void* colsum,
                   void* tickets, int n_s, int n_ct, int n_u, int n_steps,
                   int n_members, dm::MemberStrides st, cudaStream_t stream) {
    auto kern = fw_phase_two_row_kernel<T, MULTI>;
    size_t smem;
    int use_table;
    const int err = dm::two_row_smem(
        kern, sizeof(T), n_ct + n_u,
        static_cast<size_t>(n_steps) * sizeof(T), smem, use_table);
    if (err != 0) return err;
    const dim3 grid(n_s, MULTI ? n_members : 1);
    kern<<<grid, 32, smem, stream>>>(
        static_cast<const T*>(gtt), static_cast<const T*>(bt),
        static_cast<const T*>(gu), static_cast<const T*>(bu),
        static_cast<const T*>(ydy), static_cast<T*>(alpha),
        static_cast<const T*>(purity), static_cast<T*>(scal),
        static_cast<T*>(colsum), static_cast<unsigned*>(tickets), n_s, n_ct,
        n_u, n_steps, use_table, st);
    return static_cast<int>(cudaGetLastError());
}

// The column-block form in layout DEV: a cluster of plan.blocks blocks a
// column (dm::launch_column_blocks); `work` the device rows' buffer
template <typename T, bool MULTI, int DEV>
int launch_columns(const void* gtt, const void* bt, const void* gu,
                   const void* bu, const void* ydy, void* alpha,
                   const void* purity, void* scal, void* colsum,
                   void* tickets, void* work, int n_s, int n_ct, int n_u,
                   int n_steps, int n_members, const ColumnPlan& plan,
                   dm::MemberStrides st, cudaStream_t stream) {
    const int p = n_ct + n_u;
    return dm::launch_column_blocks(
        fw_phase_columns_kernel<T, MULTI, DEV>, plan, n_s,
        MULTI ? n_members : 1, static_cast<size_t>(plan.bytes), stream,
        static_cast<const T*>(gtt), static_cast<const T*>(bt),
        static_cast<const T*>(gu), static_cast<const T*>(bu),
        static_cast<const T*>(ydy), static_cast<T*>(alpha),
        static_cast<const T*>(purity), static_cast<T*>(scal),
        static_cast<T*>(colsum), static_cast<unsigned*>(tickets),
        static_cast<T*>(work), n_s, n_ct, n_u, n_steps, plan.rows,
        column_groups(sizeof(T), p, n_s), st);
}

// p > 64: the column blocks, or past 16 blocks the device rows (their
// buffer `work`); else the register form at row bucket `bucket` (8, 16 or
// 32, >= p) with `cols` columns a block, or the two-row form at bucket 64
// (a column a block)
template <typename T, bool MULTI>
int launch(const void* gtt, const void* bt, const void* gu, const void* bu,
           const void* ydy, void* alpha, const void* purity, void* scal,
           void* colsum, void* tickets, void* work, int n_s, int n_ct,
           int n_u, int n_steps, int bucket, int cols, int n_members,
           dm::MemberStrides st, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int p = n_ct + n_u;
    if (colsum == nullptr || tickets == nullptr)
        return static_cast<int>(cudaErrorInvalidValue);
    if (p > dm::kTwoRowP) {
        const ColumnPlan plan = dm::fw_column_plan(sizeof(T), p);
        if (plan.device != dm::kSharedRows && work == nullptr)
            return static_cast<int>(cudaErrorInvalidValue);
#define DM_K3_COLUMNS(DEV)                                                   \
    launch_columns<T, MULTI, DEV>(gtt, bt, gu, bu, ydy, alpha, purity, scal, \
                                  colsum, tickets, work, n_s, n_ct, n_u,     \
                                  n_steps, n_members, plan, st, s)
        if (plan.device == dm::kSharedRows) return DM_K3_COLUMNS(0);
        if (plan.device == dm::kDeviceRows) return DM_K3_COLUMNS(1);
        return DM_K3_COLUMNS(2);
#undef DM_K3_COLUMNS
    }
    if (p > bucket) return static_cast<int>(cudaErrorInvalidValue);
    if (p > kMaxP)
        return bucket != dm::kTwoRowP
                   ? static_cast<int>(cudaErrorInvalidValue)
                   : launch_two_row<T, MULTI>(gtt, bt, gu, bu, ydy, alpha,
                                              purity, scal, colsum, tickets,
                                              n_s, n_ct, n_u, n_steps,
                                              n_members, st, s);
#define DM_K3_BUCKET(P)                                                      \
    if (bucket == P)                                                         \
        return launch_reg<T, MULTI, P>(gtt, bt, gu, bu, ydy, alpha, purity,  \
                                       scal, colsum, tickets, n_s, n_ct,     \
                                       n_u, n_steps, cols, n_members, st,    \
                                       s);
    DM_K3_BUCKET(8)
    DM_K3_BUCKET(16)
    DM_K3_BUCKET(32)
#undef DM_K3_BUCKET
    return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// colsum (3, n_s) and tickets (1, zero) the per-column cost terms and
// finished-block count; work the device rows' buffer past 16 column
// blocks (dm_fw_column_plan's device; its dm_fw_column_work elements),
// else unread; bucket and cols the plan as K2's (ops/cuda_small.alpha_plan;
// unread above 32 rows but the two-row form's bucket)
#define DM_K3_ENTRY(NAME, T)                                                 \
    int NAME(const void* gtt, const void* bt, const void* gu,                \
             const void* bu, const void* ydy, void* alpha,                   \
             const void* purity, void* scal, void* colsum, void* tickets,    \
             void* work, int n_s, int n_ct, int n_u, int n_steps,            \
             int bucket, int cols, void* stream) {                           \
        return launch<T, false>(gtt, bt, gu, bu, ydy, alpha, purity, scal,   \
                                colsum, tickets, work, n_s, n_ct, n_u,       \
                                n_steps, bucket, cols, 1,                    \
                                dm::MemberStrides{}, stream);                \
    }
DM_K3_ENTRY(dm_fw_phase_full_f32, float)
DM_K3_ENTRY(dm_fw_phase_full_f64, double)

// K6: B members, member b's operands at b times the given element strides
// (gtt, bt, ydy: 0 when the members share them; purity shared);
// scal_stride is the scalar row length; colsum (B, 3, n_s), tickets
// (B, zero) and work (B members' rows) as K3's.
#define DM_K6_ENTRY(NAME, T)                                                 \
    int NAME(const void* gtt, long long gtt_stride, const void* bt,          \
             long long bt_stride, const void* gu, long long gu_stride,       \
             const void* bu, long long bu_stride, const void* ydy,           \
             long long ydy_stride, void* alpha, long long alpha_stride,      \
             const void* purity, void* scal, long long scal_stride,          \
             void* colsum, void* tickets, void* work, int n_s, int n_ct,     \
             int n_u, int n_steps, int bucket, int cols, int n_members,      \
             void* stream) {                                                 \
        const dm::MemberStrides st{gtt_stride, bt_stride,    ydy_stride,     \
                                   gu_stride,  bu_stride,    0,              \
                                   alpha_stride, scal_stride, 0};            \
        return launch<T, true>(gtt, bt, gu, bu, ydy, alpha, purity, scal,    \
                               colsum, tickets, work, n_s, n_ct, n_u,        \
                               n_steps, bucket, cols, n_members, st,         \
                               stream);                                      \
    }
DM_K6_ENTRY(dm_fw_phase_full_multi_f32, float)
DM_K6_ENTRY(dm_fw_phase_full_multi_f64, double)

// K3's and K6's column-block plan at p > 64 rows of itemsize-byte values:
// out[0] blocks a column, out[1] rows a block, out[2] threads a block,
// out[3] where its values live (as dm_alpha_column_plan's); returns the
// block's dynamic shared memory in bytes (ops/cuda_small.fw_column_plan
// is its Python copy)
long long dm_fw_column_plan(int itemsize, int p, int* out) {
    const ColumnPlan plan = dm::fw_column_plan(itemsize, p);
    out[0] = plan.blocks;
    out[1] = plan.rows;
    out[2] = plan.threads;
    out[3] = plan.device;
    return plan.bytes;
}

// Elements of the device rows' buffer a member at p rows and n_s columns
// (K3, K6, K10: 0 in the column blocks)
long long dm_fw_column_work(int itemsize, int p, int n_s) {
    const ColumnPlan plan = dm::fw_column_plan(itemsize, p);
    return static_cast<long long>(n_s) * plan.blocks
           * dm::column_block_elems(plan.device, plan.rows, p, dm::kFwPRows,
                                    dm::kFwRRows);
}

// What the card gives K3's column kernel at p rows (its layout there), as
// dm_alpha_column_capacity's
int dm_fw_column_capacity(int itemsize, int p, int* out) {
    const ColumnPlan plan = dm::fw_column_plan(itemsize, p);
    const size_t smem = static_cast<size_t>(plan.bytes);
#define DM_K3_CAPACITY(T)                                                    \
    (plan.device == dm::kSharedRows                                          \
         ? dm::column_capacity(fw_phase_columns_kernel<T, false, 0>, plan,   \
                               smem, out)                                    \
         : plan.device == dm::kDeviceRows                                    \
               ? dm::column_capacity(fw_phase_columns_kernel<T, false, 1>,   \
                                     plan, smem, out)                        \
               : dm::column_capacity(fw_phase_columns_kernel<T, false, 2>,   \
                                     plan, smem, out))
    return itemsize == 8 ? DM_K3_CAPACITY(double) : DM_K3_CAPACITY(float);
#undef DM_K3_CAPACITY
}

// The groups in which the column blocks' cost sums the columns
// (ops/cuda_small.fw_column_groups)
int dm_fw_column_groups(int itemsize, int p, int n_s) {
    return column_groups(itemsize, p, n_s);
}

}  // extern "C"
