// K2 and K5: the alpha glue kernel of the partial-reference and
// unsupervised solves, for Hopper; K5 is its member-gridded form for the
// batched random restarts.
//
// K2 replaces the Pallas kernel demethify_tpu/ops/pallas_small.py
// :: _alpha_full_kernel (called through alpha_phase_full); K5 replaces
// _alpha_full_multi_kernel (called through alpha_phase_full_multi). In
// one launch, for one member (K2) or for each of B restart members (K5):
//
//   - assemble the per-sample Grams from the loop-invariant known blocks
//     (shared by the members, or the member's own in the weighted
//     bootstrap: its w-weighted G_tt, b_t and ydy at a member stride) and
//     the member's new-u blocks from K1 or K4 (as _assemble_G_b; with no
//     known block, n_ct = 0, G and b are those blocks alone);
//   - l_h = (||Rt||^2 + usq) dmax^2  (||Rt||^2 = 0 without a known block);
//   - n_steps alpha FISTA steps with the simplex projection of each
//     column (the plain form of ops/fista.fista_alpha_gram);
//   - l_w = ||alpha_unknown||^2 dmax^2 and the Gram-identity cost
//     sum(ydy) - sum(b * alpha) - sum(alpha * (b - G alpha)).
//
// What bounds it on an H100: latency. The data is tiny (p ~ 6, n_s ~ 10)
// and the n_steps steps are serial; a launch per step would cost more
// than the arithmetic. A step of a column is a chain of warp collectives
// (the product's shuffles, the rank's, a ballot and a shuffle per rank)
// and three IEEE divisions: measured on an NVIDIA H100 80GB HBM3 at
// 700 W (chip_smoke.time_steps), ~1.06 us a step and ~6 us fixed at
// p = 6, n_s = 10, ~3.3 us a step at p = 29 (PERF.md).
//
// What the design does about it. Register form (p <= 32): one warp per
// sample column, lane q holding row q of alpha and of G_s; the
// matrix-vector product reads a_t from the other lanes by shuffle, and
// the projection runs inside the warp: a stable descending rank by
// comparison, the cumulative sum taken in sorted order (ballot finds the
// lane of each rank), and rho as the LAST lane whose condition holds
// (highest bit of a ballot) -- the reference's last-index rho.
//   - The loops are templated on a row bucket P (8, 16 or 32: the
//     smallest >= p, from the wrapper's plan, ops/cuda_small.alpha_plan),
//     so at p = 6 each collective loop runs to 8 lanes, not 32, and a
//     level of the cost's shuffle tree whose partners are all padding
//     adds +0 without a shuffle (the same bits).
//   - Each column has its own warp: up to 16 columns one block, above
//     that blocks of 8 columns (a member's blocks on a grid's x axis), so
//     no warp runs columns in turn. The block builds the steps'
//     momentum table in shared memory (small_common.cuh momentum_table:
//     thread 0 runs the Nesterov recursion, the threads form the betas)
//     after the warps have asked for their columns; every lane then
//     reads beta_k from it (past 48 KB of table, at thousands of steps,
//     the lanes replay the chain: the same values).
//   - The cost and l_w: each column's terms (its 32-lane shuffle tree)
//     go to a per-column buffer, and the member's last block to
//     finish (a ticket taken with an integer atomic, reset for the next
//     launch) sums them in a fixed order that does not depend on the
//     grid: column s into group s mod min(n_s, 32), each group in column
//     order, then the groups in order -- the order of the one-block
//     kernel with min(n_s, 32) warps, so K2 in float32 keeps its bits at
//     every n_s and K5 at n_s <= 28; where the register count gave the
//     one-block kernel fewer warps (float64 past 16 columns, K5 in
//     float32 past 28) the cost and l_w now sum in the new order.
// From 33 to 64 rows the two-row form (glue_steps.cuh): lane q holds rows
// q and q + 32 of alpha, alpha_prev and b in registers and the warp's
// column G_s sits in its slab of shared memory at an odd row stride (no
// bank conflicts in the product); the product, the projection and the
// member's grid are the register form's, extended to 64 rows, with the
// cost summed by column_cost in the same fixed order. Its alpha and
// alpha_prev are the column blocks' bit for bit; the cost too wherever
// the one-block wide loop before them held min(n_s, 32) warps. A block
// is one warp holding one column: a step is bound by its SM's shuffle,
// FP64 and issue throughput, so a column an SM is about the fastest.
// Above 64 rows the column-block form: each column of each member has a
// thread block of its own (K5's members on the grid's y axis), or a
// thread-block cluster of C blocks where one block's shared memory cannot
// hold the column. Thread t of cluster block c owns row q = c R + t (R =
// ceil(p / C) rows a block). The block keeps its R rows of G_s in shared
// memory, transposed (entry r of row q at r R + t, so a warp reads
// consecutive words at each r), its rows of b in registers and its own
// copies of alpha, alpha_prev and the momentum point a_t. A step
// (column_steps.cuh alpha_column_steps, one body with K9's) writes each
// row's v into every block's copy (through distributed shared memory),
// ranks every row there and puts each value in its rank's slot in every
// block, runs one thread's chain of p adds for the cumulative sum in rank
// order, tests the ranks side by side (rho a block maximum) and updates
// alpha, alpha_prev and a_t in every block alike, with the betas from the
// block's momentum table where it fits after the plan's bytes.
// Every value and every order is the one-warp wide loop's this form
// replaced (lane q taking rows q, q + 32, ..., lane 0 taking the
// cumulative sum and rho alone), so alpha and alpha_prev keep its bits.
// After the last step block 0 sums the column's cost terms as that loop
// did (lane l over rows l, l + 32, ..., then the shuffle-down tree,
// column_cost_terms), reading the other blocks' rows of b and G_s alpha
// through distributed shared memory, and the member's last block sums
// the columns in groups of that loop's warps (column_groups), so the cost
// and l_w keep their bits as well. C is the fewest blocks whose shared
// memory holds R rows of G_s and the seven rows of p the step needs
// (dm::alpha_column_plan), at most 16, the largest cluster an H100
// places: one block to p = 166 in float64 (237 in float32), up to 16 to
// p = 624 (904). Past that the device rows: 16 blocks a column, each
// block's R rows of G_s in its region of a device buffer the wrapper
// allocates (dm_alpha_column_work elements a member), in the same
// transposed layout, up to 1024 threads a block (a thread owning rows t,
// t + 1024, ... past 16,384 rows), the rows of p in shared memory while
// they fit (to p = 4,114 in float64, 8,228 in float32) and in the block's
// region past that -- the same body and the same bits at every p.
//
// Row masks (the JAX kernels' row_mask / row_mask_b, pallas_small.py
// :281-282, :409-410): a (p,) mask per member, or none; before each
// projection the rows whose mask is not > 0 are set to -1e30, so they
// sort last, never meet the threshold and project to exactly 0, and the
// other rows get the projection of the smaller vector. An all-ones mask
// changes nothing.
//
// Device scalars `scal` (shared with K1 and K4; one row per member, row
// stride in MemberStrides): kLW (written), kAAlpha and kLHPrev (advanced),
// kCost (written), kRtSq and kDmax2 (read; per member, so a bootstrap
// replicate has its own weighted ||Rt||^2 and surviving-row max
// coverage). K5 (MULTI) skips a member
// whose kActive slot is 0 -- it is left exactly as it was -- and sets
// kActive for the next outer iteration from |new cost - old cost| >= kTol.
//
// The step loops and the projection live in glue_steps.cuh and, for the
// column blocks, column_steps.cuh, shared with K9 (alpha_phase.cu), which
// runs them on an assembled G and b.
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

// the momentum table stays in shared memory up to this many bytes
constexpr size_t kTabSmem = 48 * 1024;

// Member mb's pointers (MULTI: K5's member grid; K2: all strides 0)
template <typename T>
struct Member {
    const T *gtt, *bt, *gu, *bu, *usq, *ydy, *mask;
    T *alpha, *alpha_prev, *scal;
};

template <typename T, bool MULTI>
__device__ __forceinline__ Member<T> member(
        long long mb, const T* gtt, const T* bt, const T* gu, const T* bu,
        const T* usq, const T* ydy, T* alpha, T* alpha_prev, T* scal,
        const T* mask, const dm::MemberStrides& st) {
    if constexpr (!MULTI) mb = 0;
    return Member<T>{gtt + mb * st.gtt, bt + mb * st.bt, gu + mb * st.gu,
                     bu + mb * st.bu, usq + mb * st.usq, ydy + mb * st.ydy,
                     mask == nullptr ? nullptr : mask + mb * st.mask,
                     alpha + mb * st.alpha, alpha_prev + mb * st.alpha,
                     scal + mb * st.scal};
}

// The member's epilogue (one thread): l_w, the advanced Nesterov scalar
// a_fin, l_h_prev and the cost.
template <typename T, bool MULTI>
__device__ __forceinline__ void finish_member(T* __restrict__ scal, T cost,
                                              T lw, T a_fin, T l_h,
                                              int n_steps) {
    scal[dm::kLW] = lw * scal[dm::kDmax2];
    scal[dm::kAAlpha] = a_fin;
    if (n_steps > 0) scal[dm::kLHPrev] = l_h;
    dm::set_cost<MULTI>(scal, cost);
}

// The register form (p <= P <= 32): block (x, mb) runs columns
// [x * cols, (x + 1) * cols) of member mb, one warp each; colsum (3, n_s)
// per member receives each column's cost terms and tickets[mb] counts the
// member's finished blocks (zero between launches).
template <typename T, bool MULTI, int P>
__global__ void __launch_bounds__(512)
alpha_phase_reg_kernel(const T* __restrict__ gtt, const T* __restrict__ bt,
                       const T* __restrict__ gu, const T* __restrict__ bu,
                       const T* __restrict__ usq, const T* __restrict__ ydy,
                       T* __restrict__ alpha, T* __restrict__ alpha_prev,
                       T* __restrict__ scal, const T* __restrict__ mask,
                       T* __restrict__ colsum, unsigned* __restrict__ tickets,
                       int n_s, int n_ct, int n_u, int n_steps, int cols,
                       int use_table, dm::MemberStrides st) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const long long mb = MULTI ? blockIdx.y : 0;
    const Member<T> m = member<T, MULTI>(mb, gtt, bt, gu, bu, usq, ydy,
                                          alpha, alpha_prev, scal, mask, st);
    if constexpr (MULTI) {
        if (m.scal[dm::kActive] == T(0)) return;     // uniform per member
    }
    T* cs = colsum + mb * 3 * n_s;
    const int lane = threadIdx.x & 31;
    const int s = blockIdx.x * cols + (threadIdx.x >> 5);
    const int p = n_ct + n_u;
    const bool row = lane < p;
    const bool col = s < n_s;

    const T a0 = m.scal[dm::kAAlpha];
    const T l_h_prev0 = m.scal[dm::kLHPrev];
    const T l_h = (m.scal[dm::kRtSq] + m.usq[0]) * m.scal[dm::kDmax2];

    T g[P], b = T(0), al = T(0), ap = T(0);
    if (col) {
        dm::load_gram_row(g, b, m.gtt, m.bt, m.gu, m.bu, s, lane, n_s, n_ct,
                          n_u);
        if (row) {
            al = m.alpha[lane * n_s + s];
            ap = m.alpha_prev[lane * n_s + s];
        }
    }
    T* tab = use_table ? reinterpret_cast<T*>(smem_raw) : nullptr;
    if (use_table)                         // uniform over the block
        dm::momentum_table(tab, a0, l_h_prev0, l_h, n_steps,
                           static_cast<int>(threadIdx.x),
                           static_cast<int>(blockDim.x),
                           [] { __syncthreads(); });

    if (col) {
        const bool masked = m.mask != nullptr && row && !(m.mask[lane] > T(0));
        dm::alpha_steps_reg(g, b, al, ap, masked, lane, p, tab, a0,
                            l_h_prev0, l_h, n_steps);
        T ba = T(0), ag = T(0), lw = T(0);
        dm::add_column_sums(g, b, al, lane, p, n_u, ba, ag, lw);
        if (row) {
            m.alpha[lane * n_s + s] = al;
            m.alpha_prev[lane * n_s + s] = ap;
        }
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
    T a_fin = a0;
    if (use_table) {
        a_fin = tab[n_steps];
    } else {
        for (int step = 0; step < n_steps; ++step) a_fin = dm::nesterov(a_fin);
    }
    finish_member<T, MULTI>(m.scal, cost, lw, a_fin, l_h, n_steps);
}

// The two-row form (32 < p <= 64): block (s, mb) is one warp running
// column s of member mb, the column's G_s in the slab of dynamic shared
// memory (two_row_elems(p) values) and the momentum table, where
// use_table, after the slab; lane q holds rows q and q + 32 of b, alpha
// and alpha_prev. colsum and tickets as the register form's.
template <typename T, bool MULTI>
__global__ void __launch_bounds__(32)
alpha_phase_two_row_kernel(const T* __restrict__ gtt,
                           const T* __restrict__ bt,
                           const T* __restrict__ gu, const T* __restrict__ bu,
                           const T* __restrict__ usq,
                           const T* __restrict__ ydy, T* __restrict__ alpha,
                           T* __restrict__ alpha_prev, T* __restrict__ scal,
                           const T* __restrict__ mask,
                           T* __restrict__ colsum,
                           unsigned* __restrict__ tickets, int n_s, int n_ct,
                           int n_u, int n_steps, int use_table,
                           dm::MemberStrides st) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const long long mb = MULTI ? blockIdx.y : 0;
    const Member<T> m = member<T, MULTI>(mb, gtt, bt, gu, bu, usq, ydy,
                                          alpha, alpha_prev, scal, mask, st);
    if constexpr (MULTI) {
        if (m.scal[dm::kActive] == T(0)) return;     // uniform per member
    }
    T* cs = colsum + mb * 3 * n_s;
    const int lane = threadIdx.x;
    const int s = blockIdx.x;
    const int p = n_ct + n_u;
    const int q1 = lane + 32;
    const bool row1 = q1 < p;

    const T a0 = m.scal[dm::kAAlpha];
    const T l_h_prev0 = m.scal[dm::kLHPrev];
    const T l_h = (m.scal[dm::kRtSq] + m.usq[0]) * m.scal[dm::kDmax2];

    T* sg = reinterpret_cast<T*>(smem_raw);
    T b0, b1, al1 = T(0), ap1 = T(0);
    dm::load_gram_two_row(sg, b0, b1, m.gtt, m.bt, m.gu, m.bu, s, lane, n_s,
                          n_ct, n_u);
    T al0 = m.alpha[lane * n_s + s];
    T ap0 = m.alpha_prev[lane * n_s + s];
    if (row1) {
        al1 = m.alpha[q1 * n_s + s];
        ap1 = m.alpha_prev[q1 * n_s + s];
    }
    __syncwarp();                          // the slab is written
    T* tab = use_table ? sg + dm::two_row_elems(p) : nullptr;
    if (use_table)
        dm::momentum_table(tab, a0, l_h_prev0, l_h, n_steps, lane, 32,
                           [] { __syncwarp(); });

    const bool masked0 = m.mask != nullptr && !(m.mask[lane] > T(0));
    const bool masked1 = m.mask != nullptr && row1 && !(m.mask[q1] > T(0));
    dm::alpha_steps_two_row(sg, b0, b1, al0, al1, ap0, ap1, masked0, masked1,
                            lane, p, tab, a0, l_h_prev0, l_h, n_steps);
    T ba, ag, lw;
    dm::column_sums_two_row(sg, b0, b1, al0, al1, lane, p, n_u, ba, ag, lw);
    m.alpha[lane * n_s + s] = al0;
    m.alpha_prev[lane * n_s + s] = ap0;
    if (row1) {
        m.alpha[q1 * n_s + s] = al1;
        m.alpha_prev[q1 * n_s + s] = ap1;
    }
    if (lane == 0) {
        cs[s] = ba;
        cs[n_s + s] = ag;
        cs[2 * n_s + s] = lw;
    }
    // the member's last block sums the columns in the fixed order
    T cost;
    if (!dm::column_cost(cs, m.ydy, n_s, dm::cost_groups(n_s),
                         tickets, mb, cost, lw)) return;
    T a_fin = a0;
    if (use_table) {
        a_fin = tab[n_steps];
    } else {
        for (int step = 0; step < n_steps; ++step) a_fin = dm::nesterov(a_fin);
    }
    finish_member<T, MULTI>(m.scal, cost, lw, a_fin, l_h, n_steps);
}

// ---- the column-block form (p > 64) ----------------------------------

namespace cg = cooperative_groups;

using dm::ColumnPlan;
using dm::column_row_dot;

// The cost's group count (dm::column_groups): the wide loop's
// device-slab kernels (K2's and K5's alike) took 128 registers a thread
// in float64 and 95 in float32 and allowed 512 and 640 threads a block,
// 16 and 20 warps (cudaFuncGetAttributes on an H100); its shared-slab
// kernels' registers allowed more warps (16 and 24) than their slabs.
constexpr int kSlabLoopWarps64 = 16;
constexpr int kSlabLoopWarps32 = 20;

int column_groups(int itemsize, int p, int n_s) {
    return dm::column_groups(itemsize, p, n_s,
                             itemsize == 8 ? kSlabLoopWarps64
                                           : kSlabLoopWarps32);
}

// The column-block form: cluster (s, mb) of C = gridDim.x / n_s blocks
// runs column s of member mb, block c of it rows [c R, c R + R), in
// layout DEV (dm::alpha_column_plan's device): G_s's rows transposed in
// the block's shared memory, or in its region of `work`, and its own
// copies of alpha, alpha_prev and a_t, the step's v, ranks and prefix
// sums, then the momentum table where use_table; the steps are
// column_steps.cuh alpha_column_steps. colsum (3, n_s) per member and
// tickets[mb] as the register form's; `groups` is column_groups.
template <typename T, bool MULTI, int DEV>
__global__ void __launch_bounds__(dm::column_threads(DEV))
alpha_phase_columns_kernel(const T* __restrict__ gtt,
                           const T* __restrict__ bt,
                           const T* __restrict__ gu, const T* __restrict__ bu,
                           const T* __restrict__ usq,
                           const T* __restrict__ ydy, T* __restrict__ alpha,
                           T* __restrict__ alpha_prev, T* __restrict__ scal,
                           const T* __restrict__ mask,
                           T* __restrict__ colsum,
                           unsigned* __restrict__ tickets,
                           T* __restrict__ work, int n_s, int n_ct, int n_u,
                           int n_steps, int rows, int groups, int use_table,
                           dm::MemberStrides st) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    cg::cluster_group cluster = cg::this_cluster();
    const long long mb = MULTI ? blockIdx.y : 0;
    const Member<T> m = member<T, MULTI>(mb, gtt, bt, gu, bu, usq, ydy,
                                          alpha, alpha_prev, scal, mask, st);
    if constexpr (MULTI) {
        if (m.scal[dm::kActive] == T(0)) return;    // uniform per cluster
    }
    const int n_blocks = static_cast<int>(cluster.num_blocks());
    const int rank = static_cast<int>(cluster.block_rank());
    const int s = blockIdx.x / n_blocks;
    const int p = n_ct + n_u;
    const int tid = threadIdx.x;
    const int n_threads = blockDim.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int q0 = rank * rows;                     // this block's rows
    const int own = p - q0 < rows ? p - q0 : rows;
    const bool row = tid < own;
    T* cs = colsum + mb * 3 * n_s;

    const T a0 = m.scal[dm::kAAlpha];
    const T l_h_prev0 = m.scal[dm::kLHPrev];
    const T l_h = (m.scal[dm::kRtSq] + m.usq[0]) * m.scal[dm::kDmax2];

    const dm::AlphaColumn<T> c = dm::alpha_column<DEV>(
        smem_raw,
        dm::column_region<DEV>(work, mb * n_s + s, rank, n_blocks, rows, p,
                               dm::kAlphaPRows, dm::kAlphaRRows),
        rows, p, use_table);
    // G_s's rows by the assembly rule of load_gram_row, read along r
    for (int k = tid; k < own * p; k += n_threads) {
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
        c.sg[r * rows + t] = x;
    }
    for (int r = tid; r < p; r += n_threads) {
        c.sal[r] = m.alpha[r * n_s + s];
        c.sap[r] = m.alpha_prev[r * n_s + s];
    }
    // row q0 + t's b and mask; the column blocks keep their one row's in
    // registers, the device rows read them each step
    auto b_of = [&](int t) {
        const int qq = q0 + t;
        return qq < n_ct ? m.bt[qq * n_s + s] : m.bu[(qq - n_ct) * n_s + s];
    };
    auto masked_of = [&](int t) {
        return m.mask != nullptr && !(m.mask[q0 + t] > T(0));
    };
    const T b = row ? b_of(tid) : T(0);
    const bool masked = row && masked_of(tid);
    const T a_fin = dm::alpha_column_steps<DEV>(
        cluster, c,
        [&](int t) { return DEV == dm::kSharedRows ? b : b_of(t); },
        [&](int t) { return DEV == dm::kSharedRows ? masked : masked_of(t); },
        own, q0, p, rows, a0, l_h_prev0, l_h, n_steps);

    // the column's cost terms in the wide loop's order (column_cost_terms);
    // the rank rows are free now and hold b and G_s alpha of the rows
    T* sb = c.srt;
    T* sga = c.spi;
    const int per = dm::rows_per_thread<DEV>(rows, n_threads);
    for (int j = 0; j < per; ++j) {
        const int t = tid + j * n_threads;
        if (t < own) {
            const int qq = q0 + t;
            sga[t] = column_row_dot(c.sg, c.sal, rows, t, p);
            sb[t] = DEV == dm::kSharedRows ? b : b_of(t);
            m.alpha[qq * n_s + s] = c.sal[qq];
            m.alpha_prev[qq * n_s + s] = c.sap[qq];
        }
    }
    dm::column_sync<DEV>(cluster, n_blocks);
    if (rank == 0 && warp == 0)
        dm::column_cost_terms<DEV>(cluster, n_blocks, c.stride, c.sal, sb,
                                   sga, lane, rows, p, n_u, cs, s, n_s);
    // no block leaves while block 0 may still read its copies
    if (n_blocks > 1) cluster.sync();
    T cost, lw;
    if (!dm::column_cost(cs, m.ydy, n_s, groups, tickets, mb, cost, lw))
        return;
    finish_member<T, MULTI>(m.scal, cost, lw, a_fin, l_h, n_steps);
}

template <typename T, bool MULTI, int P>
int launch_reg(const void* gtt, const void* bt, const void* gu,
               const void* bu, const void* usq, const void* ydy, void* alpha,
               void* alpha_prev, void* scal, const void* mask, void* colsum,
               void* tickets, int n_s, int n_ct, int n_u, int n_steps,
               int cols, int n_members, dm::MemberStrides st,
               cudaStream_t stream) {
    auto kern = alpha_phase_reg_kernel<T, MULTI, P>;
    static const int max_warps = dm::max_block_warps(kern);
    if (cols < 1 || cols > max_warps)
        return static_cast<int>(cudaErrorInvalidValue);
    const size_t tab = (static_cast<size_t>(n_steps) + 1) * sizeof(T);
    const int use_table = tab <= kTabSmem;
    const dim3 grid((n_s + cols - 1) / cols, MULTI ? n_members : 1);
    kern<<<grid, 32 * cols, use_table ? tab : 0, stream>>>(
        static_cast<const T*>(gtt), static_cast<const T*>(bt),
        static_cast<const T*>(gu), static_cast<const T*>(bu),
        static_cast<const T*>(usq), static_cast<const T*>(ydy),
        static_cast<T*>(alpha), static_cast<T*>(alpha_prev),
        static_cast<T*>(scal), static_cast<const T*>(mask),
        static_cast<T*>(colsum), static_cast<unsigned*>(tickets), n_s, n_ct,
        n_u, n_steps, cols, use_table, st);
    return static_cast<int>(cudaGetLastError());
}

// the two-row form: a warp a column, the momentum table after the slab
// where it fits
template <typename T, bool MULTI>
int launch_two_row(const void* gtt, const void* bt, const void* gu,
                   const void* bu, const void* usq, const void* ydy,
                   void* alpha, void* alpha_prev, void* scal,
                   const void* mask, void* colsum, void* tickets, int n_s,
                   int n_ct, int n_u, int n_steps, int n_members,
                   dm::MemberStrides st, cudaStream_t stream) {
    auto kern = alpha_phase_two_row_kernel<T, MULTI>;
    size_t smem;
    int use_table;
    const int err = dm::two_row_smem(
        kern, sizeof(T), n_ct + n_u,
        (static_cast<size_t>(n_steps) + 1) * sizeof(T), smem, use_table);
    if (err != 0) return err;
    const dim3 grid(n_s, MULTI ? n_members : 1);
    kern<<<grid, 32, smem, stream>>>(
        static_cast<const T*>(gtt), static_cast<const T*>(bt),
        static_cast<const T*>(gu), static_cast<const T*>(bu),
        static_cast<const T*>(usq), static_cast<const T*>(ydy),
        static_cast<T*>(alpha), static_cast<T*>(alpha_prev),
        static_cast<T*>(scal), static_cast<const T*>(mask),
        static_cast<T*>(colsum), static_cast<unsigned*>(tickets), n_s, n_ct,
        n_u, n_steps, use_table, st);
    return static_cast<int>(cudaGetLastError());
}

// The column-block form in layout DEV: a cluster of plan.blocks blocks a
// column, the momentum table after the plan's bytes where it fits
// (dm::launch_column_blocks); `work` the device rows' buffer
template <typename T, bool MULTI, int DEV>
int launch_columns(const void* gtt, const void* bt, const void* gu,
                   const void* bu, const void* usq, const void* ydy,
                   void* alpha, void* alpha_prev, void* scal,
                   const void* mask, void* colsum, void* tickets, void* work,
                   int n_s, int n_ct, int n_u, int n_steps, int n_members,
                   const ColumnPlan& plan, dm::MemberStrides st,
                   cudaStream_t stream) {
    const int p = n_ct + n_u;
    const size_t tab = (static_cast<size_t>(n_steps) + 1) * sizeof(T);
    const int use_table = dm::column_table_fits(plan, tab);
    return dm::launch_column_blocks(
        alpha_phase_columns_kernel<T, MULTI, DEV>, plan, n_s,
        MULTI ? n_members : 1,
        static_cast<size_t>(plan.bytes) + (use_table ? tab : 0), stream,
        static_cast<const T*>(gtt), static_cast<const T*>(bt),
        static_cast<const T*>(gu), static_cast<const T*>(bu),
        static_cast<const T*>(usq), static_cast<const T*>(ydy),
        static_cast<T*>(alpha), static_cast<T*>(alpha_prev),
        static_cast<T*>(scal), static_cast<const T*>(mask),
        static_cast<T*>(colsum), static_cast<unsigned*>(tickets),
        static_cast<T*>(work), n_s, n_ct, n_u, n_steps, plan.rows,
        column_groups(sizeof(T), p, n_s), use_table, st);
}

// p > 64: the column blocks, or past 16 blocks the device rows (their
// buffer `work`); else the register form at row bucket `bucket` (8, 16
// or 32, >= p) with `cols` columns a block, or the two-row form at bucket
// 64 (a column a block)
template <typename T, bool MULTI>
int launch(const void* gtt, const void* bt, const void* gu, const void* bu,
           const void* usq, const void* ydy, void* alpha, void* alpha_prev,
           void* scal, const void* mask, void* colsum, void* tickets,
           void* work, int n_s, int n_ct, int n_u, int n_steps, int bucket,
           int cols, int n_members, dm::MemberStrides st, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int p = n_ct + n_u;
    if (colsum == nullptr || tickets == nullptr)
        return static_cast<int>(cudaErrorInvalidValue);
    if (p > dm::kTwoRowP) {
        const ColumnPlan plan = dm::alpha_column_plan(sizeof(T), p);
        if (plan.device != dm::kSharedRows && work == nullptr)
            return static_cast<int>(cudaErrorInvalidValue);
#define DM_K2_COLUMNS(DEV)                                                   \
    launch_columns<T, MULTI, DEV>(gtt, bt, gu, bu, usq, ydy, alpha,          \
                                  alpha_prev, scal, mask, colsum, tickets,   \
                                  work, n_s, n_ct, n_u, n_steps, n_members,  \
                                  plan, st, s)
        if (plan.device == dm::kSharedRows) return DM_K2_COLUMNS(0);
        if (plan.device == dm::kDeviceRows) return DM_K2_COLUMNS(1);
        return DM_K2_COLUMNS(2);
#undef DM_K2_COLUMNS
    }
    if (p > bucket) return static_cast<int>(cudaErrorInvalidValue);
    if (p > kMaxP)
        return bucket != dm::kTwoRowP
                   ? static_cast<int>(cudaErrorInvalidValue)
                   : launch_two_row<T, MULTI>(gtt, bt, gu, bu, usq, ydy, alpha,
                                        alpha_prev, scal, mask, colsum,
                                        tickets, n_s, n_ct, n_u, n_steps,
                                        n_members, st, s);
#define DM_K2_BUCKET(P)                                                      \
    if (bucket == P)                                                         \
        return launch_reg<T, MULTI, P>(gtt, bt, gu, bu, usq, ydy, alpha,     \
                                       alpha_prev, scal, mask, colsum,       \
                                       tickets, n_s, n_ct, n_u, n_steps,     \
                                       cols, n_members, st, s);
    DM_K2_BUCKET(8)
    DM_K2_BUCKET(16)
    DM_K2_BUCKET(32)
#undef DM_K2_BUCKET
    return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// mask: the (p,) row mask (rows <= 0 pushed to -1e30 before each
// projection) or NULL; colsum (3, n_s) and tickets (1, zero) the
// per-column cost terms and finished-block count; work the device rows'
// buffer past 16 column blocks (dm_alpha_column_plan's device; its
// dm_alpha_column_work elements), else unread; bucket the register and
// two-row forms' row bucket and cols the register form's columns a block
// (ops/cuda_small.alpha_plan; unread in the two-row form, a column a
// block, and above 64 rows)
#define DM_K2_ENTRY(NAME, T)                                                 \
    int NAME(const void* gtt, const void* bt, const void* gu,                \
             const void* bu, const void* usq, const void* ydy, void* alpha,  \
             void* alpha_prev, void* scal, const void* mask, void* colsum,   \
             void* tickets, void* work, int n_s, int n_ct, int n_u,          \
             int n_steps, int bucket, int cols, void* stream) {              \
        return launch<T, false>(gtt, bt, gu, bu, usq, ydy, alpha,            \
                                alpha_prev, scal, mask, colsum, tickets,     \
                                work, n_s, n_ct, n_u, n_steps, bucket, cols, \
                                1, dm::MemberStrides{}, stream);             \
    }
DM_K2_ENTRY(dm_alpha_phase_full_f32, float)
DM_K2_ENTRY(dm_alpha_phase_full_f64, double)

// K5: B members, member b's operands at b times the given element strides
// (gtt, bt, ydy: 0 when the members share them); scal_stride is the
// scalar row length; mask: the members' (B, p) row masks (row stride
// mask_stride) or NULL; colsum (B, 3, n_s) and tickets (B, zero) as K2's;
// work the device rows' buffer of B members, as K2's.
#define DM_K5_ENTRY(NAME, T)                                                 \
    int NAME(const void* gtt, long long gtt_stride, const void* bt,          \
             long long bt_stride, const void* gu, long long gu_stride,       \
             const void* bu, long long bu_stride, const void* usq,           \
             long long usq_stride, const void* ydy, long long ydy_stride,    \
             void* alpha, void* alpha_prev, long long alpha_stride,          \
             void* scal, long long scal_stride, const void* mask,            \
             long long mask_stride, void* colsum, void* tickets, void* work, \
             int n_s, int n_ct, int n_u, int n_steps, int bucket, int cols,  \
             int n_members, void* stream) {                                  \
        const dm::MemberStrides st{gtt_stride,   bt_stride,  ydy_stride,     \
                                   gu_stride,    bu_stride,  usq_stride,     \
                                   alpha_stride, scal_stride, mask_stride};  \
        return launch<T, true>(gtt, bt, gu, bu, usq, ydy, alpha, alpha_prev, \
                               scal, mask, colsum, tickets, work, n_s, n_ct, \
                               n_u, n_steps, bucket, cols, n_members, st,    \
                               stream);                                      \
    }
DM_K5_ENTRY(dm_alpha_phase_full_multi_f32, float)
DM_K5_ENTRY(dm_alpha_phase_full_multi_f64, double)

// The row bucket at p rows (K2, K3, K5, K6, K9, K10): 8, 16 or 32 in the
// register form, 64 in the two-row form, 0 above (p > 64)
int dm_row_bucket(int p) { return dm::row_bucket(p); }

// The two-row form's slab row stride at p rows (33-64)
int dm_two_row_stride(int p) { return dm::two_row_stride(p); }

// The glue kernels' dynamic shared memory at p rows and n_s columns, in
// bytes: 0 in the register form (p <= 32); in the two-row form the slab
// of a block's one column (the momentum or step-size table follows it
// where it fits); above 64 rows the one-block wide loop's slabs, which
// the column blocks replaced and whose warps their cost's groups keep
// (above the card's limit when one warp's slab does not fit).
long long dm_glue_smem(int itemsize, int p, int n_s) {
    if (p <= kMaxP) return 0;
    if (p <= dm::kTwoRowP)
        return dm::two_row_elems(p) * itemsize;
    const int w = dm::glue_warps(itemsize, p, n_s);
    return (w < 1 ? 1 : w) * dm::glue_warp_elems(p) * itemsize;
}

// K2's and K5's column-block plan at p > 64 rows of itemsize-byte values:
// out[0] blocks a column, out[1] rows a block, out[2] threads a block,
// out[3] where its values live (0 shared memory, 1 G_s's rows in device
// memory, 2 all in device memory); returns the block's dynamic shared
// memory before the momentum table, in bytes
// (ops/cuda_small.alpha_column_plan is its Python copy)
long long dm_alpha_column_plan(int itemsize, int p, int* out) {
    const ColumnPlan plan = dm::alpha_column_plan(itemsize, p);
    out[0] = plan.blocks;
    out[1] = plan.rows;
    out[2] = plan.threads;
    out[3] = plan.device;
    return plan.bytes;
}

// Elements of the device rows' buffer a member at p rows and n_s columns
// (K2, K5, K9: 0 in the column blocks)
long long dm_alpha_column_work(int itemsize, int p, int n_s) {
    const ColumnPlan plan = dm::alpha_column_plan(itemsize, p);
    return static_cast<long long>(n_s) * plan.blocks
           * dm::column_block_elems(plan.device, plan.rows, p,
                                    dm::kAlphaPRows, dm::kAlphaRRows);
}

// What the card gives K2's column kernel at p rows (its layout there):
// out[0] the largest cluster it would place, out[1] the clusters of the
// plan's blocks it holds at once (dm::column_capacity)
int dm_alpha_column_capacity(int itemsize, int p, int* out) {
    const ColumnPlan plan = dm::alpha_column_plan(itemsize, p);
    const size_t smem = static_cast<size_t>(plan.bytes);
#define DM_K2_CAPACITY(T)                                                    \
    (plan.device == dm::kSharedRows                                          \
         ? dm::column_capacity(alpha_phase_columns_kernel<T, false, 0>,      \
                               plan, smem, out)                              \
         : plan.device == dm::kDeviceRows                                    \
               ? dm::column_capacity(alpha_phase_columns_kernel<T, false, 1>,\
                                     plan, smem, out)                        \
               : dm::column_capacity(alpha_phase_columns_kernel<T, false, 2>,\
                                     plan, smem, out))
    return itemsize == 8 ? DM_K2_CAPACITY(double) : DM_K2_CAPACITY(float);
#undef DM_K2_CAPACITY
}

// The groups in which K2's and K5's column blocks sum the columns
// (ops/cuda_small.alpha_column_groups)
int dm_alpha_column_groups(int itemsize, int p, int n_s) {
    return column_groups(itemsize, p, n_s);
}

}  // extern "C"
