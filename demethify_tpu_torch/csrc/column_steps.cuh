// The column-block form's step loops (p > 64 rows), shared by the glue
// kernels that assemble their Grams (K2, K5: alpha_phase_full.cu; K3, K6:
// fw_phase_full.cu) and the single-phase kernels that take an assembled G
// and b (K9: alpha_phase.cu; K10: fw_phase.cu), with the plans and the
// cluster launch they share. Each loop is written once, so a column's
// arithmetic is the same in every kernel that runs it.
//
// Each sample column has a thread block of its own, or a thread-block
// cluster of C <= 16 blocks (small_common.cuh column_plan). Block c of the
// cluster owns rows [c R, c R + R) (R rows a block), thread t its row
// q = c R + t, and values cross the blocks through distributed shared
// memory, with cluster barriers where C > 1. The block keeps its R rows of
// G_s transposed (entry r of row q at r R + t, so a warp reads consecutive
// words at each r). Where they live is the plan's `device`:
//   - kSharedRows, the column blocks: G_s's rows and the column's rows of
//     p values in the block's shared memory, one row a thread (R <= 242);
//   - kDeviceRows, where 16 blocks' shared memory cannot hold G_s: the
//     block's R rows of G_s in its region of a device buffer the wrapper
//     allocates, in the same transposed layout (a warp's loads coalesce),
//     the rows of p values still in shared memory; up to 1024 threads a
//     block, and past that thread t owns rows t, t + n_threads, ... of
//     the block, each row summed on its own as before;
//   - kDeviceColumn, where even the rows of p values do not fit: those in
//     the block's region too, each block its own copies as in shared
//     memory; a value for another block goes to that block's copy in
//     device memory, a fence and a cluster barrier before it is read, and
//     it is read from L2 (__ldcg).
// The caller loads the block's rows and the column; the loops run the
// steps; the caller writes what it keeps. Every value and every order is
// that of the one-warp wide loop these forms replaced (lane q taking rows
// q, q + 32, ...): a row's sum runs over r in index order whichever thread
// forms it, the rank is stable by comparison, the cumulative sum runs in
// rank order, a block minimum compares equal and its first row is the
// smallest, so every layout gives that loop's bits.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <set>
#include <tuple>

#include "glue_steps.cuh"
#include "small_common.cuh"

namespace dm {

namespace cg = cooperative_groups;

// The threads a block of a layout may take (the kernels' launch bounds)
__host__ __device__ constexpr int column_threads(int device) {
    return device == kSharedRows ? kColumnThreads : kDeviceRowThreads;
}

// The alpha loop's rows: R rows of G_s and seven rows of p -- alpha,
// alpha_prev, the momentum point a_t, v (two, by step parity), the values
// in rank order and their prefix sums -- before the momentum table (K2,
// K5, K9; dm_alpha_column_plan).
constexpr int kAlphaPRows = 7, kAlphaRRows = 0;
inline ColumnPlan alpha_column_plan(int itemsize, int p) {
    return column_plan(itemsize, p, kAlphaPRows, kAlphaRRows);
}

// The Frank-Wolfe loop's: R rows of G_s, alpha, and R values each of b
// and G_s alpha (the gradient during the device rows' steps; K3's and
// K6's cost epilogue; K10's column blocks leave them unused, so its
// blocks are K3's; dm_fw_column_plan).
constexpr int kFwPRows = 1, kFwRRows = 2;
inline ColumnPlan fw_column_plan(int itemsize, int p) {
    return column_plan(itemsize, p, kFwPRows, kFwRRows);
}

// The rows of a thread in a layout: t = tid + j n_threads for j < this
// (one in the column blocks, a constant there, so the loops over them are
// straight code)
template <int DEV>
__device__ __forceinline__ int rows_per_thread(int rows, int n_threads) {
    return DEV == kSharedRows ? 1 : (rows + n_threads - 1) / n_threads;
}

// Block `rank`'s region of the device buffer `work` for column `column`
// (the member's column index, mb n_s + s) of a cluster of n_blocks
// (nullptr in the column blocks)
template <int DEV, typename T>
__device__ __forceinline__ T* column_region(T* work, long long column,
                                            int rank, int n_blocks, int rows,
                                            int p, int p_rows, int r_rows) {
    if constexpr (DEV == kSharedRows) return nullptr;
    return work + (column * n_blocks + rank)
                      * column_block_elems(DEV, rows, p, p_rows, r_rows);
}

// Where the block's rows of G_s start: its shared memory, or its region
template <int DEV, typename T>
__device__ __forceinline__ T* column_gram(unsigned char* smem, T* region) {
    if constexpr (DEV == kSharedRows) return reinterpret_cast<T*>(smem);
    return region;
}

// Where the block's rows of p (and R) values start: after G_s's rows in
// shared memory, at the start of shared memory, or after G_s's rows in the
// block's region
template <int DEV, typename T>
__device__ __forceinline__ T* column_line(unsigned char* smem, T* region,
                                          int rows, int p) {
    T* sh = reinterpret_cast<T*>(smem);
    if constexpr (DEV == kSharedRows) return sh + rows * p;
    if constexpr (DEV == kDeviceRows) return sh;
    return region + static_cast<long long>(rows) * p;
}

// Block cb's copy of the block-local row x: through distributed shared
// memory, or at cb's region (stride elements a block) in device memory
template <int DEV, typename T>
__device__ __forceinline__ T* peer(cg::cluster_group& cluster, T* x, int cb,
                                   int n_blocks, long long stride) {
    if constexpr (DEV == kDeviceColumn)
        return x + (cb - static_cast<int>(cluster.block_rank())) * stride;
    return n_blocks > 1 ? cluster.map_shared_rank(x, cb) : x;
}

// A value another block wrote into this block's copy: from L2 where the
// copy is in device memory (a line of it in this SM's L1 may be stale)
template <int DEV, typename T>
__device__ __forceinline__ T peer_load(const T* x) {
    if constexpr (DEV == kDeviceColumn) return __ldcg(x);
    return *x;
}

// One column's rows in the alpha loop's layout: sg the block's rows of
// G_s, the rest the rows of p values from `line` on, tab the momentum
// table (or null) and stride the elements between two blocks' copies in
// device memory (kDeviceColumn; 0 otherwise)
template <typename T>
struct AlphaColumn {
    T *sg, *sal, *sap, *sat, *sv, *srt, *spi, *tab;
    long long stride;
    __device__ AlphaColumn(T* g, T* line, int p, T* table,
                           long long peer_stride)
        : sg(g),
          sal(line),                           // alpha (p)
          sap(sal + p),                        // alpha_prev (p)
          sat(sap + p),                        // a_t (p)
          sv(sat + p),                         // v (2 p, step parity)
          srt(sv + 2 * p),                     // v in rank order (p)
          spi(srt + p),                        // its prefix sums - 1
          tab(table),
          stride(peer_stride) {}
};

// The alpha column of a block in layout DEV: its rows from the dynamic
// shared memory and its region, the momentum table in shared memory after
// the rows that live there where use_table
template <int DEV, typename T>
__device__ __forceinline__ AlphaColumn<T> alpha_column(unsigned char* smem,
                                                       T* region, int rows,
                                                       int p,
                                                       bool use_table) {
    T* line = column_line<DEV>(smem, region, rows, p);
    T* tab = nullptr;
    if (use_table)
        tab = DEV == kDeviceColumn ? reinterpret_cast<T*>(smem)
                                   : line + kAlphaPRows * p;
    return AlphaColumn<T>(
        column_gram<DEV>(smem, region), line, p, tab,
        DEV == kDeviceColumn
            ? column_block_elems(DEV, rows, p, kAlphaPRows, kAlphaRRows)
            : 0);
}

// A barrier of the column's blocks, after a fence where they hand each
// other values through device memory
template <int DEV = kSharedRows>
__device__ __forceinline__ void column_sync(cg::cluster_group& cluster,
                                            int n_blocks) {
    if constexpr (DEV == kDeviceColumn) __threadfence();
    if (n_blocks > 1)
        cluster.sync();
    else
        __syncthreads();
}

// n_steps alpha FISTA steps on the block's column: c.sg holds the block's
// rows of G_s, c.sal and c.sap the whole column's alpha and alpha_prev
// (each block its own copy); the block owns rows q0 .. q0 + own - 1, and
// b_of(t) and masked_of(t) give row q0 + t's b and whether it is masked
// (the column blocks pass the thread's own, in registers). A step:
//   - each thread forms its rows' v = a_t,q + (b_q - (G a_t)_q) / l_h,
//     the sum over r in index order, -1e30 where the row is masked, and
//     writes each into every block's copy of v (two copies by step
//     parity); one barrier (a cluster barrier where C > 1);
//   - each thread ranks its rows among the p values (the stable
//     descending rank by comparison) and writes each value into that slot
//     of every block's rank row (a NaN marks the step instead: its rank
//     is another row's); a second barrier;
//   - one thread per block runs the cumulative sum in rank order, one
//     chain of p adds (the bits fix its order), its loads a chunk ahead;
//   - the threads test the ranks side by side, (u_j - pi_j / (j + 1)) > 0,
//     a division each, and rho, the last rank that passes, is a block
//     maximum (rank 0 where none does): the serial loop's last-index rho;
//   - theta = pi_rho / (rho + 1) (NaN at a marked step), and every block
//     updates its copies of alpha, alpha_prev and the next step's a_t the
//     same way, the betas from the block's momentum table
//     (small_common.cuh momentum_table) where c.tab is set, else the chain
//     replayed (the same values).
// Returns the advanced Nesterov scalar. After it no block reads another's
// copies.
template <int DEV, typename T, class RowB, class RowMasked>
__device__ __forceinline__ T alpha_column_steps(
        cg::cluster_group& cluster, const AlphaColumn<T>& c, RowB b_of,
        RowMasked masked_of, int own, int q0, int p, int rows, T a0,
        T l_h_prev0, T l_h, int n_steps) {
    __shared__ int red[column_threads(DEV) / 32];
    __shared__ int nan_step;       // 1 + the last step whose v held a NaN
    const int n_blocks = static_cast<int>(cluster.num_blocks());
    const int tid = threadIdx.x;
    const int n_threads = blockDim.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int n_warps = n_threads >> 5;
    const int per = rows_per_thread<DEV>(rows, n_threads);
    T* sal = c.sal;
    T* sap = c.sap;
    T* sat = c.sat;
    T* srt = c.srt;
    T* spi = c.spi;
    T* tab = c.tab;
    const bool use_table = tab != nullptr;
    if (tid == 0) nan_step = 0;
    if (use_table)                         // uniform over the block
        momentum_table(tab, a0, l_h_prev0, l_h, n_steps, tid, n_threads,
                       [] { __syncthreads(); });
    // step k's beta: from the table, or the chain replayed (the same
    // values; a then holds the advanced Nesterov scalar)
    T a = a0, l_prev = l_h_prev0;
    auto beta_of = [&](int k) {
        if (use_table) return tab[k];
        const T a2n = nesterov(a);
        const T beta = min_nan((a - T(1)) / a2n,
                               T(0.9999) * sqrt_t(l_prev / l_h));
        a = a2n;
        l_prev = l_h;
        return beta;
    };
    if (n_steps > 0) {
        const T beta = beta_of(0);
        for (int r = tid; r < p; r += n_threads)
            sat[r] = sal[r] + beta * (sal[r] - sap[r]);
    }
    // every block of the cluster has started before any reads or writes
    // another's copies
    column_sync<DEV>(cluster, n_blocks);

    for (int k = 0; k < n_steps; ++k) {
        T* vk = c.sv + (k & 1) * p;
        // this thread's rows of v, each written to every block's copy (the
        // column blocks keep their one row's in a register)
        T v = T(0);
        for (int j = 0; j < per; ++j) {
            const int t = tid + j * n_threads;
            if (t < own) {
                const int q = q0 + t;
                v = sat[q] + (b_of(t) - column_row_dot(c.sg, sat, rows, t, p))
                                 / l_h;
                if (masked_of(t)) v = T(-1e30);
                for (int cb = 0; cb < n_blocks; ++cb)
                    peer<DEV>(cluster, vk, cb, n_blocks, c.stride)[q] = v;
            }
        }
        column_sync<DEV>(cluster, n_blocks);
        // each row's stable descending rank by comparison with the p
        // values, its value into that slot of every block's srt (a NaN
        // marks the step instead: its rank is another row's)
        for (int j = 0; j < per; ++j) {
            const int t = tid + j * n_threads;
            if (t < own) {
                const int q = q0 + t;
                const T vq = DEV == kSharedRows ? v : peer_load<DEV>(vk + q);
                int rk = 0;
                for (int r = 0; r < p; ++r) {
                    const T vr = peer_load<DEV>(vk + r);
                    rk += (vr > vq) || (vr == vq && r < q);
                }
                for (int cb = 0; cb < n_blocks; ++cb) {
                    if (vq != vq)
                        *(n_blocks > 1 ? cluster.map_shared_rank(&nan_step, cb)
                                       : &nan_step) = k + 1;
                    else
                        peer<DEV>(cluster, srt, cb, n_blocks, c.stride)[rk] =
                            vq;
                }
            }
        }
        column_sync<DEV>(cluster, n_blocks);
        // the cumulative sum in rank order: one chain of p adds, its
        // loads a chunk ahead
        if (tid == 0) {
            const T* __restrict__ u = srt;
            T* __restrict__ pi = spi;
            T csum = T(0);
            for (int j0 = 0; j0 < p; j0 += 8) {
                T uj[8];
#pragma unroll
                for (int i = 0; i < 8; ++i)
                    uj[i] = j0 + i < p ? peer_load<DEV>(u + j0 + i) : T(0);
#pragma unroll
                for (int i = 0; i < 8; ++i) {
                    if (j0 + i < p) {
                        csum += uj[i];
                        pi[j0 + i] = csum - T(1);
                    }
                }
            }
        }
        __syncthreads();
        // each rank's test side by side; rho the last rank that passes
        // (a block maximum), rank 0 where none does
        int best = -1;
        for (int j = tid; j < p; j += n_threads)
            if ((peer_load<DEV>(srt + j) - spi[j] / T(j + 1)) > T(0))
                best = j;
        best = __reduce_max_sync(kFull, best);
        if (lane == 0) red[warp] = best;
        __syncthreads();
        int rho = 0;
        for (int w = 0; w < n_warps; ++w) rho = red[w] > rho ? red[w] : rho;
        const T theta = spi[rho] / T(rho + 1)
                        + (nan_step == k + 1 ? quiet_nan<T>() : T(0));
        // alpha, alpha_prev and the next step's a_t in every block alike
        const T beta = k + 1 < n_steps ? beta_of(k + 1) : T(0);
        for (int r = tid; r < p; r += n_threads) {
            const T out = peer_load<DEV>(vk + r) - theta;
            const T prev = sal[r];
            const T next = out < T(0) ? T(0) : out;
            sap[r] = prev;
            sal[r] = next;
            sat[r] = next + beta * (next - prev);
        }
        __syncthreads();                    // alpha is whole again
    }
    return use_table ? tab[n_steps] : a;
}

// One warp's (known, unknown) block minima and the first rows holding
// them (p where none does)
template <typename T>
struct WarpMin {
    T m1, m2;
    int i1, i2;
};

// Folds a warp's minimum and first row (m2, i2) into (m, i): a NaN
// minimum stays (it matches no row, so i is p), a smaller one replaces
// it, an equal one keeps the smaller first row -- the minimum over the
// rows compares equal to the one-warp loop's and the first row is the
// same, whatever order the warps are folded in.
template <typename T>
__device__ __forceinline__ void fold_min(T& m, int& i, T m2, int i2) {
    if (m != m) return;
    if (m2 != m2 || m2 < m) {
        m = m2;
        i = i2;
    } else if (m2 == m && i2 < i) {
        i = i2;
    }
}

// n_steps Frank-Wolfe steps on the block's column: sg holds the block's
// rows of G_s (its first row q0), sal the whole column's alpha (each
// block its own copy, loaded before a barrier); this thread (tid: lane
// of warp, n_warps a block) owns row q0 + tid (row) with its b, in the
// known block (rows below the known count) or not; red is the caller's
// shared pair of rows of the warps' minima. A step: each thread forms its
// row's gradient, summed over r in index order; each warp's (known,
// unknown) minima by butterfly (padding +inf, the other block's rows the
// TPU kernel's 3.4e38 mask) and their first rows by ballot; after one
// barrier (a cluster barrier when C = n_blocks > 1, the warps' pairs
// double-buffered by step parity) every thread folds all the warps'
// pairs, read through distributed shared memory, into the same minima and
// first rows in every block, and each block updates its copy of alpha
// identically with gamma = 2 / (k + 2). A NaN-propagating minimum and the
// smallest row holding it do not depend on the order in which rows are
// visited, and each row's sum is the same sum whichever thread forms it.
// In the device rows (DEV) a thread owns rows t = tid + j blockDim.x of
// the block's `own` (b of row t at sb[t], rows below n_known in the known
// block): it forms their gradients into sgr[t] and its minima over them,
// and each warp's first row is the smallest of its rows holding the
// warp's minimum -- the same minima and first rows.
// After the last step other blocks may still read this block's minima: a
// cluster barrier must come before a block leaves. The column blocks'
// locals come in as they are: a version that derived them itself (and
// declared red) compiled to the same instructions in another order, and
// K3 took 5.4% longer at p = 200 on an NVIDIA H100 80GB HBM3 at 700 W
// (chip_smoke.time_cases' "phase" table; PERF.md).
template <typename T, int DEV = kSharedRows>
__device__ __forceinline__ void fw_column_steps(
        cg::cluster_group& cluster, int n_blocks,
        WarpMin<T> (*red)[column_threads(DEV) / 32], T* sg, T* sal, T b,
        bool row, bool known, int q0, int tid, int lane, int warp,
        int n_warps, int p, int rows, T pur, T pur2, int n_steps,
        const T* sb = nullptr, T* sgr = nullptr, int own = 0,
        int n_known = 0) {
    const T big = T(3.4e38);                // the TPU kernel's block mask
    const T pad = pos_inf<T>();
    const int per = rows_per_thread<DEV>(rows, blockDim.x);
    for (int k = 0; k < n_steps; ++k) {
        if constexpr (DEV == kSharedRows) {
            T g1 = pad, g2 = pad;
            if (row) {
                const T grad = -(b - column_row_dot(sg, sal, rows, tid, p));
                g1 = known ? grad : big;
                g2 = known ? big : grad;
            }
            const T m1 = warp_min(g1);
            const T m2 = warp_min(g2);
            const unsigned h1 = __ballot_sync(kFull, row && g1 == m1);
            const unsigned h2 = __ballot_sync(kFull, row && g2 == m2);
            WarpMin<T>* mine = red[k & 1];
            if (lane == 0)
                mine[warp] = WarpMin<T>{
                    m1, m2, h1 ? q0 + 32 * warp + __ffs(h1) - 1 : p,
                    h2 ? q0 + 32 * warp + __ffs(h2) - 1 : p};
        } else {
            T g1 = pad, g2 = pad;           // over the thread's rows
            for (int j = 0; j < per; ++j) {
                const int t = tid + j * static_cast<int>(blockDim.x);
                if (t < own) {
                    const T grad =
                        -(sb[t] - column_row_dot(sg, sal, rows, t, p));
                    sgr[t] = grad;
                    const bool kn = q0 + t < n_known;
                    g1 = min_nan(g1, kn ? grad : big);
                    g2 = min_nan(g2, kn ? big : grad);
                }
            }
            const T m1 = warp_min(g1);
            const T m2 = warp_min(g2);
            int f1 = p, f2 = p;
            for (int j = 0; j < per; ++j) {  // uniform over the warp
                const int t = tid + j * static_cast<int>(blockDim.x);
                const bool r = t < own;
                const bool kn = q0 + t < n_known;
                const T gr = r ? sgr[t] : pad;
                const unsigned h1 =
                    __ballot_sync(kFull, r && (kn ? gr : big) == m1);
                const unsigned h2 =
                    __ballot_sync(kFull, r && (kn ? big : gr) == m2);
                const int base =
                    q0 + j * static_cast<int>(blockDim.x) + 32 * warp - 1;
                if (f1 == p && h1) f1 = base + __ffs(h1);
                if (f2 == p && h2) f2 = base + __ffs(h2);
            }
            WarpMin<T>* mine = red[k & 1];
            if (lane == 0) mine[warp] = WarpMin<T>{m1, m2, f1, f2};
        }
        WarpMin<T>* mine = red[k & 1];
        if (n_blocks > 1)
            cluster.sync();
        else
            __syncthreads();
        T b1 = pad, b2 = pad;
        int i1 = p, i2 = p;
        for (int c = 0; c < n_blocks; ++c) {
            const WarpMin<T>* theirs =
                n_blocks > 1 ? cluster.map_shared_rank(mine, c) : mine;
            for (int w = 0; w < n_warps; ++w) {
                const WarpMin<T> e = theirs[w];
                fold_min(b1, i1, e.m1, e.i1);
                fold_min(b2, i2, e.m2, e.i2);
            }
        }
        const T gamma = T(2) / (static_cast<T>(k) + T(2));
        for (int r = tid; r < p; r += blockDim.x) {
            const T e1 = r == i1 ? T(1) : T(0);
            const T e2 = r == i2 ? T(1) : T(0);
            const T vert = e1 * pur + e2 * pur2;
            sal[r] = (T(1) - gamma) * sal[r] + gamma * vert;
        }
        __syncthreads();                    // alpha is whole again
    }
}

// A column's cost terms in the one-warp loop's order, in the calling
// warp (block 0's warp 0): lane l over rows l, l + 32, ..., then the
// shuffle-down tree, reading each block's b (sb) and G_s alpha (sga) of
// its rows (row t of a block at index t) where that block keeps them; the
// terms b.a, a.(b - G a) and ||alpha_unknown||^2 go to cs[s], cs[n_s + s]
// and cs[2 n_s + s] (K2, K5, K3, K6)
template <int DEV, typename T>
__device__ __forceinline__ void column_cost_terms(
        cg::cluster_group& cluster, int n_blocks, long long stride,
        const T* sal, T* sb, T* sga, int lane, int rows, int p, int n_u,
        T* cs, int s, int n_s) {
    T ba = T(0), ag = T(0), lw = T(0);
    for (int qq = lane; qq < p; qq += 32) {
        const int cb = qq / rows;
        const T* rb = peer<DEV>(cluster, sb, cb, n_blocks, stride);
        const T* rga = peer<DEV>(cluster, sga, cb, n_blocks, stride);
        const T al = sal[qq];
        const T bq = peer_load<DEV>(rb + (qq - cb * rows));
        const T ga = peer_load<DEV>(rga + (qq - cb * rows));
        ba += bq * al;
        ag += al * (bq - ga);
        if (qq >= p - n_u) lw += al * al;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        ba += __shfl_down_sync(kFull, ba, off);
        ag += __shfl_down_sync(kFull, ag, off);
        lw += __shfl_down_sync(kFull, lw, off);
    }
    if (lane == 0) {
        cs[s] = ba;
        cs[n_s + s] = ag;
        cs[2 * n_s + s] = lw;
    }
}

// Whether a launch's momentum table of tab bytes follows the plan's bytes
// in shared memory: at most 48 KB of table, and the total under the
// card's limit (else the steps replay the chain, the same values)
inline bool column_table_fits(const ColumnPlan& plan, size_t tab) {
    return tab <= 48 * 1024
           && plan.bytes + static_cast<long long>(tab) <= kGlueSmemLimit;
}

// The launch configuration of a column-block launch of `kern`: a grid of
// n_s * plan.blocks blocks (x) by `members` (y) in clusters of plan.blocks
// (the cluster dimension attribute, in attr), plan.threads threads and
// smem bytes of dynamic shared memory. The kernel is opted once into
// kGlueSmemLimit bytes, less what its static shared memory takes past
// 1 KB (the card's 232,448 bytes a block in all), and into clusters past
// the portable 8 blocks.
template <typename K>
int column_config(K kern, const ColumnPlan& plan, int n_s, int members,
                  size_t smem, cudaStream_t stream, cudaLaunchConfig_t& cfg,
                  cudaLaunchAttribute* attr) {
    cfg = {};
    cfg.gridDim = dim3(n_s * plan.blocks, members);
    cfg.blockDim = dim3(plan.threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = plan.blocks;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    static std::set<const void*> opted;
    const void* key = reinterpret_cast<const void*>(kern);
    if (opted.count(key) == 0) {
        cudaFuncAttributes fa;
        cudaError_t err = cudaFuncGetAttributes(&fa, kern);
        const long long room =
            kGlueSmemLimit + 1024 - static_cast<long long>(fa.sharedSizeBytes);
        if (err == cudaSuccess)
            err = cudaFuncSetAttribute(
                kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                static_cast<int>(room < kGlueSmemLimit ? room
                                                       : kGlueSmemLimit));
        if (err == cudaSuccess)
            err = cudaFuncSetAttribute(
                kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        if (err != cudaSuccess) return static_cast<int>(err);
        opted.insert(key);
    }
    return 0;
}

// Launches `kern` in the column-block form (column_config). Each (kernel,
// blocks, threads, bytes) is checked once with
// cudaOccupancyMaxActiveClusters: cudaErrorInvalidConfiguration where the
// card cannot place one cluster.
template <typename... Params, typename... Args>
int launch_column_blocks(void (*kern)(Params...), const ColumnPlan& plan,
                         int n_s, int members, size_t smem,
                         cudaStream_t stream, Args... args) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr[1];
    const int err =
        column_config(kern, plan, n_s, members, smem, stream, cfg, attr);
    if (err != 0) return err;
    static std::set<std::tuple<const void*, int, int, size_t>> placed;
    const void* key = reinterpret_cast<const void*>(kern);
    if (placed.count({key, plan.blocks, plan.threads, smem}) == 0) {
        int clusters = 0;
        const cudaError_t e =
            cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
        if (e != cudaSuccess) return static_cast<int>(e);
        if (clusters < 1)
            return static_cast<int>(cudaErrorInvalidConfiguration);
        placed.insert({key, plan.blocks, plan.threads, smem});
    }
    return static_cast<int>(cudaLaunchKernelEx(&cfg, kern, args...));
}

// What the card gives kernel `kern` at a plan and smem bytes: out[0] the
// largest cluster it would place (cudaOccupancyMaxPotentialClusterSize),
// out[1] the clusters of plan.blocks it holds at once
// (cudaOccupancyMaxActiveClusters); returns the cudaError_t
template <typename K>
int column_capacity(K kern, const ColumnPlan& plan, size_t smem, int* out) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr[1];
    const int err = column_config(kern, plan, 1, 1, smem, nullptr, cfg, attr);
    if (err != 0) return err;
    out[0] = out[1] = 0;
    cudaError_t e = cudaOccupancyMaxActiveClusters(&out[1], kern, &cfg);
    if (e != cudaSuccess) return static_cast<int>(e);
    cfg.numAttrs = 0;
    return static_cast<int>(
        cudaOccupancyMaxPotentialClusterSize(&out[0], kern, &cfg));
}

// The single-phase kernels' forms at p rows (K9, K10; ops/cuda_small
// PHASE_FORMS): the register form, the two-row form, the column blocks
// and, past 16 of them, the device rows
enum PhaseForm { kRegisterForm = 0, kTwoRowForm, kColumnBlocks, kDeviceRowsForm };

// A single-phase kernel's plan at p rows from its column plan `plan`:
// out[0] the form, out[1] the row bucket (8, 16, 32; 64 in the two-row
// form; 0 above), out[2-5] the column plan's blocks, rows, threads and
// where its values live; returns a block's dynamic shared memory before
// any step table (0 in the register form)
inline long long phase_plan(int itemsize, int p, const ColumnPlan& plan,
                            int* out) {
    out[1] = row_bucket(p);
    out[2] = out[3] = out[4] = out[5] = 0;
    if (p <= kMaxP) {
        out[0] = kRegisterForm;
        return 0;
    }
    if (p <= kTwoRowP) {
        out[0] = kTwoRowForm;
        return two_row_elems(p) * itemsize;
    }
    out[0] = plan.device == kSharedRows ? kColumnBlocks : kDeviceRowsForm;
    out[2] = plan.blocks;
    out[3] = plan.rows;
    out[4] = plan.threads;
    out[5] = plan.device;
    return plan.bytes;
}

}  // namespace dm
