// The column-block form's step loops (p > 64 rows), shared by the glue
// kernels that assemble their Grams (K2, K5: alpha_phase_full.cu; K3, K6:
// fw_phase_full.cu) and the single-phase kernels that take an assembled G
// and b (K9: alpha_phase.cu; K10: fw_phase.cu), with the plans and the
// cluster launch they share. Each loop is written once, so a column's
// arithmetic is the same in every kernel that runs it.
//
// Each sample column has a thread block of its own, or a thread-block
// cluster of C <= 8 blocks where one block's shared memory cannot hold
// the column (the plans below). Thread t of cluster block c owns row
// q = c R + t (R rows a block); the block keeps its R rows of G_s in
// shared memory, transposed (entry r of row q at r R + t, so a warp
// reads consecutive words at each r), and values cross the blocks through
// distributed shared memory, with cluster barriers where C > 1. The
// caller loads the block's rows and the column; the loops run the steps;
// the caller writes what it keeps. Every value and every order is the
// one-warp wide loop's (glue_steps.cuh alpha_steps_wide, fw_steps_wide),
// so the forms give its bits.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <set>
#include <tuple>

#include "glue_steps.cuh"
#include "small_common.cuh"

namespace dm {

namespace cg = cooperative_groups;

// The alpha loop's plan: a block's shared memory holds R rows of G_s and
// seven rows of p -- alpha, alpha_prev, the momentum point a_t, v (two, by
// step parity), the values in rank order and their prefix sums -- before
// the momentum table (K2, K5, K9; dm_alpha_column_plan).
inline ColumnPlan alpha_column_plan(int itemsize, int p) {
    return column_plan(itemsize, p, 7, 0);
}

// The Frank-Wolfe loop's plan: R rows of G_s, alpha, and R values each of
// b and G_s alpha (K3's and K6's cost epilogue; K10 leaves them unused, so
// its blocks are K3's; dm_fw_column_plan).
inline ColumnPlan fw_column_plan(int itemsize, int p) {
    return column_plan(itemsize, p, 1, 2);
}

// One column's shared rows in the alpha loop's layout, from the block's
// dynamic shared memory (the momentum table after them where use_table)
template <typename T>
struct AlphaColumn {
    T *sg, *sal, *sap, *sat, *sv, *srt, *spi, *tab;
    __device__ AlphaColumn(unsigned char* smem, int rows, int p,
                           bool use_table)
        : sg(reinterpret_cast<T*>(smem)),      // rows x p, transposed
          sal(sg + rows * p),                  // alpha (p)
          sap(sal + p),                        // alpha_prev (p)
          sat(sap + p),                        // a_t (p)
          sv(sat + p),                         // v (2 p, step parity)
          srt(sv + 2 * p),                     // v in rank order (p)
          spi(srt + p),                        // its prefix sums - 1
          tab(use_table ? spi + p : nullptr) {}
};

__device__ __forceinline__ void column_sync(cg::cluster_group& cluster,
                                            int n_blocks) {
    if (n_blocks > 1)
        cluster.sync();
    else
        __syncthreads();
}

// n_steps alpha FISTA steps on the block's column: c.sg holds the block's
// rows of G_s, c.sal and c.sap the whole column's alpha and alpha_prev
// (each block its own copy); this thread owns row q (row: q is one of the
// block's rows) with its b and mask. A step:
//   - each thread forms its row's v = a_t,q + (b_q - (G a_t)_q) / l_h,
//     the sum over r in index order, -1e30 where the row is masked, and
//     writes it into every block's copy of v (two copies by step parity);
//     one barrier (a cluster barrier where C > 1);
//   - each thread ranks its row among the p values (the stable descending
//     rank by comparison) and writes its value into that slot of every
//     block's rank row (a NaN marks the step instead: its rank is another
//     row's); a second barrier;
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
// shared memory.
template <typename T>
__device__ __forceinline__ T alpha_column_steps(
        cg::cluster_group& cluster, const AlphaColumn<T>& c, T b,
        bool masked, bool row, int q, int p, int rows, T a0, T l_h_prev0,
        T l_h, int n_steps) {
    __shared__ int red[kColumnThreads / 32];
    __shared__ int nan_step;       // 1 + the last step whose v held a NaN
    const int n_blocks = static_cast<int>(cluster.num_blocks());
    const int tid = threadIdx.x;
    const int n_threads = blockDim.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int n_warps = n_threads >> 5;
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
    // another's shared memory
    column_sync(cluster, n_blocks);

    for (int k = 0; k < n_steps; ++k) {
        T* vk = c.sv + (k & 1) * p;
        // this thread's row of v, written to every block's copy
        T v = T(0);
        if (row) {
            v = sat[q] + (b - column_row_dot(c.sg, sat, rows, tid, p)) / l_h;
            if (masked) v = T(-1e30);
            for (int cb = 0; cb < n_blocks; ++cb)
                (n_blocks > 1 ? cluster.map_shared_rank(vk, cb) : vk)[q] = v;
        }
        column_sync(cluster, n_blocks);
        // the row's stable descending rank by comparison with the p
        // values, its value into that slot of every block's srt (a NaN
        // marks the step instead: its rank is another row's)
        if (row) {
            int rk = 0;
            for (int r = 0; r < p; ++r) {
                const T vr = vk[r];
                rk += (vr > v) || (vr == v && r < q);
            }
            for (int cb = 0; cb < n_blocks; ++cb) {
                if (v != v)
                    *(n_blocks > 1 ? cluster.map_shared_rank(&nan_step, cb)
                                   : &nan_step) = k + 1;
                else
                    (n_blocks > 1 ? cluster.map_shared_rank(srt, cb)
                                  : srt)[rk] = v;
            }
        }
        column_sync(cluster, n_blocks);
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
                    uj[i] = j0 + i < p ? u[j0 + i] : T(0);
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
            if ((srt[j] - spi[j] / T(j + 1)) > T(0)) best = j;
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
            const T out = vk[r] - theta;
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
// After the last step other blocks may still read this block's minima: a
// cluster barrier must come before a block leaves. The caller's locals
// come in as they are: a version that derived them itself (and declared
// red) compiled to the same instructions in another order, and K3 took
// 5.4% longer at p = 200 on an NVIDIA H100 80GB HBM3 at 700 W
// (chip_smoke.time_cases' "phase" table; PERF.md).
template <typename T>
__device__ __forceinline__ void fw_column_steps(
        cg::cluster_group& cluster, int n_blocks,
        WarpMin<T> (*red)[kColumnThreads / 32], T* sg, T* sal, T b,
        bool row, bool known, int q0, int tid, int lane, int warp,
        int n_warps, int p, int rows, T pur, T pur2, int n_steps) {
    const T big = T(3.4e38);                // the TPU kernel's block mask
    const T pad = pos_inf<T>();
    for (int k = 0; k < n_steps; ++k) {
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
            mine[warp] = WarpMin<T>{m1, m2,
                                    h1 ? q0 + 32 * warp + __ffs(h1) - 1 : p,
                                    h2 ? q0 + 32 * warp + __ffs(h2) - 1 : p};
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

// Whether a launch's momentum table of tab bytes follows the plan's bytes
// in shared memory: at most 48 KB of table, and the total under the
// card's limit (else the steps replay the chain, the same values)
inline bool column_table_fits(const ColumnPlan& plan, size_t tab) {
    return tab <= 48 * 1024
           && plan.bytes + static_cast<long long>(tab) <= kGlueSmemLimit;
}

// Launches `kern` in the column-block form: a grid of n_s * plan.blocks
// blocks (x) by `members` (y) in clusters of plan.blocks (the cluster
// dimension attribute), plan.threads threads and smem bytes of dynamic
// shared memory. The kernel is opted into kGlueSmemLimit bytes once, and
// each (kernel, blocks, bytes) is checked once with
// cudaOccupancyMaxActiveClusters: cudaErrorInvalidConfiguration where the
// card cannot place one cluster.
template <typename... Params, typename... Args>
int launch_column_blocks(void (*kern)(Params...), const ColumnPlan& plan,
                         int n_s, int members, size_t smem,
                         cudaStream_t stream, Args... args) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(n_s * plan.blocks, members);
    cfg.blockDim = dim3(plan.threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = plan.blocks;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    static std::set<const void*> opted;
    static std::set<std::tuple<const void*, int, size_t>> placed;
    const void* key = reinterpret_cast<const void*>(kern);
    if (opted.count(key) == 0) {
        const cudaError_t err = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(kGlueSmemLimit));
        if (err != cudaSuccess) return static_cast<int>(err);
        opted.insert(key);
    }
    if (placed.count({key, plan.blocks, smem}) == 0) {
        int clusters = 0;
        const cudaError_t err =
            cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
        if (err != cudaSuccess) return static_cast<int>(err);
        if (clusters < 1)
            return static_cast<int>(cudaErrorInvalidConfiguration);
        placed.insert({key, plan.blocks, smem});
    }
    return static_cast<int>(cudaLaunchKernelEx(&cfg, kern, args...));
}

// The single-phase kernels' forms at p rows (K9, K10; ops/cuda_small
// PHASE_FORMS): the register form, the two-row form, the column blocks
// and, past eight of them, the device slabs
enum PhaseForm { kRegisterForm = 0, kTwoRowForm, kColumnBlocks, kDeviceSlabs };

// A single-phase kernel's plan at p rows from its column plan `plan`:
// out[0] the form, out[1] the row bucket (8, 16, 32; 64 in the two-row
// form; 0 above), out[2-4] the column plan's blocks, rows and threads;
// returns a block's dynamic shared memory before any step table (0 in the
// register form and the device slabs, whose work buffer is glue_work's)
inline long long phase_plan(int itemsize, int p, const ColumnPlan& plan,
                            int* out) {
    out[1] = row_bucket(p);
    out[2] = out[3] = out[4] = 0;
    if (p <= kMaxP) {
        out[0] = kRegisterForm;
        return 0;
    }
    if (p <= kTwoRowP) {
        out[0] = kTwoRowForm;
        return two_row_elems(p) * itemsize;
    }
    out[0] = plan.blocks > 0 ? kColumnBlocks : kDeviceSlabs;
    out[2] = plan.blocks;
    out[3] = plan.rows;
    out[4] = plan.threads;
    return plan.bytes;
}

}  // namespace dm
