// Pieces shared by the port's kernels: the solver's scalar slots and the
// FISTA scalar arithmetic (K1, K2, K4, K5), and for the glue kernels K2
// and K5 (alpha_phase_full.cu), K3 and K6 (fw_phase_full.cu) -- one warp
// per sample column, over blocks of columns and members -- the Gram row
// assembly, the product, the cost epilogue and the member bookkeeping, in
// two forms: lane q holds row q of alpha and of the column's Gram matrix
// in registers (p <= 32); or lane q holds rows q and q + 32 of alpha and b
// in registers and the warp keeps the column's Gram matrix in its slab of
// shared memory (the two-row form, 32 < p <= 64). Above 64 rows every
// glue kernel gives a column a block or a cluster of blocks, one row a
// thread, with its plan here (column_plan) and its loops in
// column_steps.cuh.

#pragma once

#include <cuda_runtime.h>

namespace dm {

// Slots of the solver's device scalar vector `scal` (one row per member
// in the multi-member solves; ops/cuda_kernels.py names the same slots):
// the U Nesterov scalar, l_w, l_w_prev, the alpha Nesterov scalar,
// l_h_prev, the cost, ||Rt||^2, dmax^2; the multi-member rows add the
// member's termination tolerance and its active flag.
constexpr int kAU = 0, kLW = 1, kLWPrev = 2, kAAlpha = 3, kLHPrev = 4,
              kCost = 5, kRtSq = 6, kDmax2 = 7, kTol = 8, kActive = 9;

// Slots of the single-phase kernels' scalar vector (K7: u_phase.cu, K9:
// alpha_phase.cu): the Nesterov scalar, the Lipschitz constant and its
// previous value (read), and the advanced Nesterov scalar and previous
// Lipschitz constant (written), so the inputs stay as they were. K7's
// first three slots are the solver's kAU, kLW, kLWPrev.
constexpr int kPhA = 0, kPhL = 1, kPhLPrev = 2, kPhAOut = 3,
              kPhLPrevOut = 4;

constexpr int kMaxP = 32;          // rows of the register form
constexpr unsigned kFull = 0xffffffffu;

// The one-block wide loop's shared memory (p > 64), which the column
// blocks replaced: per warp the column's Gram matrix (p x p) and six rows
// of p (b, alpha, alpha_prev and three work rows); as many warps as fit
// under the card's opt-in limit (232,448 bytes on an H100) less 1 KB for
// the kernels' static shared memory, at most 32 and at most n_s.
// glue_warps returns 0 when one warp does not fit. No kernel keeps these
// slabs any more: the column blocks' cost groups its columns as that
// loop's blocks did (column_groups).
constexpr long long kGlueSmemLimit = 232448 - 1024;

__host__ __device__ __forceinline__ long long glue_warp_elems(int p) {
    return static_cast<long long>(p) * p + 6LL * p;
}

// The most warps one block of kernel `kern` can hold, given its register
// use (cudaFuncGetAttributes): the glue kernels' register form holds a
// Gram row per lane, 64 registers in float64, so 32 warps of it do not fit
// one block's 65,536 registers. The launchers read it once per kernel (a
// static in each instantiation) and give a block at most that many warps,
// which then loop over the sample columns.
template <typename K>
int max_block_warps(K kern) {
    cudaFuncAttributes attr;
    if (cudaFuncGetAttributes(&attr, kern) != cudaSuccess) return 1;
    return attr.maxThreadsPerBlock / 32;
}

__host__ __device__ __forceinline__ int glue_warps(int itemsize, int p,
                                                   int n_s) {
    const long long fit = kGlueSmemLimit / (itemsize * glue_warp_elems(p));
    const long long w = n_s < 32 ? n_s : 32;
    return static_cast<int>(fit < w ? fit : w);
}

// Per-member element strides of the glue kernels' operands: K2 and K3
// are the one-member case (all zero). The known blocks gtt, bt and ydy
// have stride 0 when the members share them (the batched restarts) and
// their block size when each member has its own (the weighted bootstrap:
// each replicate's w-weighted known blocks).
struct MemberStrides {
    long long gtt, bt, ydy, gu, bu, usq, alpha, scal, mask;
};

// A glue kernel's last word on its member (thread 0): the new cost and,
// in the multi-member form, whether the member stays active,
// |cost - old cost| >= tol in the working dtype (the reference's
// termination test; NaN stops).
template <bool MULTI, typename T>
__device__ __forceinline__ void set_cost(T* __restrict__ sc, T cost) {
    if constexpr (MULTI) {
        const T diff = cost - sc[kCost];
        const T mag = diff < T(0) ? -diff : diff;
        sc[kActive] = mag >= sc[kTol] ? T(1) : T(0);
    }
    sc[kCost] = cost;
}

__device__ __forceinline__ float sqrt_t(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_t(double x) { return sqrt(x); }

template <typename T>
__device__ __forceinline__ T nesterov(T a) {
    return (T(1) + sqrt_t(T(1) + T(4) * a * a)) / T(2);
}

// The single-phase kernels' scalar outputs (one thread): the Nesterov
// scalar advanced n_steps times from sc[kPhA], and the previous Lipschitz
// constant after them, sc[kPhL] (sc[kPhLPrev] when n_steps is 0), the
// JAX wrappers' host replay (pallas_kernels.py:196-204,
// pallas_small.py:137-142).
template <typename T>
__device__ __forceinline__ void phase_scalars_out(T* __restrict__ sc,
                                                  int n_steps) {
    T a = sc[kPhA];
    for (int step = 0; step < n_steps; ++step) a = nesterov(a);
    sc[kPhAOut] = a;
    sc[kPhLPrevOut] = n_steps > 0 ? sc[kPhL] : sc[kPhLPrev];
}

// NaN-propagating minimum, as jnp.minimum / torch.minimum
template <typename T>
__device__ __forceinline__ T min_nan(T x, T y) {
    return (x < y || x != x) ? x : y;
}

// The momentum table of an n_steps FISTA loop, built by n_threads
// threads (thread ids tid) that share `tab` (n_steps + 1 values) and the
// barrier sync(): tab[k] becomes step k's beta = min((a_k - 1) / a_{k+1},
// 0.9999 sqrt(l_prev_k / l)), with a_0 = a, l_prev_0 = l_prev and
// l_prev_k = l from step 1 on, and tab[n_steps] the advanced Nesterov
// scalar a_{n_steps} -- the arithmetic every thread of a step loop used
// to replay, in the same order, so the same bits (NaN and l = 0
// included). Only the Nesterov recursion is serial: thread 0 runs it
// into tab, then the threads form the betas side by side.
template <typename T, class Sync>
__device__ __forceinline__ void momentum_table(T* __restrict__ tab, T a,
                                               const T l_prev, const T l,
                                               int n_steps, int tid,
                                               int n_threads, Sync sync) {
    if (tid == 0) {
        tab[0] = a;
        for (int k = 0; k < n_steps; ++k) {
            a = nesterov(a);
            tab[k + 1] = a;
        }
    }
    sync();
    for (int k0 = 0; k0 < n_steps; k0 += n_threads) {
        const int k = k0 + tid;
        T ak = T(0), ak1 = T(1);
        if (k < n_steps) {
            ak = tab[k];
            ak1 = tab[k + 1];
        }
        sync();
        if (k < n_steps)
            tab[k] = min_nan((ak - T(1)) / ak1,
                             T(0.9999) * sqrt_t((k == 0 ? l_prev : l) / l));
        sync();
    }
}

// Row `lane` of the per-sample Gram G_s and of b_s, assembled from the
// loop-invariant known blocks and K1's new-u blocks (as _assemble_G_b):
//   G[s][c][c'] = gtt[s,c,c'],  G[s][c][n_ct+u] = gu[s,u,c],
//   G[s][n_ct+u][q] = gu[s,u,q],  b = [bt; bu].
// With n_ct = 0 gtt and bt are not read. Lanes >= p get zeros. P >= p is
// the register form's row bucket (the register arrays' length).
template <typename T, int P>
__device__ __forceinline__ void load_gram_row(
        T (&g)[P], T& b, const T* __restrict__ gtt,
        const T* __restrict__ bt, const T* __restrict__ gu,
        const T* __restrict__ bu, int s, int lane, int n_s, int n_ct,
        int n_u) {
    const int p = n_ct + n_u;
    const bool row = lane < p;
#pragma unroll
    for (int r = 0; r < P; ++r) {
        T x = T(0);
        if (row && r < p) {
            if (lane >= n_ct)
                x = gu[(s * n_u + (lane - n_ct)) * p + r];
            else if (r >= n_ct)
                x = gu[(s * n_u + (r - n_ct)) * p + lane];
            else
                x = gtt[(s * n_ct + lane) * n_ct + r];
        }
        g[r] = x;
    }
    b = row ? (lane < n_ct ? bt[lane * n_s + s] : bu[(lane - n_ct) * n_s + s])
            : T(0);
}

// (G_s a)_lane, with a_r read from lane r by shuffle: P shuffles, the
// terms r < p summed in index order whatever P is
template <typename T, int P>
__device__ __forceinline__ T gram_matvec(const T (&g)[P], T a, int p) {
    T ga = T(0);
#pragma unroll
    for (int r = 0; r < P; ++r) {
        const T ar = __shfl_sync(kFull, a, r);
        if (r < p) ga += g[r] * ar;
    }
    return ga;
}

// Adds one column's terms of the Gram-identity cost, b.a and a.(b - G a),
// and of ||alpha_unknown||^2 to the warp's running sums (valid in lane 0),
// by a shuffle tree over the 32 lanes. Lanes >= p hold +0, so a level
// whose partner lanes are all >= P adds +0 without a shuffle: the same
// bits as the 32-lane tree (x + 0 is x, or +0 for -0, either way).
template <typename T, int P>
__device__ __forceinline__ void add_column_sums(
        const T (&g)[P], T b, T al, int lane, int p, int n_u,
        T& sum_ba, T& sum_ag, T& sum_lw) {
    const bool row = lane < p;
    const T ga = gram_matvec(g, al, p);
    T ba = row ? b * al : T(0);
    T ag = row ? al * (b - ga) : T(0);
    T lw = (row && lane >= p - n_u) ? al * al : T(0);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        if (off >= P) {
            ba += T(0);
            ag += T(0);
            lw += T(0);
        } else {
            ba += __shfl_down_sync(kFull, ba, off);
            ag += __shfl_down_sync(kFull, ag, off);
            lw += __shfl_down_sync(kFull, lw, off);
        }
    }
    sum_ba += ba;
    sum_ag += ag;
    sum_lw += lw;
}

// The cost epilogue over a grid (K2, K5, K3, K6): each column's terms
// b.a, a.(b - G a) and ||alpha_unknown||^2 have been written to cs[s],
// cs[n_s + s], cs[2 n_s + s]. The member's last block to finish (a ticket
// taken with an integer atomic on tickets[mb], reset to zero for the next
// launch; no ticket with one block) sums them in a fixed order that does
// not depend on the grid: column s into group s mod `groups`, each group
// in column order, then the groups in order -- the order of one block of
// `groups` warps, each summing its columns in turn, then the warps in
// order. The register and two-row forms pass min(n_s, 32) (cost_groups);
// the column blocks the warps of the one-block wide loop they replaced
// (column_groups). Returns true in that block's thread 0, with cost =
// sum(ydy) - sum(b.a) - sum(a.(b - G a)) and lw.
__host__ __device__ __forceinline__ int cost_groups(int n_s) {
    return n_s < 32 ? n_s : 32;
}

template <typename T>
__device__ __forceinline__ bool column_cost(const T* __restrict__ cs,
                                            const T* __restrict__ ydy,
                                            int n_s, int groups,
                                            unsigned* __restrict__ tickets,
                                            long long mb, T& cost, T& lw) {
    if (gridDim.x > 1) __threadfence();
    __syncthreads();
    if (threadIdx.x != 0) return false;
    if (gridDim.x > 1) {
        if (atomicAdd(&tickets[mb], 1u) != gridDim.x - 1) return false;
        __threadfence();
        tickets[mb] = 0;                   // zero for the next launch
    }
    T s_ydy = T(0), s_ba = T(0), s_ag = T(0), s_lw = T(0);
    for (int k = 0; k < n_s; ++k) s_ydy += ydy[k];
    for (int w = 0; w < groups; ++w) {
        T g_ba = T(0), g_ag = T(0), g_lw = T(0);
        for (int k = w; k < n_s; k += groups) {
            g_ba += __ldcg(cs + k);
            g_ag += __ldcg(cs + n_s + k);
            g_lw += __ldcg(cs + 2 * n_s + k);
        }
        s_ba += g_ba;
        s_ag += g_ag;
        s_lw += g_lw;
    }
    cost = s_ydy - s_ba - s_ag;
    lw = s_lw;
    return true;
}

// ---- the column-block form (p > 64: K2, K3, K5, K6, K9, K10) ---------

// The most blocks a column's cluster takes: 16, the largest cluster an
// H100 places (past the portable 8, with
// cudaFuncAttributeNonPortableClusterSizeAllowed; chip_smoke.py records
// cudaOccupancyMaxPotentialClusterSize at the plans' largest blocks).
// Threads a block: up to 256 while G_s's rows sit in shared memory (R <=
// 242 rows in float32), up to 1024 where they sit in device memory.
constexpr int kMaxColumnBlocks = 16;
constexpr int kColumnThreads = 256;
constexpr int kDeviceRowThreads = 1024;

// Where a column's values live (ColumnPlan::device): all in the blocks'
// shared memory (the column blocks); G_s's rows in device memory, the
// rows of p values in shared memory (the device rows); or both in device
// memory, where even the rows of p values do not fit
constexpr int kSharedRows = 0, kDeviceRows = 1, kDeviceColumn = 2;

// The device rows' blocks keep 2 KB of the card's limit for their static
// shared memory (1 KB for the column blocks'): the Frank-Wolfe loop's
// minima of 32 warps, double-buffered, take 1.5 KB in float64.
constexpr long long kDeviceRowsLimit = kGlueSmemLimit - 1024;

// A column's launch plan: C blocks, R rows a block, its threads (R
// rounded up to warps, at most kDeviceRowThreads), where its values live
// and a block's dynamic shared memory before any step table.
struct ColumnPlan {
    int blocks, rows, threads, device;
    long long bytes;
};

// The fewest blocks C <= kMaxColumnBlocks whose R = ceil(p / C) rows of
// G_s, with p_rows rows of p values and r_rows rows of R values, fit one
// block's shared memory (kGlueSmemLimit). Past that the device rows:
// C = kMaxColumnBlocks, G_s's rows in device memory and the rest in
// shared memory where it fits (kDeviceRows, within kDeviceRowsLimit),
// else in device memory too (kDeviceColumn, no dynamic shared memory).
// Every p > 0 has a plan.
inline ColumnPlan column_plan(int itemsize, int p, int p_rows, int r_rows) {
    for (int c = 1; c <= kMaxColumnBlocks; ++c) {
        const int rows = (p + c - 1) / c;
        const long long bytes =
            static_cast<long long>(itemsize)
            * (static_cast<long long>(rows) * p
               + static_cast<long long>(p_rows) * p
               + static_cast<long long>(r_rows) * rows);
        if (bytes <= kGlueSmemLimit)
            return ColumnPlan{c, rows, 32 * ((rows + 31) / 32), kSharedRows,
                              bytes};
    }
    const int c = kMaxColumnBlocks;
    const int rows = (p + c - 1) / c;
    const int warps = (rows + 31) / 32;
    const int threads =
        32 * warps < kDeviceRowThreads ? 32 * warps : kDeviceRowThreads;
    const long long line =
        static_cast<long long>(itemsize)
        * (static_cast<long long>(p_rows) * p
           + static_cast<long long>(r_rows) * rows);
    if (line <= kDeviceRowsLimit)
        return ColumnPlan{c, rows, threads, kDeviceRows, line};
    return ColumnPlan{c, rows, threads, kDeviceColumn, 0};
}

// Elements of one block's region of the device buffer in a layout: none
// in the column blocks, its R rows of G_s in the device rows, and then
// its rows of p and R values where they are in device memory too
__host__ __device__ __forceinline__ long long column_block_elems(
        int device, int rows, int p, int p_rows, int r_rows) {
    if (device == kSharedRows) return 0;
    const long long g = static_cast<long long>(rows) * p;
    if (device == kDeviceRows) return g;
    return g + static_cast<long long>(p_rows) * p
           + static_cast<long long>(r_rows) * rows;
}

// The cost's group count of a column-block launch: the warps of the
// one-block-per-member wide loop the column blocks replaced, min(n_s, 32)
// capped by the slabs that fit its shared memory where one did
// (glue_warps) and, where its slabs were in device memory, by slab_cap,
// the warps its registers allowed a block
inline int column_groups(int itemsize, int p, int n_s, int slab_cap) {
    const int groups = cost_groups(n_s);
    const int fit = glue_warps(itemsize, p, n_s);
    const int cap = fit >= 1 ? fit : slab_cap;
    return cap < groups ? cap : groups;
}

// (G_s a)_q for this thread's row t, from the block's transposed rows sg
// (entry r at r * rows + t, in shared or device memory; rows * p < 2^31
// for any G_s a card holds): summed over r in index order, as every
// form's product is. A plain loop: with loads a chunk of 8 ahead of the
// sum, or unrolled by 8, K3's column blocks took 4-37% longer on an H100
// (chip_smoke.time_cases' "columns" cases).
template <typename T>
__device__ __forceinline__ T column_row_dot(const T* __restrict__ sg,
                                            const T* __restrict__ a,
                                            int rows, int t, int p) {
    T ga = T(0);
    for (int r = 0; r < p; ++r) ga += sg[r * rows + t] * a[r];
    return ga;
}

// ---- the two-row form (32 < p <= 64) ----------------------------------
// Lane q holds rows q and q + 32 of the column in registers; the column's
// Gram matrix sits in the warp's slab of shared memory, p rows at an odd
// row stride, so the 32 lanes' row starts fall in distinct banks (one
// wavefront for a float32 load, the two a 64-bit load needs in float64).
constexpr int kTwoRowP = 64;
// A block of the two-row form is one warp holding one column: a step is
// bound by its SM's shuffle, FP64 and issue throughput, so a column an SM
// is about the fastest (PERF.md, Findings).

__host__ __device__ __forceinline__ int two_row_stride(int p) {
    return p | 1;
}

__host__ __device__ __forceinline__ long long two_row_elems(int p) {
    return static_cast<long long>(p) * two_row_stride(p);
}

// A two-row launch's dynamic shared memory: the block's slab, then the
// step table of tab bytes where it fits (use_table: at most 48 KB of
// table, and the total under kGlueSmemLimit); opts kernel `kern` into
// the bytes past 48 KB. Returns the cudaError_t of that, or
// cudaErrorInvalidValue where the slab alone passes the limit.
template <typename K>
int two_row_smem(K kern, int itemsize, int p, size_t tab, size_t& smem,
                 int& use_table) {
    const size_t slab = two_row_elems(p) * itemsize;
    if (slab > static_cast<size_t>(kGlueSmemLimit))
        return static_cast<int>(cudaErrorInvalidValue);
    use_table = tab <= 48 * 1024 && slab + tab <= kGlueSmemLimit;
    smem = slab + (use_table ? tab : 0);
    if (smem <= 48 * 1024) return 0;
    return static_cast<int>(cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem)));
}

// The row bucket: the smallest of 8, 16 and 32 lanes holding p rows (the
// register form), 64 for the two-row form, 0 above (the column blocks)
// (ops/cuda_small.alpha_plan's rule; dm_row_bucket)
__host__ __device__ __forceinline__ int row_bucket(int p) {
    return p <= 8 ? 8
                  : (p <= 16 ? 16
                             : (p <= kMaxP ? kMaxP
                                           : (p <= kTwoRowP ? kTwoRowP : 0)));
}

// G_s into the two-row form's slab sg (p rows at two_row_stride(p)), by
// the assembly rule of load_gram_row, and this lane's rows of b_s into b0
// (row lane) and b1 (row lane + 32, 0 past p)
template <typename T>
__device__ __forceinline__ void load_gram_two_row(
        T* __restrict__ sg, T& b0, T& b1, const T* __restrict__ gtt,
        const T* __restrict__ bt, const T* __restrict__ gu,
        const T* __restrict__ bu, int s, int lane, int n_s, int n_ct,
        int n_u) {
    const int p = n_ct + n_u;
    const int ld = two_row_stride(p);
    for (int k = lane; k < p * p; k += 32) {
        const int q = k / p;
        const int r = k % p;
        T x;
        if (q >= n_ct)
            x = gu[(s * n_u + (q - n_ct)) * p + r];
        else if (r >= n_ct)
            x = gu[(s * n_u + (r - n_ct)) * p + q];
        else
            x = gtt[(s * n_ct + q) * n_ct + r];
        sg[q * ld + r] = x;
    }
    const int q1 = lane + 32;
    b0 = lane < n_ct ? bt[lane * n_s + s] : bu[(lane - n_ct) * n_s + s];
    b1 = q1 >= p ? T(0)
                 : (q1 < n_ct ? bt[q1 * n_s + s] : bu[(q1 - n_ct) * n_s + s]);
}

// (G_s a) at this lane's rows, lane and lane + 32, from the slab (row
// stride ld): a_r is broadcast by shuffle from lane r mod 32 (a0 holds
// rows 0-31, a1 rows 32 and up), and each row sums its terms over r in
// index order, as gram_matvec does. A lane without a
// second row reads its first row again for ga1, which no one uses.
template <typename T>
__device__ __forceinline__ void gram_two_row(const T* __restrict__ sg,
                                             int ld, T a0, T a1, int lane,
                                             int p, T& ga0, T& ga1) {
    const T* g0 = sg + lane * ld;
    const T* g1 = sg + (lane + 32 < p ? lane + 32 : lane) * ld;
    T s0 = T(0), s1 = T(0);
#pragma unroll
    for (int r = 0; r < 32; ++r) {
        const T ar = __shfl_sync(kFull, a0, r);
        s0 += g0[r] * ar;
        s1 += g1[r] * ar;
    }
#pragma unroll 4
    for (int r = 32; r < p; ++r) {
        const T ar = __shfl_sync(kFull, a1, r - 32);
        s0 += g0[r] * ar;
        s1 += g1[r] * ar;
    }
    ga0 = s0;
    ga1 = s1;
}

// One column's terms of the Gram-identity cost in the two-row form: lane
// q sums its rows q, q + 32 in order (b.a, a.(b - G a) and, for the
// unknown rows, ||alpha_unknown||^2), then a 32-lane shuffle tree: the
// operations and the order of the column blocks' cost terms (lane l over
// rows l, l + 32, ...; column_steps.cuh column_cost_terms), so the same
// bits. Valid in lane 0.
template <typename T>
__device__ __forceinline__ void column_sums_two_row(
        const T* __restrict__ sg, T b0, T b1, T al0, T al1, int lane, int p,
        int n_u, T& ba, T& ag, T& lw) {
    const bool row1 = lane + 32 < p;
    T ga0, ga1;
    gram_two_row(sg, two_row_stride(p), al0, al1, lane, p, ga0, ga1);
    ba = T(0);
    ag = T(0);
    lw = T(0);
    ba += b0 * al0;
    ag += al0 * (b0 - ga0);
    if (lane >= p - n_u) lw += al0 * al0;
    if (row1) {
        ba += b1 * al1;
        ag += al1 * (b1 - ga1);
        if (lane + 32 >= p - n_u) lw += al1 * al1;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        ba += __shfl_down_sync(kFull, ba, off);
        ag += __shfl_down_sync(kFull, ag, off);
        lw += __shfl_down_sync(kFull, lw, off);
    }
}

}  // namespace dm
