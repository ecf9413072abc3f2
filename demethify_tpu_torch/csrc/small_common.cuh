// Pieces shared by the port's kernels: the solver's scalar slots and the
// FISTA scalar arithmetic (K1, K2, K4, K5), and for the glue kernels K2
// and K5 (alpha_phase_full.cu), K3 and K6 (fw_phase_full.cu) -- one thread
// block per member, one warp per sample column -- the Gram row assembly,
// the product, the cost epilogue and the member bookkeeping, in two
// forms: lane q holds row q of alpha and of the column's Gram matrix in
// registers (p <= 32), or, above 32 rows, each warp keeps its column's
// Gram matrix, b and alpha in its own slab of shared memory and lane q
// takes rows q, q + 32, ... (the wide form).

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

constexpr int kMaxP = 32;          // rows of the register form
constexpr unsigned kFull = 0xffffffffu;

// The wide form's shared memory: per warp the column's Gram matrix
// (p x p) and six rows of p (b, alpha, alpha_prev and three work rows);
// as many warps as fit under the card's opt-in limit (232,448 bytes on an
// H100) less 1 KB for the kernels' static shared memory, at most 32 and
// at most n_s. glue_warps returns 0 when one warp does not fit.
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

// NaN-propagating minimum, as jnp.minimum / torch.minimum
template <typename T>
__device__ __forceinline__ T min_nan(T x, T y) {
    return (x < y || x != x) ? x : y;
}

// Row `lane` of the per-sample Gram G_s and of b_s, assembled from the
// loop-invariant known blocks and K1's new-u blocks (as _assemble_G_b):
//   G[s][c][c'] = gtt[s,c,c'],  G[s][c][n_ct+u] = gu[s,u,c],
//   G[s][n_ct+u][q] = gu[s,u,q],  b = [bt; bu].
// With n_ct = 0 gtt and bt are not read. Lanes >= p get zeros.
template <typename T>
__device__ __forceinline__ void load_gram_row(
        T (&g)[kMaxP], T& b, const T* __restrict__ gtt,
        const T* __restrict__ bt, const T* __restrict__ gu,
        const T* __restrict__ bu, int s, int lane, int n_s, int n_ct,
        int n_u) {
    const int p = n_ct + n_u;
    const bool row = lane < p;
#pragma unroll
    for (int r = 0; r < kMaxP; ++r) {
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

// (G_s a)_lane, with a_r read from lane r by shuffle
template <typename T>
__device__ __forceinline__ T gram_matvec(const T (&g)[kMaxP], T a, int p) {
    T ga = T(0);
#pragma unroll
    for (int r = 0; r < kMaxP; ++r) {
        const T ar = __shfl_sync(kFull, a, r);
        if (r < p) ga += g[r] * ar;
    }
    return ga;
}

// Adds one column's terms of the Gram-identity cost, b.a and a.(b - G a),
// and of ||alpha_unknown||^2 to the warp's running sums (valid in lane 0).
template <typename T>
__device__ __forceinline__ void add_column_sums(
        const T (&g)[kMaxP], T b, T al, int lane, int p, int n_u,
        T& sum_ba, T& sum_ag, T& sum_lw) {
    const bool row = lane < p;
    const T ga = gram_matvec(g, al, p);
    T ba = row ? b * al : T(0);
    T ag = row ? al * (b - ga) : T(0);
    T lw = (row && lane >= p - n_u) ? al * al : T(0);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        ba += __shfl_down_sync(kFull, ba, off);
        ag += __shfl_down_sync(kFull, ag, off);
        lw += __shfl_down_sync(kFull, lw, off);
    }
    sum_ba += ba;
    sum_ag += ag;
    sum_lw += lw;
}

// Sums the warps' running sums in a fixed order. In thread 0 returns true
// and sets cost = sum(ydy) - sum(b.a) - sum(a.(b - G a)) and
// lw = ||alpha_unknown||^2; other threads return false.
template <typename T>
__device__ __forceinline__ bool block_cost(T sum_ba, T sum_ag, T sum_lw,
                                           const T* __restrict__ ydy,
                                           int n_s, T& cost, T& lw) {
    __shared__ T red[3][32];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int n_warps = blockDim.x >> 5;
    if (lane == 0) {
        red[0][warp] = sum_ba;
        red[1][warp] = sum_ag;
        red[2][warp] = sum_lw;
    }
    __syncthreads();
    if (threadIdx.x != 0) return false;
    T s_ydy = T(0), s_ba = T(0), s_ag = T(0), s_lw = T(0);
    for (int s = 0; s < n_s; ++s) s_ydy += ydy[s];
    for (int w = 0; w < n_warps; ++w) {
        s_ba += red[0][w];
        s_ag += red[1][w];
        s_lw += red[2][w];
    }
    cost = s_ydy - s_ba - s_ag;
    lw = s_lw;
    return true;
}

// ---- the wide form (p > 32): this warp's slab of shared memory -------

// G_s and b_s of column s into the slab (sg: p x p, sb: p), by the
// assembly rule of load_gram_row; lane q fills entries q, q + 32, ...
template <typename T>
__device__ __forceinline__ void load_gram_wide(
        T* __restrict__ sg, T* __restrict__ sb, const T* __restrict__ gtt,
        const T* __restrict__ bt, const T* __restrict__ gu,
        const T* __restrict__ bu, int s, int lane, int n_s, int n_ct,
        int n_u) {
    const int p = n_ct + n_u;
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
        sg[k] = x;
    }
    for (int q = lane; q < p; q += 32)
        sb[q] = q < n_ct ? bt[q * n_s + s] : bu[(q - n_ct) * n_s + s];
}

// (G_s a)_q from the slab, summed over r in order as gram_matvec does
template <typename T>
__device__ __forceinline__ T gram_row_dot(const T* __restrict__ sg,
                                          const T* __restrict__ a, int q,
                                          int p) {
    T ga = T(0);
    for (int r = 0; r < p; ++r) ga += sg[q * p + r] * a[r];
    return ga;
}

// add_column_sums for the wide form: each lane sums its rows in order,
// then the same shuffle tree
template <typename T>
__device__ __forceinline__ void add_column_sums_wide(
        const T* __restrict__ sg, const T* __restrict__ sb,
        const T* __restrict__ al, int lane, int p, int n_u, T& sum_ba,
        T& sum_ag, T& sum_lw) {
    T ba = T(0), ag = T(0), lw = T(0);
    for (int q = lane; q < p; q += 32) {
        const T a = al[q];
        const T ga = gram_row_dot(sg, al, q, p);
        ba += sb[q] * a;
        ag += a * (sb[q] - ga);
        if (q >= p - n_u) lw += a * a;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        ba += __shfl_down_sync(kFull, ba, off);
        ag += __shfl_down_sync(kFull, ag, off);
        lw += __shfl_down_sync(kFull, lw, off);
    }
    sum_ba += ba;
    sum_ag += ag;
    sum_lw += lw;
}

}  // namespace dm
