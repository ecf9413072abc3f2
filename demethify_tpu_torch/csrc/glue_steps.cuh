// The serial inner loops of the glue kernels, shared by the kernels that
// assemble their Grams (K2, K5: alpha_phase_full.cu; K3, K6:
// fw_phase_full.cu) and the single-phase kernels that take an assembled
// G and b (K9: alpha_phase.cu; K10: fw_phase.cu). One warp owns one
// sample column; each loop is written once, so a column's arithmetic is
// the same in every kernel that runs it.
//
//   - the alpha FISTA steps with the simplex projection of the column
//     (the plain form of ops/fista.fista_alpha_gram), and an optional
//     row mask (rows not > 0 set to -1e30 before each projection);
//   - the Frank-Wolfe steps with the first-occurrence block argmin (the
//     plain form of ops/frank_wolfe.frank_wolfe_gram).
//
// Two forms each, as small_common.cuh lays them out: lane q holds row q
// of the column and of its Gram matrix in registers (p <= 32); or lane q
// holds rows q and q + 32 of the column in registers and the warp's slab
// of shared memory holds the Gram matrix (the two-row form, p <= 64).
// Above 64 rows a column runs on a block or a cluster of blocks
// (column_steps.cuh), with the same values.
//
// The two-row form is the register form's dataflow over 64 rows: the
// product broadcasts alpha_r by shuffle and reads G_s at a padded row
// stride (no bank conflicts), the projection ranks, gathers and tests in
// the lanes (no lane works alone), Frank-Wolfe reads its step sizes from
// the table, and nothing goes through shared memory between the stages.
// Its values are those of a loop over the rows in index order, bit for
// bit: each lane sums its rows over r in index order, the rank is stable
// by comparison, the cumulative sum runs in rank order and rho is the
// last index, and a block minimum compares equal to the 32-lane one.
//
// What bounds the register form on an H100: latency. A step is a chain of
// warp collectives (the product's shuffles, the rank's shuffles, a ballot
// and a shuffle per rank of the cumulative sum, the threshold's ballot)
// and divisions. The alpha loop is templated on a row bucket P (8, 16 or
// 32, the smallest >= p, chosen by the wrapper), so each collective loop
// runs to P lanes, not 32; where the registers allow (P <= 16, or float32)
// the ranks' values are gathered by P independent ballots and shuffles
// before the cumulative sum, so they overlap; and its betas can come from
// a momentum table the kernel builds once (small_common.cuh), one
// shared-memory read a step. The Frank-Wolfe loop takes the same bucket
// (its product and both block minima run to P lanes) and reads its step
// sizes from a table divided once per launch (fw_gamma_table). None of
// this changes an operation on a value: the product sums rows in index
// order, the rank is stable by comparison, the cumulative sum runs in
// rank order and rho is the last index, and a block minimum compares
// equal to the 32-lane one, so the bits are those of a 32-lane loop.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include "small_common.cuh"

namespace dm {

template <typename T> __device__ __forceinline__ T pos_inf();
template <> __device__ __forceinline__ float pos_inf<float>() {
    return CUDART_INF_F;
}
template <> __device__ __forceinline__ double pos_inf<double>() {
    return CUDART_INF;
}

template <typename T> __device__ __forceinline__ T quiet_nan();
template <> __device__ __forceinline__ float quiet_nan<float>() {
    return CUDART_NAN_F;
}
template <> __device__ __forceinline__ double quiet_nan<double>() {
    return CUDART_NAN;
}

// ---- the alpha FISTA loop ---------------------------------------------

// A column whose v holds a NaN projects to NaN in every row, as the JAX
// kernels' rank-matrix projection (pallas_small.py _project_cols) and the
// plain twin's sort give it: a NaN compares neither greater nor equal, so
// the stable rank by comparison gives it and the largest finite value the
// same rank and leaves a rank below p empty. Each projection therefore
// votes on a NaN in its column beside the rank and adds NaN to theta
// where there is one (0 elsewhere: theta is never -0, so theta + 0 is
// theta's bits), so v - theta is NaN in every row; a column without one
// keeps its bits. The addition, not a select, keeps the threshold's
// shuffle and division out of a branch: a select cost the two-row form
// some 8% of its time (chip_smoke.time_cases' "glue" cases).

// Projection of one column (lane q holds v_q, lanes >= p are padding)
// onto the probability simplex, inside one warp: a stable descending rank
// by comparison, the cumulative sum taken in sorted order (ballot finds
// the lane of each rank), and rho as the LAST lane whose condition holds
// (highest bit of a ballot) -- the reference's last-index rho. The rank
// reads the P lanes of the row bucket (P >= p).
template <typename T, int P = kMaxP>
__device__ __forceinline__ T project_simplex_warp(T v, int lane, int p) {
    const bool row = lane < p;
    int rank = 0;
#pragma unroll
    for (int r = 0; r < P; ++r) {
        const T vr = __shfl_sync(kFull, v, r);
        if (r < p && row) rank += (vr > v) || (vr == v && r < lane);
    }
    const bool nan_col = __any_sync(kFull, row && v != v);
    T csum = T(0), my_u = T(0), my_pi = T(0);
    if constexpr (P <= 16 || sizeof(T) == 4) {
        // the value of each rank: P ballots and shuffles, independent of
        // each other, then the sum in rank order over the p ranks (a rank
        // >= p has no lane; its shuffle is read by none)
        T u_rank[P];
#pragma unroll
        for (int j = 0; j < P; ++j) {
            const unsigned who = __ballot_sync(kFull, row && rank == j);
            u_rank[j] = __shfl_sync(kFull, v, __ffs(who) - 1);
        }
#pragma unroll
        for (int j = 0; j < P; ++j) {
            if (j < p) {                     // uniform across the warp
                csum += u_rank[j];
                if (lane == j) {
                    my_u = u_rank[j];
                    my_pi = csum - T(1);
                }
            }
        }
    } else {
#pragma unroll
        for (int j = 0; j < P; ++j) {
            if (j < p) {                     // uniform across the warp
                const unsigned who = __ballot_sync(kFull, row && rank == j);
                const T uj = __shfl_sync(kFull, v, __ffs(who) - 1);
                csum += uj;
                if (lane == j) {
                    my_u = uj;
                    my_pi = csum - T(1);
                }
            }
        }
    }
    const unsigned cond = __ballot_sync(
        kFull, row && (my_u - my_pi / T(lane + 1)) > T(0));
    const int rho = cond ? 31 - __clz(cond) : 0;
    const T theta = __shfl_sync(kFull, my_pi, rho) / T(rho + 1)
                    + (nan_col ? quiet_nan<T>() : T(0));
    const T out = v - theta;
    return out < T(0) ? T(0) : out;
}

// n_steps alpha FISTA steps on one column in the register form: lane q
// holds row q of G_s (g, the P entries of the row bucket) and b_s (b),
// and al, ap (alpha, alpha_prev) are updated in place; ``masked`` sets
// this lane's row to -1e30 before each projection. beta_tab is the
// steps' momentum table (momentum_table from (a0, l_prev0, l_h)), or null:
// then every lane replays the chain from (a0, l_prev0), the same values.
template <typename T, int P>
__device__ __forceinline__ void alpha_steps_reg(
        const T (&g)[P], T b, T& al, T& ap, bool masked, int lane, int p,
        const T* __restrict__ beta_tab, T a0, T l_prev0, const T l_h,
        int n_steps) {
    const bool row = lane < p;
    T a = a0, l_prev = l_prev0;
    for (int step = 0; step < n_steps; ++step) {
        T beta;
        if (beta_tab != nullptr) {
            beta = beta_tab[step];
        } else {
            const T a2n = nesterov(a);
            beta = min_nan((a - T(1)) / a2n, T(0.9999) * sqrt_t(l_prev / l_h));
            a = a2n;
            l_prev = l_h;
        }
        const T at = al + beta * (al - ap);
        const T ga = gram_matvec(g, at, p);
        T v = at + (b - ga) / l_h;
        if (masked) v = T(-1e30);
        const T proj = project_simplex_warp<T, P>(v, lane, p);
        ap = al;
        al = row ? proj : T(0);
    }
}

// The projection of project_simplex_warp over up to 64 rows (the two-row
// form, 32 < p <= 64): lane q holds v0 = row q and v1 = row q + 32 (the
// latter only where q + 32 < p). Each row's stable descending rank by
// comparison with the p values, read by shuffle; the value of each rank
// gathered by two ballots (which half holds it) and one shuffle; the
// cumulative sum in rank order, run in every lane, each lane keeping
// ranks q and q + 32; each rank's test in its own lane, its division
// included; rho the last rank whose test holds, from the two halves'
// ballots (rank 0 when none does). The values, and their order, are the
// column blocks' (column_steps.cuh alpha_column_steps). Returns the
// projected rows (0 for a missing one).
template <typename T>
__device__ __forceinline__ void project_simplex_two_row(T v0, T v1, int lane,
                                                        int p, T& out0,
                                                        T& out1) {
    const bool row1 = lane + 32 < p;
    int rank0 = 0, rank1 = 0;
#pragma unroll
    for (int r = 0; r < 32; ++r) {          // rows 0-31: r < lane + 32
        const T vr = __shfl_sync(kFull, v0, r);
        rank0 += (vr > v0) || (vr == v0 && r < lane);
        rank1 += (vr > v1) || (vr == v1);
    }
#pragma unroll 4
    for (int r = 32; r < p; ++r) {          // rows 32 and up: r > lane
        const T vr = __shfl_sync(kFull, v1, r - 32);
        rank0 += vr > v0;
        rank1 += (vr > v1) || (vr == v1 && r < lane + 32);
    }
    const bool nan_col = __any_sync(kFull, v0 != v0 || (row1 && v1 != v1));
    T csum = T(0), u0 = T(0), pi0 = T(0), u1 = T(0), pi1 = T(0);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
        const unsigned h0 = __ballot_sync(kFull, rank0 == j);
        const unsigned h1 = __ballot_sync(kFull, row1 && rank1 == j);
        const int src = (h0 ? __ffs(h0) : __ffs(h1)) - 1;
        const T uj = __shfl_sync(kFull, rank0 == j ? v0 : v1, src);
        csum += uj;
        if (lane == j) {
            u0 = uj;
            pi0 = csum - T(1);
        }
    }
#pragma unroll 4
    for (int j = 32; j < p; ++j) {
        const unsigned h0 = __ballot_sync(kFull, rank0 == j);
        const unsigned h1 = __ballot_sync(kFull, row1 && rank1 == j);
        const int src = (h0 ? __ffs(h0) : __ffs(h1)) - 1;
        const T uj = __shfl_sync(kFull, rank0 == j ? v0 : v1, src);
        csum += uj;
        if (lane + 32 == j) {
            u1 = uj;
            pi1 = csum - T(1);
        }
    }
    const unsigned c0 = __ballot_sync(kFull,
                                      (u0 - pi0 / T(lane + 1)) > T(0));
    const unsigned c1 = __ballot_sync(
        kFull, row1 && (u1 - pi1 / T(lane + 33)) > T(0));
    const int rho = c1 ? 63 - __clz(c1) : (c0 ? 31 - __clz(c0) : 0);
    const T theta = __shfl_sync(kFull, rho < 32 ? pi0 : pi1, rho & 31)
                        / T(rho + 1)
                    + (nan_col ? quiet_nan<T>() : T(0));
    const T o0 = v0 - theta;
    const T o1 = v1 - theta;
    out0 = o0 < T(0) ? T(0) : o0;
    out1 = row1 ? (o1 < T(0) ? T(0) : o1) : T(0);
}

// n_steps alpha FISTA steps on one column in the two-row form: the
// column's G_s in the warp's slab sg (two_row_stride(p)), lane q holding
// rows q and q + 32 of b_s (b0, b1), alpha (al0, al1) and alpha_prev (ap0,
// ap1), updated in place; masked0/masked1 set the lane's rows to -1e30
// before each projection. beta_tab as alpha_steps_reg's. Each step is the
// column blocks' arithmetic on the same values in the same order.
template <typename T>
__device__ __forceinline__ void alpha_steps_two_row(
        const T* __restrict__ sg, T b0, T b1, T& al0, T& al1, T& ap0, T& ap1,
        bool masked0, bool masked1, int lane, int p,
        const T* __restrict__ beta_tab, T a0, T l_prev0, const T l_h,
        int n_steps) {
    const int ld = two_row_stride(p);
    T a = a0, l_prev = l_prev0;
    for (int step = 0; step < n_steps; ++step) {
        T beta;
        if (beta_tab != nullptr) {
            beta = beta_tab[step];
        } else {
            const T a2n = nesterov(a);
            beta = min_nan((a - T(1)) / a2n, T(0.9999) * sqrt_t(l_prev / l_h));
            a = a2n;
            l_prev = l_h;
        }
        const T at0 = al0 + beta * (al0 - ap0);
        const T at1 = al1 + beta * (al1 - ap1);
        T ga0, ga1;
        gram_two_row(sg, ld, at0, at1, lane, p, ga0, ga1);
        T v0 = at0 + (b0 - ga0) / l_h;
        T v1 = at1 + (b1 - ga1) / l_h;
        if (masked0) v0 = T(-1e30);
        if (masked1) v1 = T(-1e30);
        T o0, o1;
        project_simplex_two_row(v0, v1, lane, p, o0, o1);
        ap0 = al0;
        ap1 = al1;
        al0 = o0;
        al1 = o1;
    }
}

// ---- the Frank-Wolfe loop ---------------------------------------------

// NaN-propagating minimum over lanes [0, P) (a butterfly of log2 P
// levels), in each of those lanes; P = 32 is the whole warp
template <typename T, int P = kMaxP>
__device__ __forceinline__ T warp_min(T x) {
#pragma unroll
    for (int off = P / 2; off > 0; off >>= 1)
        x = min_nan(x, __shfl_xor_sync(kFull, x, off));
    return x;
}

// first row (lane < p) whose value equals the minimum m, else p
__device__ __forceinline__ int first_row(bool hit, int p) {
    const unsigned who = __ballot_sync(kFull, hit);
    return who ? __ffs(who) - 1 : p;
}

// The Frank-Wolfe step sizes gamma_k = 2 / (k + 2), k < n_steps, into
// tab by n_threads threads (the division each step of the loop did, so
// the same bits); the caller synchronises before the steps read them.
template <typename T>
__device__ __forceinline__ void fw_gamma_table(T* __restrict__ tab,
                                               int n_steps, int tid,
                                               int n_threads) {
    for (int k = tid; k < n_steps; k += n_threads)
        tab[k] = T(2) / (static_cast<T>(k) + T(2));
}

// n_steps Frank-Wolfe steps on one column in the register form: lane q
// holds row q of G_s (g, the P entries of the row bucket P >= p), b_s (b)
// and alpha (al, updated in place); rows q < n_ct form the known block
// (vertex mass pur), the others the unknown block (mass pur2). Each
// block's minimum is a butterfly of NaN-propagating minima over the
// bucket's P lanes (padding lanes hold +inf, the other block's rows the
// TPU kernel's 3.4e38 mask; lanes >= P never take part), and the first
// row holding it is the lowest set bit of a ballot -- the tie rule of
// argmin. gamma_tab holds the step sizes (fw_gamma_table), or is null:
// then each step divides, the same values. The bucket changes no value:
// the product sums rows in index order, a minimum over the same values
// compares equal to the 32-lane one (it may pick the other zero of -0 and
// +0, which compare equal, and a NaN minimum matches no row either way).
template <typename T, int P>
__device__ __forceinline__ void fw_steps_reg(const T (&g)[P], T b, T& al,
                                             int lane, int p, int n_ct,
                                             T pur, T pur2,
                                             const T* __restrict__ gamma_tab,
                                             int n_steps) {
    const bool row = lane < p;
    const bool known = lane < n_ct;
    const T big = T(3.4e38);                // the TPU kernel's block mask
    const T pad = pos_inf<T>();
    for (int k = 0; k < n_steps; ++k) {
        const T grad = -(b - gram_matvec(g, al, p));
        const T g1 = row ? (known ? grad : big) : pad;
        const T g2 = row ? (known ? big : grad) : pad;
        const T m1 = warp_min<T, P>(g1);
        const T m2 = warp_min<T, P>(g2);
        const int idx1 = first_row(row && g1 == m1, p);
        const int idx2 = first_row(row && g2 == m2, p);
        const T e1 = (row && lane == idx1) ? T(1) : T(0);
        const T e2 = (row && lane == idx2) ? T(1) : T(0);
        const T vert = e1 * pur + e2 * pur2;
        const T gamma = gamma_tab != nullptr
                            ? gamma_tab[k]
                            : T(2) / (static_cast<T>(k) + T(2));
        al = (T(1) - gamma) * al + gamma * vert;
    }
}

// first row (< p) holding a block's minimum in the two-row form, from the
// ballots of the lanes' first rows (hit0) and second rows (hit1), else p
__device__ __forceinline__ int first_row_two(bool hit0, bool hit1, int p) {
    const unsigned h0 = __ballot_sync(kFull, hit0);
    const unsigned h1 = __ballot_sync(kFull, hit1);
    return h0 ? __ffs(h0) - 1 : (h1 ? 31 + __ffs(h1) : p);
}

// n_steps Frank-Wolfe steps on one column in the two-row form: the
// column's G_s in the warp's slab sg, lane q holding rows q and q + 32 of
// b_s (b0, b1) and alpha (al0, al1, updated in place); rows below n_ct
// form the known block. Each block's minimum is the NaN-propagating
// minimum of the lane's two rows (a missing row +inf, the other block's
// rows the 3.4e38 mask), then warp_min over the 32 lanes; its first row
// comes from the two halves' ballots (first_row_two). gamma_tab holds the
// step sizes (fw_gamma_table), or is null: then each step divides. The
// values and ties are the column blocks' (column_steps.cuh
// fw_column_steps): the same products in the same order, a minimum that
// compares equal to theirs, the first occurrence.
template <typename T>
__device__ __forceinline__ void fw_steps_two_row(
        const T* __restrict__ sg, T b0, T b1, T& al0, T& al1, int lane,
        int p, int n_ct, T pur, T pur2, const T* __restrict__ gamma_tab,
        int n_steps) {
    const int ld = two_row_stride(p);
    const bool row1 = lane + 32 < p;
    const bool known0 = lane < n_ct;
    const bool known1 = lane + 32 < n_ct;
    const T big = T(3.4e38);                // the TPU kernel's block mask
    const T pad = pos_inf<T>();
    for (int k = 0; k < n_steps; ++k) {
        T ga0, ga1;
        gram_two_row(sg, ld, al0, al1, lane, p, ga0, ga1);
        const T gr0 = -(b0 - ga0);
        const T gr1 = -(b1 - ga1);
        const T x0 = known0 ? gr0 : big;
        const T y0 = known0 ? big : gr0;
        const T x1 = row1 ? (known1 ? gr1 : big) : pad;
        const T y1 = row1 ? (known1 ? big : gr1) : pad;
        const T m1 = warp_min(min_nan(x0, x1));
        const T m2 = warp_min(min_nan(y0, y1));
        const int i1 = first_row_two(x0 == m1, row1 && x1 == m1, p);
        const int i2 = first_row_two(y0 == m2, row1 && y1 == m2, p);
        const T vert0 = (lane == i1 ? T(1) : T(0)) * pur
                        + (lane == i2 ? T(1) : T(0)) * pur2;
        const T vert1 = (lane + 32 == i1 ? T(1) : T(0)) * pur
                        + (lane + 32 == i2 ? T(1) : T(0)) * pur2;
        const T gamma = gamma_tab != nullptr
                            ? gamma_tab[k]
                            : T(2) / (static_cast<T>(k) + T(2));
        al0 = (T(1) - gamma) * al0 + gamma * vert0;
        al1 = row1 ? (T(1) - gamma) * al1 + gamma * vert1 : T(0);
    }
}

}  // namespace dm
