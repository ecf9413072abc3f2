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
// of the column and of its Gram matrix in registers (p <= 32), or, above,
// the column lives in the warp's slab of shared memory and lane q takes
// rows q, q + 32, ... (the wide form), with the register form's
// arithmetic in the same order.
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

// ---- the alpha FISTA loop ---------------------------------------------

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
    const T theta = __shfl_sync(kFull, my_pi, rho) / T(rho + 1);
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

// The same projection for the wide form: column v (p values) in this
// warp's slab row sv; srt is a work row. Ranks as above (lane q takes rows
// q, q + 32, ...), the cumulative sum and rho in lane 0 in rank order, so
// each step is the register form's arithmetic in the same order. Returns
// theta in every lane.
template <typename T>
__device__ __forceinline__ T simplex_theta_wide(const T* __restrict__ sv,
                                                T* __restrict__ srt,
                                                int lane, int p) {
    for (int q = lane; q < p; q += 32) {
        const T v = sv[q];
        int rank = 0;
        for (int r = 0; r < p; ++r) {
            const T vr = sv[r];
            rank += (vr > v) || (vr == v && r < q);
        }
        srt[rank] = v;
    }
    __syncwarp();
    T theta = T(0);
    if (lane == 0) {
        T csum = T(0), pi_rho = T(0);
        int rho = 0;
        for (int j = 0; j < p; ++j) {
            const T uj = srt[j];
            csum += uj;
            const T pi = csum - T(1);
            if (j == 0) pi_rho = pi;
            if ((uj - pi / T(j + 1)) > T(0)) {
                rho = j;
                pi_rho = pi;
            }
        }
        theta = pi_rho / T(rho + 1);
    }
    __syncwarp();            // srt is free again
    return __shfl_sync(kFull, theta, 0);
}

// One column's alpha FISTA loop in the wide form (p > 32): the slab holds
// G (sg), b (sb), alpha (sal), alpha_prev (sap) and the work rows at
// (sat), v (sv) and the sorted values (srt). ``mask`` is the (p,) row
// mask or null.
template <typename T>
__device__ __forceinline__ void alpha_steps_wide(
        const T* __restrict__ sg, const T* __restrict__ sb,
        T* __restrict__ sal, T* __restrict__ sap, T* __restrict__ sat,
        T* __restrict__ sv, T* __restrict__ srt,
        const T* __restrict__ mask, int lane, int p, T a, T l_prev,
        const T l_h, int n_steps) {
    for (int step = 0; step < n_steps; ++step) {
        const T a2n = nesterov(a);
        const T beta = min_nan((a - T(1)) / a2n,
                               T(0.9999) * sqrt_t(l_prev / l_h));
        for (int q = lane; q < p; q += 32)
            sat[q] = sal[q] + beta * (sal[q] - sap[q]);
        __syncwarp();
        for (int q = lane; q < p; q += 32) {
            const T ga = gram_row_dot(sg, sat, q, p);
            T v = sat[q] + (sb[q] - ga) / l_h;
            if (mask != nullptr && !(mask[q] > T(0))) v = T(-1e30);
            sv[q] = v;
        }
        __syncwarp();
        const T theta = simplex_theta_wide(sv, srt, lane, p);
        for (int q = lane; q < p; q += 32) {
            const T out = sv[q] - theta;
            sap[q] = sal[q];
            sal[q] = out < T(0) ? T(0) : out;
        }
        __syncwarp();
        a = a2n;
        l_prev = l_h;
    }
}

// ---- the Frank-Wolfe loop ---------------------------------------------

template <typename T> __device__ __forceinline__ T pos_inf();
template <> __device__ __forceinline__ float pos_inf<float>() {
    return CUDART_INF_F;
}
template <> __device__ __forceinline__ double pos_inf<double>() {
    return CUDART_INF;
}

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

// One column's Frank-Wolfe loop in the wide form (p > 32): the slab holds
// G (sg), b (sb), alpha (sal) and the gradient row (sgr); lane q takes
// rows q, q + 32, ... Each block's minimum is the NaN-propagating minimum
// of the lanes' minima over their rows, and its first row the smallest
// row index holding it (else p): the register form's values and ties.
template <typename T>
__device__ __forceinline__ void fw_steps_wide(
        const T* __restrict__ sg, const T* __restrict__ sb,
        T* __restrict__ sal, T* __restrict__ sgr, int lane, int p, int n_ct,
        T pur, T pur2, int n_steps) {
    const T big = T(3.4e38);                // the TPU kernel's block mask
    const T pad = pos_inf<T>();
    for (int k = 0; k < n_steps; ++k) {
        for (int q = lane; q < p; q += 32)
            sgr[q] = -(sb[q] - gram_row_dot(sg, sal, q, p));
        __syncwarp();
        T m1 = pad, m2 = pad;
        for (int q = lane; q < p; q += 32) {
            const bool known = q < n_ct;
            m1 = min_nan(m1, known ? sgr[q] : big);
            m2 = min_nan(m2, known ? big : sgr[q]);
        }
        m1 = warp_min(m1);
        m2 = warp_min(m2);
        int i1 = p, i2 = p;
        for (int q = lane; q < p; q += 32) {
            const bool known = q < n_ct;
            if (i1 == p && (known ? sgr[q] : big) == m1) i1 = q;
            if (i2 == p && (known ? big : sgr[q]) == m2) i2 = q;
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            const int o1 = __shfl_xor_sync(kFull, i1, off);
            const int o2 = __shfl_xor_sync(kFull, i2, off);
            i1 = o1 < i1 ? o1 : i1;
            i2 = o2 < i2 ? o2 : i2;
        }
        const T gamma = T(2) / (static_cast<T>(k) + T(2));
        for (int q = lane; q < p; q += 32) {
            const T e1 = q == i1 ? T(1) : T(0);
            const T e2 = q == i2 ? T(1) : T(0);
            const T vert = e1 * pur + e2 * pur2;
            sal[q] = (T(1) - gamma) * sal[q] + gamma * vert;
        }
        __syncwarp();
    }
}

}  // namespace dm
