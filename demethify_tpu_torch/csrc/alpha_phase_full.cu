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
// than the arithmetic.
//
// What the design does about it: one thread block per member
// (blockIdx.x = b; K2 is the grid of one), one warp per sample column (a
// warp loops over columns when n_s > 32; columns are independent given
// the data-free momentum scalars). Lane q holds row q of alpha and of G_s
// in registers (so p <= 32), the matrix-vector product reads a_t from the
// other lanes by shuffle, and the projection runs inside the warp: a
// stable descending rank by comparison, the cumulative sum taken in sorted
// order (ballot finds the lane of each rank), and rho as the LAST lane
// whose condition holds (highest bit of a ballot) -- the reference's
// last-index rho. Cost and l_w are reduced across the block in a fixed
// order. Above 32 rows the wide form keeps each warp's column (G_s, b_s,
// alpha, alpha_prev and work rows) in its own slab of shared memory, lane
// q takes rows q, q + 32, ..., the ranks are counted the same way and
// lane 0 takes the cumulative sum and rho in rank order, so a step is the
// register form's arithmetic in the same order; the block has as many
// warps as slabs fit (small_common.cuh), and past one slab (p ~ 170 in
// float64) the wrapper raises. A member's column sums stay inside its
// block, so up to 132
// members run on separate SMs and a K5 launch takes about K2's time
// whatever B is (the TPU kernel folds the members into its column axis
// for the same reason); each member's arithmetic is K2's, bit for bit.
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
// Plain C interface (ctypes): pointers and the stream as void*, launches
// on that stream, allocates nothing, returns cudaGetLastError().

#include <cuda_runtime.h>

#include "small_common.cuh"

namespace {

using dm::kFull;
using dm::kMaxP;

// Projection of one column (lane q holds v_q, lanes >= p are padding)
// onto the probability simplex, inside one warp.
template <typename T>
__device__ __forceinline__ T project_simplex_warp(T v, int lane, int p) {
    const bool row = lane < p;
    int rank = 0;
#pragma unroll
    for (int r = 0; r < kMaxP; ++r) {
        const T vr = __shfl_sync(kFull, v, r);
        if (r < p && row) rank += (vr > v) || (vr == v && r < lane);
    }
    T csum = T(0), my_u = T(0), my_pi = T(0);
#pragma unroll
    for (int j = 0; j < kMaxP; ++j) {
        if (j < p) {                         // uniform across the warp
            const unsigned who = __ballot_sync(kFull, row && rank == j);
            const T uj = __shfl_sync(kFull, v, __ffs(who) - 1);
            csum += uj;
            if (lane == j) {
                my_u = uj;
                my_pi = csum - T(1);
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
// (sat), v (sv) and the sorted values (srt). ``mask`` is this member's
// (p,) row mask or null.
template <typename T>
__device__ __forceinline__ void alpha_steps_wide(
        const T* __restrict__ sg, const T* __restrict__ sb,
        T* __restrict__ sal, T* __restrict__ sap, T* __restrict__ sat,
        T* __restrict__ sv, T* __restrict__ srt,
        const T* __restrict__ mask, int lane, int p, T a, T l_prev,
        const T l_h, int n_steps) {
    for (int step = 0; step < n_steps; ++step) {
        const T a2n = dm::nesterov(a);
        const T beta = dm::min_nan((a - T(1)) / a2n,
                                   T(0.9999) * dm::sqrt_t(l_prev / l_h));
        for (int q = lane; q < p; q += 32)
            sat[q] = sal[q] + beta * (sal[q] - sap[q]);
        __syncwarp();
        for (int q = lane; q < p; q += 32) {
            const T ga = dm::gram_row_dot(sg, sat, q, p);
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

template <typename T, bool MULTI, bool WIDE>
__global__ void alpha_phase_full_kernel(
        const T* __restrict__ gtt, const T* __restrict__ bt,
        const T* __restrict__ gu, const T* __restrict__ bu,
        const T* __restrict__ usq, const T* __restrict__ ydy,
        T* __restrict__ alpha, T* __restrict__ alpha_prev,
        T* __restrict__ scal, const T* __restrict__ mask, int n_s, int n_ct,
        int n_u, int n_steps, dm::MemberStrides st) {
    if constexpr (MULTI) {                     // block b: member b
        const long long mb = blockIdx.x;
        gtt += mb * st.gtt;
        bt += mb * st.bt;
        ydy += mb * st.ydy;
        gu += mb * st.gu;
        bu += mb * st.bu;
        usq += mb * st.usq;
        alpha += mb * st.alpha;
        alpha_prev += mb * st.alpha;
        scal += mb * st.scal;
        if (mask != nullptr) mask += mb * st.mask;
        if (scal[dm::kActive] == T(0)) return;        // uniform per block
    }

    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int n_warps = blockDim.x >> 5;
    const int p = n_ct + n_u;
    const bool row = lane < p;

    const T a0 = scal[dm::kAAlpha];
    const T l_h_prev0 = scal[dm::kLHPrev];
    const T dmax2 = scal[dm::kDmax2];
    const T l_h = (scal[dm::kRtSq] + usq[0]) * dmax2;

    T sum_ba = T(0), sum_ag = T(0), sum_lw = T(0);
    if constexpr (WIDE) {
        extern __shared__ __align__(16) unsigned char smem_raw[];
        T* sg = reinterpret_cast<T*>(smem_raw) + warp * dm::glue_warp_elems(p);
        T* sb = sg + p * p;
        T* sal = sb + p;
        T* sap = sal + p;
        T* sat = sap + p;
        T* sv = sat + p;
        T* srt = sv + p;
        for (int s = warp; s < n_s; s += n_warps) {
            dm::load_gram_wide(sg, sb, gtt, bt, gu, bu, s, lane, n_s, n_ct,
                               n_u);
            for (int q = lane; q < p; q += 32) {
                sal[q] = alpha[q * n_s + s];
                sap[q] = alpha_prev[q * n_s + s];
            }
            __syncwarp();
            alpha_steps_wide(sg, sb, sal, sap, sat, sv, srt, mask, lane, p,
                             a0, l_h_prev0, l_h, n_steps);
            dm::add_column_sums_wide(sg, sb, sal, lane, p, n_u, sum_ba,
                                     sum_ag, sum_lw);
            for (int q = lane; q < p; q += 32) {
                alpha[q * n_s + s] = sal[q];
                alpha_prev[q * n_s + s] = sap[q];
            }
            __syncwarp();    // the slab is free for the next column
        }
    } else {
        const bool masked = mask != nullptr && row && !(mask[lane] > T(0));
        for (int s = warp; s < n_s; s += n_warps) {
            T g[kMaxP], b;
            dm::load_gram_row(g, b, gtt, bt, gu, bu, s, lane, n_s, n_ct,
                              n_u);
            T al = row ? alpha[lane * n_s + s] : T(0);
            T ap = row ? alpha_prev[lane * n_s + s] : T(0);

            T a = a0, l_prev = l_h_prev0;
            for (int step = 0; step < n_steps; ++step) {
                const T a2n = dm::nesterov(a);
                const T beta = dm::min_nan(
                    (a - T(1)) / a2n, T(0.9999) * dm::sqrt_t(l_prev / l_h));
                const T at = al + beta * (al - ap);
                const T ga = dm::gram_matvec(g, at, p);
                T v = at + (b - ga) / l_h;
                if (masked) v = T(-1e30);
                const T proj = project_simplex_warp(v, lane, p);
                ap = al;
                al = row ? proj : T(0);
                a = a2n;
                l_prev = l_h;
            }

            dm::add_column_sums(g, b, al, lane, p, n_u, sum_ba, sum_ag,
                                sum_lw);
            if (row) {
                alpha[lane * n_s + s] = al;
                alpha_prev[lane * n_s + s] = ap;
            }
        }
    }
    T cost, lw;
    if (dm::block_cost(sum_ba, sum_ag, sum_lw, ydy, n_s, cost, lw)) {
        T a = a0;
        for (int step = 0; step < n_steps; ++step) a = dm::nesterov(a);
        scal[dm::kLW] = lw * dmax2;
        scal[dm::kAAlpha] = a;
        if (n_steps > 0) scal[dm::kLHPrev] = l_h;
        dm::set_cost<MULTI>(scal, cost);
    }
}

template <typename T, bool MULTI, bool WIDE>
int launch_form(const void* gtt, const void* bt, const void* gu,
                const void* bu, const void* usq, const void* ydy,
                void* alpha, void* alpha_prev, void* scal, const void* mask,
                int n_s, int n_ct, int n_u, int n_steps, int n_members,
                dm::MemberStrides st, cudaStream_t stream) {
    auto kern = alpha_phase_full_kernel<T, MULTI, WIDE>;
    const int p = n_ct + n_u;
    static const int max_warps = dm::max_block_warps(kern);
    int n_warps = n_s < 32 ? n_s : 32;
    n_warps = n_warps < max_warps ? n_warps : max_warps;
    size_t smem = 0;
    if constexpr (WIDE) {
        const int fit = dm::glue_warps(sizeof(T), p, n_s);
        if (fit < 1) return static_cast<int>(cudaErrorInvalidValue);
        n_warps = fit < n_warps ? fit : n_warps;
        smem = n_warps * dm::glue_warp_elems(p) * sizeof(T);
        if (smem > 48 * 1024) {
            cudaError_t err = cudaFuncSetAttribute(
                kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                static_cast<int>(smem));
            if (err != cudaSuccess) return static_cast<int>(err);
        }
    }
    kern<<<n_members, 32 * n_warps, smem, stream>>>(
        static_cast<const T*>(gtt), static_cast<const T*>(bt),
        static_cast<const T*>(gu), static_cast<const T*>(bu),
        static_cast<const T*>(usq), static_cast<const T*>(ydy),
        static_cast<T*>(alpha), static_cast<T*>(alpha_prev),
        static_cast<T*>(scal), static_cast<const T*>(mask), n_s, n_ct, n_u,
        n_steps, st);
    return static_cast<int>(cudaGetLastError());
}

template <typename T, bool MULTI>
int launch(const void* gtt, const void* bt, const void* gu, const void* bu,
           const void* usq, const void* ydy, void* alpha, void* alpha_prev,
           void* scal, const void* mask, int n_s, int n_ct, int n_u,
           int n_steps, int n_members, dm::MemberStrides st, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (n_ct + n_u > kMaxP)
        return launch_form<T, MULTI, true>(gtt, bt, gu, bu, usq, ydy, alpha,
                                           alpha_prev, scal, mask, n_s, n_ct,
                                           n_u, n_steps, n_members, st, s);
    return launch_form<T, MULTI, false>(gtt, bt, gu, bu, usq, ydy, alpha,
                                        alpha_prev, scal, mask, n_s, n_ct,
                                        n_u, n_steps, n_members, st, s);
}

}  // namespace

extern "C" {

// mask: the (p,) row mask (rows <= 0 pushed to -1e30 before each
// projection) or NULL
int dm_alpha_phase_full_f32(const void* gtt, const void* bt, const void* gu,
                            const void* bu, const void* usq, const void* ydy,
                            void* alpha, void* alpha_prev, void* scal,
                            const void* mask, int n_s, int n_ct, int n_u,
                            int n_steps, void* stream) {
    return launch<float, false>(gtt, bt, gu, bu, usq, ydy, alpha,
                                alpha_prev, scal, mask, n_s, n_ct, n_u,
                                n_steps, 1, dm::MemberStrides{}, stream);
}

int dm_alpha_phase_full_f64(const void* gtt, const void* bt, const void* gu,
                            const void* bu, const void* usq, const void* ydy,
                            void* alpha, void* alpha_prev, void* scal,
                            const void* mask, int n_s, int n_ct, int n_u,
                            int n_steps, void* stream) {
    return launch<double, false>(gtt, bt, gu, bu, usq, ydy, alpha,
                                 alpha_prev, scal, mask, n_s, n_ct, n_u,
                                 n_steps, 1, dm::MemberStrides{}, stream);
}

// K5: B members, member b's operands at b times the given element strides
// (gtt, bt, ydy: 0 when the members share them); scal_stride is the
// scalar row length; mask: the members' (B, p) row masks (row stride
// mask_stride) or NULL.
#define DM_K5_ENTRY(NAME, T)                                                 \
    int NAME(const void* gtt, long long gtt_stride, const void* bt,          \
             long long bt_stride, const void* gu, long long gu_stride,       \
             const void* bu, long long bu_stride, const void* usq,           \
             long long usq_stride, const void* ydy, long long ydy_stride,    \
             void* alpha, void* alpha_prev, long long alpha_stride,          \
             void* scal, long long scal_stride, const void* mask,            \
             long long mask_stride, int n_s, int n_ct, int n_u, int n_steps, \
             int n_members, void* stream) {                                  \
        const dm::MemberStrides st{gtt_stride,   bt_stride,  ydy_stride,     \
                                   gu_stride,    bu_stride,  usq_stride,     \
                                   alpha_stride, scal_stride, mask_stride};  \
        return launch<T, true>(gtt, bt, gu, bu, usq, ydy, alpha, alpha_prev, \
                               scal, mask, n_s, n_ct, n_u, n_steps,          \
                               n_members, st, stream);                       \
    }
DM_K5_ENTRY(dm_alpha_phase_full_multi_f32, float)
DM_K5_ENTRY(dm_alpha_phase_full_multi_f64, double)

// The wide form's dynamic shared memory at p rows and n_s columns, in
// bytes (0 in the register form, p <= 32); above the card's limit when
// one warp's slab does not fit (the wrapper raises). Shared with K3/K6.
long long dm_glue_smem(int itemsize, int p, int n_s) {
    if (p <= kMaxP) return 0;
    const int w = dm::glue_warps(itemsize, p, n_s);
    return (w < 1 ? 1 : w) * dm::glue_warp_elems(p) * itemsize;
}

}  // extern "C"
