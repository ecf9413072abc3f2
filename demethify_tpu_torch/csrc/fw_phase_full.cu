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
// What bounds it on an H100: latency. The data is tiny (p <= 32, n_s ~ 10)
// and the schedule is a serial chain of 500 steps by default (the purity
// solve's n_iter2), each a matrix-vector product and two reductions. All
// warps of a member's block share one SM, and each step issues ~42
// shuffles per warp (32 for the product, unrolled over every lane, 10 for
// the two minima): about 0.6 us a step at n_s = 10, whatever p is.
//
// What the design does about it: one thread block per member
// (blockIdx.x = b; K3 is the grid of one), one warp per sample column (a
// warp loops over columns when n_s > 32), as in K2 and K5. Lane q holds
// row q of G_s, b_s and alpha in registers; the product reads a from the
// other lanes by shuffle; each block's minimum is a butterfly of
// NaN-propagating minima over the warp (padding lanes hold +inf, the
// other block's rows the TPU kernel's 3.4e38 mask), and the first row
// holding it is the lowest set bit of a ballot -- the tie rule of _fw_run
// and of argmin. Nothing leaves registers until the epilogue, whose cost
// and l_w reductions are those of K2 (small_common.cuh).
// Above 32 rows (p > 32, e.g. the 25-type panel with 8 or more unknowns)
// the wide form keeps each warp's column (G_s, b_s, alpha and the
// gradient) in its own slab of shared memory and gives lane q the rows
// q, q + 32, ...: the same products in the same order, each block's
// minimum over the lanes' minima and its first row as the smallest row
// index holding it. The block has as many warps as slabs fit
// (small_common.cuh); past one slab (p ~ 170 in float64) the wrapper
// raises. The members'
// blocks run on separate SMs, so a K6 launch takes about K3's time
// whatever B is, and each member's arithmetic is K3's, bit for bit.
//
// Device scalars `scal` (shared with K1 and K4; one row per member):
// kLW and kCost (written), kDmax2 (read). K6 (MULTI) skips a member
// whose kActive slot is 0 and sets kActive for the next outer iteration
// from |new cost - old cost| >= kTol.
//
// The step loops live in glue_steps.cuh, shared with
// K10 (fw_phase.cu), which runs them on an assembled G and b.
//
// Plain C interface (ctypes): pointers and the stream as void*, launches
// on that stream, allocates nothing, returns cudaGetLastError().

#include <cuda_runtime.h>

#include "glue_steps.cuh"
#include "small_common.cuh"

namespace {

using dm::kMaxP;

template <typename T, bool MULTI, bool WIDE>
__global__ void fw_phase_full_kernel(
        const T* __restrict__ gtt, const T* __restrict__ bt,
        const T* __restrict__ gu, const T* __restrict__ bu,
        const T* __restrict__ ydy, T* __restrict__ alpha,
        const T* __restrict__ purity, T* __restrict__ scal, int n_s,
        int n_ct, int n_u, int n_steps, dm::MemberStrides st) {
    if constexpr (MULTI) {                     // block b: member b
        const long long mb = blockIdx.x;
        gtt += mb * st.gtt;
        bt += mb * st.bt;
        ydy += mb * st.ydy;
        gu += mb * st.gu;
        bu += mb * st.bu;
        alpha += mb * st.alpha;
        scal += mb * st.scal;
        if (scal[dm::kActive] == T(0)) return;        // uniform per block
    }

    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int n_warps = blockDim.x >> 5;
    const int p = n_ct + n_u;
    const bool row = lane < p;
    const T dmax2 = scal[dm::kDmax2];

    T sum_ba = T(0), sum_ag = T(0), sum_lw = T(0);
    if constexpr (WIDE) {
        extern __shared__ __align__(16) unsigned char smem_raw[];
        T* sg = reinterpret_cast<T*>(smem_raw) + warp * dm::glue_warp_elems(p);
        T* sb = sg + p * p;
        T* sal = sb + p;
        T* sgr = sal + p;
        for (int s = warp; s < n_s; s += n_warps) {
            dm::load_gram_wide(sg, sb, gtt, bt, gu, bu, s, lane, n_s, n_ct,
                               n_u);
            for (int q = lane; q < p; q += 32) sal[q] = alpha[q * n_s + s];
            __syncwarp();
            const T pur = purity[s];
            dm::fw_steps_wide(sg, sb, sal, sgr, lane, p, n_ct, pur,
                              T(1) - pur, n_steps);
            dm::add_column_sums_wide(sg, sb, sal, lane, p, n_u, sum_ba,
                                     sum_ag, sum_lw);
            for (int q = lane; q < p; q += 32) alpha[q * n_s + s] = sal[q];
            __syncwarp();    // the slab is free for the next column
        }
    } else {
        for (int s = warp; s < n_s; s += n_warps) {
            T g[kMaxP], b;
            dm::load_gram_row(g, b, gtt, bt, gu, bu, s, lane, n_s, n_ct,
                              n_u);
            T al = row ? alpha[lane * n_s + s] : T(0);
            const T pur = purity[s];
            const T pur2 = T(1) - pur;

            dm::fw_steps_reg(g, b, al, lane, p, n_ct, pur, pur2, n_steps);

            dm::add_column_sums(g, b, al, lane, p, n_u, sum_ba, sum_ag,
                                sum_lw);
            if (row) alpha[lane * n_s + s] = al;
        }
    }
    T cost, lw;
    if (dm::block_cost(sum_ba, sum_ag, sum_lw, ydy, n_s, cost, lw)) {
        scal[dm::kLW] = lw * dmax2;
        dm::set_cost<MULTI>(scal, cost);
    }
}

template <typename T, bool MULTI, bool WIDE>
int launch_form(const void* gtt, const void* bt, const void* gu,
                const void* bu, const void* ydy, void* alpha,
                const void* purity, void* scal, int n_s, int n_ct, int n_u,
                int n_steps, int n_members, dm::MemberStrides st,
                cudaStream_t stream) {
    auto kern = fw_phase_full_kernel<T, MULTI, WIDE>;
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
        static_cast<const T*>(ydy), static_cast<T*>(alpha),
        static_cast<const T*>(purity), static_cast<T*>(scal), n_s, n_ct,
        n_u, n_steps, st);
    return static_cast<int>(cudaGetLastError());
}

template <typename T, bool MULTI>
int launch(const void* gtt, const void* bt, const void* gu, const void* bu,
           const void* ydy, void* alpha, const void* purity, void* scal,
           int n_s, int n_ct, int n_u, int n_steps, int n_members,
           dm::MemberStrides st, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (n_ct + n_u > kMaxP)
        return launch_form<T, MULTI, true>(gtt, bt, gu, bu, ydy, alpha,
                                           purity, scal, n_s, n_ct, n_u,
                                           n_steps, n_members, st, s);
    return launch_form<T, MULTI, false>(gtt, bt, gu, bu, ydy, alpha, purity,
                                        scal, n_s, n_ct, n_u, n_steps,
                                        n_members, st, s);
}

}  // namespace

extern "C" {

int dm_fw_phase_full_f32(const void* gtt, const void* bt, const void* gu,
                         const void* bu, const void* ydy, void* alpha,
                         const void* purity, void* scal, int n_s, int n_ct,
                         int n_u, int n_steps, void* stream) {
    return launch<float, false>(gtt, bt, gu, bu, ydy, alpha, purity, scal,
                                n_s, n_ct, n_u, n_steps, 1,
                                dm::MemberStrides{}, stream);
}

int dm_fw_phase_full_f64(const void* gtt, const void* bt, const void* gu,
                         const void* bu, const void* ydy, void* alpha,
                         const void* purity, void* scal, int n_s, int n_ct,
                         int n_u, int n_steps, void* stream) {
    return launch<double, false>(gtt, bt, gu, bu, ydy, alpha, purity, scal,
                                 n_s, n_ct, n_u, n_steps, 1,
                                 dm::MemberStrides{}, stream);
}

// K6: B members, member b's operands at b times the given element strides
// (gtt, bt, ydy: 0 when the members share them; purity shared);
// scal_stride is the scalar row length.
int dm_fw_phase_full_multi_f32(
        const void* gtt, long long gtt_stride, const void* bt,
        long long bt_stride, const void* gu, long long gu_stride,
        const void* bu, long long bu_stride, const void* ydy,
        long long ydy_stride, void* alpha, long long alpha_stride,
        const void* purity, void* scal, long long scal_stride, int n_s,
        int n_ct, int n_u, int n_steps, int n_members, void* stream) {
    const dm::MemberStrides st{gtt_stride, bt_stride,    ydy_stride,
                               gu_stride,  bu_stride,    0,
                               alpha_stride, scal_stride, 0};
    return launch<float, true>(gtt, bt, gu, bu, ydy, alpha, purity, scal,
                               n_s, n_ct, n_u, n_steps, n_members, st,
                               stream);
}

int dm_fw_phase_full_multi_f64(
        const void* gtt, long long gtt_stride, const void* bt,
        long long bt_stride, const void* gu, long long gu_stride,
        const void* bu, long long bu_stride, const void* ydy,
        long long ydy_stride, void* alpha, long long alpha_stride,
        const void* purity, void* scal, long long scal_stride, int n_s,
        int n_ct, int n_u, int n_steps, int n_members, void* stream) {
    const dm::MemberStrides st{gtt_stride, bt_stride,    ydy_stride,
                               gu_stride,  bu_stride,    0,
                               alpha_stride, scal_stride, 0};
    return launch<double, true>(gtt, bt, gu, bu, ydy, alpha, purity, scal,
                                n_s, n_ct, n_u, n_steps, n_members, st,
                                stream);
}

}  // extern "C"
