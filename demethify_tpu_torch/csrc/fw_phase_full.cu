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
// grid's y axis), the cost summed by column_cost: alpha is the wide
// form's bit for bit, the cost too wherever the wide form's block held
// min(n_s, 32) warps.
// Above 64 rows the wide form keeps each warp's column (G_s, b_s, alpha
// and the gradient) in its own slab of shared memory and gives lane q the
// rows q, q + 32, ...: the same products in the same order, each block's
// minimum over the lanes' minima and its first row as the smallest row
// index holding it. The block has as many warps as slabs fit
// (small_common.cuh), warps loop over the columns, and the cost sums per
// warp then over the warps (block_cost); past one slab (p ~ 170 in
// float64) the slabs live in device memory, as K2's (GSLAB, the same
// code on other addresses). A member's columns stay inside its own
// blocks, so a K6 launch takes about K3's time whatever B is, and each
// member's arithmetic is K3's, bit for bit.
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
    if (!dm::column_cost(cs, m.ydy, n_s, tickets, mb, cost, lw)) return;
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
    if (!dm::column_cost(cs, m.ydy, n_s, tickets, mb, cost, lw)) return;
    m.scal[dm::kLW] = lw * dmax2;
    dm::set_cost<MULTI>(m.scal, cost);
}

// The wide form (p > 64): one block per member, each warp's column in its
// slab of shared memory (GSLAB: of the device buffer gslab, as K2's),
// warps looping over the columns; the cost summed per warp, then over
// the warps in order (block_cost).
template <typename T, bool MULTI, bool GSLAB>
__global__ void fw_phase_wide_kernel(
        const T* __restrict__ gtt, const T* __restrict__ bt,
        const T* __restrict__ gu, const T* __restrict__ bu,
        const T* __restrict__ ydy, T* __restrict__ alpha,
        const T* __restrict__ purity, T* __restrict__ scal,
        T* __restrict__ gslab, int n_s, int n_ct, int n_u, int n_steps,
        dm::MemberStrides st) {
    const Member<T> m = member<T, MULTI>(blockIdx.x, gtt, bt, gu, bu, ydy,
                                          alpha, scal, st);
    if constexpr (MULTI) {
        if (m.scal[dm::kActive] == T(0)) return;     // uniform per block
    }
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int n_warps = blockDim.x >> 5;
    const int p = n_ct + n_u;
    const T dmax2 = m.scal[dm::kDmax2];

    T sum_ba = T(0), sum_ag = T(0), sum_lw = T(0);
    T* sg = dm::warp_slab<T, GSLAB>(gslab, warp, n_warps, p);
    T* sb = sg + p * p;
    T* sal = sb + p;
    T* sgr = sal + p;
    for (int s = warp; s < n_s; s += n_warps) {
        dm::load_gram_wide(sg, sb, m.gtt, m.bt, m.gu, m.bu, s, lane, n_s,
                           n_ct, n_u);
        for (int q = lane; q < p; q += 32) sal[q] = m.alpha[q * n_s + s];
        __syncwarp();
        const T pur = purity[s];
        dm::fw_steps_wide(sg, sb, sal, sgr, lane, p, n_ct, pur, T(1) - pur,
                          n_steps);
        dm::add_column_sums_wide(sg, sb, sal, lane, p, n_u, sum_ba, sum_ag,
                                 sum_lw);
        for (int q = lane; q < p; q += 32) m.alpha[q * n_s + s] = sal[q];
        __syncwarp();    // the slab is free for the next column
    }
    T cost, lw;
    if (dm::block_cost(sum_ba, sum_ag, sum_lw, m.ydy, n_s, cost, lw)) {
        m.scal[dm::kLW] = lw * dmax2;
        dm::set_cost<MULTI>(m.scal, cost);
    }
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

template <typename T, bool MULTI, bool GSLAB>
int launch_wide_as(const void* gtt, const void* bt, const void* gu,
                   const void* bu, const void* ydy, void* alpha,
                   const void* purity, void* scal, void* gslab, int n_s,
                   int n_ct, int n_u, int n_steps, int n_members,
                   dm::MemberStrides st, cudaStream_t stream) {
    auto kern = fw_phase_wide_kernel<T, MULTI, GSLAB>;
    static const int max_warps = dm::max_block_warps(kern);
    size_t smem = 0;
    const int n_warps = dm::wide_warps<GSLAB>(sizeof(T), n_ct + n_u, n_s,
                                              max_warps, smem);
    if (n_warps < 1) return static_cast<int>(cudaErrorInvalidValue);
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    kern<<<n_members, 32 * n_warps, smem, stream>>>(
        static_cast<const T*>(gtt), static_cast<const T*>(bt),
        static_cast<const T*>(gu), static_cast<const T*>(bu),
        static_cast<const T*>(ydy), static_cast<T*>(alpha),
        static_cast<const T*>(purity), static_cast<T*>(scal),
        static_cast<T*>(gslab), n_s, n_ct, n_u, n_steps, st);
    return static_cast<int>(cudaGetLastError());
}

// the wide form's slabs in shared memory where one fits, else in the
// device buffer `work` (min(n_s, 32) slabs a member)
template <typename T, bool MULTI>
int launch_wide(const void* gtt, const void* bt, const void* gu,
                const void* bu, const void* ydy, void* alpha,
                const void* purity, void* scal, void* work, int n_s,
                int n_ct, int n_u, int n_steps, int n_members,
                dm::MemberStrides st, cudaStream_t stream) {
    if (dm::glue_warps(sizeof(T), n_ct + n_u, n_s) >= 1)
        return launch_wide_as<T, MULTI, false>(
            gtt, bt, gu, bu, ydy, alpha, purity, scal, nullptr, n_s, n_ct,
            n_u, n_steps, n_members, st, stream);
    if (work == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    return launch_wide_as<T, MULTI, true>(gtt, bt, gu, bu, ydy, alpha,
                                          purity, scal, work, n_s, n_ct, n_u,
                                          n_steps, n_members, st, stream);
}

// p > 64: the wide form; else the register form at row bucket `bucket`
// (8, 16 or 32, >= p) with `cols` columns a block, or the two-row form
// at bucket 64 (a column a block)
template <typename T, bool MULTI>
int launch(const void* gtt, const void* bt, const void* gu, const void* bu,
           const void* ydy, void* alpha, const void* purity, void* scal,
           void* colsum, void* tickets, int n_s, int n_ct, int n_u,
           int n_steps, int bucket, int cols, int n_members,
           dm::MemberStrides st, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int p = n_ct + n_u;
    if (p > dm::kTwoRowP)
        return launch_wide<T, MULTI>(gtt, bt, gu, bu, ydy, alpha, purity,
                                     scal, colsum, n_s, n_ct, n_u, n_steps,
                                     n_members, st, s);
    if (p > bucket || colsum == nullptr || tickets == nullptr)
        return static_cast<int>(cudaErrorInvalidValue);
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

// colsum (3, n_s) and tickets (1, zero) the register form's per-column
// cost terms and finished-block count (the register and two-row forms);
// above p = 64 tickets is unread and colsum the wide form's work buffer,
// as K2's (dm_glue_work); bucket and cols the plan as K2's
// (ops/cuda_small.alpha_plan; cols unread in the two-row form)
#define DM_K3_ENTRY(NAME, T)                                                 \
    int NAME(const void* gtt, const void* bt, const void* gu,                \
             const void* bu, const void* ydy, void* alpha,                   \
             const void* purity, void* scal, void* colsum, void* tickets,    \
             int n_s, int n_ct, int n_u, int n_steps, int bucket, int cols,  \
             void* stream) {                                                 \
        return launch<T, false>(gtt, bt, gu, bu, ydy, alpha, purity, scal,   \
                                colsum, tickets, n_s, n_ct, n_u, n_steps,    \
                                bucket, cols, 1, dm::MemberStrides{},        \
                                stream);                                     \
    }
DM_K3_ENTRY(dm_fw_phase_full_f32, float)
DM_K3_ENTRY(dm_fw_phase_full_f64, double)

// K6: B members, member b's operands at b times the given element strides
// (gtt, bt, ydy: 0 when the members share them; purity shared);
// scal_stride is the scalar row length; colsum (B, 3, n_s) and tickets
// (B, zero) as K3's.
#define DM_K6_ENTRY(NAME, T)                                                 \
    int NAME(const void* gtt, long long gtt_stride, const void* bt,          \
             long long bt_stride, const void* gu, long long gu_stride,       \
             const void* bu, long long bu_stride, const void* ydy,           \
             long long ydy_stride, void* alpha, long long alpha_stride,      \
             const void* purity, void* scal, long long scal_stride,          \
             void* colsum, void* tickets, int n_s, int n_ct, int n_u,        \
             int n_steps, int bucket, int cols, int n_members,               \
             void* stream) {                                                 \
        const dm::MemberStrides st{gtt_stride, bt_stride,    ydy_stride,     \
                                   gu_stride,  bu_stride,    0,              \
                                   alpha_stride, scal_stride, 0};            \
        return launch<T, true>(gtt, bt, gu, bu, ydy, alpha, purity, scal,    \
                               colsum, tickets, n_s, n_ct, n_u, n_steps,     \
                               bucket, cols, n_members, st, stream);         \
    }
DM_K6_ENTRY(dm_fw_phase_full_multi_f32, float)
DM_K6_ENTRY(dm_fw_phase_full_multi_f64, double)

}  // extern "C"
