// K4: the multi-member U-phase megakernel of the batched random restarts,
// for Hopper. This header holds the kernel and its launch, templated on
// the shared-memory layout (u_phase_common.cuh): u_phase_grams_multi.cu
// builds the resident layout, u_phase_grams_multi_wide.cu the wide one
// and u_phase_grams_multi_global{,_f64,_bf16}.cu the global one, a source
// a data type (K1's: Y, D and Rt
// read where they lie during the steps, the group's u rows at the top of
// shared memory, Rt streamed through a ring for the Gram stage,
// group_grams_ring; global_plan sizes it).
//
// Replaces the Pallas kernel demethify_tpu/ops/pallas_kernels.py
// :: _u_phase_grams_multi_kernel (called through u_phase_grams_multi).
// B restart members share Y, D and Rt; each has its own alpha blocks
// (a1_b, a2_b), its own u and u_prev and its own FISTA scalars. One outer
// iteration makes ONE pass over the CpG axis for all members: per site
// and per ACTIVE member b, K1's gram form (n_steps FISTA steps on u_i in
// registers, lagged or not), then member b's new-u Gram blocks
// gu_b (n_s, n_u, p), b_u_b (n_u, n_s) and usq_b. Inactive members
// (scalar slot kActive 0: the solver's per-member termination) are
// skipped: their u, u_prev, Nesterov scalar and l_w_prev stay as they are
// and their Gram outputs are not written (the solver does not read them).
// Gram form only, as the TPU kernel; the solver routes the direct form
// (n_u^2 > 3 n_s) to sequential single-member solves, as the JAX API does.
//
// Weighted form (W, the weighted bootstrap: one replicate per member):
// each member also has a row of per-site weights w_b (its resample's row
// multiplicities), which multiply the LEFT u of every Gram sum exactly
// once (gu = sum w u d [Rt | u], b_u = sum w u d y, usq = sum w u^2), as
// the TPU kernel folds its `weights` operand into the u rows of its Gram
// dots. The FISTA steps stay raw, so rows with w = 0 still move. Each
// thread forms its site's weighted rows w u_v once and stages them in NU
// more shared rows per member (s_wu) beside its raw u rows: the Gram sums
// read the weighted row as their left u and the raw rows as their right
// [Rt | u], so the self block's right-hand u is not weighted a second
// time. With all weights 1 every sum equals the unweighted kernel's bit
// for bit (1 u = u).
//
// What bounds it on an H100: instruction issue, not memory. The bytes it
// must move per outer iteration at 1M sites x 10 samples, 5 + 1, B = 16,
// float32 are Y, D, Rt (100 MB, read once) and the members' u, u_prev
// (128 MB read, 128 MB written): ~356 MB, ~106 us at 3.35 TB/s. The work
// is B times K1's per site: the C/M build, n_steps dependent FISTA steps
// and the Gram partial sums over the block's sites. Each member's momentum
// chain is computed once per launch by the prologue (k4_prologue_kernel,
// one warp per member) into a (B, n_steps + 1) table, which every thread
// reads as K1's threads do.
//
// What the design does about it (measured on an NVIDIA H100 80GB HBM3 at
// 700 W, PERF.md): one block per 128 sites stages its sites' Y, D and Rt
// columns in shared memory ONCE and takes the active members in GROUPS of
// G (k4_member_plan: the most members whose alpha blocks and u rows -- and
// weighted, their w u rows -- fit next to the staged rows while the block
// keeps min(kGroupBlocks, its one-member count) blocks per SM):
//   - the group's alpha blocks are staged at once (the wide layout reads
//     them from device memory); each thread then runs its site's steps for
//     every member of the group back to back, with no barrier between
//     members, each member into its own shared u rows. Members of
//     n_u <= kPairNU go two at a time (build_cm_pair, gram_steps_pair):
//     their chains interleave and the site's Y, D and Rt values are read
//     once for both (measured: 1.00-1.02 against 1.15-1.16 ms one at a
//     time, B = 16). Per member the arithmetic is K1's (u_phase_common.cuh
//     build_cm, gram_steps), so every member follows K1 bit for bit.
//     Above n_u = 8 a member's state lives on the chip as K1's does: in
//     the thread's column of one state region a block (build_cm_rows,
//     gram_steps_rows), which each member's loop reuses; it adds
//     state_rows to the block's shared memory once, not per member
//     (k4_smem), and overlays the wide and global layouts' chunk rows;
//   - one barrier, then ONE Gram stage over the group's G E entries
//     (group_grams, plan k4_gram_plan): where the tiles give each of the
//     128 threads one at least, register tiles whose rows run across the
//     members -- 2 samples x 2 left rows (member, unknown) x 4 rows of Rt,
//     so d_s and Rt_q are read once a site for both rows; 2 samples x 4
//     (member, v, w) pairs of the self block; 2 samples x 4 left rows of
//     b_u, the d y product formed once a site for all of them; one usq
//     per member -- each kind from a warp boundary, so no warp runs two
//     kinds (at the main shape B = 16 gives 136 tiles); below that, one
//     entry per thread as K1's stage (a handful of long tiles would leave
//     most threads waiting: B = 1 took 0.29 against K1's 0.14 ms).
//     Every entry is still summed over the block's sites in site order
//     from 0 with K1's products ((d_s u_v) r_q, u_v (d_s y_s), u_v u_v),
//     so each sum is K1's, bit for bit;
//   - the partials are laid out (n_blocks, B E): a block writes its
//     group's values contiguously (the earlier (B E, n_blocks) layout put
//     every value in its own 32-byte sector), members in active order.
//     The reduction keeps each entry's order -- 256 strided sums, block
//     t, t + 256, ..., then the same fixed tree as K1's
//     reduce_partials_kernel -- in two passes: a thread for each strided
//     sum, a warp reading 32 neighbouring entries of a block row
//     (reduce_chains_kernel), then one tree per entry (reduce_tree_kernel);
//   - the wide layout stages Y and D chunk by chunk once per group for the
//     group's Gram sums (each member's C/M build still reads its site's Y
//     and D from device memory), so its Gram stage reads them ceil(B / G)
//     times instead of B.
// The buffer is B E n_blocks itemsize bytes, as before (35 MB at the
// shape above), and shared memory is capped by the plan, not by B.
//
// bf16 storage (pallas_kernels.py:835-836, 853: the data converted at
// load, the state float32): Y, D and Rt arrive as __nv_bfloat16 (TD) with
// a float32 state and weight rows (T); each value is converted as it is
// read, and from there on every member runs the float32 form's
// arithmetic on the converted values (u_phase_common.cuh).
//
// Scalars: `scal` is (B, scal_stride) with K1's slots per member (kAU,
// kLW, kLWPrev read) plus kActive; `tab` is room for the members'
// momentum tables, B (n_steps + 1) values, and `list` for B + 1 ints (the
// active members in order, then their count; written by the prologue).
// Weights: `w` is (B, w_stride), NULL for the unweighted form.
//
// Plain C interface (ctypes): pointers and the stream as void*, launches
// on that stream, allocates nothing, returns cudaGetLastError(). Pointers
// of an empty known block (n_ct = 0) are never dereferenced.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "u_phase_common.cuh"

namespace dm {

// ---- the member plan (ops/cuda_multi.k4_member_plan is the same) -------

constexpr int kGroupBlocks = 4;     // blocks per SM a member group keeps
// Gram tiles of a member group: samples per tile, left rows (member,
// unknown) per cross tile (x kTileQ rows of Rt), (member, v, w) pairs per
// self tile, left rows per b_u tile
constexpr int kGS = 2, kGL = 2, kGP = 4, kGB = 4;

// shared memory of a group of `group` members (group = 1: the one-member
// bytes the layout rule reads, the *_smem export); layout kResident,
// kWide or kGlobal (global_plan's rows for the group). Above n_u = 8 the
// members' state region (state_rows of the gram form: one region a
// block, each member's loop reusing it) adds its rows: after the resident
// layout's, over the lead rows of the wide layout, at the bottom of the
// global layout's (in device memory where state_in_device).
__host__ __device__ __forceinline__ long long k4_smem(
        int layout, long long itemsize, int n_s, int n_ct, int n_u,
        bool weighted, int group) {
    if (layout >= kGlobal)
        return itemsize * kLd
               * global_plan(itemsize, n_s, n_ct, n_u, false,
                             n_u * (weighted ? 2 : 1), group).rows;
    const long long lead = lead_rows(n_s, n_u, false);
    const bool wide = layout == kWide;
    const long long u_rows = static_cast<long long>(group) * n_u
                             * (weighted ? 2 : 1);
    const long long alpha = wide ? 0
                                 : static_cast<long long>(group)
                                       * (n_ct + n_u) * n_s;
    const long long rows = wide ? lead
                                : 2LL * n_s + state_rows(n_s, n_u, false);
    return itemsize * ((rows + n_ct + u_rows) * kLd + alpha);
}

struct K4MemberPlan {
    long long smem;
    int group, blocks;
};

// G, the group's shared memory and the blocks per SM it keeps: the
// largest G <= n_b whose bytes leave min(kGroupBlocks, the one-member
// layout's blocks per SM) blocks on an SM, at least 1 (in the global
// layout the ring's rows shrink as G grows, so every G is tried)
__host__ __device__ __forceinline__ K4MemberPlan k4_member_plan(
        long long itemsize, int n_s, int n_ct, int n_u, int n_b,
        bool weighted, int layout) {
    K4MemberPlan g{};
    const long long one = k4_smem(layout, itemsize, n_s, n_ct, n_u,
                                  weighted, 1);
    long long fit = kSmemPerSm / (one + kSmemReserve);
    fit = fit < 16 ? fit : 16;                     // 2048 threads an SM
    g.blocks = static_cast<int>(fit < kGroupBlocks ? fit : kGroupBlocks);
    if (g.blocks < 1) g.blocks = 1;
    long long budget = kSmemPerSm / g.blocks - kSmemReserve;
    budget = budget < kSmemBlock ? budget : kSmemBlock;
    if (layout >= kGlobal) {
        g.group = 1;
        g.smem = one;
        const long long um = itemsize * kLd * n_u * (weighted ? 2 : 1);
        for (int gm = 2; gm <= n_b && gm * um <= budget; ++gm) {
            const long long b = k4_smem(layout, itemsize, n_s, n_ct, n_u,
                                        weighted, gm);
            if (b <= budget) {
                g.group = gm;
                g.smem = b;
            }
        }
        return g;
    }
    const long long base = k4_smem(layout, itemsize, n_s, n_ct, n_u,
                                   weighted, 0);
    long long group = (budget - base) / (one - base);
    group = group < n_b ? group : n_b;
    g.group = static_cast<int>(group < 1 ? 1 : group);
    g.smem = k4_smem(layout, itemsize, n_s, n_ct, n_u, weighted, g.group);
    return g;
}

struct K4GramPlan {
    int tiled, ts, tl, tq, tp, tb, n_x, n_self, n_bu, n_usq, o_self, o_bu,
        o_usq, n_items;
};

// The Gram stage's work for gm members and n_c staged samples, as items
// dealt to the block's threads (item k to thread k mod kSites). Tiled
// when the tiles give every thread one at least: cross tiles (ts x tl x
// tq: kGS samples x kGL left rows x kTileQ Rt rows) in items [0, n_x),
// self tiles (ts x tp: kGS samples x kGP pairs) from o_self, b_u tiles
// (ts x tb: kGS samples x kGB left rows) from o_bu and, with `usq`, one
// item per member from o_usq, each kind from a warp boundary so that a
// warp runs one kind (items between the kinds are idle); n_items is the
// last item + 1. Otherwise one item per entry, member by member, K1's
// local order each ([gu (n_c, n_u, p) | b_u (n_u, n_c) | usq]): fewer
// tiles than threads would leave most threads waiting on a few long ones.
__host__ __device__ __forceinline__ int warp_up(int x) {
    return (x + 31) / 32 * 32;
}

__host__ __device__ __forceinline__ K4GramPlan k4_gram_plan(int n_c,
                                                            int n_ct,
                                                            int n_u, int gm,
                                                            bool usq) {
    K4GramPlan g{};
    const int n_l = gm * n_u;
    g.ts = (n_c + kGS - 1) / kGS;
    g.tl = (n_l + kGL - 1) / kGL;
    g.tq = (n_ct + kTileQ - 1) / kTileQ;
    g.tp = (n_l * n_u + kGP - 1) / kGP;
    g.tb = (n_l + kGB - 1) / kGB;
    g.n_x = g.ts * g.tl * g.tq;
    g.n_self = g.ts * g.tp;
    g.n_bu = g.ts * g.tb;
    g.n_usq = usq ? gm : 0;
    g.tiled = g.n_x + g.n_self + g.n_bu + g.n_usq >= kSites;
    if (!g.tiled) {
        g.n_items = gm * (n_c * n_u * (n_ct + n_u) + n_u * n_c
                          + (usq ? 1 : 0));
        return g;
    }
    g.o_self = warp_up(g.n_x);
    g.o_bu = g.o_self + warp_up(g.n_self);
    g.o_usq = g.o_bu + warp_up(g.n_bu);
    g.n_items = g.o_usq + g.n_usq;
    return g;
}

}  // namespace dm

namespace {

using dm::kChunk;
using dm::kGB;
using dm::kGL;
using dm::kGP;
using dm::kGS;
using dm::kLd;
using dm::kRedThreads;
using dm::kSites;
using dm::kTileQ;
using dm::RegVec;

__device__ __forceinline__ int clamp_hi(int x, int hi) {
    return x < hi ? x : hi;
}

// Member slot k's usq: sum over the block's sites, then the unknowns, of
// x_v u_v (its left rows xk, its u rows uk)
template <typename T, int NU>
__device__ __forceinline__ T usq_tile(const T* __restrict__ xk,
                                      const T* __restrict__ uk, int nu) {
    if constexpr (NU > 0) nu = NU;
    T acc = T(0);
    for (int j = 0; j < kSites; ++j) {
#pragma unroll
        for (int v = 0; v < nu; ++v)
            acc += xk[v * kLd + j] * uk[v * kLd + j];
    }
    return acc;
}

// One entry of member slot k in the entry form: l in [0, n_loc) of K1's
// local order [gu (n_c, n_u, p) | b_u (n_u, n_c) | usq], summed over the
// block's sites in site order with K1's products (gram_entry)
template <typename T, int NU>
__device__ __forceinline__ void group_entry(
        int k, int l, const T* __restrict__ s_y, const T* __restrict__ s_d,
        const T* __restrict__ s_rt, const T* __restrict__ s_u,
        const T* __restrict__ s_x, int n_s, int c0, int n_c, int n_ct,
        int nu, T* __restrict__ out, int n_entries) {
    if constexpr (NU > 0) nu = NU;
    const int p = n_ct + nu;
    const int l_gu = n_c * nu * p;
    const T* xk = s_x + k * nu * kLd;
    const T* uk = s_u + k * nu * kLd;
    T acc = T(0);
    int e = n_entries - 1;
    if (l < l_gu) {
        const int s = l / (nu * p);
        const int v = (l / p) % nu;
        const int q = l % p;
        e = c0 * nu * p + l;
        const T* ds = s_d + s * kLd;
        const T* xv = xk + v * kLd;
        const T* rq = q < n_ct ? s_rt + q * kLd : uk + (q - n_ct) * kLd;
        for (int j = 0; j < kSites; ++j) acc += (ds[j] * xv[j]) * rq[j];
    } else if (l < l_gu + nu * n_c) {
        const int v = (l - l_gu) / n_c;
        const int s = (l - l_gu) % n_c;
        e = n_s * nu * p + v * n_s + c0 + s;
        const T* ds = s_d + s * kLd;
        const T* ys = s_y + s * kLd;
        acc = dm::bu_sum<T, dm::kRoundNone>(ds, ys, xk + v * kLd);
    } else {
        acc = usq_tile<T, NU>(xk, uk, nu);
    }
    out[static_cast<int64_t>(k) * n_entries + e] = acc;
}

// The group Gram stages' tiles, over the block's sites in site order with
// K1's products, each entry summed from 0 in a register:
// cross: acc[a][b][c] = sum_j (d_a x_b) r_c (rows ds, xl, rq);
// self: acc[a][e] = sum_j (d_a x_e) r_e (pairs e of a left and a right u
// row); b_u: acc[a][b] = sum_j x_b (d_a y_a).
template <typename T>
__device__ __forceinline__ void cross_tile(
        const T* const (&ds)[kGS], const T* const (&xl)[kGL],
        const T* const (&rq)[kTileQ], T (&acc)[kGS][kGL][kTileQ]) {
#pragma unroll
    for (int a = 0; a < kGS; ++a)
#pragma unroll
        for (int b = 0; b < kGL; ++b)
#pragma unroll
            for (int c = 0; c < kTileQ; ++c) acc[a][b][c] = T(0);
#pragma unroll 4
    for (int j = 0; j < kSites; ++j) {
        T r[kTileQ], x[kGL];
#pragma unroll
        for (int c = 0; c < kTileQ; ++c) r[c] = rq[c][j];
#pragma unroll
        for (int b = 0; b < kGL; ++b) x[b] = xl[b][j];
#pragma unroll
        for (int a = 0; a < kGS; ++a) {
            const T d = ds[a][j];
#pragma unroll
            for (int b = 0; b < kGL; ++b) {
                const T lf = d * x[b];
#pragma unroll
                for (int c = 0; c < kTileQ; ++c) acc[a][b][c] += lf * r[c];
            }
        }
    }
}

template <typename T>
__device__ __forceinline__ void self_tile(const T* const (&ds)[kGS],
                                          const T* const (&xl)[kGP],
                                          const T* const (&ur)[kGP],
                                          T (&acc)[kGS][kGP]) {
#pragma unroll
    for (int a = 0; a < kGS; ++a)
#pragma unroll
        for (int e = 0; e < kGP; ++e) acc[a][e] = T(0);
#pragma unroll 4
    for (int j = 0; j < kSites; ++j) {
        T x[kGP], r[kGP];
#pragma unroll
        for (int e = 0; e < kGP; ++e) {
            x[e] = xl[e][j];
            r[e] = ur[e][j];
        }
#pragma unroll
        for (int a = 0; a < kGS; ++a) {
            const T d = ds[a][j];
#pragma unroll
            for (int e = 0; e < kGP; ++e) {
                const T lf = d * x[e];
                acc[a][e] += lf * r[e];
            }
        }
    }
}

template <typename T>
__device__ __forceinline__ void bu_tile(const T* const (&ds)[kGS],
                                        const T* const (&ys)[kGS],
                                        const T* const (&xl)[kGB],
                                        T (&acc)[kGS][kGB]) {
#pragma unroll
    for (int a = 0; a < kGS; ++a)
#pragma unroll
        for (int b = 0; b < kGB; ++b) acc[a][b] = T(0);
#pragma unroll 4
    for (int j = 0; j < kSites; ++j) {
        T x[kGB];
#pragma unroll
        for (int b = 0; b < kGB; ++b) x[b] = xl[b][j];
#pragma unroll
        for (int a = 0; a < kGS; ++a) {
            const T dy = ds[a][j] * ys[a][j];
#pragma unroll
            for (int b = 0; b < kGB; ++b) acc[a][b] += x[b] * dy;
        }
    }
}

// Where a group stage finds its rows: sample s of the staged chunk (d, y),
// left row l = k n_u + v (member slot k, unknown v) and its right u rows
// (member k's rows at k ms rows from the first member's: ms = n_u in the
// shared layouts, -um in the global one, whose members are stacked
// downwards), and where member slot k's entry e goes (out[k E + e]).
template <typename T>
struct GroupRows {
    const T* s_y;
    const T* s_d;
    const T* s_u;
    const T* s_x;
    int ms, nu, n_c, n_l;
    __device__ __forceinline__ const T* d(int s) const {
        return s_d + clamp_hi(s, n_c - 1) * kLd;
    }
    __device__ __forceinline__ const T* y(int s) const {
        return s_y + clamp_hi(s, n_c - 1) * kLd;
    }
    __device__ __forceinline__ const T* x(int l) const {
        l = clamp_hi(l, n_l - 1);
        return s_x + ((l / nu) * ms + l % nu) * kLd;
    }
    __device__ __forceinline__ const T* u(int k, int w) const {
        return s_u + (k * ms + w) * kLd;
    }
};

// One cross tile: samples [s0, s0 + kGS) x left rows [l0, l0 + kGL) x the
// kTileQ rows from q0 of the nq rows at s_r, which are rows qo + q of Rt;
// entries past the edges write nothing
template <typename T>
__device__ __forceinline__ void put_cross(const GroupRows<T>& gr, int s0,
                                          int l0, int q0,
                                          const T* __restrict__ s_r, int nq,
                                          int qo, int c0, int p,
                                          T* __restrict__ out,
                                          int n_entries) {
    const T* ds[kGS];
    const T* xl[kGL];
    const T* rq[kTileQ];
#pragma unroll
    for (int a = 0; a < kGS; ++a) ds[a] = gr.d(s0 + a);
#pragma unroll
    for (int b = 0; b < kGL; ++b) xl[b] = gr.x(l0 + b);
#pragma unroll
    for (int c = 0; c < kTileQ; ++c)
        rq[c] = s_r + clamp_hi(q0 + c, nq - 1) * kLd;
    T acc[kGS][kGL][kTileQ];
    cross_tile(ds, xl, rq, acc);
#pragma unroll
    for (int a = 0; a < kGS; ++a)
#pragma unroll
        for (int b = 0; b < kGL; ++b)
#pragma unroll
            for (int c = 0; c < kTileQ; ++c) {
                const int s = s0 + a, l = l0 + b;
                if (s < gr.n_c && l < gr.n_l && q0 + c < nq)
                    out[static_cast<int64_t>(l / gr.nu) * n_entries
                        + ((c0 + s) * gr.nu + l % gr.nu) * p + qo + q0 + c] =
                        acc[a][b][c];
            }
}

// One self tile (samples [s0, s0 + kGS) x pairs [e0, e0 + kGP) of
// (member, v, w)), one b_u tile (samples x left rows [l0, l0 + kGB)) or
// member slot k's usq
template <typename T>
__device__ __forceinline__ void put_self(const GroupRows<T>& gr, int s0,
                                         int e0, int c0, int n_ct, int p,
                                         T* __restrict__ out, int n_entries) {
    const int nu = gr.nu;
    const int n_pair = gr.n_l * nu;
    const T* ds[kGS];
    const T* xl[kGP];
    const T* ur[kGP];
#pragma unroll
    for (int a = 0; a < kGS; ++a) ds[a] = gr.d(s0 + a);
#pragma unroll
    for (int e = 0; e < kGP; ++e) {
        const int pr = clamp_hi(e0 + e, n_pair - 1);
        const int l = pr / nu;
        xl[e] = gr.x(l);
        ur[e] = gr.u(l / nu, pr % nu);
    }
    T acc[kGS][kGP];
    self_tile(ds, xl, ur, acc);
#pragma unroll
    for (int a = 0; a < kGS; ++a)
#pragma unroll
        for (int e = 0; e < kGP; ++e) {
            const int s = s0 + a, pr = e0 + e;
            if (s < gr.n_c && pr < n_pair) {
                const int l = pr / nu;
                out[static_cast<int64_t>(l / nu) * n_entries
                    + ((c0 + s) * nu + l % nu) * p + n_ct + pr % nu] =
                    acc[a][e];
            }
        }
}

template <typename T>
__device__ __forceinline__ void put_bu(const GroupRows<T>& gr, int s0,
                                       int l0, int c0, int n_s, int e_bu,
                                       T* __restrict__ out, int n_entries) {
    const T* ds[kGS];
    const T* ys[kGS];
    const T* xl[kGB];
#pragma unroll
    for (int a = 0; a < kGS; ++a) {
        ds[a] = gr.d(s0 + a);
        ys[a] = gr.y(s0 + a);
    }
#pragma unroll
    for (int b = 0; b < kGB; ++b) xl[b] = gr.x(l0 + b);
    T acc[kGS][kGB];
    bu_tile(ds, ys, xl, acc);
#pragma unroll
    for (int a = 0; a < kGS; ++a)
#pragma unroll
        for (int b = 0; b < kGB; ++b) {
            const int l = l0 + b;
            if (s0 + a < gr.n_c && l < gr.n_l)
                out[static_cast<int64_t>(l / gr.nu) * n_entries + e_bu
                    + (l % gr.nu) * n_s + c0 + s0 + a] = acc[a][b];
        }
}

// The Gram stage of one member group for the samples [c0, c0 + n_c)
// staged in s_y, s_d (row s - c0); s_rt holds Rt (n_ct rows), s_u the
// group's u rows (row k n_u + v: member slot k, unknown v) and s_x the
// left u rows (s_u, or weighted the w u rows). Member slot k's entry e
// goes to out[k E + e], e in [gu (n_s, n_u, p) | b_u (n_u, n_s) | usq]
// (the caller points out at the block's row, at the group's first slot).
template <typename T, int NU>
__device__ __forceinline__ void group_grams(
        const T* __restrict__ s_y, const T* __restrict__ s_d,
        const T* __restrict__ s_rt, const T* __restrict__ s_u,
        const T* __restrict__ s_x, int n_s, int c0, int n_c, bool usq,
        int n_ct, int n_u, int gm, int tid, T* __restrict__ out,
        int n_entries) {
    const int nu = NU > 0 ? NU : n_u;
    const int p = n_ct + nu;
    const int n_l = gm * nu;
    const int e_bu = n_s * nu * p;
    const dm::K4GramPlan g = dm::k4_gram_plan(n_c, n_ct, nu, gm, usq);
    if (!g.tiled) {
        const int n_loc = g.n_items / gm;
        for (int l = tid; l < g.n_items; l += kSites)
            group_entry<T, NU>(l / n_loc, l % n_loc, s_y, s_d, s_rt, s_u,
                               s_x, n_s, c0, n_c, n_ct, nu, out, n_entries);
        return;
    }
    const GroupRows<T> gr{s_y, s_d, s_u, s_x, nu, nu, n_c, n_l};
    for (int k = tid; k < g.n_items; k += kSites) {
        if (k < g.n_x) {
            // cross tile: (d_s x_l) Rt_q, d_s and Rt_q shared by the rows
            put_cross(gr, (k / (g.tq * g.tl)) * kGS, ((k / g.tq) % g.tl) * kGL,
                      (k % g.tq) * kTileQ, s_rt, n_ct, 0, c0, p, out,
                      n_entries);
            continue;
        }
        if (k < g.o_self) continue;                 // between the kinds
        int kk = k - g.o_self;
        if (kk < g.n_self) {
            // self tile: (d_s x_{k,v}) u_{k,w} over pairs (k n_u + v) n_u + w
            put_self(gr, (kk / g.tp) * kGS, (kk % g.tp) * kGP, c0, n_ct, p,
                     out, n_entries);
            continue;
        }
        if (k < g.o_bu) continue;
        kk = k - g.o_bu;
        if (kk < g.n_bu) {
            // b_u tile: x_l (d_s y_s), d_s y_s formed once a site
            put_bu(gr, (kk / g.tb) * kGS, (kk % g.tb) * kGB, c0, n_s, e_bu,
                   out, n_entries);
            continue;
        }
        // usq of member slot kk: sum over sites, then unknowns, of x_v u_v
        if (k < g.o_usq) continue;
        kk = k - g.o_usq;
        out[static_cast<int64_t>(kk) * n_entries + n_entries - 1] =
            usq_tile<T, NU>(s_x + kk * nu * kLd, s_u + kk * nu * kLd, nu);
    }
}

// The global layout's group Gram stage (group_grams' tiles, products and
// orders; gram_partials_ring's pipeline): Y and D g.cs samples at a time
// into the bottom rows; per chunk, first the self tiles, b_u tiles and
// (with the last chunk) each member's usq, each kind from a warp boundary,
// while the first slot of Rt lands, then Rt g.q rows a slot through the
// ring, the next slot loading while this one's cross tiles (samples x left
// rows x rows of the slot) are summed. Member slot k's u rows are at
// s_u + k ms rows (its left rows at s_x + k ms). Called by every thread of
// the block after the group's u rows are written; starts with a barrier.
template <typename T, typename TD, int NU>
__device__ __forceinline__ void group_grams_ring(
        T* __restrict__ smem, const dm::GlobalPlan& g,
        const T* __restrict__ s_u, const T* __restrict__ s_x, int ms,
        const TD* __restrict__ ydt, const TD* __restrict__ rtt, int64_t i,
        bool live, int64_t n, int n_s, int n_ct, int n_u, int gm, int tid,
        T* __restrict__ out, int n_entries) {
    const int nu = NU > 0 ? NU : n_u;
    const int p = n_ct + nu;
    const int n_l = gm * nu;
    const int e_bu = n_s * nu * p;
    T* s_y = smem;
    T* s_d = s_y + g.cs * kLd;
    T* ring = s_d + g.cs * kLd;
    const int n_rc = g.q > 0 ? (n_ct + g.q - 1) / g.q : 0;
    const int tl = (n_l + kGL - 1) / kGL;
    const int tp = (n_l * nu + kGP - 1) / kGP;
    const int tb = (n_l + kGB - 1) / kGB;
    for (int c0 = 0; c0 < n_s; c0 += g.cs) {
        const int c1 = c0 + g.cs < n_s ? c0 + g.cs : n_s;
        const int n_c = c1 - c0;
        const int ts = (n_c + kGS - 1) / kGS;
        const GroupRows<T> gr{s_y, s_d, s_u, s_x, ms, nu, n_c, n_l};
        __syncthreads();     // the u rows written; the last chunk's sums done
        dm::stage_rows(s_y, ydt, c0, c1, i, live, n, tid);
        dm::stage_rows(s_d, ydt + static_cast<int64_t>(n_s) * n, c0, c1, i,
                       live, n, tid);
        dm::stage_commit();
        if (n_rc > 0) {
            dm::stage_rows(ring, rtt, 0, g.q < n_ct ? g.q : n_ct, i, live, n,
                           tid);
            dm::stage_commit();
        }
        dm::stage_wait_pending(n_rc > 0 ? 1 : 0);
        __syncthreads();
        const int n_self = ts * tp, n_bu = ts * tb;
        const int o_bu = dm::warp_up(n_self), o_usq = o_bu + dm::warp_up(n_bu);
        const int n_items = o_usq + (c1 == n_s ? gm : 0);
        for (int k = tid; k < n_items; k += kSites) {
            if (k < n_self) {
                put_self(gr, (k / tp) * kGS, (k % tp) * kGP, c0, n_ct, p, out,
                         n_entries);
            } else if (k >= o_bu && k - o_bu < n_bu) {
                const int kk = k - o_bu;
                put_bu(gr, (kk / tb) * kGS, (kk % tb) * kGB, c0, n_s, e_bu,
                       out, n_entries);
            } else if (k >= o_usq) {
                const int kk = k - o_usq;
                out[static_cast<int64_t>(kk) * n_entries + n_entries - 1] =
                    usq_tile<T, NU>(s_x + kk * ms * kLd, s_u + kk * ms * kLd,
                                    nu);
            }
        }
        for (int rc = 0; rc < n_rc; ++rc) {
            dm::stage_wait_pending(0);
            __syncthreads();    // slot rc % 2 landed, the other one free
            const int r0 = rc * g.q;
            const int nq = n_ct - r0 < g.q ? n_ct - r0 : g.q;
            if (rc + 1 < n_rc) {
                const int r1 = r0 + g.q;
                dm::stage_rows(ring + ((rc + 1) & 1) * g.q * kLd, rtt, r1,
                               r1 + g.q < n_ct ? r1 + g.q : n_ct, i, live, n,
                               tid);
                dm::stage_commit();
            }
            const T* slot = ring + (rc & 1) * g.q * kLd;
            const int tq = (nq + kTileQ - 1) / kTileQ;
            const int n_x = ts * tl * tq;
            for (int k = tid; k < n_x; k += kSites)
                put_cross(gr, (k / (tq * tl)) * kGS, ((k / tq) % tl) * kGL,
                          (k % tq) * kTileQ, slot, nq, r0, c0, p, out,
                          n_entries);
        }
    }
}

// Members of n_u <= kPairNU run two at a time in each thread
// (build_cm_pair, gram_steps_pair): their chains are independent, so the
// two interleave, and the site's Y, D and Rt values are read once for
// both. Above, the state of two members would not fit the registers.
constexpr int kPairNU = 4;

// build_cm (u_phase_common.cuh, its plain form) for two members at once:
// per member the same sums in the same order (the known residual
// d y - d (a1' rt), C += a2 dres, M += (a2 a2') d), the site's y, d and Rt
// values read once for both (from a DevRows, kKnownGroup samples' known
// sums a pass, as build_cm's)
template <typename T, int NU, typename TY, typename RT>
__device__ __forceinline__ void build_cm_pair_at(
        RegVec<T, NU> (&cc)[2], RegVec<T, NU * (NU + 1) / 2> (&m)[2],
        const TY* __restrict__ y, const TY* __restrict__ d, int64_t ld,
        RT rt, const T* const (&a1)[2], const T* const (&a2)[2], int n_s,
        int n_ct) {
#pragma unroll
    for (int x = 0; x < 2; ++x) {
#pragma unroll
        for (int v = 0; v < NU; ++v) cc[x][v] = T(0);
#pragma unroll
        for (int k = 0; k < NU * (NU + 1) / 2; ++k) m[x][k] = T(0);
    }
    if constexpr (dm::IsDevRows<RT>::value) {
        constexpr int G = dm::kKnownGroup;
        for (int s0 = 0; s0 < n_s; s0 += G) {
            int sg[G];
            T kn[2][G];
#pragma unroll
            for (int g = 0; g < G; ++g) {
                sg[g] = s0 + g < n_s ? s0 + g : n_s - 1;
                kn[0][g] = kn[1][g] = T(0);
            }
#pragma unroll 4
            for (int c = 0; c < n_ct; ++c) {
                const T r = dm::rt_at(rt, c);
#pragma unroll
                for (int x = 0; x < 2; ++x)
#pragma unroll
                    for (int g = 0; g < G; ++g)
                        kn[x][g] += a1[x][c * n_s + sg[g]] * r;
            }
#pragma unroll
            for (int g = 0; g < G; ++g) {
                const int s = s0 + g;
                if (s >= n_s) break;
                const T yv = dm::to_state(y[s * ld]);
                const T dv = dm::to_state(d[s * ld]);
#pragma unroll
                for (int x = 0; x < 2; ++x)
                    dm::add_cm(cc[x], m[x], a2[x], s, n_s, NU, dv,
                               dv * yv - dv * kn[x][g]);
            }
        }
    } else {
        for (int s = 0; s < n_s; ++s) {
            const T yv = dm::to_state(y[s * ld]);
            const T dv = dm::to_state(d[s * ld]);
            T known[2] = {T(0), T(0)};
            for (int c = 0; c < n_ct; ++c) {
                const T r = rt[c * kLd];
#pragma unroll
                for (int x = 0; x < 2; ++x)
                    known[x] += a1[x][c * n_s + s] * r;
            }
#pragma unroll
            for (int x = 0; x < 2; ++x)
                dm::add_cm(cc[x], m[x], a2[x], s, n_s, NU, dv,
                           dv * yv - dv * known[x]);
        }
    }
}

// build_cm_pair_at on a staged Rt column (the staged layouts' form:
// u_phase_common.cuh, known_resid's note)
template <typename T, int NU, typename TY>
__device__ __forceinline__ void build_cm_pair(
        RegVec<T, NU> (&cc)[2], RegVec<T, NU * (NU + 1) / 2> (&m)[2],
        const TY* __restrict__ y, const TY* __restrict__ d, int64_t ld,
        const T* __restrict__ rt, const T* const (&a1)[2],
        const T* const (&a2)[2], int n_s, int n_ct) {
    build_cm_pair_at<T, NU>(cc, m, y, d, ld, rt, a1, a2, n_s, n_ct);
}

// gram_steps (u_phase_common.cuh) for two members at once, each with its
// own momentum table and l_w: per member the same steps in the same order
template <typename T, int NU, bool LAG>
__device__ __forceinline__ void gram_steps_pair(
        RegVec<T, NU> (&u)[2], RegVec<T, NU> (&up)[2],
        const RegVec<T, NU> (&cc)[2],
        const RegVec<T, NU * (NU + 1) / 2> (&m)[2], RegVec<T, NU> (&ut)[2],
        RegVec<T, NU> (&un)[2], const T* const (&beta_tab)[2],
        const T (&l_w)[2], int n_steps) {
    T beta_next[2] = {beta_tab[0][0], beta_tab[1][0]};
    for (int step = 0; step < n_steps; ++step) {
#pragma unroll
        for (int x = 0; x < 2; ++x) {
            const T beta = beta_next[x];
            beta_next[x] = beta_tab[x][step + 1];
#pragma unroll
            for (int v = 0; v < NU; ++v)
                ut[x][v] = u[x][v] + beta * (u[x][v] - up[x][v]);
#pragma unroll
            for (int v = 0; v < NU; ++v) {
                T mu = T(0);
#pragma unroll
                for (int w = 0; w < NU; ++w)
                    mu += m[x][dm::sym(v, w, NU)] * (LAG ? u[x][w]
                                                         : ut[x][w]);
                un[x][v] = dm::clip01(ut[x][v] + (cc[x][v] - mu) / l_w[x]);
            }
#pragma unroll
            for (int v = 0; v < NU; ++v) {
                up[x][v] = u[x][v];
                u[x][v] = un[x][v];
            }
        }
    }
}

template <typename T, typename TD, int NU, bool W, int LAYOUT>
__global__ void __launch_bounds__(kSites)
u_phase_grams_multi_kernel(
        const TD* __restrict__ ydt, const TD* __restrict__ rtt,
        const T* __restrict__ a1b, int64_t a1_stride,
        const T* __restrict__ a2b, int64_t a2_stride, T* __restrict__ uut,
        const T* __restrict__ w, int64_t w_stride,
        const T* __restrict__ scal, int scal_stride,
        const T* __restrict__ tab, const int* __restrict__ list,
        T* __restrict__ partials, T* __restrict__ state, int64_t n, int n_s,
        int n_ct, int n_u, int n_steps, int n_members, int group,
        int lagged) {
    constexpr bool WIDE = LAYOUT != dm::kResident;
    constexpr bool GLOBAL = LAYOUT >= dm::kGlobal;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int nu = NU > 0 ? NU : n_u;
    const int p = n_ct + nu;
    // staged Y (and D) rows, Rt, then the group's rows; the global layout
    // (global_plan) stages nothing before the steps and keeps the group's
    // rows at the top, member k's um rows at rows - (k + 1) um
    const int rows = WIDE ? dm::chunk_rows(n_s) : n_s;
    T* s_y = reinterpret_cast<T*>(smem_raw);
    T* s_d = s_y + rows * kLd;
    T* s_rt = s_d + rows * kLd;                     // n_ct rows
    // above n_u = 8 the wide layout's staged rows are its lead rows, which
    // the state region overlays
    if constexpr (NU == 0 && WIDE && !GLOBAL)
        s_rt = s_y + dm::lead_rows(n_s, nu, false) * kLd;
    const int um = W ? 2 * nu : nu;
    dm::GlobalPlan gp{};
    if constexpr (GLOBAL)
        gp = dm::global_plan(sizeof(T), n_s, n_ct, nu, false, um, group);
    // rows from one member's u rows to the next one's
    const int ms = GLOBAL ? -um : nu;
    T* s_u = GLOBAL ? s_y + (gp.rows - um) * kLd    // the group's u rows
                    : s_rt + n_ct * kLd;
    T* s_wu = GLOBAL ? s_u + nu * kLd               // W: their w u rows
                     : s_u + group * nu * kLd;
    T* s_a = s_wu + (W ? group * nu * kLd : 0);     // resident: alpha blocks
    const T* s_x = W ? s_wu : s_u;                  // the Gram sums' left u

    const int tid = threadIdx.x;
    const int64_t i = static_cast<int64_t>(blockIdx.x) * kSites + tid;
    const bool live = i < n;
    if constexpr (!WIDE) {
        dm::stage_rows(s_y, ydt, 0, n_s, i, live, n, tid);
        dm::stage_rows(s_d, ydt + static_cast<int64_t>(n_s) * n, 0, n_s, i,
                       live, n, tid);
    }
    if constexpr (!GLOBAL) dm::stage_rows(s_rt, rtt, 0, n_ct, i, live, n, tid);
    dm::stage_wait();
    // this site's Rt column where it lies (the global layout)
    const dm::DevRows<TD> rt_dev{rtt + i, n};
    const int n_entries = dm::gram_entries(n_s, n_ct, nu);
    const int n_act = list[n_members];
    T* out_row = partials + static_cast<int64_t>(blockIdx.x) * n_members
                                * n_entries;

    for (int k0 = 0; k0 < n_act; k0 += group) {
        const int gm = n_act - k0 < group ? n_act - k0 : group;
        __syncthreads();     // staged rows published; previous group done
        if constexpr (!WIDE) {
            const int blk = p * n_s;
            for (int x = tid; x < gm * blk; x += kSites) {
                const int b = list[k0 + x / blk];
                const int r = x % blk;
                s_a[x] = r < n_ct * n_s ? a1b[b * a1_stride + r]
                                        : a2b[b * a2_stride + r - n_ct * n_s];
            }
            __syncthreads();
        }
        // the group's members back to back, no barrier between them: two
        // at a time where n_u <= kPairNU, then one at a time
        int k = 0;
        if constexpr (NU > 0 && NU <= kPairNU) {
            for (; k + 1 < gm; k += 2) {
                const T* tb[2];
                const T* a1[2];
                const T* a2[2];
                T* ub[2];
                T lw[2], wi[2];
#pragma unroll
                for (int x = 0; x < 2; ++x) {
                    const int b = list[k0 + k + x];
                    lw[x] = scal[static_cast<int64_t>(b) * scal_stride
                                 + dm::kLW];
                    tb[x] = tab + static_cast<int64_t>(b) * (n_steps + 1);
                    a1[x] = WIDE ? a1b + b * a1_stride
                                 : s_a + (k + x) * p * n_s;
                    a2[x] = WIDE ? a2b + b * a2_stride : a1[x] + n_ct * n_s;
                    ub[x] = uut + static_cast<int64_t>(b) * (2 * NU) * n;
                    wi[x] = (W && live)
                                ? w[static_cast<int64_t>(b) * w_stride + i]
                                : T(0);
                }
                T* u_rows = s_u + k * ms * kLd + tid;   // both members' rows
                T* wu_rows = s_wu + k * ms * kLd + tid;
                if (live) {
                    RegVec<T, NU> u[2], up[2], cc[2], t1[2], t2[2];
                    RegVec<T, NU * (NU + 1) / 2> m[2];
#pragma unroll
                    for (int x = 0; x < 2; ++x)
#pragma unroll
                        for (int v = 0; v < NU; ++v) {
                            u[x][v] = ub[x][v * n + i];
                            up[x][v] = ub[x][(NU + v) * n + i];
                        }
                    if constexpr (GLOBAL)
                        build_cm_pair_at<T, NU>(
                            cc, m, ydt + i,
                            ydt + static_cast<int64_t>(n_s) * n + i, n,
                            rt_dev, a1, a2, n_s, n_ct);
                    else if constexpr (WIDE)
                        build_cm_pair<T, NU>(
                            cc, m, ydt + i,
                            ydt + static_cast<int64_t>(n_s) * n + i, n,
                            s_rt + tid, a1, a2, n_s, n_ct);
                    else
                        build_cm_pair<T, NU>(cc, m, s_y + tid, s_d + tid,
                                             int64_t(kLd), s_rt + tid, a1,
                                             a2, n_s, n_ct);
                    if (lagged)
                        gram_steps_pair<T, NU, true>(u, up, cc, m, t1, t2,
                                                     tb, lw, n_steps);
                    else
                        gram_steps_pair<T, NU, false>(u, up, cc, m, t1, t2,
                                                      tb, lw, n_steps);
#pragma unroll
                    for (int x = 0; x < 2; ++x)
#pragma unroll
                        for (int v = 0; v < NU; ++v) {
                            ub[x][v * n + i] = u[x][v];
                            ub[x][(NU + v) * n + i] = up[x][v];
                            u_rows[(x * ms + v) * kLd] = u[x][v];
                            if constexpr (W)
                                wu_rows[(x * ms + v) * kLd] = wi[x] * u[x][v];
                        }
                } else {
#pragma unroll
                    for (int x = 0; x < 2; ++x)
#pragma unroll
                        for (int v = 0; v < NU; ++v) {
                            u_rows[(x * ms + v) * kLd] = T(0);
                            if constexpr (W)
                                wu_rows[(x * ms + v) * kLd] = T(0);
                        }
                }
            }
        }
        for (; k < gm; ++k) {
            const int b = list[k0 + k];
            const T* sc = scal + static_cast<int64_t>(b) * scal_stride;
            const T* tb = tab + static_cast<int64_t>(b) * (n_steps + 1);
            const T* a1 = WIDE ? a1b + b * a1_stride : s_a + k * p * n_s;
            const T* a2 = WIDE ? a2b + b * a2_stride : a1 + n_ct * n_s;
            T* ub = uut + static_cast<int64_t>(b) * (2 * nu) * n;
            T* u_rows = s_u + k * ms * kLd + tid;
            T* wu_rows = s_wu + k * ms * kLd + tid;
            const T wi = (W && live)
                             ? w[static_cast<int64_t>(b) * w_stride + i]
                             : T(0);
            auto run = [&](auto& u, auto& up, auto& cc, auto& m, auto& t1,
                           auto& t2) {
                if constexpr (GLOBAL)
                    dm::build_cm_at<T, NU, dm::kRoundNone>(
                        cc, m, t1, nu, ydt + i,
                        ydt + static_cast<int64_t>(n_s) * n + i, n, rt_dev,
                        a1, a2, n_s, n_ct);
                else if constexpr (WIDE)
                    dm::build_cm<T, NU, dm::kRoundNone>(
                        cc, m, t1, nu, ydt + i,
                        ydt + static_cast<int64_t>(n_s) * n + i, n,
                        s_rt + tid, a1, a2, n_s, n_ct);
                else
                    dm::build_cm<T, NU, dm::kRoundNone>(
                        cc, m, t1, nu, s_y + tid, s_d + tid, int64_t(kLd),
                        s_rt + tid, a1, a2, n_s, n_ct);
                if (lagged)
                    dm::gram_steps<T, NU, true>(u, up, cc, m, t1, t2, nu, tb,
                                                sc[dm::kLW], n_steps);
                else
                    dm::gram_steps<T, NU, false>(u, up, cc, m, t1, t2, nu,
                                                 tb, sc[dm::kLW], n_steps);
#pragma unroll
                for (int v = 0; v < nu; ++v) {
                    u_rows[v * kLd] = u[v];
                    if constexpr (W) wu_rows[v * kLd] = wi * u[v];
                }
            };
            if (live) {
                if constexpr (NU > 0) {
                    RegVec<T, NU> u, up, cc, t1, t2;
                    RegVec<T, NU * (NU + 1) / 2> m;
#pragma unroll
                    for (int v = 0; v < NU; ++v) {
                        u[v] = ub[v * n + i];
                        up[v] = ub[(NU + v) * n + i];
                    }
                    run(u, up, cc, m, t1, t2);
#pragma unroll
                    for (int v = 0; v < NU; ++v) {
                        ub[v * n + i] = u[v];
                        ub[(NU + v) * n + i] = up[v];
                    }
                } else {
                    // the member's state in this thread's column of the
                    // block's state region (K1's n_u > 8 form; the next
                    // member reuses it): after the alpha blocks, over the
                    // lead rows, or in this block's part of the state
                    // buffer. C/M, then the steps on u, u_prev
                    T* region;
                    if constexpr (LAYOUT == dm::kGlobalState)
                        region = state
                                 + static_cast<int64_t>(blockIdx.x)
                                       * dm::state_rows(n_s, nu, false)
                                       * kLd;
                    else if constexpr (WIDE)
                        region = s_y;
                    else
                        region = s_a + group * p * n_s;
                    T* st = region + tid;
                    if constexpr (GLOBAL)
                        dm::build_cm_rows_at<T, dm::kRoundNone>(
                            st, nu, ydt + i,
                            ydt + static_cast<int64_t>(n_s) * n + i, n,
                            rt_dev, a1, a2, n_s, n_ct);
                    else if constexpr (WIDE)
                        dm::build_cm_rows<T, dm::kRoundNone>(
                            st, nu, ydt + i,
                            ydt + static_cast<int64_t>(n_s) * n + i, n,
                            s_rt + tid, a1, a2, n_s, n_ct);
                    else
                        dm::build_cm_rows<T, dm::kRoundNone>(
                            st, nu, s_y + tid, s_d + tid, int64_t(kLd),
                            s_rt + tid, a1, a2, n_s, n_ct);
                    for (int v = 0; v < 2 * nu; ++v)
                        st[v * kLd] = ub[v * n + i];
                    const T l_w = sc[dm::kLW];
                    const int2 slot =
                        lagged ? dm::gram_steps_rows<T, true>(st, nu, tb, l_w,
                                                              n_steps)
                               : dm::gram_steps_rows<T, false>(st, nu, tb,
                                                               l_w, n_steps);
                    const T* u = st + slot.x * nu * kLd;
                    const T* up = st + slot.y * nu * kLd;
                    for (int v = 0; v < nu; ++v) {
                        const T uv = u[v * kLd];
                        ub[v * n + i] = uv;
                        ub[(nu + v) * n + i] = up[v * kLd];
                        u_rows[v * kLd] = uv;
                        if constexpr (W) wu_rows[v * kLd] = wi * uv;
                    }
                }
            } else {
#pragma unroll
                for (int v = 0; v < nu; ++v) {
                    u_rows[v * kLd] = T(0);
                    if constexpr (W) wu_rows[v * kLd] = T(0);
                }
            }
        }
        __syncthreads();
        T* out = out_row + static_cast<int64_t>(k0) * n_entries;
        if constexpr (GLOBAL) {
            group_grams_ring<T, TD, NU>(s_y, gp, s_u, s_x, ms, ydt, rtt, i,
                                        live, n, n_s, n_ct, nu, gm, tid, out,
                                        n_entries);
        } else if constexpr (WIDE) {
            for (int c0 = 0; c0 < n_s; c0 += kChunk) {
                const int c1 = c0 + kChunk < n_s ? c0 + kChunk : n_s;
                if (c0 > 0) __syncthreads();   // the previous chunk's sums
                dm::stage_rows(s_y, ydt, c0, c1, i, live, n, tid);
                dm::stage_rows(s_d, ydt + static_cast<int64_t>(n_s) * n, c0,
                               c1, i, live, n, tid);
                dm::stage_wait();
                __syncthreads();
                group_grams<T, NU>(s_y, s_d, s_rt, s_u, s_x, n_s, c0,
                                   c1 - c0, c1 == n_s, n_ct, nu, gm, tid,
                                   out, n_entries);
            }
        } else {
            group_grams<T, NU>(s_y, s_d, s_rt, s_u, s_x, n_s, 0, n_s, true,
                               n_ct, nu, gm, tid, out, n_entries);
        }
    }
}


// The launch's prologue: warp b < B writes member b's momentum table
// (momentum_table_kernel's arithmetic, the betas then the advanced
// Nesterov scalar) at tab + b (n_steps + 1); warp B writes the active
// members (kActive not 0) in order to list[0, n_act) and n_act to
// list[B].
template <typename T>
__global__ void __launch_bounds__(32)
k4_prologue_kernel(const T* __restrict__ scal, int scal_stride,
                   T* __restrict__ tab, int* __restrict__ list,
                   int n_steps, int n_members) {
    const int b = blockIdx.x;
    const int lane = threadIdx.x;
    if (b < n_members) {
        const T* sc = scal + static_cast<int64_t>(b) * scal_stride;
        dm::momentum_table(tab + static_cast<int64_t>(b) * (n_steps + 1),
                           sc[dm::kAU], sc[dm::kLWPrev], sc[dm::kLW],
                           n_steps, lane, 32, [] { __syncwarp(); });
        return;
    }
    int n_act = 0;
    for (int m0 = 0; m0 < n_members; m0 += 32) {
        const int m = m0 + lane;
        const bool act =
            m < n_members
            && !(scal[static_cast<int64_t>(m) * scal_stride + dm::kActive]
                 == T(0));
        const unsigned who = __ballot_sync(dm::kFull, act);
        if (act) list[n_act + __popc(who & ((1u << lane) - 1u))] = m;
        n_act += __popc(who);
    }
    if (lane == 0) list[n_members] = n_act;
}

// Second pass, in two kernels: column c = k E + e of the (n_blocks, B E)
// partials (member list[k], entry e) summed in K1's order -- 256 sums, the
// t-th over blocks t, t + 256, ... in block order, then the fixed tree
// buf[t] += buf[t + w] for w = 128, ..., 1 -- into out[list[k] E + e].
// reduce_chains_kernel: thread (t, c) forms the t-th sum of column c and
// writes it over the partial it started from (row t, which no other
// thread reads); a warp takes 32 neighbouring columns of one row, and
// there is a thread for every (t, c), so even a few columns fill the
// card. reduce_tree_kernel: a block stages the 256 sums of kTreeCols
// columns and runs the tree; entry 0 also sets the member's Nesterov
// scalar to its table's last slot and l_w_prev = l_w, as K1's
// reduce_partials_kernel does.
constexpr int kChainCols = 32;     // columns of a chain block (one warp)
constexpr int kChainRows = kRedThreads / kChainCols;

template <typename T>
__global__ void __launch_bounds__(kRedThreads)
reduce_chains_kernel(T* __restrict__ partials, const int* __restrict__ list,
                     int n_blocks, int n_entries, int n_members) {
    const int col = blockIdx.x * kChainCols + threadIdx.x % kChainCols;
    const int t = blockIdx.y * kChainRows + threadIdx.x / kChainCols;
    if (col >= list[n_members] * n_entries || t >= n_blocks) return;
    const int64_t row = static_cast<int64_t>(n_members) * n_entries;
    T acc = T(0);
#pragma unroll 8
    for (int b = t; b < n_blocks; b += kRedThreads)
        acc += partials[b * row + col];
    partials[t * row + col] = acc;
}

template <typename T>
__global__ void __launch_bounds__(kRedThreads)
reduce_tree_kernel(const T* __restrict__ partials, T* __restrict__ out,
                   T* __restrict__ scal, const T* __restrict__ tab,
                   const int* __restrict__ list, int n_blocks, int n_steps,
                   int n_entries, int n_members, int scal_stride) {
    constexpr int kCols = 128 / static_cast<int>(sizeof(T));
    __shared__ T buf[kRedThreads][kCols];
    const int n_cols = list[n_members] * n_entries;
    const int c0 = blockIdx.x * kCols;
    if (c0 >= n_cols) return;                       // uniform per block
    const int tid = threadIdx.x;
    const int64_t row = static_cast<int64_t>(n_members) * n_entries;
    for (int x = tid; x < kRedThreads * kCols; x += kRedThreads) {
        const int t = x / kCols, c = c0 + x % kCols;
        buf[t][x % kCols] = (t < n_blocks && c < n_cols)
                                ? partials[t * row + c] : T(0);
    }
    __syncthreads();
    for (int wd = kRedThreads / 2; wd > 0; wd >>= 1) {
        for (int x = tid; x < wd * kCols; x += kRedThreads)
            buf[x / kCols][x % kCols] += buf[x / kCols + wd][x % kCols];
        __syncthreads();
    }
    const int col = c0 + tid;
    if (tid < kCols && col < n_cols) {
        const int b = list[col / n_entries];
        const int e = col % n_entries;
        out[static_cast<int64_t>(b) * n_entries + e] = buf[0][tid];
        if (e == 0) {
            T* sc = scal + static_cast<int64_t>(b) * scal_stride;
            sc[dm::kAU] = tab[static_cast<int64_t>(b) * (n_steps + 1)
                              + n_steps];
            if (n_steps > 0) sc[dm::kLWPrev] = sc[dm::kLW];
        }
    }
}

template <typename T, typename TD, int NU, bool W, int LAYOUT>
int launch(const void* ydt, const void* rtt, const void* a1b,
           int64_t a1_stride, const void* a2b, int64_t a2_stride, void* uut,
           const void* w, int64_t w_stride, void* scal, int scal_stride,
           void* tab, void* list, void* partials, void* out, void* state,
           int64_t n, int n_s, int n_ct, int n_u, int n_steps, int n_members,
           int lagged, cudaStream_t stream) {
    if (LAYOUT == dm::kGlobalState && state == nullptr)
        return static_cast<int>(cudaErrorInvalidValue);
    const int n_blocks = static_cast<int>((n + kSites - 1) / kSites);
    k4_prologue_kernel<T><<<n_members + 1, 32, 0, stream>>>(
        static_cast<const T*>(scal), scal_stride, static_cast<T*>(tab),
        static_cast<int*>(list), n_steps, n_members);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const int n_entries = dm::gram_entries(n_s, n_ct, n_u);
    const dm::K4MemberPlan plan = dm::k4_member_plan(
        sizeof(T), n_s, n_ct, n_u, n_members, W, LAYOUT);
    auto kern = u_phase_grams_multi_kernel<T, TD, NU, W, LAYOUT>;
    if (plan.smem > 48 * 1024) {
        err = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(plan.smem));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    kern<<<n_blocks, kSites, plan.smem, stream>>>(
        static_cast<const TD*>(ydt), static_cast<const TD*>(rtt),
        static_cast<const T*>(a1b), a1_stride, static_cast<const T*>(a2b),
        a2_stride, static_cast<T*>(uut), static_cast<const T*>(w), w_stride,
        static_cast<const T*>(scal), scal_stride, static_cast<const T*>(tab),
        static_cast<const int*>(list), static_cast<T*>(partials),
        static_cast<T*>(state), n, n_s, n_ct, n_u, n_steps, n_members,
        plan.group, lagged);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const int n_cols = n_members * n_entries;
    const int n_rows = n_blocks < kRedThreads ? n_blocks : kRedThreads;
    const dim3 chains((n_cols + kChainCols - 1) / kChainCols,
                      (n_rows + kChainRows - 1) / kChainRows);
    reduce_chains_kernel<T><<<chains, kRedThreads, 0, stream>>>(
        static_cast<T*>(partials), static_cast<const int*>(list), n_blocks,
        n_entries, n_members);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    constexpr int kCols = 128 / static_cast<int>(sizeof(T));
    reduce_tree_kernel<T><<<(n_cols + kCols - 1) / kCols, kRedThreads, 0,
                            stream>>>(
        static_cast<const T*>(partials), static_cast<T*>(out),
        static_cast<T*>(scal), static_cast<const T*>(tab),
        static_cast<const int*>(list), n_blocks, n_steps, n_entries,
        n_members, scal_stride);
    return static_cast<int>(cudaGetLastError());
}

template <typename T, typename TD, bool W, int LAYOUT>
int dispatch_nu(const void* ydt, const void* rtt, const void* a1b,
                long long a1_stride, const void* a2b, long long a2_stride,
                void* uut, const void* w, long long w_stride, void* scal,
                int scal_stride, void* tab, void* list, void* partials,
                void* out, void* state, long long n, int n_s, int n_ct,
                int n_u, int n_steps, int n_members, int lagged,
                cudaStream_t st) {
#define DM_K4_CASE(NU)                                                      \
    case NU:                                                                \
        return launch<T, TD, NU, W, LAYOUT>(                                \
            ydt, rtt, a1b, a1_stride, a2b, a2_stride, uut, w, w_stride,     \
            scal, scal_stride, tab, list, partials, out, state, n, n_s,     \
            n_ct, n_u, n_steps, n_members, lagged, st);
    switch (n_u) {
        DM_K4_CASE(1) DM_K4_CASE(2) DM_K4_CASE(3) DM_K4_CASE(4)
        DM_K4_CASE(5) DM_K4_CASE(6) DM_K4_CASE(7) DM_K4_CASE(8)
        default:
            // n_u > 8: the state region in shared memory, or (global
            // layout, past the card's shared memory) in device memory
            if (n_u < 1) return static_cast<int>(cudaErrorInvalidValue);
            if constexpr (LAYOUT == dm::kGlobal) {
                if (dm::state_in_device(sizeof(T), n_s, n_u, false))
                    return launch<T, TD, 0, W, dm::kGlobalState>(
                        ydt, rtt, a1b, a1_stride, a2b, a2_stride, uut, w,
                        w_stride, scal, scal_stride, tab, list, partials,
                        out, state, n, n_s, n_ct, n_u, n_steps, n_members,
                        lagged, st);
            }
            return launch<T, TD, 0, W, LAYOUT>(
                ydt, rtt, a1b, a1_stride, a2b, a2_stride, uut, w, w_stride,
                scal, scal_stride, tab, list, partials, out, state, n, n_s,
                n_ct, n_u, n_steps, n_members, lagged, st);
    }
#undef DM_K4_CASE
}

template <typename T, typename TD, int LAYOUT>
int dispatch(const void* ydt, const void* rtt, const void* a1b,
             long long a1_stride, const void* a2b, long long a2_stride,
             void* uut, const void* w, long long w_stride, void* scal,
             int scal_stride, void* tab, void* list, void* partials,
             void* out, void* state, long long n, int n_s, int n_ct, int n_u,
             int n_steps, int n_members, int lagged, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (n_members < 1) return static_cast<int>(cudaErrorInvalidValue);
    if (w != nullptr)
        return dispatch_nu<T, TD, true, LAYOUT>(
            ydt, rtt, a1b, a1_stride, a2b, a2_stride, uut, w, w_stride, scal,
            scal_stride, tab, list, partials, out, state, n, n_s, n_ct, n_u,
            n_steps, n_members, lagged, st);
    return dispatch_nu<T, TD, false, LAYOUT>(
        ydt, rtt, a1b, a1_stride, a2b, a2_stride, uut, w, w_stride, scal,
        scal_stride, tab, list, partials, out, state, n, n_s, n_ct, n_u,
        n_steps, n_members, lagged, st);
}

}  // namespace

// The C entry points of one layout (PREFIX dm_u_phase_grams_multi,
// dm_u_phase_grams_multi_wide or dm_u_phase_grams_multi_global):
//   PREFIX_smem(itemsize, n_s, n_ct, n_u, weighted): one member's shared
//     memory in bytes (what the layout rule compares; a launch takes
//     k4_member_plan's group bytes);
//   PREFIX_{f32,f64,bf16}(ydt, rtt, a1b, a1_stride, a2b, a2_stride, uut,
//     w, w_stride, scal, scal_stride, tab, list, partials, out, state, n,
//     n_s, n_ct, n_u, n_steps, n_members, lagged, stream): w the members'
//     weight rows (B, w_stride) or NULL (unweighted); list room for B + 1
//     ints; state the n_u > 8 form's state regions where they live in
//     device memory (the global layout where dm_state_in_device says so;
//     NULL otherwise), n_blocks x dm_state_rows(n_s, n_u, 0) x 129 values;
//     bf16: bf16 data with a float32 state and float32 weight rows.
#define DM_K4_ENTRY(PREFIX, SUFFIX, T, TD, LAYOUT)                           \
    int PREFIX##SUFFIX(const void* ydt, const void* rtt, const void* a1b,    \
                       long long a1_stride, const void* a2b,                 \
                       long long a2_stride, void* uut, const void* w,        \
                       long long w_stride, void* scal, int scal_stride,      \
                       void* tab, void* list, void* partials, void* out,     \
                       void* state, long long n, int n_s, int n_ct, int n_u, \
                       int n_steps, int n_members, int lagged,               \
                       void* stream) {                                       \
        return dispatch<T, TD, LAYOUT>(ydt, rtt, a1b, a1_stride, a2b,        \
                                       a2_stride, uut, w, w_stride, scal,    \
                                       scal_stride, tab, list, partials,     \
                                       out, state, n, n_s, n_ct, n_u,        \
                                       n_steps, n_members, lagged, stream);  \
    }
#define DM_K4_SMEM_EXPORT(PREFIX, LAYOUT)                                    \
    extern "C" long long PREFIX##_smem(int itemsize, int n_s, int n_ct,      \
                                       int n_u, int weighted) {              \
        return dm::k4_smem(LAYOUT, itemsize, n_s, n_ct, n_u, weighted != 0,  \
                           1);                                               \
    }
// all of one layout's entry points in one source
#define DM_K4_EXPORTS(PREFIX, LAYOUT)                                        \
    DM_K4_SMEM_EXPORT(PREFIX, LAYOUT)                                        \
    extern "C" {                                                             \
    DM_K4_ENTRY(PREFIX, _f32, float, float, LAYOUT)                          \
    DM_K4_ENTRY(PREFIX, _f64, double, double, LAYOUT)                        \
    DM_K4_ENTRY(PREFIX, _bf16, float, __nv_bfloat16, LAYOUT)                 \
    }
