// Pieces shared by the U-phase megakernels: K1 (u_phase_grams.cuh, one
// member) and K4 (u_phase_grams_multi.cuh, B restart members on the same
// Y, D, Rt). One thread per CpG site, kSites sites per block. The
// per-site arithmetic and the per-block and cross-block summation orders
// live here once, so K4's members follow K1's arithmetic bit for bit, and
// each kernel's two shared-memory layouts follow each other bit for bit:
//
//   - resident (the narrow shapes): the block's site columns of Y, D and
//     [Rt | u] and the whole alpha block are staged in shared memory
//     (row stride kLd against bank conflicts) and reused for the Gram
//     sums, so Y, D and Rt are read from device memory once;
//   - wide (where the resident layout would pass the card's shared
//     memory, or fit less than half as many blocks on an SM): only
//     [Rt | u] stays resident. Each thread reads its own site's Y and D
//     rows from device memory (neighbouring threads on neighbouring
//     addresses) and the alpha entries (the same address in every
//     thread, a broadcast), and the Gram stage stages Y and D kChunk
//     samples at a time. Shared memory grows with n_s only up to one
//     chunk; Y and D are read twice. The C/M sums keep their per-sample
//     order and every Gram entry its per-site order, so at a shape that
//     both layouts take they give the same bits;
//   - global (where even the wide layout would pass the card's shared
//     memory: p of about 160 in float64 at n_s >= 32, 386 in float32):
//     nothing of Rt is staged before the steps. The C/M build and the
//     direct form's known residual read this site's Rt column where it
//     lies in device memory (DevRows: a warp reads one row of
//     neighbouring addresses), kKnownGroup samples' known sums a pass so
//     each value is read once a group, each sum still over c in order
//     from 0. The Gram stage streams Rt through shared memory instead
//     (gram_partials_ring): Y and D a chunk of samples at a time, and
//     for each chunk the rows of Rt q at a time into a ring of two
//     slots by cp.async, the next slot loading while the current one is
//     summed; the entries whose right row is a u row are summed from the
//     u rows, which live in the top rows of shared memory. Every entry
//     is one thread's sum over the block's sites in site order from 0,
//     as in the other layouts, so the same bits (global_plan sizes the
//     chunk, the ring and the rows). The register forms (n_u <= 8), whose
//     steps leave shared memory free, form their known sums first in
//     shared rows with a1 staged beside them (known_rows), so that a1 is
//     not read from device memory once a term.
//
// What the pieces here do about what bounds the kernels (each keeps
// every rounding, so the kernels' outputs do not depend on them):
//
//   - the momentum scalars of the n_steps FISTA steps are the same in
//     every thread (a nesterov step, two IEEE divisions and two square
//     roots a step, most of a step's instructions at n_u = 1), so they
//     are computed once per launch: a prologue (momentum_table_kernel;
//     K4's k4_prologue_kernel also lists its active members; one warp
//     per member, launched just before the main pass into a
//     buffer the wrapper allocates; no shared memory, so the layout rule
//     does not move) writes the table of the steps' betas with the same
//     arithmetic on the same inputs, and every thread reads beta_k from
//     it one step ahead. The reduction pass takes the advanced Nesterov
//     scalar from the table's last slot;
//   - K1's Gram stage (gram_partials; K4 sums a member group's entries
//     in its own, u_phase_grams_multi.cuh) at wide shapes would read three
//     shared values per product with one thread per entry (~139k
//     warp-level loads per block at 1M x 100, 25 + 4). Above kSites
//     entries per block it deals register micro-tiles of RS samples x RV
//     unknowns x kTileQ rows of [Rt | u] (gram_plan): the left factor
//     d_s u_v is formed once per site and reused across the tile's rows,
//     about half a shared load per product, and each entry is still
//     summed over the block's sites in site order from 0. At or below
//     kSites entries (the main shape's 71) every thread keeps one entry:
//     tiles there were measured slower (a tile's 16 products a site are
//     one thread's serial work while most threads wait);
//   - staging copies the block's site columns with cp.async (TD = T), so
//     all a thread's rows are in flight at once and nothing passes
//     through registers (measured ~11% off K1 at the main and the cohort
//     shape); bf16 data is converted as it is staged, through registers.
//
// Tensor cores are not used for the Gram stage: plain TF32 keeps 10
// mantissa bits, which the float32 Gram tolerance (5e-5 of the largest
// entry) rules out, and 3xTF32 or DMMA in float64 would sum each entry in
// another order, so the kernels' outputs would no longer equal those of
// the CUDA-core stage bit for bit (the check that holds them today).
//
// State: n_u = 1..8 is a template parameter and the per-site state (u,
// u_prev, C, the n_u(n_u+1)/2 curvature terms, the step temporaries)
// lives in registers (RegVec). Above 8 one form with NU = 0 takes n_u at
// run time and keeps that state on the chip, in a per-thread column of a
// state region in shared memory (state_rows; "the n_u > 8 form" below).
// K7 (u_phase.cu) runs the same form on a region in device memory.
//
// Data and state types: the data rows (Y, D, Rt) are of type TD, the
// state and every sum of type T. TD = T is the float32 and float64 forms;
// TD = __nv_bfloat16 with T = float is bf16 storage: each value is
// converted once as it is staged or read (bf16 -> float32 is exact), the
// staged rows are T in shared memory, and from there on the arithmetic
// is the float32 form's, instruction for instruction.
//
// RND, K1's bf16_compute forms (T = float): kRoundAll (gram form) rounds
// with __float2bfloat16_rn at the points where the JAX kernel's
// bf16_compute branch forms bf16 products (pallas_kernels.py:263-334,
// 464-479): d y, d rt, the alpha operands a2, a2 a1 and a2 a2 of the C
// and M sums, and u and d u in the Gram sums. kRoundDy (direct form)
// rounds d y alone, in the residual and in b_u: the JAX kernel's direct
// dataflow upcasts everything else (pallas_kernels.py:299-311). Every
// sum stays float32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "small_common.cuh"

namespace dm {

constexpr int kSites = 128;        // sites (threads) per main-pass block
constexpr int kLd = kSites + 1;    // shared row stride: avoids bank conflicts
constexpr int kRedThreads = 256;   // threads per block of the reduction pass
constexpr int kChunk = 32;         // samples per staged chunk (wide layout)

// the shared-memory layouts (the kernels' LAYOUT template parameter);
// kGlobalState is the global layout with the n_u > 8 form's state region
// in device memory too (state_in_device)
constexpr int kResident = 0, kWide = 1, kGlobal = 2, kGlobalState = 3;

constexpr long long kSmemPerSm = 233472;   // bytes of shared memory an SM has
constexpr long long kSmemBlock = 232448;   // bytes a block may opt into
constexpr long long kSmemReserve = 1024;   // bytes the card keeps per block

// rows of Y (and of D) the wide layout stages: one chunk, or all n_s
// samples when there are fewer
__host__ __device__ __forceinline__ constexpr int chunk_rows(int n_s) {
    return n_s < kChunk ? n_s : kChunk;
}

// bf16_compute roundings (RND); kResidFirst is no rounding but K7's
// association of the known-block residual, d (y - a1' rt) where K1 forms
// d y - d (a1' rt) (u_phase.cu)
constexpr int kRoundNone = 0, kRoundAll = 1, kRoundDy = 2, kResidFirst = 3;

// clip to [0, 1]; NaN passes through, as torch.clamp
template <typename T>
__device__ __forceinline__ T clip01(T x) {
    return x < T(0) ? T(0) : (x > T(1) ? T(1) : x);
}

// index of M[v][w] in the packed upper triangle of a symmetric nu x nu
// matrix (constant-folded inside the unrolled loops of the NU forms)
__host__ __device__ __forceinline__ constexpr int sym(int v, int w, int nu) {
    return v <= w ? v * nu - v * (v - 1) / 2 + (w - v)
                  : w * nu - w * (w - 1) / 2 + (v - w);
}

// Gram entries of one member: [gu (n_s, n_u, p) | b_u (n_u, n_s) | usq]
__host__ __device__ __forceinline__ int gram_entries(int n_s, int n_ct,
                                                     int n_u) {
    return n_s * n_u * (n_ct + n_u) + n_u * n_s + 1;
}

// A per-site state vector in registers (indices constant after unrolling)
template <typename T, int N>
struct RegVec {
    T x[N];
    __device__ __forceinline__ T& operator[](int k) { return x[k]; }
    __device__ __forceinline__ const T& operator[](int k) const {
        return x[k];
    }
};

// a data value in the state type (the identity when TD = T)
__device__ __forceinline__ float to_state(float x) { return x; }
__device__ __forceinline__ double to_state(double x) { return x; }
__device__ __forceinline__ float to_state(__nv_bfloat16 x) {
    return __bfloat162float(x);
}

// x rounded to bf16 (to nearest, ties to even) and back: RND's rounding
__device__ __forceinline__ float bf16r(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
}

// Stages rows [r0, r1) of this thread's site column of src (row stride n)
// into dst (row r at dst[(r - r0) * kLd + tid]), converted to T; the
// ragged tail is zero. With TD = T the rows are copied by cp.async (4 or
// 8 bytes each, zero-filled past the last site), all in flight at once;
// stage_wait() must come before the __syncthreads that publishes them.
// bf16 data is converted through registers.
template <typename T, typename TD>
__device__ __forceinline__ void stage_rows(T* __restrict__ dst,
                                           const TD* __restrict__ src,
                                           int r0, int r1, int64_t i,
                                           bool live, int64_t n, int tid) {
    if constexpr (std::is_same<T, TD>::value) {
        const int bytes = live ? static_cast<int>(sizeof(T)) : 0;
        for (int r = r0; r < r1; ++r) {
            const unsigned sa = static_cast<unsigned>(
                __cvta_generic_to_shared(dst + (r - r0) * kLd + tid));
            const T* g = live ? src + r * n + i : src;
            asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                         :: "r"(sa), "l"(g), "n"(sizeof(T)), "r"(bytes)
                         : "memory");
        }
    } else {
        for (int r = r0; r < r1; ++r)
            dst[(r - r0) * kLd + tid] = live ? to_state(src[r * n + i])
                                             : T(0);
    }
}

// This thread's site column of Rt where it lies in device memory (the
// global layout): row c at p[c * n], converted to the state type as it is
// read. rt_at reads row c of either form of an Rt column: a staged column
// in shared memory (stride kLd) or a DevRows.
template <typename TD>
struct DevRows {
    const TD* __restrict__ p;
    int64_t n;
};

template <typename T>
__device__ __forceinline__ T rt_at(const T* __restrict__ rt, int c) {
    return rt[c * kLd];
}

template <typename TD>
__device__ __forceinline__ auto rt_at(DevRows<TD> rt, int c) {
    return to_state(rt.p[c * rt.n]);
}

template <typename RT>
struct IsDevRows : std::false_type {};
template <typename TD>
struct IsDevRows<DevRows<TD>> : std::true_type {};

// This thread's known sums a1' rt, one a sample, already formed in its
// column of shared rows (known_rows): known_s at p[s * kLd]
template <typename T>
struct KnownCol {
    const T* __restrict__ p;
};

template <typename RT>
struct IsKnownCol : std::false_type {};
template <typename T>
struct IsKnownCol<KnownCol<T>> : std::true_type {};

// samples whose known sums a DevRows pass forms together (known_group)
constexpr int kKnownGroup = 8;

// kn[g] = sum_c a1[c, s0 + g] rt_c for g < kKnownGroup, each over c in
// order from 0 (the sum known_resid forms), Rt's value of row c read once
// for the group; samples past n_s repeat the last one (their sums are not
// used)
template <typename T, typename RT>
__device__ __forceinline__ void known_group(T (&kn)[kKnownGroup], RT rt,
                                            const T* __restrict__ a1,
                                            int s0, int n_s, int n_ct) {
    int sg[kKnownGroup];
#pragma unroll
    for (int g = 0; g < kKnownGroup; ++g) {
        kn[g] = T(0);
        sg[g] = s0 + g < n_s ? s0 + g : n_s - 1;
    }
#pragma unroll 4
    for (int c = 0; c < n_ct; ++c) {
        const T r = rt_at(rt, c);
        const T* a1c = a1 + c * n_s;
#pragma unroll
        for (int g = 0; g < kKnownGroup; ++g) kn[g] += a1c[sg[g]] * r;
    }
}

// known_s = sum_c a1[c, s] rt_c for every sample s of this thread's site,
// into kn[s * kLd] (its column of n_s shared rows), each sum over c in
// order from 0 (known_resid's): Rt's rows read where they lie (rt), a1
// staged by the whole block kc rows at a time into a1s, so that its values
// are read from shared memory, each sum carried in its row from one chunk
// to the next (a running sum, never a chunk's partial sum added later),
// kKnownGroup samples a pass. Every thread of the block calls it (the
// chunks are staged between barriers); a dead thread (live false) sums
// nothing.
template <typename T, typename TD>
__device__ __forceinline__ void known_rows(T* __restrict__ kn,
                                           T* __restrict__ a1s,
                                           const T* __restrict__ a1,
                                           DevRows<TD> rt, bool live,
                                           int n_s, int n_ct, int kc,
                                           int tid) {
    for (int c0 = 0; c0 < n_ct; c0 += kc) {
        const int c1 = c0 + kc < n_ct ? c0 + kc : n_ct;
        __syncthreads();               // the last chunk's sums done
        for (int k = tid; k < (c1 - c0) * n_s; k += kSites)
            a1s[k] = a1[c0 * n_s + k];
        __syncthreads();
        if (!live) continue;
        for (int s0 = 0; s0 < n_s; s0 += kKnownGroup) {
            T acc[kKnownGroup];
            int sg[kKnownGroup];
#pragma unroll
            for (int g = 0; g < kKnownGroup; ++g) {
                sg[g] = s0 + g < n_s ? s0 + g : n_s - 1;
                acc[g] = c0 == 0 ? T(0) : kn[sg[g] * kLd];
            }
#pragma unroll 4
            for (int c = c0; c < c1; ++c) {
                const T r = rt_at(rt, c);
                const T* ac = a1s + (c - c0) * n_s;
#pragma unroll
                for (int g = 0; g < kKnownGroup; ++g) acc[g] += ac[sg[g]] * r;
            }
#pragma unroll
            for (int g = 0; g < kKnownGroup; ++g)
                if (s0 + g < n_s) kn[(s0 + g) * kLd] = acc[g];
        }
    }
}

// Commits this thread's cp.async copies issued since the last commit as
// one group
__device__ __forceinline__ void stage_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most `pending` (0 or 1) of this thread's committed groups
// are still in flight
__device__ __forceinline__ void stage_wait_pending(int pending) {
    if (pending > 0)
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    else
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Waits for this thread's cp.async copies (a no-op when there are none)
__device__ __forceinline__ void stage_wait() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The known-block residual of sample s at this thread's site, given its
// y and d and its known sum a1' rt: d y - d known  (just d y when n_ct =
// 0). kRoundDy rounds d y to bf16; kResidFirst forms d (y - known), as
// the JAX package's single-phase U kernel does (d y when n_ct = 0,
// exactly).
template <int RND, typename T>
__device__ __forceinline__ T resid_of(T y, T d, T known) {
    if constexpr (RND == kRoundDy) return bf16r(d * y) - d * known;
    if constexpr (RND == kResidFirst) return d * (y - known);
    return d * y - d * known;
}

// The known-block residual of sample s at this thread's site (resid_of),
// with the known sum over c in order; rt is this site's Rt column (rt_at),
// a1 the (n_ct, n_s) block.
template <int RND, typename T, typename RT>
__device__ __forceinline__ T known_resid_at(T y, T d, RT rt,
                                            const T* __restrict__ a1, int s,
                                            int n_s, int n_ct) {
    T known = T(0);
    for (int c = 0; c < n_ct; ++c) known += a1[c * n_s + s] * rt_at(rt, c);
    return resid_of<RND>(y, d, known);
}

// known_resid_at on a staged Rt column. The staged layouts and K7 call
// this form, the global layout *_at's forms with a DevRows or KnownCol: a
// template parameter would drop the __restrict__ the staged column has
// always had, so these forms keep the staged layouts' signatures as they
// were. build_cm, build_cm_rows, site_phase, site_phase_rows and K4's
// build_cm_pair are split the same way.
template <int RND, typename T>
__device__ __forceinline__ T known_resid(T y, T d, const T* __restrict__ rt,
                                         const T* __restrict__ a1, int s,
                                         int n_s, int n_ct) {
    return known_resid_at<RND>(y, d, rt, a1, s, n_s, n_ct);
}

// res[s * kLd] = known_resid<RND>(y_s, d_s, rt, a1, s) for every sample
// (the direct form's residual rows): a sample at a time from a staged Rt
// column, kKnownGroup samples a pass from a DevRows
template <int RND, typename T, typename TY, typename RT>
__device__ __forceinline__ void resid_rows(T* __restrict__ res,
                                           const TY* __restrict__ y,
                                           const TY* __restrict__ d,
                                           int64_t ld, RT rt,
                                           const T* __restrict__ a1, int n_s,
                                           int n_ct) {
    if constexpr (IsKnownCol<RT>::value) {
        // the known sums' rows may be res itself: each read before its
        // sample's residual is written over it
        for (int s = 0; s < n_s; ++s)
            res[s * kLd] = resid_of<RND>(to_state(y[s * ld]),
                                         to_state(d[s * ld]),
                                         rt.p[s * kLd]);
    } else if constexpr (IsDevRows<RT>::value) {
        for (int s0 = 0; s0 < n_s; s0 += kKnownGroup) {
            T kn[kKnownGroup];
            known_group(kn, rt, a1, s0, n_s, n_ct);
#pragma unroll
            for (int g = 0; g < kKnownGroup; ++g) {
                const int s = s0 + g;
                if (s < n_s)
                    res[s * kLd] = resid_of<RND>(to_state(y[s * ld]),
                                                 to_state(d[s * ld]), kn[g]);
            }
        }
    } else {
        for (int s = 0; s < n_s; ++s)
            res[s * kLd] = known_resid<RND>(to_state(y[s * ld]),
                                            to_state(d[s * ld]), rt, a1, s,
                                            n_s, n_ct);
    }
}

// Sample s's terms of C and M at this thread's site, given its d and its
// known-block residual: C[v] += a2[v,s] dres, M[v][w] += (a2[v,s] a2[w,s]) d
// (a function, not a lambda, so that no staged build captures its sums)
template <typename T, class VC, class VM>
__device__ __forceinline__ void add_cm(VC& cc, VM& m,
                                       const T* __restrict__ a2, int s,
                                       int n_s, int nu, T dv, T dres) {
#pragma unroll
    for (int v = 0; v < nu; ++v) {
        const T av = a2[v * n_s + s];
        cc[v] += av * dres;
#pragma unroll
        for (int w = v; w < nu; ++w)
            m[sym(v, w, nu)] += (av * a2[w * n_s + s]) * dv;
    }
}

// C[u] = sum_s a2[u,s] dres_s and the upper triangle of
// M[u][v] = sum_s (a2[u,s] a2[v,s]) d_s at this thread's site. y, d are
// this site's sample rows (row stride ld: the staged rows or the data
// itself), rt its Rt column (rt_at: staged, or a DevRows), a1, a2 the
// alpha blocks (row stride n_s). kRoundAll builds C as the JAX kernel's
// bf16 branch does, c1 - c2 with c1[u] = sum_s bf16(a2[u,s]) bf16(d_s y_s)
// and c2[u] = sum_{s,c} bf16(a2[u,s] a1[c,s]) bf16(d_s rt_c) (c2: a
// temporary), and M from bf16(a2[u,s] a2[v,s]). From a DevRows the known
// sums come kKnownGroup samples a pass (known_group), and kRoundAll takes
// the rows of Rt in its outer loop within a sample (each c2[u] still sums
// its (s, c) terms in the same order), so Rt's values are read from device
// memory once a group or once a sample, not once a term.
template <typename T, int NU, int RND, typename TY, class VC, class VM,
          typename RT>
__device__ __forceinline__ void build_cm_at(
        VC& cc, VM& m, VC& c2, int n_u, const TY* __restrict__ y,
        const TY* __restrict__ d, int64_t ld, RT rt,
        const T* __restrict__ a1, const T* __restrict__ a2, int n_s,
        int n_ct) {
    constexpr bool DEV = IsDevRows<RT>::value;
    const int nu = NU > 0 ? NU : n_u;
#pragma unroll
    for (int v = 0; v < nu; ++v) cc[v] = T(0);
#pragma unroll
    for (int k = 0; k < nu * (nu + 1) / 2; ++k) m[k] = T(0);
    if constexpr (RND == kRoundAll) {
#pragma unroll
        for (int v = 0; v < nu; ++v) c2[v] = T(0);
        for (int s = 0; s < n_s; ++s) {
            const T dv = to_state(d[s * ld]);
            const T dy = bf16r(dv * to_state(y[s * ld]));
#pragma unroll
            for (int v = 0; v < nu; ++v) {
                const T av = a2[v * n_s + s];
                cc[v] += bf16r(av) * dy;
                if constexpr (!DEV) {
                    for (int c = 0; c < n_ct; ++c)
                        c2[v] += bf16r(av * a1[c * n_s + s])
                                 * bf16r(dv * rt_at(rt, c));
                }
#pragma unroll
                for (int w = v; w < nu; ++w)
                    m[sym(v, w, nu)] += bf16r(av * a2[w * n_s + s]) * dv;
            }
            if constexpr (DEV) {
                for (int c = 0; c < n_ct; ++c) {
                    const T dr = bf16r(dv * rt_at(rt, c));
                    const T a1c = a1[c * n_s + s];
#pragma unroll
                    for (int v = 0; v < nu; ++v)
                        c2[v] += bf16r(a2[v * n_s + s] * a1c) * dr;
                }
            }
        }
#pragma unroll
        for (int v = 0; v < nu; ++v) cc[v] -= c2[v];
        return;
    }
    constexpr int RK = RND == kResidFirst ? kResidFirst : kRoundNone;
    if constexpr (IsKnownCol<RT>::value) {
        for (int s = 0; s < n_s; ++s) {
            const T dv = to_state(d[s * ld]);
            add_cm(cc, m, a2, s, n_s, nu, dv,
                   resid_of<RK>(to_state(y[s * ld]), dv, rt.p[s * kLd]));
        }
    } else if constexpr (DEV) {
        for (int s0 = 0; s0 < n_s; s0 += kKnownGroup) {
            T kn[kKnownGroup];
            known_group(kn, rt, a1, s0, n_s, n_ct);
#pragma unroll
            for (int g = 0; g < kKnownGroup; ++g) {
                const int s = s0 + g;
                if (s >= n_s) break;
                const T dv = to_state(d[s * ld]);
                add_cm(cc, m, a2, s, n_s, nu, dv,
                       resid_of<RK>(to_state(y[s * ld]), dv, kn[g]));
            }
        }
    } else {
        // (add_cm's sums written out, as are bu_sum's and usq_sum's in
        // gram_entry: with the shared bodies the cohort's K1, wide layout,
        // 1M x 100, 25 + 4, float32, took 4% longer on an H100; PERF.md
        // section 6)
        for (int s = 0; s < n_s; ++s) {
            const T yv = to_state(y[s * ld]);
            const T dv = to_state(d[s * ld]);
            const T dres = known_resid<RK>(yv, dv, rt, a1, s, n_s, n_ct);
#pragma unroll
            for (int v = 0; v < nu; ++v) {
                const T av = a2[v * n_s + s];
                cc[v] += av * dres;
#pragma unroll
                for (int w = v; w < nu; ++w)
                    m[sym(v, w, nu)] += (av * a2[w * n_s + s]) * dv;
            }
        }
    }
}

// build_cm_at on a staged Rt column (known_resid's note)
template <typename T, int NU, int RND, typename TY, class VC, class VM>
__device__ __forceinline__ void build_cm(
        VC& cc, VM& m, VC& c2, int n_u, const TY* __restrict__ y,
        const TY* __restrict__ d, int64_t ld, const T* __restrict__ rt,
        const T* __restrict__ a1, const T* __restrict__ a2, int n_s,
        int n_ct) {
    build_cm_at<T, NU, RND>(cc, m, c2, n_u, y, d, ld, rt, a1, a2, n_s, n_ct);
}

// The n_steps FISTA loop of the gram form; LAG takes each step's gradient
// at the old u (an instantiation each, so the step loop carries no
// per-step test). beta is the launch's momentum table (n_steps + 1
// values, momentum_table_kernel), read one step ahead; ut, un are step
// temporaries.
template <typename T, int NU, bool LAG, class VU, class VC, class VM>
__device__ __forceinline__ void gram_steps(
        VU& u, VU& up, const VC& cc, const VM& m, VC& ut, VC& un, int n_u,
        const T* __restrict__ beta_tab, const T l_w, int n_steps) {
    const int nu = NU > 0 ? NU : n_u;
    T beta_next = beta_tab[0];
    for (int step = 0; step < n_steps; ++step) {
        const T beta = beta_next;
        beta_next = beta_tab[step + 1];
#pragma unroll
        for (int v = 0; v < nu; ++v) ut[v] = u[v] + beta * (u[v] - up[v]);
#pragma unroll
        for (int v = 0; v < nu; ++v) {
            T mu = T(0);
#pragma unroll
            for (int w = 0; w < nu; ++w)
                mu += m[sym(v, w, nu)] * (LAG ? u[w] : ut[w]);
            un[v] = clip01(ut[v] + (cc[v] - mu) / l_w);
        }
#pragma unroll
        for (int v = 0; v < nu; ++v) {
            up[v] = u[v];
            u[v] = un[v];
        }
    }
}

// ---- the n_u > 8 form: the per-site state on the chip --------------------
//
// Above kRegNU unknowns the state of a site's FISTA loop (u, u_prev, the
// step vectors, C and the n_u (n_u + 1) / 2 curvature terms of the gram
// form) no longer fits a thread's registers as a template-sized vector:
// at n_u = 17 the gram form holds 221 values a site, at n_u = 25 the
// direct form's registers alone would pass 255 in float64. What bounds the
// form is where that state lives. Kept in a scratch column per site in
// device memory, every product of a step was a load, and the direct form's
// gradient a read-modify-write a (v, s) pair (about 4 KB a step and site
// at n_u = 25, n_s = 10; in flight more than the 50 MB L2), and the gram
// form's C/M build 2 n_s n_u (n_u + 1) / 2 such accesses before any step.
//
// What this form does about it, keeping every sum's order (so its bits are
// those of the scratch-column form and of the twin's arithmetic):
//   - the state lives in a STATE REGION of shared memory, one column per
//     thread (row stride kLd: a warp reads one row of neighbouring words,
//     free of bank conflicts), state_rows rows: in the gram form M (packed
//     upper triangle), C and three u vectors (u, u_prev / u_t, u_new,
//     rotated by index, so no step copies a vector); in the direct form
//     two u vectors (u, u_prev / u_t / u_new), the residual rows of a chunk
//     of samples and, past one chunk, the gradient rows. In the wide and
//     global layouts the region overlays the Gram stage's chunk rows of Y
//     and D, which are dead until the steps end;
//   - the products run in REGISTER TILES of kTile entries: C and M are
//     built entry tile by entry tile, each entry summed over the samples
//     in order from 0 in a register and written once a chunk of samples
//     (kChunk-free: a chunk is n_u samples, staged in two of the u
//     vectors' rows, which the build does not use yet); a step's M g and
//     the direct form's model and gradient keep kTile sums in registers,
//     each over its index in order. The direct form forms each sample's
//     residual first (a tile of samples at a time) and then sums each
//     gradient entry over the samples in a register, so a step writes no
//     partial gradient;
//   - where the region does not fit beside the layout's rows in any
//     layout (the gram form past n_u = 17 in float64, 25 in float32; the
//     direct form far past any sweep), it moves to a per-block region of
//     a device buffer the wrapper allocates (kGlobalState, the global
//     layout's one instantiation with it), the same code on other
//     addresses.
// What bounds it now (an H100, PERF.md): at the sweep's rank 25 (1M x 10,
// 5 + 25, float32) the steps are latency-bound, not bound by their shared
// loads (four-value alpha loads cut those by about 45% and a step's time
// by about 9%), and the staging and the Gram stage run at 3 blocks an SM
// under the region (7 before); in the gram form at n_s = 100 the C/M
// build and the Gram stage at one block an SM are most of a launch.
constexpr int kRegNU = 8;     // n_u above this runs the NU = 0 form
constexpr int kTile = 4;      // entries per register tile

// samples per chunk of the direct form's residual rows
__host__ __device__ __forceinline__ constexpr int direct_chunk(int n_s) {
    return n_s < kChunk ? n_s : kChunk;
}

// n rounded up to a multiple of 4: the row stride of the resident direct
// form's alpha table (its rows start on 16 bytes)
__host__ __device__ __forceinline__ constexpr int pad4(int n) {
    return (n + 3) / 4 * 4;
}

// x = p[0..4) in 16-byte shared-memory loads (p 16-byte aligned): one for
// float, two for double; a warp reading one address gets it broadcast
__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    x[0] = q.x;
    x[1] = q.y;
    x[2] = q.z;
    x[3] = q.w;
}

__device__ __forceinline__ void load4(const double* p, double (&x)[4]) {
    const double2 q0 = *reinterpret_cast<const double2*>(p);
    const double2 q1 = *reinterpret_cast<const double2*>(p + 2);
    x[0] = q0.x;
    x[1] = q0.y;
    x[2] = q1.x;
    x[3] = q1.y;
}

// rows (kLd values each) of the n_u > 8 form's state region, 0 below:
// gram [u vectors (3 n_u) | C (n_u) | M (n_u (n_u + 1) / 2)], direct
// [u vectors (2 n_u) | residuals (direct_chunk) | gradient (n_u, past one
// chunk)]
__host__ __device__ __forceinline__ int state_rows(int n_s, int n_u,
                                                   bool direct) {
    if (n_u <= kRegNU) return 0;
    if (direct) {
        const int ch = direct_chunk(n_s);
        return 2 * n_u + ch + (n_s > ch ? n_u : 0);
    }
    return 4 * n_u + n_u * (n_u + 1) / 2;
}

// rows that lead a block's shared memory in the wide and global layouts:
// the Gram stage's chunk of Y and D, overlaid by the state region
__host__ __device__ __forceinline__ int lead_rows(int n_s, int n_u,
                                                  bool direct) {
    const int ch2 = 2 * chunk_rows(n_s);
    const int st = state_rows(n_s, n_u, direct);
    return st > ch2 ? st : ch2;
}

// true where the state region does not fit one block's shared memory even
// in the global layout (which holds nothing else): it then lives in device
// memory (kGlobalState)
__host__ __device__ __forceinline__ bool state_in_device(long long itemsize,
                                                         int n_s, int n_u,
                                                         bool direct) {
    return itemsize * lead_rows(n_s, n_u, direct) * kLd > kSmemBlock;
}

// C and M of the gram form into the state rows (st: this thread's column
// of the region, rows as state_rows), build_cm's sums in build_cm's
// orders: chunk by chunk of n_u samples, each chunk's d_s and known
// residual (kRoundAll: d_s y_s rounded) staged in the rows of u vectors 1
// and 2, then C in tiles of kTile unknowns and M in tiles of kTile
// entries of one row, each entry carried in a register over the chunk's
// samples from its value after the last chunk. kRoundAll's c2 sums (the
// rt part of C) use u vector 0's rows; C -= c2 at the end. kResidFirst
// (K7) forms the known residual as K7's build_cm does. From a DevRows
// (the global layout) the known sums come kKnownGroup samples a pass and
// kRoundAll's c2 terms take the rows of Rt in the outer loop within a
// sample, as build_cm's.
template <typename T, int RND, typename TY, typename RT>
__device__ __forceinline__ void build_cm_rows_at(
        T* __restrict__ st, int nu, const TY* __restrict__ y,
        const TY* __restrict__ d, int64_t ld, RT rt,
        const T* __restrict__ a1, const T* __restrict__ a2, int n_s,
        int n_ct) {
    constexpr bool DEV = IsDevRows<RT>::value;
    constexpr int RK = RND == kResidFirst ? kResidFirst : kRoundNone;
    T* c2 = st;
    T* dq = st + nu * kLd;          // d_s of the chunk's samples
    T* qq = dq + nu * kLd;          // their residual (or bf16(d_s y_s))
    T* cc = qq + nu * kLd;
    T* m = cc + nu * kLd;
    for (int c0 = 0; c0 < n_s; c0 += nu) {
        const int n_c = n_s - c0 < nu ? n_s - c0 : nu;
        const bool first = c0 == 0;
        if constexpr (DEV && RND != kRoundAll) {
            for (int s0 = 0; s0 < n_c; s0 += kKnownGroup) {
                T kn[kKnownGroup];
                known_group(kn, rt, a1, c0 + s0, n_s, n_ct);
#pragma unroll
                for (int g = 0; g < kKnownGroup; ++g) {
                    const int s = s0 + g;
                    if (s >= n_c) break;
                    const T dv = to_state(d[(c0 + s) * ld]);
                    dq[s * kLd] = dv;
                    qq[s * kLd] = resid_of<RK>(to_state(y[(c0 + s) * ld]),
                                               dv, kn[g]);
                }
            }
        } else {
            for (int s = 0; s < n_c; ++s) {
                const T dv = to_state(d[(c0 + s) * ld]);
                const T yv = to_state(y[(c0 + s) * ld]);
                dq[s * kLd] = dv;
                if constexpr (RND == kRoundAll)
                    qq[s * kLd] = bf16r(dv * yv);
                else
                    qq[s * kLd] = known_resid<RK>(yv, dv, rt, a1, c0 + s,
                                                  n_s, n_ct);
            }
        }
        const T* a2c = a2 + c0;
        const T* a1c = a1 + c0;
        for (int v0 = 0; v0 < nu; v0 += kTile) {
            int vj[kTile];
            T acc[kTile], acc2[kTile];
#pragma unroll
            for (int j = 0; j < kTile; ++j) {
                vj[j] = v0 + j < nu ? v0 + j : nu - 1;
                acc[j] = first ? T(0) : cc[vj[j] * kLd];
                acc2[j] = (RND == kRoundAll && !first) ? c2[vj[j] * kLd]
                                                       : T(0);
            }
            for (int s = 0; s < n_c; ++s) {
                const T q = qq[s * kLd];
#pragma unroll
                for (int j = 0; j < kTile; ++j) {
                    const T av = a2c[vj[j] * n_s + s];
                    if constexpr (RND == kRoundAll) {
                        acc[j] += bf16r(av) * q;
                        if constexpr (!DEV) {
                            const T dv = dq[s * kLd];
                            for (int c = 0; c < n_ct; ++c)
                                acc2[j] += bf16r(av * a1c[c * n_s + s])
                                           * bf16r(dv * rt_at(rt, c));
                        }
                    } else {
                        acc[j] += av * q;
                    }
                }
                if constexpr (RND == kRoundAll && DEV) {
                    const T dv = dq[s * kLd];
                    for (int c = 0; c < n_ct; ++c) {
                        const T dr = bf16r(dv * rt_at(rt, c));
                        const T a1s = a1c[c * n_s + s];
#pragma unroll
                        for (int j = 0; j < kTile; ++j)
                            acc2[j] += bf16r(a2c[vj[j] * n_s + s] * a1s) * dr;
                    }
                }
            }
#pragma unroll
            for (int j = 0; j < kTile; ++j) {
                if (v0 + j < nu) {
                    cc[vj[j] * kLd] = acc[j];
                    if constexpr (RND == kRoundAll) c2[vj[j] * kLd] = acc2[j];
                }
            }
        }
        for (int v = 0; v < nu; ++v) {
            T* mv = m + (v * nu - v * (v - 1) / 2 - v) * kLd;  // + w kLd
            const T* av_row = a2c + v * n_s;
            for (int w0 = v; w0 < nu; w0 += kTile) {
                int wj[kTile];
                T acc[kTile];
#pragma unroll
                for (int j = 0; j < kTile; ++j) {
                    wj[j] = w0 + j < nu ? w0 + j : nu - 1;
                    acc[j] = first ? T(0) : mv[wj[j] * kLd];
                }
                for (int s = 0; s < n_c; ++s) {
                    const T av = av_row[s];
                    const T dv = dq[s * kLd];
#pragma unroll
                    for (int j = 0; j < kTile; ++j) {
                        T x = av * a2c[wj[j] * n_s + s];
                        if constexpr (RND == kRoundAll) x = bf16r(x);
                        acc[j] += x * dv;
                    }
                }
#pragma unroll
                for (int j = 0; j < kTile; ++j)
                    if (w0 + j < nu) mv[wj[j] * kLd] = acc[j];
            }
        }
    }
    if constexpr (RND == kRoundAll) {
        for (int v = 0; v < nu; ++v) cc[v * kLd] -= c2[v * kLd];
    }
}

// build_cm_rows_at on a staged Rt column (known_resid's note)
template <typename T, int RND, typename TY>
__device__ __forceinline__ void build_cm_rows(
        T* __restrict__ st, int nu, const TY* __restrict__ y,
        const TY* __restrict__ d, int64_t ld, const T* __restrict__ rt,
        const T* __restrict__ a1, const T* __restrict__ a2, int n_s,
        int n_ct) {
    build_cm_rows_at<T, RND>(st, nu, y, d, ld, rt, a1, a2, n_s, n_ct);
}

// The n_steps FISTA loop of the gram form on the state rows (u in u
// vector 0, u_prev in 1; C and M as build_cm_rows left them): gram_steps'
// arithmetic in its orders. u_t overwrites u_prev in place, M g is summed
// in tiles of kTile unknowns over w in order (the packed index of
// (v, w) advanced as w moves), and the new u goes to the free vector;
// the three vectors then rotate. Returns the vectors holding u and
// u_prev (u vector k at st + k n_u kLd).
template <typename T, bool LAG>
__device__ __forceinline__ int2 gram_steps_rows(
        T* __restrict__ st, int nu, const T* __restrict__ beta_tab,
        const T l_w, int n_steps) {
    const T* cc = st + 3 * nu * kLd;
    const T* m = cc + nu * kLd;
    // u in vector a, u_prev in a + 1, the free one in a + 2 (mod 3)
    int a = 0;
    T beta_next = beta_tab[0];
    for (int step = 0; step < n_steps; ++step) {
        const T beta = beta_next;
        beta_next = beta_tab[step + 1];
        const int b = a == 2 ? 0 : a + 1, x = b == 2 ? 0 : b + 1;
        const T* ua = st + a * nu * kLd;
        T* ub = st + b * nu * kLd;
        T* ux = st + x * nu * kLd;
        for (int v = 0; v < nu; ++v) {
            const T u = ua[v * kLd];
            ub[v * kLd] = u + beta * (u - ub[v * kLd]);
        }
        const T* g = LAG ? ua : ub;
        for (int v0 = 0; v0 < nu; v0 += kTile) {
            int vj[kTile], k[kTile];
            T mu[kTile];
#pragma unroll
            for (int j = 0; j < kTile; ++j) {
                vj[j] = v0 + j < nu ? v0 + j : nu - 1;
                k[j] = vj[j];                       // sym(0, v)
                mu[j] = T(0);
            }
            for (int w = 0; w < nu; ++w) {
                const T gw = g[w * kLd];
#pragma unroll
                for (int j = 0; j < kTile; ++j) {
                    mu[j] += m[k[j] * kLd] * gw;
                    k[j] += w < vj[j] ? nu - w - 1 : 1;
                }
            }
#pragma unroll
            for (int j = 0; j < kTile; ++j)
                if (v0 + j < nu)
                    ux[vj[j] * kLd] = clip01(
                        ub[vj[j] * kLd] + (cc[vj[j] * kLd] - mu[j]) / l_w);
        }
        a = x;          // the new u; u_prev is the old u, in a + 1
    }
    return make_int2(a, a == 2 ? 0 : a + 1);
}

// The Gram stage's plan for one block (or one chunk of samples) of n_c
// samples: at most kSites entries [gu | b_u | usq] get a thread each
// (the "entry" form); above, gu is dealt in micro-tiles of RS samples x
// RV unknowns x kTileQ rows of [Rt | u] and b_u and usq keep a thread
// each (the "tile" form). RV is 1 at n_u = 1 (tiles of 4 samples), 2
// otherwise (2 samples x 2 unknowns), so every tile forms 4 left factors
// and reuses each across kTileQ = 4 rows. ops/cuda_kernels.gram_tile_plan
// is the same plan; dm_gram_tile_plan exports it for chip_smoke.py.
constexpr int kTileQ = 4;

__host__ __device__ __forceinline__ constexpr int tile_rv(int n_u) {
    return n_u == 1 ? 1 : 2;
}

struct GramPlan {
    int tiled, rs, rv, ts, tv, tq, n_tiles, n_items;
};

__host__ __device__ __forceinline__ GramPlan gram_plan(int n_c, int n_u,
                                                       int p, bool usq) {
    GramPlan g{};
    const int n_local = n_c * n_u * p + n_u * n_c + (usq ? 1 : 0);
    g.rv = tile_rv(n_u);
    g.rs = 4 / g.rv;
    g.tiled = n_local > kSites;
    if (!g.tiled) {
        g.n_items = n_local;
        return g;
    }
    g.ts = (n_c + g.rs - 1) / g.rs;
    g.tv = (n_u + g.rv - 1) / g.rv;
    g.tq = (p + kTileQ - 1) / kTileQ;
    g.n_tiles = g.ts * g.tv * g.tq;
    g.n_items = g.n_tiles + n_u * n_c + (usq ? 1 : 0);
    return g;
}

// ---- the global layout's plan ------------------------------------------
//
// The global layout's shared memory (rows of kLd values, from the bottom):
//   - during the steps: the n_u > 8 form's state region (state_rows, unless
//     it lives in device memory) and, in the direct form, the n_s rows of
//     its known-block residual (res) past the region where they fit the
//     block (else the residual is rebuilt each step, as the wide layout
//     does); nothing at n_u <= 8 in the gram form, whose Y, D and Rt are
//     read where they lie;
//   - for the Gram stage (global_plan: cs, q, depth): Y and D, cs samples
//     each, then the ring, depth slots of q rows of Rt;
//   - at the top, the u rows: `members` blocks of um rows (K1: u, and under
//     kRoundAll bf16(u) then the raw u; K4: a member's u, weighted then its
//     w u), written after each member's steps. The last member's rows may
//     overlay the region's dead tail (its M rows, or the direct form's
//     residual and gradient rows), never the vectors u is read from; the
//     other members' rows lie past the region, which the next member's
//     steps reuse (K4's members are stacked downwards: member k at
//     rows - (k + 1) um).
// q is the multiple of kTileQ that gives the block's threads a tile each
// per slot (kSites / (samples x unknowns x members) tiles per kTileQ rows,
// gram_plan's tile shape), at most all of Rt, shrunk by kTileQ while the
// Gram stage would take the block from two blocks an SM (or from the rows
// the steps hold, if more) -- unless one block an SM with the larger q
// keeps more of the SM's threads busy with tiles; where the state region
// lives in device memory (kGlobalState) the layout keeps the 2 chunk_rows
// rows it had, and cs shrinks too. kc: the register forms (n_u <= 8), whose
// steps leave shared memory free but for the u rows, form their known
// sums in n_s rows at the bottom with a1 staged kc rows of n_s values at a
// time above them (known_rows), where the rows below the u rows hold n_s
// rows and one row of a1 (0: the sums come from device memory, a
// kKnownGroup of samples a pass). ops/cuda_kernels.global_plan is the
// same plan; dm_global_plan exports it.
constexpr int kRingSlots = 2;

struct GlobalPlan {
    int cs, q, depth, rows, res, kc;
};

__host__ __device__ __forceinline__ int imax(int a, int b) {
    return a > b ? a : b;
}

__host__ __device__ __forceinline__ int ring_need(int cs, int q, int n_ct,
                                                  int u_rows) {
    const int depth = q == 0 ? 0 : (q < n_ct ? kRingSlots : 1);
    return 2 * cs + depth * q + u_rows;
}

__host__ __device__ __forceinline__ GlobalPlan global_plan(
        long long itemsize, int n_s, int n_ct, int n_u, bool direct, int um,
        int members) {
    GlobalPlan g{};
    const long long row = itemsize * kLd;
    const int max_rows = static_cast<int>(kSmemBlock / row);
    const int two = static_cast<int>((kSmemPerSm / 2 - kSmemReserve) / row);
    const int sr = state_rows(n_s, n_u, direct);
    const bool in_dev = sr > 0 && state_in_device(itemsize, n_s, n_u, direct);
    const int region = in_dev ? 0 : sr;
    const int vec = region > 0 ? (direct ? 2 : 3) * n_u : 0;
    g.res = direct && !in_dev && region + n_s <= max_rows;
    const int hold = region + (g.res ? n_s : 0);
    const int fixed = imax(hold + (members - 1) * um, vec + members * um);
    g.cs = chunk_rows(n_s);
    const int rv = tile_rv(n_u), rs = 4 / rv;
    const int per4 = (g.cs + rs - 1) / rs * ((n_u + rv - 1) / rv) * members;
    const int ct4 = (n_ct + kTileQ - 1) / kTileQ * kTileQ;
    int q = kTileQ * ((kSites + per4 - 1) / per4);
    q = q < ct4 ? q : ct4;
    const int floor_rows = in_dev ? 2 * chunk_rows(n_s) : 0;
    // q within two blocks' rows, or one block's where that keeps more of
    // an SM's threads busy with tiles
    int q2 = q;
    while (q2 > kTileQ
           && ring_need(g.cs, q2, n_ct, members * um) > imax(two, fixed))
        q2 -= kTileQ;
    int q1 = q;
    while (q1 > kTileQ
           && ring_need(g.cs, q1, n_ct, members * um) > imax(max_rows, fixed))
        q1 -= kTileQ;
    const int busy2 = per4 * q2 / kTileQ < kSites ? per4 * q2 / kTileQ
                                                   : kSites;
    const int busy1 = per4 * q1 / kTileQ < kSites ? per4 * q1 / kTileQ
                                                   : kSites;
    q = 2 * busy2 < busy1 ? q1 : q2;
    while (in_dev && ring_need(g.cs, q, n_ct, members * um) > floor_rows) {
        if (q > kTileQ)
            q -= kTileQ;
        else if (g.cs > 1)
            --g.cs;
        else
            break;
    }
    g.q = q;
    g.depth = q == 0 ? 0 : (q < n_ct ? kRingSlots : 1);
    g.rows = imax(imax(fixed, ring_need(g.cs, q, n_ct, members * um)),
                  floor_rows);
    // the register forms' known sums (known_rows): n_s rows at the bottom
    // and a1 staged kc rows at a time in the rows free below the u rows
    const int free_vals = (g.rows - members * um - n_s) * kLd;
    if (n_u <= kRegNU && n_ct > 0 && free_vals >= n_s)
        g.kc = free_vals / n_s < n_ct ? free_vals / n_s : n_ct;
    return g;
}

// b_u's sum for one (v, s): sum_j u_v (d_s y_s) over the block's sites in
// site order, ds, ys, uv rows of kLd values (kRoundDy and kRoundAll round
// d y to bf16); gram_entry writes the same sum out (build_cm_at's note)
template <typename T, int RND>
__device__ __forceinline__ T bu_sum(const T* __restrict__ ds,
                                    const T* __restrict__ ys,
                                    const T* __restrict__ uv) {
    T acc = T(0);
    if constexpr (RND != kRoundNone) {
        for (int j = 0; j < kSites; ++j) acc += uv[j] * bf16r(ds[j] * ys[j]);
    } else {
        for (int j = 0; j < kSites; ++j) acc += uv[j] * (ds[j] * ys[j]);
    }
    return acc;
}

// usq's sum: sum_j sum_v x_v^2 over the block's sites, then the
// unknowns, x the nu rows at xs (kLd values each; gram_entry's sum)
template <typename T, int NU>
__device__ __forceinline__ T usq_sum(const T* __restrict__ xs, int nu) {
    const int nuc = NU > 0 ? NU : nu;
    T acc = T(0);
    for (int j = 0; j < kSites; ++j) {
#pragma unroll
        for (int v = 0; v < nuc; ++v) {
            const T x = xs[v * kLd + j];
            acc += x * x;
        }
    }
    return acc;
}

// One Gram entry of this block, l in [0, n_local) of the local order
// [gu (n_c, n_u, p) | b_u (n_u, n_c) | usq] (see gram_partials), summed
// over the block's sites in site order and written to out[e * n_blocks].
template <typename T, int NU, int RND>
__device__ __forceinline__ void gram_entry(
        int l, const T* __restrict__ s_y, const T* __restrict__ s_d,
        const T* __restrict__ s_r, int n_s, int c0, int n_c, int n_ct,
        int nu, T* __restrict__ out, int n_blocks,
        const T* __restrict__ s_x) {
    if constexpr (NU > 0) nu = NU;
    const int p = n_ct + nu;
    const int l_gu = n_c * nu * p;
    const int l_bu = nu * n_c;
    const int e_gu = n_s * nu * p;
    T acc = T(0);
    int e;
    if (l < l_gu) {
        const int s = l / (nu * p);
        const int v = (l / p) % nu;
        const int q = l % p;
        e = c0 * nu * p + l;
        const T* ds = s_d + s * kLd;
        const T* uv = s_r + (n_ct + v) * kLd;
        const T* rq = s_r + q * kLd;
        if constexpr (RND == kRoundAll) {
            for (int j = 0; j < kSites; ++j)
                acc += bf16r(ds[j] * uv[j]) * rq[j];
        } else {
            for (int j = 0; j < kSites; ++j)
                acc += (ds[j] * uv[j]) * rq[j];
        }
    } else if (l < l_gu + l_bu) {
        const int v = (l - l_gu) / n_c;
        const int s = (l - l_gu) % n_c;
        e = e_gu + v * n_s + c0 + s;
        const T* ds = s_d + s * kLd;
        const T* ys = s_y + s * kLd;
        const T* uv = s_r + (n_ct + v) * kLd;
        if constexpr (RND != kRoundNone) {
            for (int j = 0; j < kSites; ++j)
                acc += uv[j] * bf16r(ds[j] * ys[j]);
        } else {
            for (int j = 0; j < kSites; ++j)
                acc += uv[j] * (ds[j] * ys[j]);
        }
    } else {
        e = e_gu + nu * n_s;
        const int nuc = NU > 0 ? NU : nu;
        for (int j = 0; j < kSites; ++j) {
#pragma unroll
            for (int v = 0; v < nuc; ++v) {
                if constexpr (RND == kRoundAll) {
                    const T x = s_x[v * kLd + j];
                    acc += x * x;
                } else {
                    const T x = s_r[(n_ct + v) * kLd + j];
                    acc += x * x;
                }
            }
        }
    }
    out[static_cast<int64_t>(e) * n_blocks] = acc;
}

// One micro-tile of gu: samples [s0, s0 + RS) x unknowns [v0, v0 + RV) x
// right rows [q0, q0 + kTileQ) of the nq rows at s_rr, clamped to the
// block's entries; the left u rows are at s_ul, and right row q is the
// entry's row qo + q of [Rt | u]. Per site the RS x RV left factors
// d_s u_v (bf16(d_s u_v) under kRoundAll) are formed once and each is
// multiplied into kTileQ accumulators, each entry summed in site order
// from 0: the entry form's sum, bit for bit.
template <typename T, int RS, int RV, int RND>
__device__ __forceinline__ void gram_tile_rows(
        int s0, int v0, int q0, const T* __restrict__ s_d,
        const T* __restrict__ s_ul, const T* __restrict__ s_rr, int nq,
        int qo, int c0, int n_c, int nu, int p, T* __restrict__ out,
        int n_blocks) {
    const T* ds[RS];
    const T* uv[RV];
    const T* rq[kTileQ];
#pragma unroll
    for (int a = 0; a < RS; ++a)
        ds[a] = s_d + (s0 + a < n_c ? s0 + a : n_c - 1) * kLd;
#pragma unroll
    for (int b = 0; b < RV; ++b)
        uv[b] = s_ul + (v0 + b < nu ? v0 + b : nu - 1) * kLd;
#pragma unroll
    for (int c = 0; c < kTileQ; ++c)
        rq[c] = s_rr + (q0 + c < nq ? q0 + c : nq - 1) * kLd;
    T acc[RS][RV][kTileQ];
#pragma unroll
    for (int a = 0; a < RS; ++a)
#pragma unroll
        for (int b = 0; b < RV; ++b)
#pragma unroll
            for (int c = 0; c < kTileQ; ++c) acc[a][b][c] = T(0);
#pragma unroll 4
    for (int j = 0; j < kSites; ++j) {
        T r[kTileQ], u[RV];
#pragma unroll
        for (int c = 0; c < kTileQ; ++c) r[c] = rq[c][j];
#pragma unroll
        for (int b = 0; b < RV; ++b) u[b] = uv[b][j];
#pragma unroll
        for (int a = 0; a < RS; ++a) {
            const T d = ds[a][j];
#pragma unroll
            for (int b = 0; b < RV; ++b) {
                T x = d * u[b];
                if constexpr (RND == kRoundAll) x = bf16r(x);
#pragma unroll
                for (int c = 0; c < kTileQ; ++c) acc[a][b][c] += x * r[c];
            }
        }
    }
#pragma unroll
    for (int a = 0; a < RS; ++a)
#pragma unroll
        for (int b = 0; b < RV; ++b)
#pragma unroll
            for (int c = 0; c < kTileQ; ++c) {
                const int s = s0 + a, v = v0 + b, q = q0 + c;
                if (s < n_c && v < nu && q < nq)
                    out[static_cast<int64_t>((c0 + s) * nu * p + v * p + qo
                                             + q) * n_blocks] = acc[a][b][c];
            }
}

// gram_tile_rows over the rows of [Rt | u] staged in s_r: samples
// [s0, s0 + RS) x unknowns [v0, v0 + RV) x rows [q0, q0 + kTileQ) of
// [Rt | u], clamped to the block's entries (the left u rows are [Rt | u]'s
// last nu rows)
template <typename T, int RS, int RV, int RND>
__device__ __forceinline__ void gram_tile(
        int s0, int v0, int q0, const T* __restrict__ s_d,
        const T* __restrict__ s_r, int c0, int n_c, int n_ct, int nu,
        T* __restrict__ out, int n_blocks) {
    const int p = n_ct + nu;
    gram_tile_rows<T, RS, RV, RND>(s0, v0, q0, s_d, s_r + n_ct * kLd, s_r, p,
                                   0, c0, n_c, nu, p, out, n_blocks);
}

// Gram entries of this block with the new u, for the samples [c0, c1)
// whose Y and D rows are staged in s_y, s_d (row s at (s - c0) * kLd),
// and [Rt | u] in s_r: gu[s,v,q] = sum_j (d_s u_v) [Rt|u]_q and
// b_u[v,s] = sum_j u_v (d_s y_s) for those samples, and with `usq` the
// entry sum_j sum_v u_v^2. Each entry is summed over the block's sites in
// site order and written to out[e * n_blocks] with e the entry's index in
// [gu (n_s, n_u, p) | b_u (n_u, n_s) | usq] (the caller points out at
// this block's column). The work follows gram_plan: one thread per entry
// (entry l to thread l mod kSites), or gu's micro-tiles (gram_tile) then
// b_u's and usq's entries, item k to thread k mod kSites.
// (K1's and K7's stage; K4 sums a member group's entries in its own
// stage, u_phase_grams_multi.cuh, with the same products.) With kRoundAll
// the caller stages
// bf16(u) in s_r and the raw u in s_x: gu = sum bf16(d_s bf16(u_v))
// [Rt|bf16(u)]_q, b_u = sum bf16(u_v) bf16(d y), usq = sum u_v^2 of the
// raw u; kRoundDy rounds d y in b_u.
template <typename T, int NU, int RND>
__device__ __forceinline__ void gram_partials(
        const T* __restrict__ s_y, const T* __restrict__ s_d,
        const T* __restrict__ s_r, int n_s, int c0, int c1, bool usq,
        int n_ct, int n_u, int tid, T* __restrict__ out, int n_blocks,
        const T* __restrict__ s_x) {
    const int nu = NU > 0 ? NU : n_u;
    const int p = n_ct + nu;
    const int n_c = c1 - c0;
    const GramPlan g = gram_plan(n_c, nu, p, usq);
    if (!g.tiled) {
        for (int l = tid; l < g.n_items; l += kSites)
            gram_entry<T, NU, RND>(l, s_y, s_d, s_r, n_s, c0, n_c, n_ct,
                                      nu, out, n_blocks, s_x);
        return;
    }
    constexpr int RV = tile_rv(NU > 0 ? NU : 9);
    constexpr int RS = 4 / RV;
    const int l_gu = n_c * nu * p;
    for (int k = tid; k < g.n_items; k += kSites) {
        if (k >= g.n_tiles) {
            gram_entry<T, NU, RND>(l_gu + k - g.n_tiles, s_y, s_d, s_r,
                                      n_s, c0, n_c, n_ct, nu, out, n_blocks,
                                      s_x);
            continue;
        }
        const int qt = k % g.tq;
        const int vt = (k / g.tq) % g.tv;
        const int st = k / (g.tq * g.tv);
        gram_tile<T, RS, RV, RND>(st * RS, vt * RV, qt * kTileQ, s_d, s_r,
                                     c0, n_c, n_ct, nu, out, n_blocks);
    }
}

// The Gram stage of the wide layout: Y and D staged kChunk samples at a
// time into s_y, s_d, each chunk's entries summed by gram_partials (usq
// with the last chunk). Called by every thread of the block after the
// new u rows of s_r (and s_x) are written and synchronised.
template <typename T, typename TD, int NU, int RND>
__device__ __forceinline__ void gram_partials_chunked(
        T* __restrict__ s_y, T* __restrict__ s_d, const T* __restrict__ s_r,
        const TD* __restrict__ ydt, int64_t i, bool live, int64_t n,
        int n_s, int n_ct, int n_u, int tid, T* __restrict__ out,
        int n_blocks, const T* __restrict__ s_x) {
    for (int c0 = 0; c0 < n_s; c0 += kChunk) {
        const int c1 = c0 + kChunk < n_s ? c0 + kChunk : n_s;
        if (c0 > 0) __syncthreads();     // the previous chunk's sums done
        stage_rows(s_y, ydt, c0, c1, i, live, n, tid);
        stage_rows(s_d, ydt + static_cast<int64_t>(n_s) * n, c0, c1, i, live,
                   n, tid);
        stage_wait();
        __syncthreads();
        gram_partials<T, NU, RND>(s_y, s_d, s_r, n_s, c0, c1, c1 == n_s,
                                     n_ct, n_u, tid, out, n_blocks, s_x);
    }
}

// The Gram stage of the global layout (gram_partials' entries, products
// and orders): Y and D g.cs samples at a time into the bottom rows; per
// chunk, first the entries whose right row is a u row (u tiles, b_u's
// entries and, with the last chunk, usq) while the first slot of Rt lands,
// then Rt g.q rows a slot through the ring, the next slot loading
// (cp.async; bf16 data through registers) while this one's tiles are
// summed, dealt over samples x unknowns x rows as gram_plan deals them,
// item k to thread k mod kSites. s_u holds the u rows (bf16(u) under
// kRoundAll, the raw u in s_x). Called by every thread of the block after
// the u rows are written; starts with a barrier.
template <typename T, typename TD, int NU, int RND>
__device__ __forceinline__ void gram_partials_ring(
        T* __restrict__ smem, const GlobalPlan& g, const T* __restrict__ s_u,
        const T* __restrict__ s_x, const TD* __restrict__ ydt,
        const TD* __restrict__ rtt, int64_t i, bool live, int64_t n, int n_s,
        int n_ct, int n_u, int tid, T* __restrict__ out, int n_blocks) {
    const int nu = NU > 0 ? NU : n_u;
    const int p = n_ct + nu;
    constexpr int RV = tile_rv(NU > 0 ? NU : 9);
    constexpr int RS = 4 / RV;
    T* s_y = smem;
    T* s_d = s_y + g.cs * kLd;
    T* ring = s_d + g.cs * kLd;
    const int n_rc = g.q > 0 ? (n_ct + g.q - 1) / g.q : 0;
    const int tv = (nu + RV - 1) / RV;
    const int tqu = (nu + kTileQ - 1) / kTileQ;
    for (int c0 = 0; c0 < n_s; c0 += g.cs) {
        const int c1 = c0 + g.cs < n_s ? c0 + g.cs : n_s;
        const int n_c = c1 - c0;
        const int ts = (n_c + RS - 1) / RS;
        __syncthreads();     // the u rows written; the last chunk's sums done
        stage_rows(s_y, ydt, c0, c1, i, live, n, tid);
        stage_rows(s_d, ydt + static_cast<int64_t>(n_s) * n, c0, c1, i, live,
                   n, tid);
        stage_commit();
        if (n_rc > 0) {
            stage_rows(ring, rtt, 0, g.q < n_ct ? g.q : n_ct, i, live, n,
                       tid);
            stage_commit();
        }
        stage_wait_pending(n_rc > 0 ? 1 : 0);
        __syncthreads();
        const int n_ut = ts * tv * tqu;
        const int n_items = n_ut + nu * n_c + (c1 == n_s ? 1 : 0);
        for (int k = tid; k < n_items; k += kSites) {
            if (k < n_ut) {
                const int qt = k % tqu;
                const int vt = (k / tqu) % tv;
                const int st = k / (tqu * tv);
                gram_tile_rows<T, RS, RV, RND>(st * RS, vt * RV,
                                               qt * kTileQ, s_d, s_u, s_u,
                                               nu, n_ct, c0, n_c, nu, p, out,
                                               n_blocks);
            } else if (k < n_ut + nu * n_c) {
                const int v = (k - n_ut) / n_c;
                const int s = (k - n_ut) % n_c;
                out[static_cast<int64_t>(n_s * nu * p + v * n_s + c0 + s)
                    * n_blocks] = bu_sum<T, RND>(s_d + s * kLd,
                                                 s_y + s * kLd,
                                                 s_u + v * kLd);
            } else {
                out[static_cast<int64_t>(n_s * nu * p + nu * n_s)
                    * n_blocks] =
                    usq_sum<T, NU>(RND == kRoundAll ? s_x : s_u, nu);
            }
        }
        for (int rc = 0; rc < n_rc; ++rc) {
            stage_wait_pending(0);
            __syncthreads();    // slot rc % 2 landed, the other one free
            const int r0 = rc * g.q;
            const int nq = n_ct - r0 < g.q ? n_ct - r0 : g.q;
            if (rc + 1 < n_rc) {
                const int r1 = r0 + g.q;
                stage_rows(ring + ((rc + 1) & 1) * g.q * kLd, rtt, r1,
                           r1 + g.q < n_ct ? r1 + g.q : n_ct, i, live, n,
                           tid);
                stage_commit();
            }
            const T* slot = ring + (rc & 1) * g.q * kLd;
            const int tq = (nq + kTileQ - 1) / kTileQ;
            const int n_t = ts * tv * tq;
            for (int k = tid; k < n_t; k += kSites) {
                const int qt = k % tq;
                const int vt = (k / tq) % tv;
                const int st = k / (tq * tv);
                gram_tile_rows<T, RS, RV, RND>(st * RS, vt * RV,
                                               qt * kTileQ, s_d, s_u, slot,
                                               nq, r0, c0, n_c, nu, p, out,
                                               n_blocks);
            }
        }
    }
}

// The launch's prologue: warp b writes member b's momentum table (the
// betas of its n_steps FISTA steps, then the advanced Nesterov scalar in
// slot n_steps) at tab + b * (n_steps + 1), from its scalar row
// scal + b * scal_stride: the solver's slots (kAU, kLWPrev, kLW) for K1
// and K4, or with PH the single-phase slots (kPhA, kPhLPrev, kPhL) for
// K7, whose prologue also writes the output slots kPhAOut and
// kPhLPrevOut (phase_scalars_out's values). One tiny launch ahead of the
// main pass, so no thread of the main pass replays the chain.
// (In an unnamed namespace: each source that includes this header
// registers its own copy of the kernels.)
namespace {

constexpr int kTabThreads = 32;

template <typename T, bool PH>
__global__ void __launch_bounds__(kTabThreads)
momentum_table_kernel(T* __restrict__ scal, int scal_stride,
                      T* __restrict__ tab, int n_steps) {
    const int b = blockIdx.x;
    T* sc = scal + static_cast<int64_t>(b) * scal_stride;
    T* tb = tab + static_cast<int64_t>(b) * (n_steps + 1);
    const T l = sc[PH ? kPhL : kLW];
    const T l_prev = sc[PH ? kPhLPrev : kLWPrev];
    momentum_table(tb, sc[PH ? kPhA : kAU], l_prev, l, n_steps,
                   static_cast<int>(threadIdx.x), kTabThreads,
                   [] { __syncwarp(); });
    if constexpr (PH) {
        if (threadIdx.x == 0) {
            sc[kPhAOut] = tb[n_steps];
            sc[kPhLPrevOut] = n_steps > 0 ? l : l_prev;
        }
    }
}

template <typename T, bool PH>
int launch_momentum_table(T* scal, int scal_stride, int n_members, T* tab,
                          int n_steps, cudaStream_t stream) {
    momentum_table_kernel<T, PH><<<n_members, kTabThreads, 0, stream>>>(
        scal, scal_stride, tab, n_steps);
    return static_cast<int>(cudaGetLastError());
}

// Second pass (K1): row e of the (n_entries, n_blocks) partials is summed
// in a FIXED order (strided per thread, then a fixed tree) into out[e].
// The row e = 0 also sets the Nesterov scalar to the table's last slot
// (the chain advanced n_steps times by the prologue) and l_w_prev = l_w.
// K4 keeps this order in its own pass over a (n_blocks, B E) layout
// (u_phase_grams_multi.cuh, reduce_group_partials_kernel).
template <typename T>
__global__ void __launch_bounds__(kRedThreads)
reduce_partials_kernel(const T* __restrict__ partials, T* __restrict__ out,
                       T* __restrict__ scal, const T* __restrict__ tab,
                       int n_blocks, int n_steps) {
    __shared__ T buf[kRedThreads];
    const int e = blockIdx.x;
    const int tid = threadIdx.x;
    const T* row = partials + static_cast<int64_t>(e) * n_blocks;
    T acc = T(0);
    for (int b = tid; b < n_blocks; b += kRedThreads) acc += row[b];
    buf[tid] = acc;
    __syncthreads();
    for (int w = kRedThreads / 2; w > 0; w >>= 1) {
        if (tid < w) buf[tid] += buf[tid + w];
        __syncthreads();
    }
    if (tid == 0) {
        out[e] = buf[0];
        if (e == 0) {
            scal[kAU] = tab[n_steps];
            if (n_steps > 0) scal[kLWPrev] = scal[kLW];
        }
    }
}

}  // namespace

}  // namespace dm
