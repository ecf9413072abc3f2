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
//     both layouts take they give the same bits.
//
// State: n_u = 1..8 is a template parameter and the per-site state (u,
// u_prev, C, the n_u(n_u+1)/2 curvature terms, the step temporaries)
// lives in registers (RegVec). Above 8 one form with NU = 0 takes n_u at
// run time and keeps that state in a scratch buffer in device memory, one
// column per site (ColVec: the same addressing as the data rows, so a
// warp's accesses coalesce), and u, u_prev in place in the state rows.
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

#include "small_common.cuh"

namespace dm {

constexpr int kSites = 128;        // sites (threads) per main-pass block
constexpr int kLd = kSites + 1;    // shared row stride: avoids bank conflicts
constexpr int kRedThreads = 256;   // threads per block of the reduction pass
constexpr int kChunk = 32;         // samples per staged chunk (wide layout)

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

// A per-site state vector in device memory: element k at p[k * ld]
template <typename T>
struct ColVec {
    T* p;
    int64_t ld;
    __device__ __forceinline__ T& operator[](int k) const {
        return p[k * ld];
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
// ragged tail is zero.
template <typename T, typename TD>
__device__ __forceinline__ void stage_rows(T* __restrict__ dst,
                                           const TD* __restrict__ src,
                                           int r0, int r1, int64_t i,
                                           bool live, int64_t n, int tid) {
    for (int r = r0; r < r1; ++r)
        dst[(r - r0) * kLd + tid] = live ? to_state(src[r * n + i]) : T(0);
}

// The known-block residual of sample s at this thread's site, given its
// y and d: d y - d (a1' rt)  (just d y when n_ct = 0); rt is this site's
// column of the staged Rt rows (stride kLd), a1 the (n_ct, n_s) block.
// kRoundDy rounds d y to bf16; kResidFirst forms d (y - a1' rt), as the
// JAX package's single-phase U kernel does (d y when n_ct = 0, exactly).
template <int RND, typename T>
__device__ __forceinline__ T known_resid(T y, T d, const T* __restrict__ rt,
                                         const T* __restrict__ a1, int s,
                                         int n_s, int n_ct) {
    T known = T(0);
    for (int c = 0; c < n_ct; ++c) known += a1[c * n_s + s] * rt[c * kLd];
    if constexpr (RND == kRoundDy) return bf16r(d * y) - d * known;
    if constexpr (RND == kResidFirst) return d * (y - known);
    return d * y - d * known;
}

// C[u] = sum_s a2[u,s] dres_s and the upper triangle of
// M[u][v] = sum_s (a2[u,s] a2[v,s]) d_s at this thread's site. y, d are
// this site's sample rows (row stride ld: the staged rows or the data
// itself), rt its staged Rt column, a1, a2 the alpha blocks (row stride
// n_s). kRoundAll builds C as the JAX kernel's bf16 branch does, c1 - c2
// with c1[u] = sum_s bf16(a2[u,s]) bf16(d_s y_s) and
// c2[u] = sum_{s,c} bf16(a2[u,s] a1[c,s]) bf16(d_s rt_c) (c2: a
// temporary), and M from bf16(a2[u,s] a2[v,s]).
template <typename T, int NU, int RND, typename TY, class VC, class VM>
__device__ __forceinline__ void build_cm(
        VC& cc, VM& m, VC& c2, int n_u, const TY* __restrict__ y,
        const TY* __restrict__ d, int64_t ld, const T* __restrict__ rt,
        const T* __restrict__ a1, const T* __restrict__ a2, int n_s,
        int n_ct) {
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
                for (int c = 0; c < n_ct; ++c)
                    c2[v] += bf16r(av * a1[c * n_s + s])
                             * bf16r(dv * rt[c * kLd]);
#pragma unroll
                for (int w = v; w < nu; ++w)
                    m[sym(v, w, nu)] += bf16r(av * a2[w * n_s + s]) * dv;
            }
        }
#pragma unroll
        for (int v = 0; v < nu; ++v) cc[v] -= c2[v];
        return;
    }
    for (int s = 0; s < n_s; ++s) {
        const T yv = to_state(y[s * ld]);
        const T dv = to_state(d[s * ld]);
        const T dres = known_resid<RND == kResidFirst ? kResidFirst
                                                      : kRoundNone>(
            yv, dv, rt, a1, s, n_s, n_ct);
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

// The n_steps FISTA loop of the gram form; LAG takes each step's gradient
// at the old u (an instantiation each, so the step loop carries no
// per-step test). ut, un are step temporaries.
template <typename T, int NU, bool LAG, class VU, class VC, class VM>
__device__ __forceinline__ void gram_steps(
        VU& u, VU& up, const VC& cc, const VM& m, VC& ut, VC& un, int n_u,
        T a, T l_prev, const T l_w, int n_steps) {
    const int nu = NU > 0 ? NU : n_u;
    for (int step = 0; step < n_steps; ++step) {
        const T a1n = nesterov(a);
        const T beta = min_nan((a - T(1)) / a1n,
                               T(0.9999) * sqrt_t(l_prev / l_w));
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
        a = a1n;
        l_prev = l_w;
    }
}

// Gram entries of this block with the new u, for the samples [c0, c1)
// whose Y and D rows are staged in s_y, s_d (row s at (s - c0) * kLd),
// and [Rt | u] in s_r: gu[s,v,q] = sum_j (d_s u_v) [Rt|u]_q and
// b_u[v,s] = sum_j u_v (d_s y_s) for those samples, and with `usq` the
// entry sum_j sum_v u_v^2. One thread per entry, each summed over the
// block's sites in site order, written to out[e * n_blocks] with e the
// entry's index in [gu (n_s, n_u, p) | b_u (n_u, n_s) | usq] (the caller
// points out at this block's column). Entries are dealt to the threads
// in that order, so the resident layout (one range, [0, n_s), with usq)
// gives each thread the entries e = tid, tid + kSites, ...
// With W (K4's weighted bootstrap) the LEFT u of every sum is the
// weighted row s_x[v] = w u_v (formed by the caller once per site), so
// each sum carries the site weight exactly once, and weights of 1 give
// the unweighted sums bit for bit. With kRoundAll the caller stages
// bf16(u) in s_r and the raw u in s_x: gu = sum bf16(d_s bf16(u_v))
// [Rt|bf16(u)]_q, b_u = sum bf16(u_v) bf16(d y), usq = sum u_v^2 of the
// raw u; kRoundDy rounds d y in b_u.
template <typename T, int NU, bool W, int RND>
__device__ __forceinline__ void gram_partials(
        const T* __restrict__ s_y, const T* __restrict__ s_d,
        const T* __restrict__ s_r, int n_s, int c0, int c1, bool usq,
        int n_ct, int n_u, int tid, T* __restrict__ out, int n_blocks,
        const T* __restrict__ s_x) {
    const int nu = NU > 0 ? NU : n_u;
    const int p = n_ct + nu;
    const int n_c = c1 - c0;
    const int l_gu = n_c * nu * p;
    const int l_bu = nu * n_c;
    const int e_gu = n_s * nu * p;
    const int n_local = l_gu + l_bu + (usq ? 1 : 0);
    const bool left_x = W || RND == kRoundAll;   // usq's left u in s_x
    for (int l = tid; l < n_local; l += kSites) {
        T acc = T(0);
        int e;
        if (l < l_gu) {
            const int s = l / (nu * p);
            const int v = (l / p) % nu;
            const int q = l % p;
            e = c0 * nu * p + l;
            const T* ds = s_d + s * kLd;
            const T* uv = W ? s_x + v * kLd : s_r + (n_ct + v) * kLd;
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
            const T* uv = W ? s_x + v * kLd : s_r + (n_ct + v) * kLd;
            if constexpr (RND != kRoundNone) {
                for (int j = 0; j < kSites; ++j)
                    acc += uv[j] * bf16r(ds[j] * ys[j]);
            } else {
                for (int j = 0; j < kSites; ++j)
                    acc += uv[j] * (ds[j] * ys[j]);
            }
        } else {
            e = e_gu + nu * n_s;
            for (int j = 0; j < kSites; ++j) {
#pragma unroll
                for (int v = 0; v < nu; ++v) {
                    if constexpr (RND == kRoundAll) {
                        const T x = s_x[v * kLd + j];
                        acc += x * x;
                    } else {
                        const T x = s_r[(n_ct + v) * kLd + j];
                        acc += (left_x ? s_x[v * kLd + j] : x) * x;
                    }
                }
            }
        }
        out[static_cast<int64_t>(e) * n_blocks] = acc;
    }
}

// The Gram stage of the wide layout: Y and D staged kChunk samples at a
// time into s_y, s_d, each chunk's entries summed by gram_partials (usq
// with the last chunk). Called by every thread of the block after the
// new u rows of s_r (and s_x) are written and synchronised.
template <typename T, typename TD, int NU, bool W, int RND>
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
        __syncthreads();
        gram_partials<T, NU, W, RND>(s_y, s_d, s_r, n_s, c0, c1, c1 == n_s,
                                     n_ct, n_u, tid, out, n_blocks, s_x);
    }
}

// Second pass: row r of the (members x n_entries, n_blocks) partials is
// summed in a FIXED order (strided per thread, then a fixed tree) into
// out[r]; r = b * n_entries + e for member b, whose scalar row is
// scal + b * scal_stride. The row e = 0 of each member also advances that
// member's Nesterov scalar n_steps times and sets l_w_prev = l_w. With
// MULTI (K4), inactive members (slot kActive 0) are skipped: their
// outputs and scalars are left as they are; K1 (one member) has no
// member arithmetic at all.
// (In an unnamed namespace: each source that includes this header
// registers its own copy of the kernel.)
namespace {

template <typename T, bool MULTI>
__global__ void __launch_bounds__(kRedThreads)
reduce_partials_kernel(const T* __restrict__ partials, T* __restrict__ out,
                       T* __restrict__ scal, int n_blocks, int n_steps,
                       int n_entries, int scal_stride) {
    __shared__ T buf[kRedThreads];
    const int r = blockIdx.x;
    int e = r;
    T* sc = scal;
    if constexpr (MULTI) {
        e = r % n_entries;
        sc += static_cast<int64_t>(r / n_entries) * scal_stride;
        if (sc[kActive] == T(0)) return;           // uniform over the block
    }
    const int tid = threadIdx.x;
    const T* row = partials + static_cast<int64_t>(r) * n_blocks;
    T acc = T(0);
    for (int b = tid; b < n_blocks; b += kRedThreads) acc += row[b];
    buf[tid] = acc;
    __syncthreads();
    for (int w = kRedThreads / 2; w > 0; w >>= 1) {
        if (tid < w) buf[tid] += buf[tid + w];
        __syncthreads();
    }
    if (tid == 0) {
        out[r] = buf[0];
        if (e == 0) {
            T a = sc[kAU];
            for (int step = 0; step < n_steps; ++step) a = nesterov(a);
            sc[kAU] = a;
            if (n_steps > 0) sc[kLWPrev] = sc[kLW];
        }
    }
}

}  // namespace

}  // namespace dm
