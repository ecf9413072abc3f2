// Pieces shared by the U-phase megakernels: K1 (u_phase_grams.cu, one
// member) and K4 (u_phase_grams_multi.cu, B restart members on the same
// Y, D, Rt). One thread per CpG site, kSites sites per block; the block's
// site columns of Y, D and [Rt | u] are staged in shared memory (row
// stride kLd against bank conflicts) and reused for the Gram sums. The
// per-site arithmetic and the per-block and cross-block summation orders
// live here once, so K4's members follow K1's arithmetic bit for bit.
//
// Data and state types: the data rows (Y, D, Rt) are of type TD, the
// state and every sum of type T. TD = T is the float32 and float64 forms;
// TD = __nv_bfloat16 with T = float is bf16 storage: stage_sites converts
// each value once as it stages it, and the staged rows are T in shared
// memory, so from there on the arithmetic is the float32 form's,
// instruction for instruction (bf16 -> float32 is exact). Keeping the
// staged rows in bf16 would halve their shared memory but put a convert
// in every read of the C/M build and the Gram sums; at these shapes
// shared memory does not limit the blocks, so the rows stay T.
//
// BF16C (K1's bf16_compute form, T = float, gram form only) rounds with
// __float2bfloat16_rn at the points where the JAX kernel's bf16_compute
// branch forms bf16 products (pallas_kernels.py:263-334, 464-479): d y,
// d rt, the alpha operands a2, a2 a1 and a2 a2 of the C and M sums, and u
// and d u in the Gram sums. Every sum stays float32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "small_common.cuh"

namespace dm {

constexpr int kSites = 128;        // sites (threads) per main-pass block
constexpr int kLd = kSites + 1;    // shared row stride: avoids bank conflicts
constexpr int kRedThreads = 256;   // threads per block of the reduction pass

// clip to [0, 1]; NaN passes through, as torch.clamp
template <typename T>
__device__ __forceinline__ T clip01(T x) {
    return x < T(0) ? T(0) : (x > T(1) ? T(1) : x);
}

// index of M[v][w] in the packed upper triangle of a symmetric NU x NU
// matrix (constant-folded inside the unrolled loops)
template <int NU>
__device__ __forceinline__ constexpr int sym(int v, int w) {
    return v <= w ? v * NU - v * (v - 1) / 2 + (w - v)
                  : w * NU - w * (w - 1) / 2 + (v - w);
}

// Gram entries of one member: [gu (n_s, n_u, p) | b_u (n_u, n_s) | usq]
__host__ __device__ __forceinline__ int gram_entries(int n_s, int n_ct,
                                                     int n_u) {
    return n_s * n_u * (n_ct + n_u) + n_u * n_s + 1;
}

// a data value in the state type (the identity when TD = T)
__device__ __forceinline__ float to_state(float x) { return x; }
__device__ __forceinline__ double to_state(double x) { return x; }
__device__ __forceinline__ float to_state(__nv_bfloat16 x) {
    return __bfloat162float(x);
}

// x rounded to bf16 (to nearest, ties to even) and back: BF16C's rounding
__device__ __forceinline__ float bf16r(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
}

// Stages this block's site columns of Y and D (s_y, s_d: n_s rows each)
// and Rt (the first n_ct rows of s_r), converted to T; the ragged tail is
// zero.
template <typename T, typename TD>
__device__ __forceinline__ void stage_sites(
        T* __restrict__ s_y, T* __restrict__ s_d, T* __restrict__ s_r,
        const TD* __restrict__ ydt, const TD* __restrict__ rtt, int64_t i,
        bool live, int64_t n, int n_s, int n_ct, int tid) {
    for (int s = 0; s < n_s; ++s) {
        s_y[s * kLd + tid] = live ? to_state(ydt[s * n + i]) : T(0);
        s_d[s * kLd + tid] = live ? to_state(ydt[(n_s + s) * n + i]) : T(0);
    }
    for (int c = 0; c < n_ct; ++c)
        s_r[c * kLd + tid] = live ? to_state(rtt[c * n + i]) : T(0);
}

// The known-block residual of sample s at this thread's site, given its
// y and d: d y - d (a1' rt)  (just d y when n_ct = 0)
template <typename T>
__device__ __forceinline__ T known_resid(
        T y, T d, const T* __restrict__ s_r, const T* __restrict__ s_a1,
        int s, int n_s, int n_ct, int tid) {
    T known = T(0);
    for (int c = 0; c < n_ct; ++c)
        known += s_a1[c * n_s + s] * s_r[c * kLd + tid];
    return d * y - d * known;
}

// C[u] = sum_s a2[u,s] dres_s and the upper triangle of
// M[u][v] = sum_s (a2[u,s] a2[v,s]) d_s at this thread's site. BF16C
// builds C as the JAX kernel's bf16 branch does, c1 - c2 with
// c1[u] = sum_s bf16(a2[u,s]) bf16(d_s y_s) and
// c2[u] = sum_{s,c} bf16(a2[u,s] a1[c,s]) bf16(d_s rt_c), and M from
// bf16(a2[u,s] a2[v,s]).
template <typename T, int NU, bool BF16C = false>
__device__ __forceinline__ void build_cm(
        T (&cc)[NU], T (&m)[NU * (NU + 1) / 2], const T* __restrict__ s_y,
        const T* __restrict__ s_d, const T* __restrict__ s_r,
        const T* __restrict__ s_a1, const T* __restrict__ s_a2, int n_s,
        int n_ct, int tid) {
#pragma unroll
    for (int v = 0; v < NU; ++v) cc[v] = T(0);
#pragma unroll
    for (int k = 0; k < NU * (NU + 1) / 2; ++k) m[k] = T(0);
    if constexpr (BF16C) {
        T c2[NU];
#pragma unroll
        for (int v = 0; v < NU; ++v) c2[v] = T(0);
        for (int s = 0; s < n_s; ++s) {
            const T d = s_d[s * kLd + tid];
            const T dy = bf16r(d * s_y[s * kLd + tid]);
#pragma unroll
            for (int v = 0; v < NU; ++v) {
                const T av = s_a2[v * n_s + s];
                cc[v] += bf16r(av) * dy;
                for (int c = 0; c < n_ct; ++c)
                    c2[v] += bf16r(av * s_a1[c * n_s + s])
                             * bf16r(d * s_r[c * kLd + tid]);
#pragma unroll
                for (int w = v; w < NU; ++w)
                    m[sym<NU>(v, w)] += bf16r(av * s_a2[w * n_s + s]) * d;
            }
        }
#pragma unroll
        for (int v = 0; v < NU; ++v) cc[v] -= c2[v];
        return;
    }
    for (int s = 0; s < n_s; ++s) {
        const T y = s_y[s * kLd + tid];
        const T d = s_d[s * kLd + tid];
        const T dres = known_resid(y, d, s_r, s_a1, s, n_s, n_ct, tid);
#pragma unroll
        for (int v = 0; v < NU; ++v) {
            const T av = s_a2[v * n_s + s];
            cc[v] += av * dres;
#pragma unroll
            for (int w = v; w < NU; ++w)
                m[sym<NU>(v, w)] += (av * s_a2[w * n_s + s]) * d;
        }
    }
}

// The n_steps FISTA loop of the gram form, in registers; LAG takes each
// step's gradient at the old u (an instantiation each, so the step loop
// carries no per-step test).
template <typename T, int NU, bool LAG>
__device__ __forceinline__ void gram_steps(
        T (&u)[NU], T (&up)[NU], const T (&cc)[NU],
        const T (&m)[NU * (NU + 1) / 2], T a, T l_prev, const T l_w,
        int n_steps) {
    for (int step = 0; step < n_steps; ++step) {
        const T a1n = nesterov(a);
        const T beta = min_nan((a - T(1)) / a1n,
                               T(0.9999) * sqrt_t(l_prev / l_w));
        T ut[NU], un[NU];
#pragma unroll
        for (int v = 0; v < NU; ++v) ut[v] = u[v] + beta * (u[v] - up[v]);
#pragma unroll
        for (int v = 0; v < NU; ++v) {
            T mu = T(0);
#pragma unroll
            for (int w = 0; w < NU; ++w)
                mu += m[sym<NU>(v, w)] * (LAG ? u[w] : ut[w]);
            un[v] = clip01(ut[v] + (cc[v] - mu) / l_w);
        }
#pragma unroll
        for (int v = 0; v < NU; ++v) {
            up[v] = u[v];
            u[v] = un[v];
        }
        a = a1n;
        l_prev = l_w;
    }
}

// This block's Gram partial sums with the new u (rows n_ct .. n_ct+NU-1
// of s_r): entry e of [gu (n_s, NU, p) | b_u (NU, n_s) | usq], one thread
// each, summed over the block's sites in site order, written to
// out[e * n_blocks] (the caller points out at this block's column).
// With W (K4's weighted bootstrap) the LEFT u of every sum is the
// weighted row s_xu[v] = w u_v (NU rows, stride kLd, formed by the caller
// once per site), so each sum carries the site weight exactly once --
// gu[s,v,q] = sum (w u_v) d_s [Rt|u]_q, b_u = sum (w u_v) d y,
// usq = sum (w u_v) u_v -- with the same shared loads per term as the
// unweighted sums, and weights of 1 give those sums bit for bit.
// With BF16C the caller stages bf16(u) in s_r and the raw u in s_xu:
// gu[s,v,q] = sum bf16(d_s bf16(u_v)) [Rt|bf16(u)]_q,
// b_u = sum bf16(u_v) bf16(d y), usq = sum u_v^2 of the raw u.
template <typename T, int NU, bool W = false, bool BF16C = false>
__device__ __forceinline__ void gram_partials(
        const T* __restrict__ s_y, const T* __restrict__ s_d,
        const T* __restrict__ s_r, int n_s, int n_ct, int tid,
        T* __restrict__ out, int n_blocks,
        const T* __restrict__ s_xu = nullptr) {
    const int p = n_ct + NU;
    const int e_gu = n_s * NU * p;
    const int e_bu = NU * n_s;
    const int n_entries = e_gu + e_bu + 1;
    for (int e = tid; e < n_entries; e += kSites) {
        T acc = T(0);
        if (e < e_gu) {
            const int s = e / (NU * p);
            const int v = (e / p) % NU;
            const int q = e % p;
            const T* ds = s_d + s * kLd;
            const T* uv = W ? s_xu + v * kLd : s_r + (n_ct + v) * kLd;
            const T* rq = s_r + q * kLd;
            if constexpr (BF16C) {
                for (int j = 0; j < kSites; ++j)
                    acc += bf16r(ds[j] * uv[j]) * rq[j];
            } else {
                for (int j = 0; j < kSites; ++j)
                    acc += (ds[j] * uv[j]) * rq[j];
            }
        } else if (e < e_gu + e_bu) {
            const int v = (e - e_gu) / n_s;
            const int s = (e - e_gu) % n_s;
            const T* ds = s_d + s * kLd;
            const T* ys = s_y + s * kLd;
            const T* uv = W ? s_xu + v * kLd : s_r + (n_ct + v) * kLd;
            if constexpr (BF16C) {
                for (int j = 0; j < kSites; ++j)
                    acc += uv[j] * bf16r(ds[j] * ys[j]);
            } else {
                for (int j = 0; j < kSites; ++j)
                    acc += uv[j] * (ds[j] * ys[j]);
            }
        } else if constexpr (BF16C) {
            for (int j = 0; j < kSites; ++j) {
#pragma unroll
                for (int v = 0; v < NU; ++v) {
                    const T x = s_xu[v * kLd + j];
                    acc += x * x;
                }
            }
        } else {
            for (int j = 0; j < kSites; ++j) {
#pragma unroll
                for (int v = 0; v < NU; ++v) {
                    const T x = s_r[(n_ct + v) * kLd + j];
                    acc += (W ? s_xu[v * kLd + j] : x) * x;
                }
            }
        }
        out[static_cast<int64_t>(e) * n_blocks] = acc;
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
