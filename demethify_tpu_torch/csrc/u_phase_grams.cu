// K1: the U-phase megakernel of the partial-reference solve, for Hopper.
//
// Replaces the Pallas kernel demethify_tpu/ops/pallas_kernels.py
// :: _u_phase_grams_kernel (called through u_phase_grams_packed). One
// outer iteration of the solve makes ONE pass over the CpG axis:
//
//   per site i (one thread each):
//     C[u]    = sum_s a2[u,s] (d_is y_is - d_is (a1' rt_i)_s)
//     M[u][v] = sum_s (a2[u,s] a2[v,s]) d_is
//     n_steps FISTA steps on u_i in registers:
//       beta = min((a-1)/a', 0.9999 sqrt(l_prev/l_w))
//       u_t  = u + beta (u - u_prev)
//       u    = clip(u_t + (C - M u_t) / l_w, 0, 1)
//     (this is the plain form of ops/fista.fista_u_gram; the TPU kernel's
//      1/l_w pre-scaled form rounds differently and is not used)
//   per block, with the NEW u:
//     gu[s,u,q] = sum_i u_iu d_is [Rt | u]_iq,  b_u[u,s] = sum_i u_iu d_is y_is,
//     usq = sum_i sum_u u_iu^2
//
// What bounds it on an H100: memory traffic. At 1M sites x 10 samples,
// 5 + 1 cell types in float32 it reads Y, D, Rt, u, u_prev (~108 MB) and
// writes u, u_prev (~8 MB) per outer iteration, ~35 us at 3.35 TB/s; the
// arithmetic is a few hundred flops per site.
//
// What the design does about it:
//   - the big arrays stay in the transposed (rows, N) layout, so the
//     threads of a warp read neighbouring addresses of every row once;
//   - C, M and the FISTA state live in registers (n_u is a template
//     parameter, 1..4), so the n_steps loop touches no memory;
//   - the site columns a block read are staged in shared memory (row
//     stride T + 1 against bank conflicts) and reused for the Gram sums,
//     so Y, D and Rt are read from device memory exactly once;
//   - blocks run in no order, so the TPU kernel's in-order accumulation
//     across its grid becomes per-block partial sums (one column per
//     block of an (E, n_blocks) buffer) and a second kernel that sums each
//     row in a FIXED order. No float atomics: the trajectory is the same
//     from run to run, which |delta cost| < tol termination needs;
//   - the ragged tail is masked (zero columns contribute nothing);
//     nothing is padded.
//
// The Nesterov scalar and l_w_prev live in a small device vector `scal`
// (slot 0: a, 1: l_w, 2: l_w_prev) that every thread reads; the reduction
// kernel advances them after the main pass, so the host never syncs.
//
// Plain C interface (ctypes): pointers and the stream as void*, launches
// on that stream, allocates nothing, returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSites = 128;        // sites (threads) per block of the main pass
constexpr int kLd = kSites + 1;    // shared row stride: avoids bank conflicts
constexpr int kRedThreads = 256;   // threads per block of the reduction pass

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

// clip to [0, 1]; NaN passes through, as torch.clamp
template <typename T>
__device__ __forceinline__ T clip01(T x) {
    return x < T(0) ? T(0) : (x > T(1) ? T(1) : x);
}

template <typename T, int NU>
__global__ void __launch_bounds__(kSites)
u_phase_grams_kernel(const T* __restrict__ ydt, const T* __restrict__ rtt,
                     const T* __restrict__ a1b, const T* __restrict__ a2b,
                     T* __restrict__ uut, const T* __restrict__ scal,
                     T* __restrict__ partials, int64_t n, int n_s, int n_ct,
                     int n_steps, int n_blocks) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* s_y = reinterpret_cast<T*>(smem_raw);   // n_s rows
    T* s_d = s_y + n_s * kLd;                   // n_s rows
    T* s_r = s_d + n_s * kLd;                   // n_ct + NU rows: [Rt | u]
    T* s_a1 = s_r + (n_ct + NU) * kLd;          // (n_ct, n_s)
    T* s_a2 = s_a1 + n_ct * n_s;                // (NU, n_s)

    const int tid = threadIdx.x;
    for (int k = tid; k < n_ct * n_s; k += kSites) s_a1[k] = a1b[k];
    for (int k = tid; k < NU * n_s; k += kSites) s_a2[k] = a2b[k];

    const int64_t i = static_cast<int64_t>(blockIdx.x) * kSites + tid;
    const bool live = i < n;
    for (int s = 0; s < n_s; ++s) {
        s_y[s * kLd + tid] = live ? ydt[s * n + i] : T(0);
        s_d[s * kLd + tid] = live ? ydt[(n_s + s) * n + i] : T(0);
    }
    for (int c = 0; c < n_ct; ++c)
        s_r[c * kLd + tid] = live ? rtt[c * n + i] : T(0);
    __syncthreads();

    // ---- C and M for this site, in registers --------------------------
    T u[NU], up[NU], cc[NU], m[NU][NU];
#pragma unroll
    for (int v = 0; v < NU; ++v) {
        u[v] = live ? uut[v * n + i] : T(0);
        up[v] = live ? uut[(NU + v) * n + i] : T(0);
        cc[v] = T(0);
#pragma unroll
        for (int w = 0; w < NU; ++w) m[v][w] = T(0);
    }
    for (int s = 0; s < n_s; ++s) {
        const T y = s_y[s * kLd + tid];
        const T d = s_d[s * kLd + tid];
        T known = T(0);
        for (int c = 0; c < n_ct; ++c)
            known += s_a1[c * n_s + s] * s_r[c * kLd + tid];
        const T dres = d * y - d * known;
#pragma unroll
        for (int v = 0; v < NU; ++v) {
            const T av = s_a2[v * n_s + s];
            cc[v] += av * dres;
#pragma unroll
            for (int w = 0; w < NU; ++w)
                m[v][w] += (av * s_a2[w * n_s + s]) * d;
        }
    }

    // ---- the whole U FISTA loop, in registers ------------------------
    T a = scal[0];
    const T l_w = scal[1];
    T l_prev = scal[2];
    for (int step = 0; step < n_steps; ++step) {
        const T a1n = nesterov(a);
        const T beta = min_nan((a - T(1)) / a1n,
                               T(0.9999) * sqrt_t(l_prev / l_w));
        T ut[NU];
#pragma unroll
        for (int v = 0; v < NU; ++v) ut[v] = u[v] + beta * (u[v] - up[v]);
#pragma unroll
        for (int v = 0; v < NU; ++v) {
            T mu = T(0);
#pragma unroll
            for (int w = 0; w < NU; ++w) mu += m[v][w] * ut[w];
            up[v] = u[v];
            u[v] = clip01(ut[v] + (cc[v] - mu) / l_w);
        }
        a = a1n;
        l_prev = l_w;
    }
#pragma unroll
    for (int v = 0; v < NU; ++v) {
        if (live) {
            uut[v * n + i] = u[v];
            uut[(NU + v) * n + i] = up[v];
        }
        s_r[(n_ct + v) * kLd + tid] = live ? u[v] : T(0);
    }
    __syncthreads();

    // ---- this block's Gram partial sums with the new u ----------------
    // entry e: [gu (n_s, NU, p) | b_u (NU, n_s) | usq], one thread each,
    // summed over the block's sites in site order
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
            const T* uv = s_r + (n_ct + v) * kLd;
            const T* rq = s_r + q * kLd;
            for (int j = 0; j < kSites; ++j) acc += (ds[j] * uv[j]) * rq[j];
        } else if (e < e_gu + e_bu) {
            const int v = (e - e_gu) / n_s;
            const int s = (e - e_gu) % n_s;
            const T* ds = s_d + s * kLd;
            const T* ys = s_y + s * kLd;
            const T* uv = s_r + (n_ct + v) * kLd;
            for (int j = 0; j < kSites; ++j) acc += uv[j] * (ds[j] * ys[j]);
        } else {
            for (int j = 0; j < kSites; ++j) {
#pragma unroll
                for (int v = 0; v < NU; ++v) {
                    const T x = s_r[(n_ct + v) * kLd + j];
                    acc += x * x;
                }
            }
        }
        partials[static_cast<int64_t>(e) * n_blocks + blockIdx.x] = acc;
    }
}

// Second pass: out[e] = sum over blocks of partials[e, :], in a fixed
// order (strided per thread, then a fixed tree). Block 0 also advances
// the Nesterov scalar n_steps times and sets l_w_prev = l_w.
template <typename T>
__global__ void __launch_bounds__(kRedThreads)
reduce_partials_kernel(const T* __restrict__ partials, T* __restrict__ out,
                       T* __restrict__ scal, int n_blocks, int n_steps) {
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
            T a = scal[0];
            for (int step = 0; step < n_steps; ++step) a = nesterov(a);
            scal[0] = a;
            if (n_steps > 0) scal[2] = scal[1];
        }
    }
}

template <typename T, int NU>
int launch(const void* ydt, const void* rtt, const void* a1b, const void* a2b,
           void* uut, void* scal, void* partials, void* out, int64_t n,
           int n_s, int n_ct, int n_steps, cudaStream_t stream) {
    const int n_blocks = static_cast<int>((n + kSites - 1) / kSites);
    const int p = n_ct + NU;
    const int n_entries = n_s * NU * p + NU * n_s + 1;
    const size_t smem = sizeof(T) * (static_cast<size_t>(2 * n_s + p) * kLd
                                     + static_cast<size_t>(p) * n_s);
    auto kern = u_phase_grams_kernel<T, NU>;
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    kern<<<n_blocks, kSites, smem, stream>>>(
        static_cast<const T*>(ydt), static_cast<const T*>(rtt),
        static_cast<const T*>(a1b), static_cast<const T*>(a2b),
        static_cast<T*>(uut), static_cast<const T*>(scal),
        static_cast<T*>(partials), n, n_s, n_ct, n_steps, n_blocks);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    reduce_partials_kernel<T><<<n_entries, kRedThreads, 0, stream>>>(
        static_cast<const T*>(partials), static_cast<T*>(out),
        static_cast<T*>(scal), n_blocks, n_steps);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* ydt, const void* rtt, const void* a1b,
             const void* a2b, void* uut, void* scal, void* partials,
             void* out, int64_t n, int n_s, int n_ct, int n_u, int n_steps,
             void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (n_u) {
        case 1: return launch<T, 1>(ydt, rtt, a1b, a2b, uut, scal, partials,
                                    out, n, n_s, n_ct, n_steps, st);
        case 2: return launch<T, 2>(ydt, rtt, a1b, a2b, uut, scal, partials,
                                    out, n, n_s, n_ct, n_steps, st);
        case 3: return launch<T, 3>(ydt, rtt, a1b, a2b, uut, scal, partials,
                                    out, n, n_s, n_ct, n_steps, st);
        case 4: return launch<T, 4>(ydt, rtt, a1b, a2b, uut, scal, partials,
                                    out, n, n_s, n_ct, n_steps, st);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // namespace

extern "C" {

// Shared memory the main pass needs, in bytes (the wrapper checks it
// against the card's limit before launching).
long long dm_u_phase_grams_smem(int itemsize, int n_s, int n_ct, int n_u) {
    const long long p = n_ct + n_u;
    return itemsize * ((2LL * n_s + p) * kLd + p * n_s);
}

int dm_u_phase_grams_blocks(long long n) {
    return static_cast<int>((n + kSites - 1) / kSites);
}

int dm_u_phase_grams_f32(const void* ydt, const void* rtt, const void* a1b,
                         const void* a2b, void* uut, void* scal,
                         void* partials, void* out, long long n, int n_s,
                         int n_ct, int n_u, int n_steps, void* stream) {
    return dispatch<float>(ydt, rtt, a1b, a2b, uut, scal, partials, out, n,
                           n_s, n_ct, n_u, n_steps, stream);
}

int dm_u_phase_grams_f64(const void* ydt, const void* rtt, const void* a1b,
                         const void* a2b, void* uut, void* scal,
                         void* partials, void* out, long long n, int n_s,
                         int n_ct, int n_u, int n_steps, void* stream) {
    return dispatch<double>(ydt, rtt, a1b, a2b, uut, scal, partials, out, n,
                            n_s, n_ct, n_u, n_steps, stream);
}

}  // extern "C"
