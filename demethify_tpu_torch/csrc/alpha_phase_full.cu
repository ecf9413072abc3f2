// K2: the alpha glue kernel of the partial-reference solve, for Hopper.
//
// Replaces the Pallas kernel demethify_tpu/ops/pallas_small.py
// :: _alpha_full_kernel (called through alpha_phase_full). In one launch:
//
//   - assemble the per-sample Grams from the loop-invariant known blocks
//     and K1's new-u blocks (as _assemble_G_b):
//       G[s][c][c'] = gtt[s,c,c'],  G[s][c][n_ct+u] = gu[s,u,c],
//       G[s][n_ct+u][q] = gu[s,u,q],  b = [bt; bu];
//   - l_h = (||Rt||^2 + usq) dmax^2;
//   - n_steps alpha FISTA steps with the simplex projection of each
//     column (the plain form of ops/fista.fista_alpha_gram);
//   - l_w = ||alpha_unknown||^2 dmax^2 and the Gram-identity cost
//     sum(ydy) - sum(b * alpha) - sum(alpha * (b - G alpha)).
//
// What bounds it on an H100: latency. The data is tiny (p ~ 6, n_s ~ 10)
// and the n_steps steps are serial; a launch per step would cost more
// than the arithmetic.
//
// What the design does about it: one thread block, one warp per sample
// column (a warp loops over columns when n_s > 32; columns are
// independent given the data-free momentum scalars). Lane q holds row q
// of alpha and of G_s in registers (so p <= 32), the matrix-vector
// product reads a_t from the other lanes by shuffle, and the projection
// runs inside the warp: a stable descending rank by comparison, the
// cumulative sum taken in sorted order (ballot finds the lane of each
// rank), and rho as the LAST lane whose condition holds (highest bit of
// a ballot) -- the reference's last-index rho. Cost and l_w are reduced
// across the block in a fixed order.
//
// Device scalars `scal` (shared with K1): 1 l_w (written), 3 a (the
// alpha Nesterov scalar, advanced), 4 l_h_prev (advanced), 5 cost
// (written), 6 ||Rt||^2 and 7 dmax^2 (read).
//
// Plain C interface (ctypes): pointers and the stream as void*, launches
// on that stream, allocates nothing, returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kMaxP = 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float sqrt_t(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_t(double x) { return sqrt(x); }

template <typename T>
__device__ __forceinline__ T nesterov(T a) {
    return (T(1) + sqrt_t(T(1) + T(4) * a * a)) / T(2);
}

template <typename T>
__device__ __forceinline__ T min_nan(T x, T y) {
    return (x < y || x != x) ? x : y;
}

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

template <typename T>
__global__ void alpha_phase_full_kernel(
        const T* __restrict__ gtt, const T* __restrict__ bt,
        const T* __restrict__ gu, const T* __restrict__ bu,
        const T* __restrict__ usq, const T* __restrict__ ydy,
        T* __restrict__ alpha, T* __restrict__ alpha_prev,
        T* __restrict__ scal, int n_s, int n_ct, int n_u, int n_steps) {
    __shared__ T red[3][32];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int n_warps = blockDim.x >> 5;
    const int p = n_ct + n_u;
    const bool row = lane < p;

    const T a0 = scal[3];
    const T l_h_prev0 = scal[4];
    const T dmax2 = scal[7];
    const T l_h = (scal[6] + usq[0]) * dmax2;

    T sum_ba = T(0), sum_ag = T(0), sum_lw = T(0);
    for (int s = warp; s < n_s; s += n_warps) {
        // row `lane` of G_s and b_s
        T g[kMaxP];
#pragma unroll
        for (int r = 0; r < kMaxP; ++r) {
            T x = T(0);
            if (row && r < p) {
                if (lane >= n_ct)
                    x = gu[(s * n_u + (lane - n_ct)) * p + r];
                else if (r >= n_ct)
                    x = gu[(s * n_u + (r - n_ct)) * p + lane];
                else
                    x = gtt[(s * n_ct + lane) * n_ct + r];
            }
            g[r] = x;
        }
        const T b = row ? (lane < n_ct ? bt[lane * n_s + s]
                                       : bu[(lane - n_ct) * n_s + s])
                        : T(0);
        T al = row ? alpha[lane * n_s + s] : T(0);
        T ap = row ? alpha_prev[lane * n_s + s] : T(0);

        T a = a0, l_prev = l_h_prev0;
        for (int step = 0; step < n_steps; ++step) {
            const T a2n = nesterov(a);
            const T beta = min_nan((a - T(1)) / a2n,
                                   T(0.9999) * sqrt_t(l_prev / l_h));
            const T at = al + beta * (al - ap);
            T ga = T(0);
#pragma unroll
            for (int r = 0; r < kMaxP; ++r) {
                const T atr = __shfl_sync(kFull, at, r);
                if (r < p) ga += g[r] * atr;
            }
            const T v = at + (b - ga) / l_h;
            const T proj = project_simplex_warp(v, lane, p);
            ap = al;
            al = row ? proj : T(0);
            a = a2n;
            l_prev = l_h;
        }

        // gradient at the final alpha, for the Gram-identity cost
        T ga = T(0);
#pragma unroll
        for (int r = 0; r < kMaxP; ++r) {
            const T ar = __shfl_sync(kFull, al, r);
            if (r < p) ga += g[r] * ar;
        }
        T ba = row ? b * al : T(0);
        T ag = row ? al * (b - ga) : T(0);
        T lw = (row && lane >= p - n_u) ? al * al : T(0);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            ba += __shfl_down_sync(kFull, ba, off);
            ag += __shfl_down_sync(kFull, ag, off);
            lw += __shfl_down_sync(kFull, lw, off);
        }
        sum_ba += ba;
        sum_ag += ag;
        sum_lw += lw;
        if (row) {
            alpha[lane * n_s + s] = al;
            alpha_prev[lane * n_s + s] = ap;
        }
    }
    if (lane == 0) {
        red[0][warp] = sum_ba;
        red[1][warp] = sum_ag;
        red[2][warp] = sum_lw;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        T s_ydy = T(0), s_ba = T(0), s_ag = T(0), s_lw = T(0);
        for (int s = 0; s < n_s; ++s) s_ydy += ydy[s];
        for (int w = 0; w < n_warps; ++w) {
            s_ba += red[0][w];
            s_ag += red[1][w];
            s_lw += red[2][w];
        }
        T a = a0;
        for (int step = 0; step < n_steps; ++step) a = nesterov(a);
        scal[1] = s_lw * dmax2;
        scal[3] = a;
        if (n_steps > 0) scal[4] = l_h;
        scal[5] = s_ydy - s_ba - s_ag;
    }
}

template <typename T>
int launch(const void* gtt, const void* bt, const void* gu, const void* bu,
           const void* usq, const void* ydy, void* alpha, void* alpha_prev,
           void* scal, int n_s, int n_ct, int n_u, int n_steps,
           void* stream) {
    const int n_warps = n_s < 32 ? n_s : 32;
    alpha_phase_full_kernel<T><<<1, 32 * n_warps, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(gtt), static_cast<const T*>(bt),
        static_cast<const T*>(gu), static_cast<const T*>(bu),
        static_cast<const T*>(usq), static_cast<const T*>(ydy),
        static_cast<T*>(alpha), static_cast<T*>(alpha_prev),
        static_cast<T*>(scal), n_s, n_ct, n_u, n_steps);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int dm_alpha_phase_full_f32(const void* gtt, const void* bt, const void* gu,
                            const void* bu, const void* usq, const void* ydy,
                            void* alpha, void* alpha_prev, void* scal,
                            int n_s, int n_ct, int n_u, int n_steps,
                            void* stream) {
    return launch<float>(gtt, bt, gu, bu, usq, ydy, alpha, alpha_prev, scal,
                         n_s, n_ct, n_u, n_steps, stream);
}

int dm_alpha_phase_full_f64(const void* gtt, const void* bt, const void* gu,
                            const void* bu, const void* usq, const void* ydy,
                            void* alpha, void* alpha_prev, void* scal,
                            int n_s, int n_ct, int n_u, int n_steps,
                            void* stream) {
    return launch<double>(gtt, bt, gu, bu, usq, ydy, alpha, alpha_prev, scal,
                          n_s, n_ct, n_u, n_steps, stream);
}

}  // extern "C"
