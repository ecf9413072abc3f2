// K8: the per-sample Gram system in one pass over the sites, for Hopper.
//
// Replaces the Pallas kernel demethify_tpu/ops/pallas_kernels.py
// :: _gram_kernel (called through grams). From Yt, Dt (n_s, N) and
// Rt (p, N) it sums, for every sample s,
//
//   G[s] = R' diag(d_s) R       G[s][q][r] = sum_i (r_qi d_si) r_ri
//   b[:, s] = R' (d_s y_s)      b[q][s]    = sum_i (d_si y_si) r_qi
//   ydy[s] = y_s' D y_s         ydy[s]     = sum_i (d_si y_si) y_si
//
// in the accumulation type (float32 for bf16 data). Under bf16 data the
// products the Pallas body keeps as bf16 arrays are rounded where its
// compiled program rounds them (pallas_kernels.py:748-757): r_q d_s and
// d y, each a dot operand, with __float2bfloat16_rn; (d y) y feeds a
// float32 sum straight away and stays unrounded, as XLA compiles it.
// Every sum stays float32.
//
// The three sums are one: with x_s = [R; y_s] ((p + 1) rows), the
// (p + 1)^2 matrix X_s = sum_i (x_qi d_si) x_ri holds G in its first p
// rows and columns, b in its last column and in its last row, and ydy in
// its corner. In float32 and float64 X_s is symmetric, so only its upper
// triangle is summed (b from the last column, left factor r d_s) and G is
// mirrored on output: about half the operations of the whole matrix.
// Under bf16 the rounded left factor makes X_s[q][r] and X_s[r][q]
// differ, so the whole matrix is summed as the Pallas body sums it, b and
// ydy from the last row (left factor d y, as there); the last column
// above ydy is then not stored.
//
// What bounds it on an H100: memory traffic at few cell types, operations
// at many. It reads Y, D and R once: at 1M sites x 10 samples, p = 6 in
// float32 104 MB (~31 us at 3.35 TB/s) against ~0.6 GFLOP; at 1M x 100,
// p = 29, 0.92 GB (~0.27 ms) against ~94 GFLOP (~1.4 ms at 67 TFLOP/s):
// two per term of G's upper triangle, the pair products r_q r_r formed
// once per site.
//
// What the design does about it: the TPU kernel carries its sums across
// an in-order grid; here blocks run in any order on 132 SMs, so each
// block owns a chunk of sites and a group of samples, walks the chunk in
// tiles of 64 sites staged in shared memory (R once for the group, y and
// d per sample, converted to the accumulation type), and keeps its share
// of the entries in registers as 4 x 4 micro-tiles (per site: four left
// factors x d and four right rows for 16 fused multiply-adds), those on
// or above the diagonal of micro-tiles in float32 and float64.
// Small Gram systems leave threads over, so several threads split
// a tile's sites between them (`slices`) and add their sums in slice
// order at the end. The sums are fused multiply-adds (one rounding a
// term), unlike the other kernels' separate products and sums
// (--fmad=false): they hold to the twin within the same bounds. Each
// block writes one column of a (n_s (p + 1)^2, n_chunks) partial buffer
// -- n_chunks is a few per SM, not one per 128 sites, so the buffer stays
// tens of MB at the cohort shape -- and a second kernel sums each row
// over the chunks in a fixed order. No atomics: the same
// inputs give the same bits on every run.
//
// Plain C interface (ctypes): pointers and the stream as void*, launches
// on that stream, allocates nothing, returns cudaGetLastError(). The
// wrapper plans the sample groups and chunks (ops/cuda_kernels.grams_plan)
// and allocates the partial buffer.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "u_phase_common.cuh"

namespace {

constexpr int kGThreads = 256;      // threads per block of the main pass
constexpr int kGTile = 64;          // sites per staged tile
constexpr int kGLd = kGTile + 1;    // staged row stride
constexpr int kMT = 4;              // micro-tile edge
constexpr int kRedWarp = 32;        // threads per entry of the second pass

__device__ __forceinline__ float fma_t(float a, float b, float c) {
    return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_t(double a, double b, double c) {
    return fma(a, b, c);
}

// shared memory of the main pass: p rows of R, sg rows of y and of d, a
// zero row, and the slices' sums (kGThreads micro-tiles)
size_t smem_bytes(size_t itemsize, int p, int sg) {
    return itemsize * (static_cast<size_t>(p + 2 * sg + 1) * kGLd
                       + kGThreads * kMT * kMT);
}

// micro-tiles summed per sample: all nt^2 under bf16 (RND), else the nt
// (nt + 1) / 2 on or above the diagonal
__device__ __forceinline__ int n_tiles(int nt, bool rnd) {
    return rnd ? nt * nt : nt * (nt + 1) / 2;
}

// row and column of micro-tile t, row by row (from the diagonal on when
// only the upper triangle is summed)
__device__ __forceinline__ void tile_at(int t, int nt, bool rnd, int& tr,
                                        int& tc) {
    if (rnd) {
        tr = t / nt;
        tc = t % nt;
        return;
    }
    tr = 0;
    while (t >= nt - tr) t -= nt - tr++;
    tc = tr + t;
}

// whether entry (rr, cc) of X_s is stored: the upper triangle (G's, b in
// column p, ydy), or under bf16 every entry but column p above row p
__device__ __forceinline__ bool stored(int rr, int cc, int p, bool rnd) {
    if (rr > p || cc > p) return false;
    return rnd ? !(rr < p && cc == p) : rr <= cc;
}

// the partial buffer's row of entry (rr, cc) of sample s; -1 for the
// entries not stored
__device__ __forceinline__ int64_t entry_row(int s, int rr, int cc, int p,
                                             bool rnd) {
    if (!stored(rr, cc, p, rnd)) return -1;
    return (static_cast<int64_t>(s) * (p + 1) + rr) * (p + 1) + cc;
}

template <typename T, typename TD, bool RND>
__global__ void __launch_bounds__(kGThreads)
grams_kernel(const TD* __restrict__ yt, const TD* __restrict__ dt,
             const TD* __restrict__ rt, T* __restrict__ partials, int64_t n,
             int n_s, int p, int sg, int64_t chunk_sites, int n_chunks) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int nt = (p + 1 + kMT - 1) / kMT;     // micro-tiles per edge
    const int tiles = n_tiles(nt, RND);
    const int s0 = blockIdx.x * sg;
    const int sgc = sg < n_s - s0 ? sg : n_s - s0;
    const int chunk = blockIdx.y;
    const int64_t lo = chunk * chunk_sites;
    const int64_t hi = lo + chunk_sites < n ? lo + chunk_sites : n;
    T* s_r = reinterpret_cast<T*>(smem_raw);    // p rows: R
    T* s_y = s_r + p * kGLd;                    // sgc rows: y
    T* s_d = s_y + sg * kGLd;                   // sgc rows: d
    T* s_z = s_d + sg * kGLd;                   // a zero row
    T* s_red = s_z + kGLd;                      // the slices' sums
    const int tid = threadIdx.x;
    for (int j = tid; j < kGLd; j += kGThreads) s_z[j] = T(0);
    const int n_rows = p + 2 * sgc;
    const int n_tasks = sgc * tiles;

    // tasks (sample, micro-tile) in passes of at most kGThreads
    for (int t0 = 0; t0 < n_tasks; t0 += kGThreads) {
        const int in_pass = n_tasks - t0 < kGThreads ? n_tasks - t0
                                                     : kGThreads;
        const int slices = kGThreads / in_pass;
        const int k = tid % slices;
        const int tl = tid / slices;
        const bool active = tl < in_pass;
        const int task = t0 + (active ? tl : 0);
        const int sl = task / tiles;
        int tr, tc;
        tile_at(task % tiles, nt, RND, tr, tc);
        // left and right factors: rows of x_s = [R; y_s], past row p the
        // zero row; the left ones are multiplied by d_s per site
        const T* lrow[kMT];
        const T* rrow[kMT];
#pragma unroll
        for (int a = 0; a < kMT; ++a) {
            const int r = tr * kMT + a;
            const int c = tc * kMT + a;
            const T* y_row = s_y + sl * kGLd;
            lrow[a] = r < p ? s_r + r * kGLd : (r == p ? y_row : s_z);
            rrow[a] = c < p ? s_r + c * kGLd : (c == p ? y_row : s_z);
        }
        const T* drow = s_d + sl * kGLd;
        T acc[kMT][kMT];
#pragma unroll
        for (int a = 0; a < kMT; ++a)
#pragma unroll
            for (int b = 0; b < kMT; ++b) acc[a][b] = T(0);

        for (int64_t j0 = lo; j0 < hi; j0 += kGTile) {
            __syncthreads();             // the previous tile's sums done
            for (int idx = tid; idx < n_rows * kGTile; idx += kGThreads) {
                const int r = idx / kGTile;
                const int j = idx % kGTile;
                const int64_t site = j0 + j;
                const TD* src;
                T* dst;
                if (r < p) {
                    src = rt + r * n;
                    dst = s_r + r * kGLd;
                } else if (r < p + sgc) {
                    src = yt + (s0 + r - p) * n;
                    dst = s_y + (r - p) * kGLd;
                } else {
                    src = dt + (s0 + r - p - sgc) * n;
                    dst = s_d + (r - p - sgc) * kGLd;
                }
                dst[j] = site < hi ? dm::to_state(src[site]) : T(0);
            }
            __syncthreads();
            if (active) {
                for (int j = k; j < kGTile; j += slices) {
                    const T d = drow[j];
                    T L[kMT], R[kMT];
#pragma unroll
                    for (int a = 0; a < kMT; ++a) {
                        // the Pallas body's r d_s and d y, bf16 under RND
                        L[a] = lrow[a][j] * d;
                        if constexpr (RND) L[a] = dm::bf16r(L[a]);
                        R[a] = rrow[a][j];
                    }
#pragma unroll
                    for (int a = 0; a < kMT; ++a)
#pragma unroll
                        for (int b = 0; b < kMT; ++b)
                            acc[a][b] = fma_t(L[a], R[b], acc[a][b]);
                }
            }
        }

        // the pass's entries: the slices' sums added in slice order
        if (slices > 1) {
            if (active)
#pragma unroll
                for (int a = 0; a < kMT; ++a)
#pragma unroll
                    for (int b = 0; b < kMT; ++b)
                        s_red[(tl * kMT * kMT + a * kMT + b) * slices + k] =
                            acc[a][b];
            __syncthreads();
            for (int e = tid; e < in_pass * kMT * kMT; e += kGThreads) {
                T sum = T(0);
                for (int kk = 0; kk < slices; ++kk)
                    sum += s_red[e * slices + kk];
                const int et = t0 + e / (kMT * kMT);
                const int a = (e / kMT) % kMT, b = e % kMT;
                int er, ec;
                tile_at(et % tiles, nt, RND, er, ec);
                const int64_t row = entry_row(s0 + et / tiles, er * kMT + a,
                                              ec * kMT + b, p, RND);
                if (row >= 0) partials[row * n_chunks + chunk] = sum;
            }
            __syncthreads();             // s_red is free for the next pass
        } else if (active) {
#pragma unroll
            for (int a = 0; a < kMT; ++a)
#pragma unroll
                for (int b = 0; b < kMT; ++b) {
                    const int64_t row = entry_row(s0 + sl, tr * kMT + a,
                                                  tc * kMT + b, p, RND);
                    if (row >= 0) partials[row * n_chunks + chunk] = acc[a][b];
                }
        }
    }
}

// Second pass: one warp per stored entry sums its row of the partial
// buffer over the chunks in a fixed order (strided, then a fixed tree)
// and writes it to G (and its mirror, in float32 and float64), b or ydy.
template <typename T, bool RND>
__global__ void __launch_bounds__(kRedWarp)
grams_reduce_kernel(const T* __restrict__ partials, T* __restrict__ G,
                    T* __restrict__ b, T* __restrict__ ydy, int n_s, int p,
                    int n_chunks) {
    const int p1 = p + 1;
    const int r = blockIdx.x;
    const int s = r / (p1 * p1);
    const int rr = (r / p1) % p1;
    const int cc = r % p1;
    if (!stored(rr, cc, p, RND)) return;
    const T* row = partials + static_cast<int64_t>(r) * n_chunks;
    T acc = T(0);
    for (int c = threadIdx.x; c < n_chunks; c += kRedWarp) acc += row[c];
#pragma unroll
    for (int off = kRedWarp / 2; off > 0; off >>= 1)
        acc += __shfl_down_sync(dm::kFull, acc, off);
    if (threadIdx.x != 0) return;
    T* gs = G + static_cast<int64_t>(s) * p * p;
    if (rr < p && cc < p) {
        gs[rr * p + cc] = acc;
        if (!RND) gs[cc * p + rr] = acc;
    } else if (rr < p) {
        b[static_cast<int64_t>(rr) * n_s + s] = acc;     // column p
    } else if (cc < p) {
        b[static_cast<int64_t>(cc) * n_s + s] = acc;     // row p (bf16)
    } else {
        ydy[s] = acc;
    }
}

template <typename T, typename TD, bool RND>
int launch(const void* yt, const void* dt, const void* rt, void* partials,
           void* G, void* b, void* ydy, int64_t n, int n_s, int p, int sg,
           long long chunk_sites, int n_chunks, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (n < 1 || n_s < 1 || p < 1 || sg < 1 || chunk_sites % kGTile != 0
        || (n + chunk_sites - 1) / chunk_sites != n_chunks)
        return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = smem_bytes(sizeof(T), p, sg);
    auto kern = grams_kernel<T, TD, RND>;
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    const dim3 grid((n_s + sg - 1) / sg, n_chunks);
    kern<<<grid, kGThreads, smem, st>>>(
        static_cast<const TD*>(yt), static_cast<const TD*>(dt),
        static_cast<const TD*>(rt), static_cast<T*>(partials), n, n_s, p,
        sg, chunk_sites, n_chunks);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const int n_entries = n_s * (p + 1) * (p + 1);
    grams_reduce_kernel<T, RND><<<n_entries, kRedWarp, 0, st>>>(
        static_cast<const T*>(partials), static_cast<T*>(G),
        static_cast<T*>(b), static_cast<T*>(ydy), n_s, p, n_chunks);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The main pass's shared memory in bytes at p rows and sample groups of
// sg (itemsize: the accumulation type's), which the wrapper's plan
// matches.
long long dm_grams_smem(int itemsize, int p, int sg) {
    return static_cast<long long>(smem_bytes(itemsize, p, sg));
}

// yt, dt (n_s, n), rt (p, n) of the data type; partials
// (n_s (p + 1)^2, n_chunks), G (n_s, p, p), b (p, n_s), ydy (n_s,) of the
// accumulation type (float32 for bf16 data)
#define DM_K8_ENTRY(NAME, T, TD, RND)                                        \
    int NAME(const void* yt, const void* dt, const void* rt, void* partials, \
             void* G, void* b, void* ydy, long long n, int n_s, int p,       \
             int sg, long long chunk_sites, int n_chunks, void* stream) {    \
        return launch<T, TD, RND>(yt, dt, rt, partials, G, b, ydy, n, n_s,   \
                                  p, sg, chunk_sites, n_chunks, stream);     \
    }
DM_K8_ENTRY(dm_grams_f32, float, float, false)
DM_K8_ENTRY(dm_grams_f64, double, double, false)
DM_K8_ENTRY(dm_grams_bf16, float, __nv_bfloat16, true)
#undef DM_K8_ENTRY

}  // extern "C"
