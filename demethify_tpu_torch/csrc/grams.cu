// K8: the per-sample Gram system on the H100's tensor cores.
//
// Replaces the Pallas kernel demethify_tpu/ops/pallas_kernels.py
// :: _gram_kernel (called through grams). From Yt, Dt (n_s, N) and
// Rt (p, N) it sums, for every sample s,
//
//   G[s] = R' diag(d_s) R       G[s][q][r] = sum_i d_si r_qi r_ri
//   b[:, s] = R' (d_s y_s)      b[q][s]    = sum_i (d_si y_si) r_qi
//   ydy[s] = y_s' D y_s         ydy[s]     = sum_i (d_si y_si) y_si
//
// in the accumulation type (float32 for bf16 data).
//
// What bounds it on an H100: bytes at few cell types, operations at
// many. It reads Y, D and R once: at 1M sites x 10 samples, p = 6, in
// float32 104 MB, 31 us at 3.35 TB/s, against 0.6 GFLOP; at 1M x 100,
// p = 29, 0.92 GB (0.27 ms) against 94 GFLOP, which is 0.57 ms at the
// tensor cores' float32 rate through 3xTF32 (three TF32 products a
// float32 product, 495 / 3 TFLOP/s): operations. float64 (DMMA) is held
// to 67 TFLOP/s (1.40 ms there), bf16 data (its 177 GFLOP) to 989 TFLOP/s
// (0.18 ms). mma.sync reaches less on this card (measured: TF32 m16n8k8
// and bf16 m16n8k16 0.57 MMAs a clock an SM, about 62% of those peaks;
// DMMA m8n8k4 0.24, about 48%), so the float64 cohort sum cannot take
// less than about 3 ms on this route.
//
// Forms, by data type:
// - float32 and float64, the pair form: G[s][(q, r)] = sum_i d_si P_i,qr
//   with P_i,qr = r_qi r_ri for q <= r is one product of D (n_s x N) and
//   the pair matrix P (N x p (p + 1) / 2); b = (D * Y) R' is a second one
//   in the same loop (its columns are pairs of r_q with a row of ones,
//   in warp tiles of their own, so each warp's A operand is fixed); ydy
//   is summed elementwise on the CUDA cores while the tile is converted.
//   A block holds a group of samples (32 at most: its sums live in
//   registers) and all columns; P is formed in registers, per lane, once
//   per block and tile, and shared by the group's samples. R is staged
//   once per group: at the cohort shape four groups, whose blocks for one
//   chunk of sites run next to one another, so R comes from device memory
//   once and from L2 for the others (the 52,800 sums of all 100 samples
//   do not fit one SM's registers).
//   float32 takes 3xTF32: every factor is split as hi = tf32(a) (round to
//   nearest, ties away, by integer ops: cvt.rna runs at the conversion
//   rate) and lo = a - hi cut to TF32, and each product is hi hi + hi lo
//   + lo hi on mma.sync m16n8k8 (plain TF32 is the float32 Gram bound's
//   risk). float64 takes DMMA (mma.sync m8n8k4, full float64 products).
// - bf16 data, the per-sample form: the JAX program rounds r_q d_s and
//   d y to bf16 (dot operands) and sums (d y) y unrounded, so with
//   x_s = [R; y_s] ((p + 1) rows) every entry of X_s = bf16(x d_s)' x is
//   summed, as the Pallas body sums it: G in its first p rows and
//   columns, b in its last row (left factor bf16(d y)), ydy in its
//   corner; the column p above ydy is not stored. Left factors are formed
//   per lane as bf16x2 products rounded to nearest (fma.rn.bf16x2 with
//   -0: exact products of bf16 values rounded once, as bf16(r d) is),
//   the right ones read as they are, on mma.sync m16n8k16 (float32
//   products of bf16 values are exact). A block holds up to 16 samples,
//   one warp each; R is staged once per tile for all of them.
// mma.sync, not wgmma: wgmma takes 64-row tiles, and here the rows are
// samples (10 at the main shape) or the p + 1 <= 32 rows of X_s, so most
// of a 64-row tile would be padding; mma.sync's 16- and 8-row tiles
// waste at most 15 rows.
//
// The tensor cores' float32 sums truncate, about an ulp an MMA, all
// downward, so no MMA chain runs long: float32 accumulates one tile's
// k-steps (at most 48 MMAs, under 6e-6 of the tile's sum), bf16 two
// k-steps (32 sites) from zero, and each chain is then added into float32
// running sums on the CUDA cores, which round to nearest. float64 chains
// its DMMAs (they round as float64 fused multiply-adds).
//
// Staging: a ring of 2-4 tile stages in shared memory fed by cp.async
// (16-byte copies, .cg), so the next tiles' loads are in flight while
// the tensor cores work. Every row copies the 16-byte-aligned chunks
// that hold its tile's elements and keeps its element offset (a table
// per block), so a ragged N (rows not 16-byte aligned) takes the same
// route; a chunk holding a row's element lies in that element's page, so
// no copy faults past the array. (1-D bulk copies on the copy engine,
// one a row and tile, measured slower here.) Each tile is converted into
// one of two operand buffers (split into hi and lo under float32, zero
// past the chunk's end) laid out for conflict-free fragment loads: under
// float32 each lane's A fragment is one 16-byte hi and one lo load; within
// a k-step, slot t of a lane holds site 2t and slot t + 4 site 2t + 1. In
// each step every warp converts its share of the next tile and runs its
// MMAs on this one, one barrier a tile, so one warp's conversion overlaps
// another's tensor-core work.
//
// Blocks run in any order on 132 SMs: each owns a chunk of sites (one
// block per SM in all, two where the groups' work differs) and writes its
// sums to one row of a (n_chunks, n_s E) partial buffer; a second kernel
// sums each entry over the chunks in a fixed order. When a block has
// fewer warp tiles than warps, its warps split the k-steps of every tile
// (slices) and add their sums in slice order at the end. No atomics: the
// same inputs give the same bits on every run. Those bits are not the
// CUDA-core kernel's this one replaced (another order, split products):
// K8 owes its twin ``grams_plain`` 5e-5 of each output's largest entry
// in float32, 1e-10 in float64, and under bf16 data 1e-6 of the twin's
// rounding summed in float64.
//
// Plain C interface (ctypes): pointers and the stream as void*, launches
// on that stream, allocates nothing, returns a cudaError_t. The wrapper
// plans the groups, slices, tile, ring and chunks
// (ops/cuda_kernels.grams_plan) and allocates the partial buffer.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxSlices = 8;
constexpr int kMaxIt = 2048 / kThreads;   // float64: site pairs a thread
constexpr int kMaxU = 32 / kWarps;        // float32: (m-tile, k-step) a warp
constexpr int kRedEntries = 32;     // entries per block of the second pass
constexpr int kRedLanes = 8;        // chunk lanes per entry there
constexpr int kWN = 4;              // n-tiles per warp tile

enum Kind { kF32 = 0, kF64 = 1, kBF16 = 2 };

__host__ __device__ constexpr int data_size(int kind) {
    return kind == kF64 ? 8 : kind == kF32 ? 4 : 2;
}
__host__ __device__ constexpr int acc_size(int kind) {
    return kind == kF64 ? 8 : 4;
}
// rows of an MMA tile, sites of a k-step, m-tiles of a warp tile and
// accumulators a lane holds per MMA tile
__host__ __device__ constexpr int mma_rows(int kind) {
    return kind == kF64 ? 8 : 16;
}
__host__ __device__ constexpr int k_sites(int kind) {
    return kind == kF64 ? 4 : kind == kF32 ? 8 : 16;
}
__host__ __device__ constexpr int warp_m(int kind) {
    return kind == kF64 ? 4 : 2;
}
__host__ __device__ constexpr int acc_regs(int kind) {
    return kind == kF64 ? 2 : 4;
}

struct Plan {
    long long n, chunk_sites;
    int n_s, p;
    int tile, stages;       // sites per staged tile; ring stages
    int group_samples;      // samples a block holds (the last group fewer)
    int col_groups;         // float32/float64: blocks across the columns
    int items;              // warp tiles a block holds
    int slices;             // warps splitting each warp tile's k-steps
    int n_chunks;
};

// Shared memory of the main pass in bytes: the ring, two operand
// buffers (one converted while the other feeds the MMAs), the rows'
// table, and (reusing them at a chunk's end) the ydy and slice sums.
struct Layout {
    int rows;               // staged rows: D, Y (group_samples each), R
    int ldb;                // bytes of a staged row
    int a_rows;             // float32/float64: A rows (padded samples)
    int lda, ldr;           // operand row strides in elements
    long long ring, ops, tab, ydy, slice;
    __host__ __device__ long long total() const {
        const long long main = ring + 2 * ops + tab;
        const long long end = ydy > slice ? ydy : slice;
        return main > end ? main : end;
    }
};

__host__ __device__ inline Layout layout(int kind, int p, int group_samples,
                                         int tile, int stages, int items,
                                         int slices) {
    Layout l;
    l.rows = 2 * group_samples + p;
    l.ldb = tile * data_size(kind) + 16;
    l.ring = static_cast<long long>(stages) * l.rows * l.ldb;
    if (kind == kBF16) {
        // R rows, then per sample D, Y and bf16(d y) rows, then a zero row
        l.a_rows = l.lda = 0;
        l.ldr = tile + 8;
        l.ops = static_cast<long long>(p + 3 * group_samples + 1) * l.ldr * 2;
        l.ydy = 0;
    } else {
        const int mr = mma_rows(kind);
        l.a_rows = (group_samples + mr - 1) / mr * mr;
        l.lda = kind == kF32 ? 2 * tile : tile + 4;
        l.ldr = kind == kF32 ? tile + 8 : tile + 4;
        // A buffers of D and D * Y; R rows, a row of ones and a zero row
        l.ops = (2LL * l.a_rows * l.lda + static_cast<long long>(p + 2)
                 * l.ldr) * acc_size(kind);
        l.ydy = static_cast<long long>(l.a_rows) * (tile / 2)
                * acc_size(kind);
    }
    l.tab = (12LL * l.rows + 15) / 16 * 16;     // aligned starts, offsets
    l.slice = static_cast<long long>(slices - 1) * items * warp_m(kind) * kWN
              * acc_regs(kind) * 32 * acc_size(kind);
    return l;
}

// ------------------------------------------------------------ primitives

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// waits until at most stages - 2 groups are in flight (the oldest tile
// has landed)
__device__ __forceinline__ void cp_wait_ring(int stages) {
    if (stages == 4)
        asm volatile("cp.async.wait_group 2;\n" ::: "memory");
    else if (stages == 3)
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    else
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// x = hi + lo + O(2^-21 |x|) in TF32 values: hi is x rounded to nearest,
// ties away (half a TF32 ulp added to the magnitude's bits, the low 13
// bits cleared, as cvt.rna.tf32.f32 rounds), lo = x - hi (exact) cut to
// TF32. Integer and float adds run at the full rate; cvt runs at the
// conversion rate, 16 a clock an SM.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
    hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
    lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_f64(double (&c)[2], double a, double b) {
    asm volatile(
        "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
        "{%0,%1}, {%2}, {%3}, {%0,%1};\n"
        : "+d"(c[0]), "+d"(c[1]) : "d"(a), "d"(b));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two bf16 products, each exact and rounded once to nearest
__device__ __forceinline__ uint32_t bf16_mul2(uint32_t a, uint32_t b) {
    uint32_t d;
    asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
        : "=r"(d) : "r"(a), "r"(b), "r"(0x80008000u));
    return d;
}

constexpr uint32_t kBf16One2 = 0x3f803f80u;   // bf16x2 (1, 1)

// pair column c (q <= r, row by row) of p rows
__host__ __device__ __forceinline__ void pair_rows(int c, int p, int& q,
                                                   int& r) {
    q = 0;
    while (c >= p - q) c -= p - q++;
    r = q + c;
}

// ------------------------------------------------------------ staging

// The block's staged rows: D of its samples at [0, G), Y at [G, 2 G), R
// at [2 G, 2 G + p), G the plan's group size (gs of them live).
template <typename TD>
__device__ __forceinline__ const TD* staged_row(
        int r, const TD* yt, const TD* dt, const TD* rt, long long n, int s0,
        int G) {
    if (r < G) return dt + static_cast<long long>(s0 + r) * n;
    if (r < 2 * G) return yt + static_cast<long long>(s0 + r - G) * n;
    return rt + static_cast<long long>(r - 2 * G) * n;
}

__device__ __forceinline__ bool live_row(int r, int G, int gs) {
    return r >= 2 * G || (r < G ? r : r - G) < gs;
}

// Issues the cp.async copies of one tile of every live staged row into a
// stage, one warp a row: the 16-byte chunks from the row's aligned tile
// start (src[r], advanced by whole tiles) that hold its nv sites.
__device__ __forceinline__ void stage_tile(
        unsigned char* stage, const unsigned long long* src,
        const int* off, int rows, int G, int gs, int ldb, int es,
        long long adv, int nv, int warp, int lane) {
    for (int r = warp; r < rows; r += kWarps) {
        if (!live_row(r, G, gs)) continue;
        const int need = ((off[r] + nv) * es + 15) >> 4;
        const unsigned long long a = src[r] + adv;
        unsigned char* dst = stage + r * ldb;
        for (int c = lane; c < need; c += 32)
            cp_async16(dst + c * 16, reinterpret_cast<const void*>(a + c * 16));
    }
}

template <int V>
struct Int {
    static constexpr int value = V;
};

// f(Int<MT>, Int<NT>) for the live m-tiles mt (1..MAXM) and n-tiles nt
// (1..kWN) of a warp tile
template <int MAXM, int NT, class F>
__device__ __forceinline__ void with_m(int mt, F& f) {
    if constexpr (MAXM >= 4)
        if (mt == 4) return f(Int<4>{}, Int<NT>{});
    if constexpr (MAXM >= 3)
        if (mt == 3) return f(Int<3>{}, Int<NT>{});
    if (mt == 2) return f(Int<2>{}, Int<NT>{});
    f(Int<1>{}, Int<NT>{});
}

template <int MAXM, class F>
__device__ __forceinline__ void with_tiles(int mt, int nt, F&& f) {
    if (nt >= 4) with_m<MAXM, 4>(mt, f);
    else if (nt == 3) with_m<MAXM, 3>(mt, f);
    else if (nt == 2) with_m<MAXM, 2>(mt, f);
    else with_m<MAXM, 1>(mt, f);
}

// ---------------------------------------------------------- the k-steps
// One warp's k-steps [k0, k1) (step ks) of a converted tile, branch-free:
// the warp tile's MT live m-tiles and NT live n-tiles (columns past the
// matrix within them read the zero row and are never stored).

// float32: A (the samples' d or d y, split) from `a` in fragment order
// (per m-tile, k-step and lane a hi and a lo quad); B the lane's pair
// products r_q r_r (r_r the ones row for b's columns), split per lane.
// The tile's k-steps accumulate in acc: a chain of at most 48 MMAs, whose
// truncating sums lose at most 48 ulps of the tile's sum, about 6e-6.
template <int MT, int NT>
__device__ __forceinline__ void ksteps_f32(
        float (&acc)[2][kWN][4], const float* __restrict__ a, int mstride,
        const float* __restrict__ r_op, const int (&off_a)[kWN],
        const int (&off_b)[kWN], int lane, int t, int k0, int k1, int ks) {
    for (int kk = k0; kk < k1; kk += ks) {
        uint32_t ah[MT][4], al[MT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m) {
            const float* f = a + m * mstride + kk * 256 + lane * 4;
            const uint4 h = *reinterpret_cast<const uint4*>(f);
            const uint4 l = *reinterpret_cast<const uint4*>(f + 128);
            ah[m][0] = h.x; ah[m][1] = h.y; ah[m][2] = h.z; ah[m][3] = h.w;
            al[m][0] = l.x; al[m][1] = l.y; al[m][2] = l.z; al[m][3] = l.w;
        }
        uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
        for (int i = 0; i < NT; ++i) {
            const int k = kk * 8 + 2 * t;
            const float2 x = *reinterpret_cast<const float2*>(r_op + off_a[i]
                                                              + k);
            const float2 z = *reinterpret_cast<const float2*>(r_op + off_b[i]
                                                              + k);
            split(x.x * z.x, bh[i][0], bl[i][0]);    // slot t: site 2t
            split(x.y * z.y, bh[i][1], bl[i][1]);    // slot t + 4: 2t + 1
        }
        // lo hi, hi lo, hi hi, each over every tile before the next
#pragma unroll
        for (int i = 0; i < NT; ++i)
#pragma unroll
            for (int m = 0; m < MT; ++m)
                mma_tf32(acc[m][i], al[m], bh[i][0], bh[i][1]);
#pragma unroll
        for (int i = 0; i < NT; ++i)
#pragma unroll
            for (int m = 0; m < MT; ++m)
                mma_tf32(acc[m][i], ah[m], bl[i][0], bl[i][1]);
#pragma unroll
        for (int i = 0; i < NT; ++i)
#pragma unroll
            for (int m = 0; m < MT; ++m)
                mma_tf32(acc[m][i], ah[m], bh[i][0], bh[i][1]);
    }
}

// float64: A one value a lane, B the lane's pair product
template <int MT, int NT>
__device__ __forceinline__ void ksteps_f64(
        double (&run)[4][kWN][2], const double* __restrict__ a, int lda,
        const double* __restrict__ r_op, const int (&off_a)[kWN],
        const int (&off_b)[kWN], int g, int t, int k0, int k1, int ks) {
    for (int kk = k0; kk < k1; kk += ks) {
        const int k = kk * 4 + t;
        double av[MT], bv[NT];
#pragma unroll
        for (int m = 0; m < MT; ++m) av[m] = a[(m * 8 + g) * lda + k];
#pragma unroll
        for (int i = 0; i < NT; ++i)
            bv[i] = r_op[off_a[i] + k] * r_op[off_b[i] + k];
#pragma unroll
        for (int i = 0; i < NT; ++i)
#pragma unroll
            for (int m = 0; m < MT; ++m) mma_f64(run[m][i], av[m], bv[i]);
    }
}

// bf16: A rows bf16(r_q d_s) (ud) or bf16(d y) (row p, times one) or
// zero; B columns r_r, y_s (column p) or zero; w the operand buffer in
// bf16 pairs, ro / co / drow word offsets of the lane's rows
template <int MT, int NT>
__device__ __forceinline__ void frags_bf16(
        uint32_t (&a)[MT][4], uint32_t (&b)[NT][2],
        const uint32_t* __restrict__ w, const int (&ro)[2][2],
        const bool (&ud)[2][2], const int (&co)[kWN], int drow, int k) {
    const uint32_t dlo = w[drow + k], dhi = w[drow + k + 4];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
        a[m][0] = bf16_mul2(w[ro[m][0] + k], ud[m][0] ? dlo : kBf16One2);
        a[m][1] = bf16_mul2(w[ro[m][1] + k], ud[m][1] ? dlo : kBf16One2);
        a[m][2] = bf16_mul2(w[ro[m][0] + k + 4], ud[m][0] ? dhi : kBf16One2);
        a[m][3] = bf16_mul2(w[ro[m][1] + k + 4], ud[m][1] ? dhi : kBf16One2);
    }
#pragma unroll
    for (int i = 0; i < NT; ++i) {
        b[i][0] = w[co[i] + k];
        b[i][1] = w[co[i] + k + 4];
    }
}

// two k-steps (32 sites) a chain, from zero, then added into the running
// sums; the tiles' chains interleaved, so no MMA waits on the one before
template <int MT, int NT>
__device__ __forceinline__ void ksteps_bf16(
        float (&run)[2][kWN][4], const uint32_t* __restrict__ w,
        const int (&ro)[2][2], const bool (&ud)[2][2], const int (&co)[kWN],
        int drow, int t, int k0, int k1, int ks) {
    int kk = k0;
    for (; kk + ks < k1; kk += 2 * ks) {
        uint32_t a0[MT][4], b0[NT][2], a1[MT][4], b1[NT][2];
        frags_bf16<MT, NT>(a0, b0, w, ro, ud, co, drow, kk * 8 + t);
        frags_bf16<MT, NT>(a1, b1, w, ro, ud, co, drow, (kk + ks) * 8 + t);
        float c[MT][NT][4];
#pragma unroll
        for (int i = 0; i < NT; ++i)
#pragma unroll
            for (int m = 0; m < MT; ++m) {
#pragma unroll
                for (int q = 0; q < 4; ++q) c[m][i][q] = 0.f;
                mma_bf16(c[m][i], a0[m], b0[i][0], b0[i][1]);
            }
#pragma unroll
        for (int i = 0; i < NT; ++i)
#pragma unroll
            for (int m = 0; m < MT; ++m)
                mma_bf16(c[m][i], a1[m], b1[i][0], b1[i][1]);
#pragma unroll
        for (int i = 0; i < NT; ++i)
#pragma unroll
            for (int m = 0; m < MT; ++m)
#pragma unroll
                for (int q = 0; q < 4; ++q) run[m][i][q] += c[m][i][q];
    }
    if (kk < k1) {
        uint32_t a0[MT][4], b0[NT][2];
        frags_bf16<MT, NT>(a0, b0, w, ro, ud, co, drow, kk * 8 + t);
#pragma unroll
        for (int i = 0; i < NT; ++i)
#pragma unroll
            for (int m = 0; m < MT; ++m) {
                float c[4] = {0.f, 0.f, 0.f, 0.f};
                mma_bf16(c, a0[m], b0[i][0], b0[i][1]);
#pragma unroll
                for (int q = 0; q < 4; ++q) run[m][i][q] += c[q];
            }
    }
}

// ------------------------------------------------------- the main pass

template <int KIND>
struct Types;
template <> struct Types<kF32> { using TD = float; using T = float; };
template <> struct Types<kF64> { using TD = double; using T = double; };
template <> struct Types<kBF16> { using TD = __nv_bfloat16; using T = float; };

template <int KIND>
__global__ void __launch_bounds__(kThreads, 1)
grams_kernel(const typename Types<KIND>::TD* __restrict__ yt,
             const typename Types<KIND>::TD* __restrict__ dt,
             const typename Types<KIND>::TD* __restrict__ rt,
             typename Types<KIND>::T* __restrict__ partials, Plan pl,
             int np, int nt, int mts_s, int e_s) {
    using TD = typename Types<KIND>::TD;
    using T = typename Types<KIND>::T;
    constexpr int MR = mma_rows(KIND);
    constexpr int KS = k_sites(KIND);
    constexpr int WM = warp_m(KIND);
    constexpr int ACC = acc_regs(KIND);
    constexpr int ES = static_cast<int>(sizeof(TD));
    extern __shared__ __align__(16) unsigned char smem[];

    const Layout L = layout(KIND, pl.p, pl.group_samples, pl.tile,
                            pl.stages, pl.items, pl.slices);
    const int p = pl.p, G = pl.group_samples, tile = pl.tile;
    const int n_s = pl.n_s;
    const int sgi = blockIdx.x / pl.col_groups;
    const int cg = blockIdx.x - sgi * pl.col_groups;
    const int s0 = sgi * G;
    const int gs = G < n_s - s0 ? G : n_s - s0;
    const int chunk = blockIdx.y;
    const long long lo = chunk * pl.chunk_sites;
    const long long hi = lo + pl.chunk_sites < pl.n ? lo + pl.chunk_sites
                                                    : pl.n;
    const int n_tiles = static_cast<int>((hi - lo + tile - 1) / tile);
    const long long E = static_cast<long long>(n_s) * e_s;
    T* __restrict__ out = partials + chunk * E;
    const int half = tile / 2;
    const int hsh = 31 - __clz(half);                    // log2(half)

    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int item = warp % pl.items;
    const int slice = warp / pl.items;
    bool active = slice < pl.slices;
    const int stage_bytes = L.rows * L.ldb;

    // operand buffer b at ops + b L.ops: f32/f64 A of d, A of d y, then R
    // rows with the ones and zero rows; bf16 R, d, y, bf16(d y) rows and
    // the zero row
    unsigned char* const ops = smem + L.ring;
    auto a_of = [&](int buf) { return reinterpret_cast<T*>(ops + buf * L.ops); };
    auto r_of = [&](int buf) { return a_of(buf) + 2 * L.a_rows * L.lda; };
    // the rows' aligned tile-0 starts and element offsets
    unsigned long long* const tab_src =
        reinterpret_cast<unsigned long long*>(ops + 2 * L.ops);
    int* const tab_off = reinterpret_cast<int*>(tab_src + L.rows);

    // ---- the warp's tile, fixed per block
    int mts = 0, nts = 0;       // live m-tiles and n-tiles of the warp tile
    int t0 = 0;                 // its first n-tile (f32/f64: of its kind)
    int mt0 = 0, sb = 0;        // bf16: its first m-tile of X_s, its sample
    bool wb = false;            // f32/f64: its columns are b's (A = d y)
    int off_a[kWN], off_b[kWN]; // f32/f64: R rows of the lane's pair
    int ro[2][2] = {{0, 0}, {0, 0}};   // bf16: A rows, in bf16 pairs
    bool ud[2][2] = {{false, false}, {false, false}};
    int drow = 0;
    if constexpr (KIND != kBF16) {
        mts = (gs + MR - 1) / MR;
        const int np_t = (np + 7) / 8;
        const int nrp = (np_t + kWN - 1) / kWN;
        const int nrb = (p + 8 * kWN - 1) / (8 * kWN);
        const int nr = cg * pl.items + item;
        if (nr >= nrp + nrb) active = false;
        wb = nr >= nrp;
        t0 = (wb ? nr - nrp : nr) * kWN;
        nts = (wb ? (p + 7) / 8 : np_t) - t0;
        nts = nts < kWN ? nts : kWN;
#pragma unroll
        for (int i = 0; i < kWN; ++i) {
            const int c = (t0 + i) * 8 + g;
            int q = p + 1, r = p + 1;           // the zero row
            if (!wb) {
                if (c < np) pair_rows(c, p, q, r);
            } else {
                q = c < p ? c : p + 1;
                r = p;                          // the row of ones
            }
            off_a[i] = q * L.ldr;
            off_b[i] = r * L.ldr;
        }
    } else {
        // item -> (sample, tile of X_s); rows past p + 1 read the zero row
        const int nrs = (nt + kWN - 1) / kWN;
        const int tps = (mts_s + WM - 1) / WM * nrs;
        sb = item / tps;
        const int tl = item - sb * tps;
        mt0 = tl / nrs * WM;
        t0 = (tl - tl / nrs * nrs) * kWN;
        if (sb >= gs) active = false;
        mts = mts_s - mt0 < WM ? mts_s - mt0 : WM;
        nts = nt - t0 < kWN ? nt - t0 : kWN;
        const int zero = (p + 3 * G) * L.ldr;
        drow = (p + sb) * L.ldr / 2;
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int q = (mt0 + m) * 16 + g + 8 * h;
                ro[m][h] = (q < p ? q * L.ldr
                                  : q == p ? (p + 2 * G + sb) * L.ldr
                                           : zero) / 2;
                ud[m][h] = q < p;
            }
#pragma unroll
        for (int i = 0; i < kWN; ++i) {
            const int r = (t0 + i) * 8 + g;
            off_b[i] = (r < p ? r * L.ldr : r == p ? (p + G + sb) * L.ldr
                                                   : zero) / 2;
        }
    }

    // the table and the constant rows of both operand buffers: ones and
    // zeros (f32/f64), zeros (bf16)
    for (int r = tid; r < L.rows; r += kThreads) {
        if (!live_row(r, G, gs)) continue;
        const uintptr_t a = reinterpret_cast<uintptr_t>(
            staged_row(r, yt, dt, rt, pl.n, s0, G) + lo);
        tab_src[r] = a & ~static_cast<uintptr_t>(15);
        tab_off[r] = static_cast<int>((a & 15) / ES);
    }
    for (int buf = 0; buf < 2; ++buf) {
        if constexpr (KIND != kBF16) {
            T* r_op = r_of(buf);
            for (int j = tid; j < L.ldr; j += kThreads) {
                r_op[p * L.ldr + j] = T(1);
                r_op[(p + 1) * L.ldr + j] = T(0);
            }
        } else {
            __nv_bfloat16* b_op = reinterpret_cast<__nv_bfloat16*>(
                ops + buf * L.ops);
            for (int j = tid; j < L.ldr; j += kThreads)
                b_op[(p + 3 * G) * L.ldr + j] = __float2bfloat16_rn(0.0f);
        }
    }
    __syncthreads();

    T run[WM][kWN][ACC];
#pragma unroll
    for (int m = 0; m < WM; ++m)
#pragma unroll
        for (int i = 0; i < kWN; ++i)
#pragma unroll
            for (int a = 0; a < ACC; ++a) run[m][i][a] = T(0);
    T ydy[kMaxIt];
#pragma unroll
    for (int it = 0; it < kMaxIt; ++it) ydy[it] = T(0);

    auto sites = [&](int ti) {
        const long long j0 = lo + static_cast<long long>(ti) * tile;
        return static_cast<int>(hi - j0 < tile ? hi - j0 : tile);
    };
    auto issue = [&](int ti) {
        if (ti < n_tiles)
            stage_tile(smem + (ti % pl.stages) * stage_bytes, tab_src,
                       tab_off, L.rows, G, gs, L.ldb, ES,
                       static_cast<long long>(ti) * tile * ES, sites(ti),
                       warp, lane);
        cp_commit();
    };

    // ---- converts tile ti (landed) into operand buffer ti % 2
    auto convert = [&](int ti) {
        const int nv = sites(ti);
        const unsigned char* st = smem + (ti % pl.stages) * stage_bytes;
        auto row_of = [&](int r) {
            return reinterpret_cast<const TD*>(st + r * L.ldb) + tab_off[r];
        };
        if constexpr (KIND == kF32) {
            // one warp a (m-tile, k-step): each lane converts its own
            // fragment, rows g and g + 8 at sites 2t and 2t + 1
            float* const a_d = a_of(ti & 1);
            float* const a_dy = a_d + L.a_rows * L.lda;
            const int ksh = hsh - 2;                // log2(k-steps a tile)
#pragma unroll
            for (int it = 0; it < kMaxU; ++it) {
                const int u = warp + it * kWarps;
                if (u < (L.a_rows >> 4) << ksh) {
                    const int m = u >> ksh;
                    const int j = (u & ((1 << ksh) - 1)) * 8 + 2 * t;
                    float d[2][2], dy[2][2];
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        const int sr = m * 16 + g + 8 * h;
                        float y0 = 0.f, y1 = 0.f;
                        d[h][0] = d[h][1] = 0.f;
                        if (sr < gs) {
                            const TD* dr = row_of(sr);
                            const TD* yr = row_of(G + sr);
                            if (j < nv) { d[h][0] = dr[j]; y0 = yr[j]; }
                            if (j + 1 < nv) {
                                d[h][1] = dr[j + 1];
                                y1 = yr[j + 1];
                            }
                        }
                        dy[h][0] = d[h][0] * y0;
                        dy[h][1] = d[h][1] * y1;
                        ydy[2 * it + h] += dy[h][0] * y0;
                        ydy[2 * it + h] += dy[h][1] * y1;
                    }
                    // a0..a3: (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
                    auto frag = [&](float (&v)[2][2], float* base) {
                        uint32_t h[4], l[4];
                        split(v[0][0], h[0], l[0]);
                        split(v[1][0], h[1], l[1]);
                        split(v[0][1], h[2], l[2]);
                        split(v[1][1], h[3], l[3]);
                        float* f = base + u * 256 + lane * 4;
                        *reinterpret_cast<uint4*>(f) =
                            make_uint4(h[0], h[1], h[2], h[3]);
                        *reinterpret_cast<uint4*>(f + 128) =
                            make_uint4(l[0], l[1], l[2], l[3]);
                    };
                    frag(d, a_d);
                    frag(dy, a_dy);
                }
            }
        } else if constexpr (KIND == kF64) {
            T* const a_d = a_of(ti & 1);
            T* const a_dy = a_d + L.a_rows * L.lda;
#pragma unroll
            for (int it = 0; it < kMaxIt; ++it) {
                const int idx = tid + it * kThreads;
                if (idx < L.a_rows << hsh) {
                    const int s = idx >> hsh;
                    const int jp = idx & (half - 1);
                    const int j = 2 * jp;
                    T d0 = T(0), d1 = T(0), y0 = T(0), y1 = T(0);
                    if (s < gs) {
                        const TD* dr = row_of(s);
                        const TD* yr = row_of(G + s);
                        if (j < nv) { d0 = dr[j]; y0 = yr[j]; }
                        if (j + 1 < nv) { d1 = dr[j + 1]; y1 = yr[j + 1]; }
                    }
                    const T dy0 = d0 * y0, dy1 = d1 * y1;
                    ydy[it] += dy0 * y0;
                    ydy[it] += dy1 * y1;
                    a_d[s * L.lda + j] = d0;
                    a_d[s * L.lda + j + 1] = d1;
                    a_dy[s * L.lda + j] = dy0;
                    a_dy[s * L.lda + j + 1] = dy1;
                }
            }
        }
        if constexpr (KIND != kBF16) {
            T* const r_op = r_of(ti & 1);
            for (int idx = tid; idx < p << hsh; idx += kThreads) {
                const int q = idx >> hsh;
                const int j = 2 * (idx & (half - 1));
                const TD* rr = row_of(2 * G + q);
                r_op[q * L.ldr + j] = j < nv ? rr[j] : T(0);
                r_op[q * L.ldr + j + 1] = j + 1 < nv ? rr[j + 1] : T(0);
            }
        }
        if constexpr (KIND == kBF16) {
            // R rows as they are; per sample d, y and bf16(d y)
            const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
            uint32_t* w = reinterpret_cast<uint32_t*>(ops + (ti & 1) * L.ops);
            for (int idx = tid; idx < (p + gs) << hsh; idx += kThreads) {
                const int row = idx >> hsh;
                const int j = 2 * (idx & (half - 1));
                if (row < p) {
                    const TD* rr = row_of(2 * G + row);
                    __nv_bfloat162 r2;
                    r2.x = j < nv ? rr[j] : zero;
                    r2.y = j + 1 < nv ? rr[j + 1] : zero;
                    w[(row * L.ldr + j) / 2] =
                        *reinterpret_cast<uint32_t*>(&r2);
                } else {
                    const int s = row - p;
                    const TD* dr = row_of(s);
                    const TD* yr = row_of(G + s);
                    __nv_bfloat162 d2, y2;
                    d2.x = j < nv ? dr[j] : zero;
                    d2.y = j + 1 < nv ? dr[j + 1] : zero;
                    y2.x = j < nv ? yr[j] : zero;
                    y2.y = j + 1 < nv ? yr[j + 1] : zero;
                    const uint32_t du = *reinterpret_cast<uint32_t*>(&d2);
                    const uint32_t yu = *reinterpret_cast<uint32_t*>(&y2);
                    w[((p + s) * L.ldr + j) / 2] = du;
                    w[((p + G + s) * L.ldr + j) / 2] = yu;
                    w[((p + 2 * G + s) * L.ldr + j) / 2] = bf16_mul2(du, yu);
                }
            }
        }
    };

    // ---- the tensor cores on tile ti's k-steps (operand buffer ti % 2)
    auto mma = [&](int ti) {
        const int k1 = tile / KS;
        if constexpr (KIND == kF32) {
            const float* a = a_of(ti & 1) + (wb ? L.a_rows * L.lda : 0);
            const float* r_op = r_of(ti & 1);
            float acc[2][kWN][4];
#pragma unroll
            for (int m = 0; m < 2; ++m)
#pragma unroll
                for (int i = 0; i < kWN; ++i)
#pragma unroll
                    for (int q = 0; q < 4; ++q) acc[m][i][q] = 0.f;
            with_tiles<WM>(mts, nts, [&](auto m, auto n) {
                ksteps_f32<decltype(m)::value, decltype(n)::value>(
                    acc, a, 16 * L.lda, r_op, off_a, off_b, lane, t, slice,
                    k1, pl.slices);
            });
            // the tile's sums into the running sums, rounding to nearest
#pragma unroll
            for (int m = 0; m < 2; ++m)
#pragma unroll
                for (int i = 0; i < kWN; ++i)
#pragma unroll
                    for (int q = 0; q < 4; ++q) run[m][i][q] += acc[m][i][q];
        } else if constexpr (KIND == kF64) {
            const double* a = a_of(ti & 1) + (wb ? L.a_rows * L.lda : 0);
            const double* r_op = r_of(ti & 1);
            with_tiles<WM>(mts, nts, [&](auto m, auto n) {
                ksteps_f64<decltype(m)::value, decltype(n)::value>(
                    run, a, L.lda, r_op, off_a, off_b, g, t, slice, k1,
                    pl.slices);
            });
        } else {
            const uint32_t* w = reinterpret_cast<const uint32_t*>(
                ops + (ti & 1) * L.ops);
            with_tiles<WM>(mts, nts, [&](auto m, auto n) {
                ksteps_bf16<decltype(m)::value, decltype(n)::value>(
                    run, w, ro, ud, off_b, drow, t, slice, k1, pl.slices);
            });
        }
    };

    // ---- the ring (stages - 1 tiles in flight ahead of the one being
    // converted) and the two operand buffers: in each step every warp
    // converts its share of tile ti + 1 and runs its MMAs on tile ti, so
    // one warp's conversion overlaps another's tensor-core work
    for (int i = 0; i < pl.stages; ++i) {
        if (i == pl.stages - 1) {
            cp_wait_ring(pl.stages);            // tile 0 landed
            __syncthreads();
            convert(0);
        }
        issue(i);
    }
    for (int ti = 0; ti < n_tiles; ++ti) {
        cp_wait_ring(pl.stages);                // tile ti + 1 landed
        // tile ti's operands are converted; tile ti - 1's MMAs are done
        // with buffer (ti + 1) % 2; tile ti's stage is free
        __syncthreads();
        issue(ti + pl.stages);
        if (ti + 1 < n_tiles) convert(ti + 1);
        if (active) mma(ti);
    }

    // ---- the chunk's end: ydy, the slices' sums, the partial row
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    T* const scr = reinterpret_cast<T*>(smem);
    if constexpr (KIND == kF32) {
        // each lane's sums of rows g and g + 8 in its (m-tile, k-step)
        // units; a sample's: its units in k-step order, lanes in t order
        const int ksh = hsh - 2;
#pragma unroll
        for (int it = 0; it < kMaxU; ++it) {
            const int u = warp + it * kWarps;
            if (u < (L.a_rows >> 4) << ksh) {
                scr[(u * 32 + lane) * 2] = ydy[2 * it];
                scr[(u * 32 + lane) * 2 + 1] = ydy[2 * it + 1];
            }
        }
        __syncthreads();
        if (cg == 0 && tid < gs) {
            const int m = tid >> 4, gg = tid & 7, h = (tid >> 3) & 1;
            T sum = T(0);
            for (int kk = 0; kk < 1 << ksh; ++kk)
                for (int tt = 0; tt < 4; ++tt)
                    sum += scr[((((m << ksh) + kk) * 32 + gg * 4 + tt) << 1)
                               + h];
            out[static_cast<long long>(s0 + tid) * e_s + e_s - 1] = sum;
        }
        __syncthreads();
    } else if constexpr (KIND == kF64) {
#pragma unroll
        for (int it = 0; it < kMaxIt; ++it) {
            const int idx = tid + it * kThreads;
            if (idx < L.a_rows << hsh) scr[idx] = ydy[it];
        }
        __syncthreads();
        if (cg == 0 && tid < gs) {
            T sum = T(0);
            for (int jp = 0; jp < half; ++jp) sum += scr[(tid << hsh) + jp];
            out[static_cast<long long>(s0 + tid) * e_s + e_s - 1] = sum;
        }
        __syncthreads();
    }
    constexpr int REG = WM * kWN * ACC;
    if (pl.slices > 1) {
        if (active && slice > 0) {
            T* dst = scr + ((slice - 1) * pl.items + item) * REG * 32 + lane;
#pragma unroll
            for (int m = 0; m < WM; ++m)
#pragma unroll
                for (int i = 0; i < kWN; ++i)
#pragma unroll
                    for (int a = 0; a < ACC; ++a)
                        dst[((m * kWN + i) * ACC + a) * 32] = run[m][i][a];
        }
        __syncthreads();
        if (active && slice == 0) {
            // the slices of this warp tile, in slice order
            for (int sl = 1; sl < pl.slices; ++sl) {
                const T* src = scr + ((sl - 1) * pl.items + item) * REG * 32
                               + lane;
#pragma unroll
                for (int m = 0; m < WM; ++m)
#pragma unroll
                    for (int i = 0; i < kWN; ++i)
#pragma unroll
                        for (int a = 0; a < ACC; ++a)
                            run[m][i][a] += src[((m * kWN + i) * ACC + a)
                                                * 32];
            }
        }
    }
    if (!active || slice != 0) return;

#pragma unroll
    for (int m = 0; m < WM; ++m) {
        if (m >= mts) continue;
#pragma unroll
        for (int i = 0; i < kWN; ++i)
#pragma unroll
            for (int a = 0; a < ACC; ++a) {
                const T v = run[m][i][a];
                if constexpr (KIND != kBF16) {
                    // f32: c0..c3 at (g, 2t), (g, 2t+1), (g+8, 2t),
                    // (g+8, 2t+1); f64: c0, c1 at (g, 2t), (g, 2t+1)
                    const int row = m * MR + g + (ACC == 4 && a >= 2 ? 8 : 0);
                    const int c = (t0 + i) * 8 + 2 * t + (a & 1);
                    if (row >= gs || c >= (wb ? p : np)) continue;
                    out[static_cast<long long>(s0 + row) * e_s
                        + (wb ? np + c : c)] = v;
                } else {
                    const int q = (mt0 + m) * 16 + g + (a >= 2 ? 8 : 0);
                    const int r = (t0 + i) * 8 + 2 * t + (a & 1);
                    if (q > p || r > p || (q < p && r == p)) continue;
                    const int k = q < p ? q * p + r
                                        : (r < p ? p * p + r : p * p + p);
                    out[static_cast<long long>(s0 + sb) * e_s + k] = v;
                }
            }
    }
}

// Second pass: 8 lanes per entry sum its column of the partial buffer
// over the chunks (lane k takes chunks k, k + 8, ..., in order), then
// lane 0 adds the 8 sums in lane order and writes G (its mirror too in
// float32 and float64), b or ydy.
template <int KIND>
__global__ void __launch_bounds__(kRedEntries * kRedLanes)
grams_reduce_kernel(const typename Types<KIND>::T* __restrict__ partials,
                    typename Types<KIND>::T* __restrict__ G,
                    typename Types<KIND>::T* __restrict__ b,
                    typename Types<KIND>::T* __restrict__ ydy, int n_s,
                    int p, int np, int e_s, int n_chunks) {
    using T = typename Types<KIND>::T;
    __shared__ T part[kRedLanes][kRedEntries];
    const long long E = static_cast<long long>(n_s) * e_s;
    const int el = threadIdx.x % kRedEntries;
    const int ln = threadIdx.x / kRedEntries;
    const long long e = static_cast<long long>(blockIdx.x) * kRedEntries + el;
    // chunks ln, ln + 8, ... in order, loaded 8 at a time
    T acc = T(0);
    if (e < E) {
        int c = ln;
        for (; c + 7 * kRedLanes < n_chunks; c += 8 * kRedLanes) {
            T v[8];
#pragma unroll
            for (int k = 0; k < 8; ++k)
                v[k] = partials[(c + k * kRedLanes) * E + e];
#pragma unroll
            for (int k = 0; k < 8; ++k) acc += v[k];
        }
        for (; c < n_chunks; c += kRedLanes) acc += partials[c * E + e];
    }
    part[ln][el] = acc;
    __syncthreads();
    if (ln != 0 || e >= E) return;
    T sum = part[0][el];
    for (int k = 1; k < kRedLanes; ++k) sum += part[k][el];
    const int s = static_cast<int>(e / e_s);
    const int k = static_cast<int>(e - static_cast<long long>(s) * e_s);
    T* gs = G + static_cast<long long>(s) * p * p;
    const int n_g = KIND == kBF16 ? p * p : np;
    if (k < n_g) {
        if constexpr (KIND == kBF16) {
            gs[k] = sum;
        } else {
            int q, r;
            pair_rows(k, p, q, r);
            gs[q * p + r] = sum;
            gs[r * p + q] = sum;
        }
    } else if (k < n_g + p) {
        b[static_cast<long long>(k - n_g) * n_s + s] = sum;
    } else {
        ydy[s] = sum;
    }
}

// the plan's counts: pairs; bf16's n-tiles and m-tiles of X_s and the
// warp tiles a sample takes; float32/float64's warp tiles of columns;
// entries a sample has in the partial buffer
struct Counts {
    int np, nt, mts, tps, ranges, e_s;
};

__host__ inline Counts counts(int kind, int p) {
    Counts c;
    c.np = p * (p + 1) / 2;
    if (kind == kBF16) {
        c.mts = (p + 1 + 15) / 16;
        c.nt = (p + 1 + 7) / 8;
        c.tps = (c.mts + warp_m(kind) - 1) / warp_m(kind)
                * ((c.nt + kWN - 1) / kWN);
        c.ranges = 0;
        c.e_s = p * p + p + 1;
    } else {
        // warp tiles of G's pair columns, then of b's
        c.mts = c.nt = c.tps = 0;
        c.ranges = ((c.np + 7) / 8 + kWN - 1) / kWN
                   + (p + 8 * kWN - 1) / (8 * kWN);
        c.e_s = c.np + p + 1;
    }
    return c;
}

template <int KIND>
int launch(const void* yt, const void* dt, const void* rt, void* partials,
           void* G, void* b, void* ydy, const Plan& pl, void* stream) {
    using TD = typename Types<KIND>::TD;
    using T = typename Types<KIND>::T;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const Counts c = counts(KIND, pl.p);
    const int mr = mma_rows(KIND);
    const int n_groups = (pl.n_s + pl.group_samples - 1) / pl.group_samples;
    bool ok = pl.n >= 1 && pl.n_s >= 1 && pl.p >= 1
              && (pl.tile == 32 || pl.tile == 64 || pl.tile == 128
                  || pl.tile == 256 || (KIND == kBF16 && pl.tile == 512))
              && pl.stages >= 2 && pl.stages <= 4 && pl.slices >= 1
              && pl.slices <= kMaxSlices && pl.slices <= pl.tile
                                                        / k_sites(KIND)
              && pl.items >= 1 && pl.items * pl.slices <= kWarps
              && pl.group_samples >= 1 && pl.group_samples <= pl.n_s
              && pl.col_groups >= 1 && pl.chunk_sites % pl.tile == 0
              && (pl.n + pl.chunk_sites - 1) / pl.chunk_sites == pl.n_chunks;
    if (KIND == kBF16)
        ok = ok && pl.col_groups == 1 && pl.items == pl.group_samples * c.tps;
    else
        ok = ok && pl.group_samples <= warp_m(KIND) * mr
             && (pl.group_samples + mr - 1) / mr * mr * (pl.tile / 2)
                <= kMaxIt * kThreads
             && pl.col_groups * pl.items >= c.ranges;
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
    const Layout L = layout(KIND, pl.p, pl.group_samples, pl.tile,
                            pl.stages, pl.items, pl.slices);
    const size_t smem = static_cast<size_t>(L.total());
    auto kern = grams_kernel<KIND>;
    // the kernel's shared-memory ceiling on this device, raised when a
    // plan needs more
    static size_t smem_set[64] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= 64 || smem > smem_set[dev]) {
        err = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
        if (dev < 64) smem_set[dev] = smem;
    }
    const dim3 grid(n_groups * pl.col_groups, pl.n_chunks);
    kern<<<grid, kThreads, smem, st>>>(
        static_cast<const TD*>(yt), static_cast<const TD*>(dt),
        static_cast<const TD*>(rt), static_cast<T*>(partials), pl, c.np,
        c.nt, c.mts, c.e_s);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long E = static_cast<long long>(pl.n_s) * c.e_s;
    const int blocks = static_cast<int>((E + kRedEntries - 1) / kRedEntries);
    grams_reduce_kernel<KIND><<<blocks, kRedEntries * kRedLanes, 0, st>>>(
        static_cast<const T*>(partials), static_cast<T*>(G),
        static_cast<T*>(b), static_cast<T*>(ydy), pl.n_s, pl.p, c.np, c.e_s,
        pl.n_chunks);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The main pass's shared memory in bytes (kind 0 float32, 1 float64,
// 2 bf16 data), which the wrapper's plan (grams_smem) matches.
long long dm_grams_smem(int kind, int p, int group_samples, int tile,
                        int stages, int items, int slices) {
    return layout(kind, p, group_samples, tile, stages, items, slices)
        .total();
}

// yt, dt (n_s, n), rt (p, n) of the data type; partials
// (n_chunks, n_s E) with E entries a sample, G (n_s, p, p), b (p, n_s),
// ydy (n_s,) of the accumulation type (float32 for bf16 data)
#define DM_K8_ENTRY(NAME, KIND)                                               \
    int NAME(const void* yt, const void* dt, const void* rt, void* partials,  \
             void* G, void* b, void* ydy, long long n, long long chunk_sites, \
             int n_s, int p, int tile, int stages, int group_samples,         \
             int col_groups, int items, int slices, int n_chunks,             \
             void* stream) {                                                  \
        const Plan pl{n, chunk_sites, n_s, p, tile, stages, group_samples,    \
                      col_groups, items, slices, n_chunks};                   \
        return launch<KIND>(yt, dt, rt, partials, G, b, ydy, pl, stream);     \
    }
DM_K8_ENTRY(dm_grams_f32, kF32)
DM_K8_ENTRY(dm_grams_f64, kF64)
DM_K8_ENTRY(dm_grams_bf16, kBF16)
#undef DM_K8_ENTRY

}  // extern "C"
