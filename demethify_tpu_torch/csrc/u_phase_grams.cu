// K1 in the resident layout: the shapes whose staged site columns and
// alpha block fit the card's shared memory (u_phase_grams.cuh); and the
// exports of the pieces K1, K4 and K7 share (u_phase_common.cuh) that the
// wrappers and chip_smoke.py read on their own.

#include "u_phase_grams.cuh"

DM_K1_EXPORTS(dm_u_phase_grams, dm::kResident)

extern "C" {

int dm_u_phase_grams_blocks(long long n) {
    return static_cast<int>((n + kSites - 1) / kSites);
}

// The global layout's plan (dm::global_plan) into out[6]: cs, q, depth,
// rows, res, kc, for `members` blocks of um u rows (K1: n_u, or 2 n_u in
// bf16_compute's gram form, one member; K4: n_u, or 2 n_u weighted, a
// group)
int dm_global_plan(int itemsize, int n_s, int n_ct, int n_u, int direct,
                   int um, int members, int* out) {
    const dm::GlobalPlan g = dm::global_plan(itemsize, n_s, n_ct, n_u,
                                             direct != 0, um, members);
    const int v[6] = {g.cs, g.q, g.depth, g.rows, g.res, g.kc};
    for (int k = 0; k < 6; ++k) out[k] = v[k];
    return 0;
}

// Rows of the n_u > 8 form's state region (129 values each; 0 at
// n_u <= 8), and whether it lives in device memory (the global layout's
// kGlobalState; the wrapper then allocates n_blocks of those rows)
int dm_state_rows(int n_s, int n_u, int direct) {
    return dm::state_rows(n_s, n_u, direct != 0);
}

int dm_state_in_device(int itemsize, int n_s, int n_u, int direct) {
    return dm::state_rows(n_s, n_u, direct != 0) > 0
           && dm::state_in_device(itemsize, n_s, n_u, direct != 0);
}

// The momentum-table prologue alone (K1/K4's slots, or with ph K7's):
// member b's table at tab + b (n_steps + 1) from scal + b scal_stride.
int dm_momentum_table_f32(void* scal, int scal_stride, int n_members,
                          void* tab, int n_steps, int ph, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    float* sc = static_cast<float*>(scal);
    float* tb = static_cast<float*>(tab);
    return ph ? dm::launch_momentum_table<float, true>(sc, scal_stride,
                                                       n_members, tb,
                                                       n_steps, st)
              : dm::launch_momentum_table<float, false>(sc, scal_stride,
                                                        n_members, tb,
                                                        n_steps, st);
}

int dm_momentum_table_f64(void* scal, int scal_stride, int n_members,
                          void* tab, int n_steps, int ph, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    double* sc = static_cast<double*>(scal);
    double* tb = static_cast<double*>(tab);
    return ph ? dm::launch_momentum_table<double, true>(sc, scal_stride,
                                                        n_members, tb,
                                                        n_steps, st)
              : dm::launch_momentum_table<double, false>(sc, scal_stride,
                                                         n_members, tb,
                                                         n_steps, st);
}

// The Gram stage's plan for a block of n_c samples (dm::gram_plan) into
// out[8]: tiled, rs, rv, ts, tv, tq, n_tiles, n_items.
int dm_gram_tile_plan(int n_c, int n_u, int p, int usq, int* out) {
    const dm::GramPlan g = dm::gram_plan(n_c, n_u, p, usq != 0);
    const int v[8] = {g.tiled, g.rs, g.rv, g.ts, g.tv, g.tq, g.n_tiles,
                      g.n_items};
    for (int k = 0; k < 8; ++k) out[k] = v[k];
    return 0;
}

}  // extern "C"
