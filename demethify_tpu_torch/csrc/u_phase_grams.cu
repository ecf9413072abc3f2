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

// Rows per block of the global layout's device buffer (129 values each)
int dm_u_phase_grams_global_rows(int n_ct, int n_u, int direct, int bf16c) {
    return global_rows(n_ct, n_u,
                       bf16c && !direct ? dm::kRoundAll : dm::kRoundNone);
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
