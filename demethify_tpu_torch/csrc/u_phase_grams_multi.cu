// K4 in the resident layout: the shapes whose staged site columns and
// one member's alpha block fit the card's shared memory
// (u_phase_grams_multi.cuh); and the exports of K4's member plan, which
// the wrapper's ops/cuda_multi.k4_member_plan mirrors and chip_smoke.py
// holds it to.

#include "u_phase_grams_multi.cuh"

DM_K4_EXPORTS(dm_u_phase_grams_multi, dm::kResident)

extern "C" {

// out: group, smem (bytes), blocks per SM kept; layout 0 resident, 1
// wide, 2 global
int dm_k4_member_plan(int itemsize, int n_s, int n_ct, int n_u, int n_b,
                      int weighted, int layout, long long* out) {
    const dm::K4MemberPlan g = dm::k4_member_plan(
        itemsize, n_s, n_ct, n_u, n_b, weighted != 0, layout);
    out[0] = g.group;
    out[1] = g.smem;
    out[2] = g.blocks;
    return 0;
}

// out: tiled, ts, tl, tq, tp, tb, n_x, n_self, n_bu, n_usq, o_self, o_bu,
// o_usq, n_items
int dm_k4_gram_plan(int n_c, int n_ct, int n_u, int gm, int usq, int* out) {
    const dm::K4GramPlan g = dm::k4_gram_plan(n_c, n_ct, n_u, gm, usq != 0);
    const int v[14] = {g.tiled, g.ts,     g.tl,   g.tq,    g.tp,
                       g.tb,    g.n_x,    g.n_self, g.n_bu, g.n_usq,
                       g.o_self, g.o_bu,  g.o_usq, g.n_items};
    for (int k = 0; k < 14; ++k) out[k] = v[k];
    return 0;
}

}  // extern "C"
