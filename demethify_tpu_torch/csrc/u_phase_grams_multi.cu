// K4 in the resident layout: the shapes whose staged site columns and
// one member's alpha block fit the card's shared memory
// (u_phase_grams_multi.cuh).

#include "u_phase_grams_multi.cuh"

DM_K4_EXPORTS(dm_u_phase_grams_multi, false)
