// K4 in the global layout: the wide layout with Rt and the member group's
// u rows in a device-memory buffer, for the shapes where even the wide
// layout would pass the card's shared memory (u_phase_grams_multi.cuh,
// u_phase_common.cuh).

#include "u_phase_grams_multi.cuh"

DM_K4_EXPORTS(dm_u_phase_grams_multi_global, dm::kGlobal)
