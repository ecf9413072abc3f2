// K1 in the global layout: the wide layout with the [Rt | u] rows in a
// device-memory buffer, for the shapes where even the wide layout would
// pass the card's shared memory (u_phase_grams.cuh, u_phase_common.cuh).

#include "u_phase_grams.cuh"

DM_K1_EXPORTS(dm_u_phase_grams_global, dm::kGlobal)
