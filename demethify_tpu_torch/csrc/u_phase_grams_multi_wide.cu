// K4 in the wide layout: Y and D staged in chunks of samples, for the
// shapes where the resident layout would pass the card's shared memory or
// fit less than half the blocks per SM (u_phase_grams_multi.cuh,
// u_phase_common.cuh).

#include "u_phase_grams_multi.cuh"

DM_K4_EXPORTS(dm_u_phase_grams_multi_wide, true)
