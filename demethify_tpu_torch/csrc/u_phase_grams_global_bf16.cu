// K1 in the global layout, bf16 data with a float32 state, with and
// without bf16_compute (u_phase_grams_global.cu).

#include "u_phase_grams.cuh"

DM_K1_BF16_EXPORT(dm_u_phase_grams_global, dm::kGlobal)
