// K1 in the global layout, float64 (u_phase_grams_global.cu).

#include "u_phase_grams.cuh"

DM_K1_F64_EXPORT(dm_u_phase_grams_global, dm::kGlobal)
