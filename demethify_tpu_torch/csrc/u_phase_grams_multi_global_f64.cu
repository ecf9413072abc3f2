// K4 in the global layout, float64 (u_phase_grams_multi_global.cu).

#include "u_phase_grams_multi.cuh"

extern "C" {
DM_K4_ENTRY(dm_u_phase_grams_multi_global, _f64, double, double, dm::kGlobal)
}
