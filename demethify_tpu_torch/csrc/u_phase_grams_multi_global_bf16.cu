// K4 in the global layout, bf16 data with a float32 state and float32
// weight rows (u_phase_grams_multi_global.cu).

#include "u_phase_grams_multi.cuh"

extern "C" {
DM_K4_ENTRY(dm_u_phase_grams_multi_global, _bf16, float, __nv_bfloat16,
            dm::kGlobal)
}
