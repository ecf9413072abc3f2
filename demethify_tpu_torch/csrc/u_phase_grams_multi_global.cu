// K4 in the global layout: K1's global layout for a member group, whose u
// rows live at the top of shared memory, with Rt streamed through the
// ring for the group's Gram stage (u_phase_grams_multi.cuh,
// u_phase_common.cuh: global_plan). One source a data type, so the three
// compile in parallel: this one float32 (and the layout's shared-memory
// export), u_phase_grams_multi_global_f64.cu float64,
// u_phase_grams_multi_global_bf16.cu bf16 data.

#include "u_phase_grams_multi.cuh"

DM_K4_SMEM_EXPORT(dm_u_phase_grams_multi_global, dm::kGlobal)
extern "C" {
DM_K4_ENTRY(dm_u_phase_grams_multi_global, _f32, float, float, dm::kGlobal)
}
