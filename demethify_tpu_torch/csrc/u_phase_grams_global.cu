// K1 in the global layout: Y, D and Rt read where they lie in device
// memory during the steps, and streamed through shared memory for the Gram
// stage (Rt through a ring of row chunks), for the shapes where even the
// wide layout would pass the card's shared memory (u_phase_grams.cuh,
// u_phase_common.cuh: global_plan, gram_partials_ring). One source a data
// type, so the three compile in parallel: this one float32 (and the
// layout's shared-memory export), u_phase_grams_global_f64.cu float64,
// u_phase_grams_global_bf16.cu bf16 data.

#include "u_phase_grams.cuh"

DM_K1_SMEM_EXPORT(dm_u_phase_grams_global, dm::kGlobal)
DM_K1_F32_EXPORT(dm_u_phase_grams_global, dm::kGlobal)
