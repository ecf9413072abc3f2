// K1 in the resident layout: the shapes whose staged site columns and
// alpha block fit the card's shared memory (u_phase_grams.cuh).

#include "u_phase_grams.cuh"

DM_K1_EXPORTS(dm_u_phase_grams, false)

extern "C" int dm_u_phase_grams_blocks(long long n) {
    return static_cast<int>((n + kSites - 1) / kSites);
}
