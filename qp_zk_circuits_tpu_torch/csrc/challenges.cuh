// A proof's challenge record: the Fiat-Shamir values that kernels A-E read
// from device memory, at fixed word offsets (plonk/transcript.py REC_*, the
// one other table of them: change both together). The fused prover's
// transcript (kernel I, transcript.cu) writes them on the card as it draws
// them; the staged prover and the batch paths write their host draws into
// a record of the same layout, one copy, so both launch the same kernels.
// A batch's records lie `stride` words apart.
#pragma once

namespace rec {

constexpr int NC = 4;           // challenges of each kind at most
constexpr int ALPHA = 0;        // alpha_c, c < nc (kernel A)
constexpr int BETA = 4;         // beta_c (kernels A, B)
constexpr int GAMMA = 8;        // gamma_c (kernels A, B)
constexpr int PI = 12;          // the public-input hash, 4 felts (kernel A)
constexpr int ZETA = 16;        // zeta, an extension pair (kernels C, D)
constexpr int ZETA_NEXT = 18;   // g * zeta (kernels C, D)
constexpr int FRI_ALPHA = 20;   // FRI's batching alpha (kernel C)
constexpr int FRI_BETA = 22;    // round r's beta at FRI_BETA + 2 r (kernel E)
constexpr int MAX_ROUNDS = 16;
constexpr int WORDS = 56;       // a record; FRI_BETA + 2 MAX_ROUNDS = 54, padded

}  // namespace rec
