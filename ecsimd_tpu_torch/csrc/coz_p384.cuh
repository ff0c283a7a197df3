// Jacobian formulas on P-384 (a = -3) for one lane per thread (sm_90a).
//
// Instantiates the a = -3 doubling of dbl_am3.cuh, the shared adds of
// jacobian.cuh and the co-Z formulas of coz.cuh over the P-384 field
// (field_p384.cuh) with the curve's a, as coz_p256.cuh does on P-256. Each
// follows the JAX package's formula sequence operation for operation, and
// every field result is canonical, so the Jacobian planes agree bit for bit.
//
// What bounds these formulas: field multiplies (144 products each, a squaring
// 78), called, not inlined (field_p384.cuh says why).

#pragma once

#include "field_p384.cuh"

namespace p384 {

// a = p - 3 (residues are stored plain)
#define P384_A \
  {0xFFFFFFFCu, 0x00000000u, 0x00000000u, 0xFFFFFFFFu, 0xFFFFFFFEu, 0xFFFFFFFFu, \
   0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu}

__device__ __forceinline__ fe curve_a() {
  const fe a = {P384_A};
  return a;
}

// The a = -3 doubling, the adds and the co-Z formulas, written once for
// every field.
#include "dbl_am3.cuh"
#include "jacobian.cuh"
#include "coz.cuh"

}  // namespace p384
