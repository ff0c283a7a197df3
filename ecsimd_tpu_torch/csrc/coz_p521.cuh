// Jacobian formulas on P-521 (a = -3) for one lane per thread (sm_90a).
//
// Instantiates the a = -3 doubling of dbl_am3.cuh, the shared adds of
// jacobian.cuh and the co-Z formulas of coz.cuh over the P-521 field
// (field_p521.cuh) with the curve's a, as coz_p256.cuh does on P-256. Each
// follows the JAX package's formula sequence operation for operation, and
// every field result is canonical, so the Jacobian planes agree bit for bit.
//
// What bounds these formulas: field multiplies (289 products each, a squaring
// 153), called, not inlined (field_p521.cuh says why).

#pragma once

#include "field_p521.cuh"

namespace p521 {

// a = p - 3 (residues are stored plain)
#define P521_A \
  {0xFFFFFFFCu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, \
   0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, \
   0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0x000001FFu}

__device__ __forceinline__ fe curve_a() {
  const fe a = {P521_A};
  return a;
}

// The a = -3 doubling, the adds and the co-Z formulas, written once for
// every field.
#include "dbl_am3.cuh"
#include "jacobian.cuh"
#include "coz.cuh"

}  // namespace p521
