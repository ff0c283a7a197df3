// Jacobian formulas on P-256 (a = -3) for one lane per thread (sm_90a).
//
// Instantiates the a = -3 doubling of dbl_am3.cuh, the shared adds of
// jacobian.cuh and the co-Z formulas of coz.cuh over the Solinas field with
// the curve's a. Each follows the JAX package's formula sequence operation
// for operation. The JAX kernels fuse whole coordinate polynomials into one
// Solinas reduction; here every operation reduces on its own, which gives
// the same canonical residues, hence the same Jacobian planes. Inputs are
// taken by value so that callers may pass outputs that alias inputs.
//
// What bounds these formulas: field multiplies (jac_dbl: 3 mul + 5 sqr;
// add_complete: 15 mul + 9 sqr; coz.cuh and jacobian.cuh count theirs) —
// 32-bit multiply-add throughput; all state stays in registers.

#pragma once

#include "field_p256.cuh"

namespace p256 {

// a = p - 3 (the Solinas field's internal form is the classical one)
#define P256_A \
  {0xFFFFFFFCu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0u, 0u, 0u, 1u, 0xFFFFFFFFu}

__device__ __forceinline__ fe curve_a() {
  const fe a = {P256_A};
  return a;
}

// The a = -3 doubling (dbl_am3.cuh), then add_z2_1, jac_add and
// add_complete, and the co-Z formulas, written once for every field.
#include "dbl_am3.cuh"
#include "jacobian.cuh"
#include "coz.cuh"

}  // namespace p256
