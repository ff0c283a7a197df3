// Kernel J's step schedules on P-384 (48 positions) and P-521 (66): the
// post-order walk of the comb's stride tree, written by
// kernels/comb.py:tree_schedule_header() from tree_schedule(npos), which
// says what a step does; tests/test_torch_comb_general.py holds this file to
// the generator, so edit the generator, not this file. Word k of a table is
// p | f << 8: step k adds the level-1 pair (p, p + npos / 2), then folds the
// f most recently pending sums into it. kPending: the most sums pending at
// once.

#pragma once

#include <stdint.h>

namespace tree_schedule {

template <int kNpos>
struct Schedule;

static __constant__ uint16_t kSteps48[24] = {
    0x0000, 0x010C, 0x0006, 0x0212, 0x0003, 0x010F, 0x0009, 0x0315,
    0x0001, 0x010D, 0x0007, 0x0213, 0x0004, 0x0110, 0x000A, 0x0416,
    0x0002, 0x010E, 0x0008, 0x0214, 0x0005, 0x0111, 0x000B, 0x0417};

template <>
struct Schedule<48> {
  static constexpr int kSteps = 24;
  static constexpr int kPending = 4;
  static __device__ __forceinline__ uint32_t step(int k) { return kSteps48[k]; }
};

static __constant__ uint16_t kSteps66[33] = {
    0x0000, 0x0110, 0x0008, 0x0218, 0x0004, 0x0114, 0x000C, 0x031C,
    0x0002, 0x0112, 0x000A, 0x021A, 0x0006, 0x0116, 0x000E, 0x041E,
    0x0001, 0x0111, 0x0009, 0x0219, 0x0005, 0x0115, 0x000D, 0x031D,
    0x0003, 0x0113, 0x000B, 0x021B, 0x0007, 0x0117, 0x000F, 0x051F,
    0x0120};

template <>
struct Schedule<66> {
  static constexpr int kSteps = 33;
  static constexpr int kPending = 5;
  static __device__ __forceinline__ uint32_t step(int k) { return kSteps66[k]; }
};

}  // namespace tree_schedule
