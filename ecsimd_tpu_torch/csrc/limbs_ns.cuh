// The limb helpers of limbs.cuh at the including namespace's width, under
// the names the formulas and lanes call (fe, fe_load, fe_store, ...).
// field_p384.cuh and field_p521.cuh include this file inside their
// namespaces after defining kWords (32-bit words an element) and kDigits
// (base-2^16 digit planes), so it has no include guard and includes
// nothing. The 8-word fields name limbs.cuh's 8-word functions directly.

using fe = ec::fe_t<kWords>;
using ec::fe_is_zero;
using ec::fe_select;
using ec::fe_swap_if;

__device__ __forceinline__ fe fe_zero() { return ec::zero_n<kWords>(); }

__device__ __forceinline__ fe fe_from_u32(uint32_t x) { return ec::from_u32_n<kWords>(x); }

__device__ __forceinline__ fe fe_load(const int32_t* planes, int64_t B, int64_t i) {
  return ec::load_n<kWords, kDigits>(planes, B, i);
}

__device__ __forceinline__ uint32_t scalar_word(const int32_t* planes, int64_t B, int64_t i,
                                                int w) {
  return ec::scalar_word_n<kDigits>(planes, B, i, w);
}

__device__ __forceinline__ void fe_store(int32_t* planes, int64_t B, int64_t i, const fe& a) {
  ec::store_n<kWords, kDigits>(planes, B, i, a);
}

__device__ __forceinline__ fe fe_from_digits(const int32_t* d) {
  return ec::from_digits_n<kWords, kDigits>(d);
}
