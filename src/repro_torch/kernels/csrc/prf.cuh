// The counter-mode PRF shared by the integer kernels (secure_agg.cu,
// compress.cu, sketch.cu): the port of src/repro/kernels/secure_agg.py's
// _mix32 and mask_bits.  All arithmetic is uint32_t, which wraps mod 2^32
// by definition, as the reference's jnp.uint32 words do.
#pragma once

#include <stdint.h>

namespace prf {

constexpr uint32_t kM1 = 0x7FEB352Du;
constexpr uint32_t kM2 = 0x846CA68Bu;
constexpr uint32_t kGold = 0x9E3779B9u;

// murmur3 fmix32
__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= kM1;
  x ^= x >> 15;
  x *= kM2;
  x ^= x >> 16;
  return x;
}

// mask_bits(seed, ctr) of the reference, given seed2 = seed + kGold
__device__ __forceinline__ uint32_t mask_bits(uint32_t seed, uint32_t seed2,
                                              uint32_t ctr) {
  return mix32(mix32(ctr ^ seed) ^ seed2);
}

__device__ __forceinline__ uint32_t mask_bits(uint32_t seed, uint32_t ctr) {
  return mask_bits(seed, seed + kGold, ctr);
}

// PRF word -> f32 uniform in [0, 1]: round to nearest even, as XLA's and
// torch's integer -> f32 conversions do, then an exact scaling by 2^-32
// (the top words round up to exactly 1.0, in the reference too)
__device__ __forceinline__ float uniform(uint32_t bits) {
  return __fmul_rn(__uint2float_rn(bits), 2.3283064365386963e-10f);
}

}  // namespace prf
