// 3xTF32 products on the tensor cores, shared by the f32 flash-attention
// kernel (flash_attention.cu) and the WKV scan (rwkv6_scan_sm90.cu).
//
// A TF32 product reads 11 significant bits of each f32 operand, about
// 1e-3 relative.  Each f32 operand x is split as hi = x with its 13 low
// mantissa bits masked off and lo = x - hi (exact; the tensor core reads
// lo's own top 11 bits), and a.b is summed as lo_a.hi_b + hi_a.lo_b +
// hi_a.hi_b, the small terms first: the lo.lo term is below f32's
// rounding.  Fragments are those of mma.sync m16n8k8 (row.col): lane
// (g = lane / 4, t4 = lane % 4) holds A (16 x 8) at rows g, g + 8 and
// columns t4, t4 + 4 as {a0: (g, t4), a1: (g + 8, t4), a2: (g, t4 + 4),
// a3: (g + 8, t4 + 4)}, B (8 x 8) as {b0: (t4, g), b1: (t4 + 4, g)}, and
// the accumulator (16 x 8) as {(g, 2 t4), (g, 2 t4 + 1), (g + 8, 2 t4),
// (g + 8, 2 t4 + 1)}.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

__device__ __forceinline__ uint32_t tf32_hi(float x) {
  return __float_as_uint(x) & 0xffffe000u;
}

// x = hi + lo exactly, hi with TF32's 11 significant bits
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_hi(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a.b with b split into hi + lo, and a too when kSplitA (otherwise a
// is exact in TF32); the small terms first
template <bool kSplitA>
__device__ __forceinline__ void mma_split(float (&d)[4],
                                          const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4],
                                          const uint32_t (&b)[4]) {
  if (kSplitA) mma(d, al, b[0], b[1]);
  mma(d, ah, b[2], b[3]);
  mma(d, ah, b[0], b[1]);
}

// b = {hi0, hi1, lo0, lo1} of the B fragment (x0, x1)
__device__ __forceinline__ void split_b(float x0, float x1,
                                        uint32_t (&b)[4]) {
  split(x0, b[0], b[2]);
  split(x1, b[1], b[3]);
}

// a 16-byte cp.async into shared memory, zero-filled when !in (src is
// then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(in ? 16 : 0));
}

}  // namespace tf32x3
