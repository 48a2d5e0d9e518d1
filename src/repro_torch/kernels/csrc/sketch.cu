// Fused count-sketch encode: stochastic round onto the 2^-s grid, hash,
// sign and int32 bucket accumulate in one pass.
//
// Replaces the TPU kernel src/repro/kernels/sketch.py::sketch_encode_kernel,
// batched over clients: one launch encodes every client's (R, 128)
// message into its own (rows, cols) sketch.  For client c and element e
// (counter ctr = base_c + e, wrapping mod 2^32):
//
//   y = x * 2^s
//   q = int32(floor(y) + [u < y - floor(y)]),  u = mask_bits(seed_c, ctr) * 2^-32
//   for each sketch row r, with w = mask_bits(row_seed(sketch_seed_c, r), ctr):
//     out[c, r, w & (cols - 1)] += (w >> 31 ? -q : q)          (mod 2^32)
//
// The TPU kernel reduces with a one-hot compare because the TPU has no
// scatter.  Here each thread adds into the zero-filled output with an
// integer atomicAdd, which is exact in any order (ring arithmetic), so
// the sketch equals the plain version's bit for bit.  An exact zero
// rounds to q = 0 (u >= 0 never beats a zero fraction), and a thread
// with q = 0 skips its atomics: after the client's top-`keep`
// pre-sparsification almost every element is zero.  Threads past the
// last element read nothing, so no padding can reach a bucket.
//
// Bound on the card: device memory, the read of x (4 bytes per element,
// 4.07 MB at the MLP's full width for 10 clients: 1.2 us at 3.35 TB/s).
// The rounding draw is about 20 integer operations per element; the hash,
// sign and atomic add run only for the nonzero elements.  A shared-memory
// histogram per block would cut the global atomics; not needed while the
// input is sparse.
//
// Numerics: y = x * 2^s is exact (a power-of-two scale), floorf and the
// explicitly rounded intrinsics match torch, and __float2int_rz of an
// integer-valued float is exact; like XLA's conversion it saturates and
// sends NaN to 0.
#include <cuda_runtime.h>
#include <stdint.h>

#include "prf.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void sketch_encode_kernel(const float* __restrict__ x,
                                     const int64_t* __restrict__ su,
                                     int64_t per_client, int64_t total,
                                     int rows, int64_t cols, float scale,
                                     uint32_t* __restrict__ out) {
  const int64_t e = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (e >= total) return;
  const int64_t c = e / per_client;
  const uint32_t seed = (uint32_t)su[3 * c];
  const uint32_t ctr = (uint32_t)su[3 * c + 1] + (uint32_t)(e - c * per_client);
  const float y = __fmul_rn(x[e], scale);
  const float low = floorf(y);
  const float u = prf::uniform(prf::mask_bits(seed, ctr));
  const int q = __float2int_rz(__fadd_rn(low, u < __fsub_rn(y, low) ? 1.0f
                                                                     : 0.0f));
  if (q == 0) return;
  const uint32_t sk_seed = (uint32_t)su[3 * c + 2];
  const uint32_t col_mask = (uint32_t)(cols - 1);
  uint32_t* sketch = out + c * rows * cols;
  for (int r = 0; r < rows; ++r) {
    const uint32_t rseed = prf::mix32(sk_seed ^ ((uint32_t)(r + 1) * prf::kGold));
    const uint32_t w = prf::mask_bits(rseed, ctr);
    const uint32_t v = (w >> 31) ? 0u - (uint32_t)q : (uint32_t)q;
    atomicAdd(sketch + r * cols + (w & col_mask), v);
  }
}

}  // namespace

// x: device (clients, per_client) f32, contiguous; su: device (clients, 3)
// int64 [stream seed, counter base, sketch seed] (the low 32 bits are
// used); out: device (clients, rows, cols) int32, zero-filled by the
// caller; cols a power of two.  Launches on `stream`; returns
// cudaGetLastError().
extern "C" int sketch_encode_launch(const float* x, const int64_t* su,
                                    int clients, int64_t per_client,
                                    int rows, int64_t cols, int scale_bits,
                                    int32_t* out, void* stream) {
  const int64_t total = (int64_t)clients * per_client;
  if (total > 0) {
    const float scale = (float)(1u << scale_bits);
    const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
    sketch_encode_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        x, su, per_client, total, rows, cols, scale, (uint32_t*)out);
  }
  return (int)cudaGetLastError();
}
