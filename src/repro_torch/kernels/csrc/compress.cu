// Fused upload compression: threshold mask, stochastic round, clip, residual.
//
// Replaces the TPU kernel src/repro/kernels/compress.py::compress_2d_kernel,
// batched over clients: one launch compresses every client's (R, 128)
// message.  For client c and element e of its message (counter
// base_c + e, wrapping mod 2^32, e = row * 128 + col):
//
//   y   = x / delta_c
//   q   = floor(y) + [u < y - floor(y)],   u = mask_bits(seed_c, ctr) * 2^-32
//   q   = clip(q, -L, L);  out = q * delta_c          (when quantizing)
//   out = 0 where !(|x| >= theta_c)                    (when masked)
//   res = x - out
//
// Bound on the card: device memory.  It reads x and writes out and res,
// 12 bytes per element, against about 25 integer and 8 f32 operations
// (the PRF word is made in registers from the counter alone).  At the
// top-k shape (10, 794, 128) that is 12.2 MB, 3.6 us at 3.35 TB/s.
// Design: one thread per element, coalesced 4-byte loads and stores, the
// client's scalars read from its (2,) rows (L1 broadcast).
//
// Numerics: every f32 operation is an explicitly rounded intrinsic, so
// nvcc contracts nothing into an FMA and the kernel equals its plain
// PyTorch version bit for bit; the division stays IEEE (no
// --use_fast_math).  The clip is two comparisons, which keep a NaN, as
// jnp.clip and torch.clamp do (fminf / fmaxf would drop it).
#include <cuda_runtime.h>
#include <stdint.h>

#include "prf.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void compress_kernel(const float* __restrict__ x,
                                const int64_t* __restrict__ su,
                                const float* __restrict__ sf,
                                int64_t per_client, int64_t total,
                                float lbound, int quantize, int masked,
                                float* __restrict__ out,
                                float* __restrict__ res) {
  const int64_t e = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (e >= total) return;
  const int64_t c = e / per_client;
  const float xv = x[e];
  float o = xv;
  if (quantize) {
    const uint32_t seed = (uint32_t)su[2 * c];
    const uint32_t ctr = (uint32_t)su[2 * c + 1] + (uint32_t)(e - c * per_client);
    const float delta = sf[2 * c + 1];
    const float y = __fdiv_rn(xv, delta);
    const float low = floorf(y);
    const float u = prf::uniform(prf::mask_bits(seed, ctr));
    float q = __fadd_rn(low, u < __fsub_rn(y, low) ? 1.0f : 0.0f);
    if (q < -lbound) q = -lbound;
    if (q > lbound) q = lbound;
    o = __fmul_rn(q, delta);
  }
  if (masked && !(fabsf(xv) >= sf[2 * c])) o = 0.0f;
  out[e] = o;
  res[e] = __fsub_rn(xv, o);
}

}  // namespace

// x, out, res: device (clients, per_client) f32, contiguous; su: device
// (clients, 2) int64 [stream seed, counter base] (the low 32 bits are
// used); sf: device (clients, 2) f32 [threshold, lattice step].  Launches
// on `stream`; returns cudaGetLastError().
extern "C" int compress_launch(const float* x, const int64_t* su,
                               const float* sf, int clients,
                               int64_t per_client, int lbound, int quantize,
                               int masked, float* out, float* res,
                               void* stream) {
  const int64_t total = (int64_t)clients * per_client;
  if (total > 0) {
    const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
    compress_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        x, su, sf, per_client, total, (float)lbound, quantize, masked, out,
        res);
  }
  return (int)cudaGetLastError();
}
