// Streaming secure aggregation: quantize, mask, and sum in Z_2^32.
//
// Replaces the TPU kernel src/repro/kernels/secure_agg.py::masked_sum_2d.
// For each local client row li (global id i = offset + li) and each
// element e (its counter is the flat index e):
//
//   q      = round_half_even(m[li, e] * 2^scale_bits)          (int32)
//   upload = q + sum_j sgn(i, j) * alive[j] * mask_bits(pair_seed(k0, k1,
//                                             min(i, j), max(i, j)), e)
//   upload = upload * alive[i]
//   out[e] = sum_li upload                                  (mod 2^32)
//
// with sgn = +1 for i < j, -1 for i > j, 0 for i == j.  Every client's
// masked upload is formed and added; the masks cancel only in the total.
//
// Bound on the card: integer ALU work, not memory.  Each element needs
// I_loc * (num_clients - 1) directed mask streams of 19 integer operations
// (two murmur3 finalizers of 8, the xors with the two seed words, and the
// accumulate: the coefficient is +-1, one multiply-add), against
// 4 * (I_loc + 1) bytes of traffic.  At I = 10 that is about 1,740
// operations per 44 bytes.  Design: one thread per element keeps its
// running upload in a register; the pair seed, its second word
// seed + kGold and the signed coefficient depend only on (i, j) and the
// round key, so each block computes them once per client row into a
// shared-memory table (tiled over peers, so any num_clients fits) and
// every thread reads them from there.  Zero coefficients (j == i, dropped
// peers) skip their stream.
//
// All ring arithmetic is uint32_t: it wraps mod 2^32 by definition, where
// signed int32 overflow would be undefined.  Quantization uses
// __float2int_rn (round to nearest even), the rounding of jnp.round.
#include <cuda_runtime.h>
#include <stdint.h>

#include "prf.cuh"

namespace {

using prf::kGold;
using prf::kM1;
using prf::mask_bits;
using prf::mix32;

constexpr int kThreads = 256;
constexpr int kPeerTile = 512;

__device__ __forceinline__ uint32_t pair_seed(uint32_t k0, uint32_t k1,
                                              uint32_t lo, uint32_t hi) {
  uint32_t s = mix32(k0 ^ (lo * kGold));
  s = mix32(s ^ (hi * kM1));
  return mix32(s ^ k1);
}

__global__ void masked_sum_kernel(const float* __restrict__ msgs, int i_loc,
                                  int64_t n, float scale, uint32_t key0,
                                  uint32_t key1, uint32_t offset,
                                  int num_clients,
                                  const int32_t* __restrict__ alive,
                                  int32_t* __restrict__ out) {
  __shared__ uint32_t seed_s[kPeerTile];
  __shared__ uint32_t seed2_s[kPeerTile];
  __shared__ uint32_t coef_s[kPeerTile];
  const int64_t e = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const bool valid = e < n;
  const uint32_t ctr = (uint32_t)e;
  uint32_t acc = 0u;
  for (int li = 0; li < i_loc; ++li) {
    const uint32_t i = offset + (uint32_t)li;
    uint32_t up = valid ? (uint32_t)__float2int_rn(msgs[li * n + e] * scale)
                        : 0u;
    for (int j0 = 0; j0 < num_clients; j0 += kPeerTile) {
      const int tile = min(kPeerTile, num_clients - j0);
      __syncthreads();  // the previous tile's readers are done
      for (int t = threadIdx.x; t < tile; t += kThreads) {
        const uint32_t j = (uint32_t)(j0 + t);
        uint32_t c = (j == i) ? 0u : (i < j ? 1u : 0xFFFFFFFFu);
        if (alive != nullptr) c *= (uint32_t)alive[j];
        const uint32_t seed = pair_seed(key0, key1, min(i, j), max(i, j));
        seed_s[t] = seed;
        seed2_s[t] = seed + kGold;
        coef_s[t] = c;
      }
      __syncthreads();
      if (valid) {
        for (int t = 0; t < tile; ++t) {
          const uint32_t c = coef_s[t];
          if (c != 0u) up += c * mask_bits(seed_s[t], seed2_s[t], ctr);
        }
      }
    }
    if (alive != nullptr) up *= (uint32_t)alive[i];
    acc += up;
  }
  if (valid) out[e] = (int32_t)acc;
}

}  // namespace

// msgs: device (i_loc, n) f32, contiguous; out: device (n,) int32; alive:
// device (num_clients,) int32 of 0/1, or null.  Launches on `stream`;
// returns cudaGetLastError().
extern "C" int masked_sum_launch(const float* msgs, int i_loc, int64_t n,
                                 int scale_bits, uint32_t key0, uint32_t key1,
                                 uint32_t offset, int num_clients,
                                 const int32_t* alive, int32_t* out,
                                 void* stream) {
  if (n > 0) {
    const float scale = (float)(1u << scale_bits);
    const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
    masked_sum_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        msgs, i_loc, n, scale, key0, key1, offset, num_clients, alive, out);
  }
  return (int)cudaGetLastError();
}

// The message of a CUDA error code, for the Python wrappers' exceptions.
extern "C" const char* kernel_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}
