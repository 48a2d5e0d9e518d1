// Streaming secure aggregation: quantize, mask, and sum in Z_2^32.
//
// Replaces the TPU kernel src/repro/kernels/secure_agg.py::masked_sum_2d.
// For each local client row li (global id i = offset + li) and each
// element e (its counter is the flat index e, as a uint32):
//
//   q      = round_half_even(m[li, e] * 2^scale_bits)          (int32)
//   upload = q + sum_j sgn(i, j) * alive[j] * mask_bits(pair_seed(k0, k1,
//                                             min(i, j), max(i, j)), e)
//   upload = upload * alive[i]
//   out[e] = sum_li upload                                  (mod 2^32)
//
// with sgn = +1 for i < j, -1 for i > j, 0 for i == j.
//
// The ring mode (masked_ring_sum_launch) takes rows that are already int32
// ring elements, q = m[li, e], and skips the quantize: level 2 of the
// hierarchical tree re-masks the G group partials in Z_2^32 with it, the
// port of the reference's XLA masked_ring_partial_sum
// (src/repro/kernels/secure_agg.py).  The two modes are one template,
// instantiated on the row type; everything else is shared.  Every client's
// masked upload is formed and added: each element regenerates each of the
// I_loc * (num_clients - 1) directed mask streams (less those of dropped
// clients), and the masks cancel only in the total.
//
// Bound on the card: integer work, with the bytes close behind at the
// full-width LM shapes.  Each element needs I_loc * (num_clients - 1)
// directed streams against 4 * (I_loc + 1) bytes of traffic: at I = 10,
// 90 streams per 44 bytes; at I = 4, 12 streams per 20 bytes.
//
// Design for Hopper:
// * The stream table.  A directed stream (i, j) needs only its pair's seed
//   and its coefficient sgn(i, j) * alive[i] * alive[j] (alive[i] folded
//   in: ring multiplication distributes over the row's sum).  Each block
//   builds the table once, in shared memory, with the zero coefficients
//   (j == i, a dropped peer, a dropped row) left out, so the inner loop
//   has no branch; the entries land in no fixed order, which changes no
//   bit, since ring addition commutes.  The grid is persistent (4 blocks
//   of 256 an SM, striding over element tiles), so the table is built
//   once a block rather than once per 256 elements per client row.  Where
//   I_loc * num_clients candidates pass kTable, the table is built chunk
//   by chunk for each element tile instead.
// * Four consecutive elements a thread: one 16-byte load of each client
//   row and one 16-byte store of out (the wrapper copies rows that are not
//   16-byte aligned).  Each table read serves
//   the four elements, whose streams are four independent chains.  The
//   first kPrefetch rows are loaded before the streams and quantized
//   after them, so a thread's loads are in flight while its streams run;
//   the 64 registers of the launch bound hold them without spilling.
// * The row split, for small n.  With splits > 1 the block's threads form
//   `splits` groups over the same elements; group g takes the g-th slice
//   of the table and the rows g, g + splits, ...  The groups' partial
//   sums are added mod 2^32 in shared memory (ring addition is
//   associative, so the bits are unchanged).  This fills the card where
//   one thread per four elements is less than a wave of it: the paper's
//   MLP (n = 101,632) gives 25,408 such threads against the 135,168 that
//   132 SMs hold at 4 blocks of 256.
// * mask_bits in 12 operations instead of 18, bit for bit.  Write
//   f(v) = v ^ (v >> 16), so that mix32(x) = f(M2 * h(M1 * f(x))) with
//   h(v) = v ^ (v >> 15).  f is linear over xor (f(a ^ b) = f(a) ^ f(b))
//   and its own inverse (f(f(v)) = v, as (v >> 16) >> 16 = 0).  So
//     mask_bits(s, e) = mix32(mix32(e ^ s) ^ (s + kGold))
//                     = f(M2 * h(M1 * (z ^ f(s + kGold)))),
//     z = M2 * h(M1 * (f(e) ^ f(s))):
//   f(e) is computed once per element and f(s), f(s + kGold) once per
//   stream, in the table.  Each stream then costs 5 xors, 3 shifts and 4
//   multiplies, and the multiply-add of its coefficient: 13 operations,
//   where the bound counts 19 (chip_smoke.py, OPS_PER_STREAM).
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
using prf::kM2;
using prf::mix32;

constexpr int kThreads = 256;
constexpr int kElems = 4;     // consecutive elements a thread
constexpr int kMinBlocks = 4;  // blocks an SM: the wrapper's BLOCKS_PER_SM
constexpr int kTable = 512;   // table entries a chunk
constexpr int kPrefetch = 4;  // client rows a thread loads ahead

__device__ __forceinline__ uint32_t pair_seed(uint32_t k0, uint32_t k1,
                                              uint32_t lo, uint32_t hi) {
  uint32_t s = mix32(k0 ^ (lo * kGold));
  s = mix32(s ^ (hi * kM1));
  return mix32(s ^ k1);
}

__device__ __forceinline__ uint32_t fold16(uint32_t v) {
  return v ^ (v >> 16);
}

// The streams of candidates [c0, min(c0 + kTable, total)) of the
// row-major (li, j) grid with a nonzero coefficient, into `table` as
// (f(seed), f(seed + kGold), coefficient, 0); returns their number.  Each
// warp claims its entries' places with one atomic.  The caller makes sure
// no thread still reads the table.
__device__ int build_table(uint4* table, int* count, uint32_t c0,
                           uint32_t total, uint32_t num_clients,
                           uint32_t offset, uint32_t key0, uint32_t key1,
                           const int32_t* __restrict__ alive) {
  if (threadIdx.x == 0) *count = 0;
  __syncthreads();
  const uint32_t c1 = c0 + kTable < total ? c0 + kTable : total;
  const uint32_t lane = threadIdx.x % 32;
  for (uint32_t c = c0 + threadIdx.x; c < c1; c += kThreads) {
    const uint32_t i = offset + c / num_clients;
    const uint32_t j = c % num_clients;
    uint32_t coef = (j == i) ? 0u : (i < j ? 1u : 0xFFFFFFFFu);
    if (alive != nullptr) coef *= (uint32_t)alive[i] * (uint32_t)alive[j];
    const uint32_t active = __activemask();
    const uint32_t keep = __ballot_sync(active, coef != 0u);
    const uint32_t leader = __ffs(active) - 1;
    int base = 0;
    if (lane == leader) base = atomicAdd(count, __popc(keep));
    base = __shfl_sync(active, base, leader);
    if (coef != 0u) {
      const uint32_t seed = pair_seed(key0, key1, min(i, j), max(i, j));
      table[base + __popc(keep & ((1u << lane) - 1u))] =
          make_uint4(fold16(seed), fold16(seed + kGold), coef, 0u);
    }
  }
  __syncthreads();
  return *count;
}

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ int4 load4(const int32_t* p) {
  return __ldg(reinterpret_cast<const int4*>(p));
}

// acc += a * round_half_even(v * scale), elementwise
__device__ __forceinline__ void add_row(uint32_t (&acc)[kElems], float4 v,
                                       float scale, uint32_t a) {
  acc[0] += a * (uint32_t)__float2int_rn(v.x * scale);
  acc[1] += a * (uint32_t)__float2int_rn(v.y * scale);
  acc[2] += a * (uint32_t)__float2int_rn(v.z * scale);
  acc[3] += a * (uint32_t)__float2int_rn(v.w * scale);
}

// the ring mode: acc += a * v, elementwise, v already in Z_2^32
__device__ __forceinline__ void add_row(uint32_t (&acc)[kElems], int4 v,
                                       float, uint32_t a) {
  acc[0] += a * (uint32_t)v.x;
  acc[1] += a * (uint32_t)v.y;
  acc[2] += a * (uint32_t)v.z;
  acc[3] += a * (uint32_t)v.w;
}

// acc[k] += coef * mask_bits(seed, e_k) for the table's streams [lo, hi),
// where fe[k] = f(e_k)
__device__ __forceinline__ void add_streams(const uint4* table, int lo,
                                            int hi,
                                            const uint32_t (&fe)[kElems],
                                            uint32_t (&acc)[kElems]) {
#pragma unroll 2
  for (int t = lo; t < hi; ++t) {
    const uint4 s = table[t];
#pragma unroll
    for (int k = 0; k < kElems; ++k) {
      uint32_t x = (fe[k] ^ s.x) * kM1;
      x = (x ^ (x >> 15)) * kM2;
      x = (x ^ s.y) * kM1;
      x = (x ^ (x >> 15)) * kM2;
      acc[k] += s.z * (x ^ (x >> 16));
    }
  }
}

// T = float: quantize each row (masked_sum_launch); T = int32_t: the rows
// are ring elements already (masked_ring_sum_launch)
template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    masked_sum_kernel(const T* __restrict__ msgs, int i_loc, int64_t n,
                      float scale, uint32_t key0, uint32_t key1,
                      uint32_t offset, int num_clients,
                      const int32_t* __restrict__ alive,
                      int32_t* __restrict__ out, int splits) {
  __shared__ uint4 table[kTable];
  __shared__ uint4 partial[kThreads];  // the groups' sums (row split)
  __shared__ int count;
  const int width = kThreads / splits;  // a group's threads
  const int group = threadIdx.x / width;
  const int lane = threadIdx.x % width;
  const int64_t tile_elems = (int64_t)width * kElems;
  const int64_t tiles = (n + tile_elems - 1) / tile_elems;
  const uint32_t total = (uint32_t)i_loc * (uint32_t)num_clients;
  const bool resident = total <= kTable;
  int entries = 0;
  if (resident) {
    entries = build_table(table, &count, 0, total, num_clients, offset, key0,
                          key1, alive);
  }
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int64_t e0 = tile * tile_elems + (int64_t)lane * kElems;
    const bool valid = e0 < n;  // n is a multiple of 4: all four or none
    uint32_t acc[kElems], fe[kElems];
#pragma unroll
    for (int k = 0; k < kElems; ++k) {
      acc[k] = 0u;
      fe[k] = fold16((uint32_t)(e0 + k));
    }
    // the group's first kPrefetch client rows are loaded before its
    // streams and quantized after them, so the loads are in flight while
    // the streams run
    decltype(load4(msgs)) v[kPrefetch];
#pragma unroll
    for (int r = 0; r < kPrefetch; ++r) {
      const int li = group + r * splits;
      if (valid && li < i_loc) {
        v[r] = load4(msgs + (int64_t)li * n + e0);
      }
    }
    // the group's slice of the streams
    if (resident) {
      add_streams(table, entries * group / splits,
                  entries * (group + 1) / splits, fe, acc);
    } else {
      for (uint32_t c0 = 0; c0 < total; c0 += kTable) {
        __syncthreads();  // the previous chunk's readers are done
        const int m = build_table(table, &count, c0, total, num_clients,
                                  offset, key0, key1, alive);
        add_streams(table, m * group / splits, m * (group + 1) / splits, fe,
                    acc);
      }
    }
    // the group's client rows, quantized (float rows), times alive[i]
    if (valid) {
#pragma unroll
      for (int r = 0; r < kPrefetch; ++r) {
        const int li = group + r * splits;
        if (li < i_loc) {
          add_row(acc, v[r], scale,
                  alive != nullptr ? (uint32_t)alive[offset + li] : 1u);
        }
      }
      for (int li = group + kPrefetch * splits; li < i_loc; li += splits) {
        add_row(acc, load4(msgs + (int64_t)li * n + e0), scale,
                alive != nullptr ? (uint32_t)alive[offset + li] : 1u);
      }
    }
    if (splits > 1) {
      if (group > 0) {
        partial[threadIdx.x] = make_uint4(acc[0], acc[1], acc[2], acc[3]);
      }
      __syncthreads();
      if (group == 0) {
        for (int g = 1; g < splits; ++g) {
          const uint4 p = partial[g * width + lane];
          acc[0] += p.x, acc[1] += p.y, acc[2] += p.z, acc[3] += p.w;
        }
      }
      __syncthreads();  // `partial` is free for the next tile
    }
    if (group == 0 && valid) {
      *reinterpret_cast<int4*>(out + e0) =
          make_int4((int32_t)acc[0], (int32_t)acc[1], (int32_t)acc[2],
                    (int32_t)acc[3]);
    }
  }
}

// The launch of either mode: returns cudaGetLastError()
// (cudaErrorInvalidValue for a plan the kernel does not take).
template <typename T>
int launch(const T* msgs, int i_loc, int64_t n, float scale, uint32_t key0,
           uint32_t key1, uint32_t offset, int num_clients,
           const int32_t* alive, int32_t* out, int splits, int blocks,
           void* stream) {
  if (n == 0) return (int)cudaGetLastError();
  if (n % kElems || splits < 1 || splits > kThreads / 32 ||
      kThreads % splits || blocks < 1 ||
      (int64_t)i_loc * num_clients >= (int64_t)1 << 31) {
    return (int)cudaErrorInvalidValue;
  }
  masked_sum_kernel<T><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      msgs, i_loc, n, scale, key0, key1, offset, num_clients, alive, out,
      splits);
  return (int)cudaGetLastError();
}

}  // namespace

// msgs: device (i_loc, n) f32, contiguous, n a multiple of 4, 16-byte
// aligned; out: device (n,) int32, 16-byte aligned; alive:
// device (num_clients,) int32 of 0/1, or null.  `splits` (1, 2, 4 or 8)
// groups of threads share each element tile; `blocks` is the persistent
// grid.  Launches on `stream`; returns cudaGetLastError()
// (cudaErrorInvalidValue for a plan the kernel does not take).
extern "C" int masked_sum_launch(const float* msgs, int i_loc, int64_t n,
                                 int scale_bits, uint32_t key0, uint32_t key1,
                                 uint32_t offset, int num_clients,
                                 const int32_t* alive, int32_t* out,
                                 int splits, int blocks, void* stream) {
  return launch(msgs, i_loc, n, (float)(1u << scale_bits), key0, key1,
                offset, num_clients, alive, out, splits, blocks, stream);
}

// The ring mode: q is device (i_loc, n) int32, ring elements already, under
// the same layout, plan and alignment rules as masked_sum_launch.
extern "C" int masked_ring_sum_launch(const int32_t* q, int i_loc, int64_t n,
                                      uint32_t key0, uint32_t key1,
                                      uint32_t offset, int num_clients,
                                      const int32_t* alive, int32_t* out,
                                      int splits, int blocks, void* stream) {
  return launch(q, i_loc, n, 0.0f, key0, key1, offset, num_clients, alive,
                out, splits, blocks, stream);
}

// (registers a thread, local (spill) bytes a thread, static shared bytes a
// block) of the quantizing instance (ring == 0) or of the ring mode's int32
// instance (ring != 0), from cudaFuncGetAttributes
extern "C" void masked_sum_attributes(int ring, int* vals) {
  cudaFuncAttributes a;
  if (ring) {
    cudaFuncGetAttributes(&a, masked_sum_kernel<int32_t>);
  } else {
    cudaFuncGetAttributes(&a, masked_sum_kernel<float>);
  }
  vals[0] = a.numRegs;
  vals[1] = (int)a.localSizeBytes;
  vals[2] = (int)a.sharedSizeBytes;
}

// The message of a CUDA error code, for the Python wrappers' exceptions.
extern "C" const char* kernel_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}
