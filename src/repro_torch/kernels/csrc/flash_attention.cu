// Causal flash attention with grouped-query heads (GQA), f32 q/k/v on the
// SIMT lanes.
//
// Replaces the TPU kernel
// src/repro/kernels/flash_attention.py::flash_attention_bhsd and the head
// mapping of its wrapper src/repro/kernels/ops.py::flash_attention.  For
// each batch row b, query head h (kv head hk = h / (H / Hkv)) and query
// position i:
//
//   out[b, i, h, :] = sum_{j <= i} softmax_j(scale * q[b,i,h,:] . k[b,j,hk,:])
//                     * v[b, j, hk, :]
//
// with f32 scores, probabilities and accumulators; q/k/v and out are f32,
// in the model's (B, S, H, Dh) and (B, S, Hkv, Dh) layouts.  k and v are
// read un-repeated (the reference's wrapper broadcasts them G-fold), and
// Dh is not padded to 128 (the reference's wrapper pads it).
//
// This kernel serves f32 inputs only; bf16 inputs go to the tensor-core
// kernel of flash_attention_sm90.cu.  Bound on the card: operations, at
// the f32 SIMT peak (67 TFLOP/s): the tensor cores' TF32 keeps 10 bits of
// mantissa and would break the kernel's 2e-5 agreement with its plain
// version, so the FLOPs stay f32 FMAs on the SIMT lanes.
//
// Design: one block of 256 threads per (64-row query tile, query head,
// batch row); the TPU's sequential kv grid axis and its pl.when skip
// become a loop inside the block over the 32-key K/V tiles up to the
// diagonal.  The query tile and each K/V tile are staged in shared memory
// as f32; thread (ty, tx) of the 16 x 16 layout owns query rows ty + 16 r
// (r < 4), score columns tx + 16 c (c < 2) and output columns tx + 16 j
// (j < Dh / 16).  The running max, sum and output accumulator live in
// registers; the row max and sum are reduced over the 16 threads of a
// row with warp shuffles (the 16 threads are one half-warp).  The
// diagonal tile is masked elementwise and the ragged last tile by bounds
// (keys and queries past S load as zeros, and their outputs are not
// stored), so S need not be a multiple of 64.  The first K/V tile always
// holds key 0, visible to every query row, so the running max is finite
// from the first tile on and a fully masked row of a later tile adds
// exp(-inf) = 0.  Row strides of Dh + 4 floats keep the float4 reads of q
// and k conflict-free.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 64;   // query rows per block
constexpr int kBlockN = 32;   // keys per K/V tile
constexpr int kThreads = 256;
constexpr int kRows = kBlockM / 16;
constexpr int kKeys = kBlockN / 16;
constexpr int kPS = kBlockN + 1;   // row stride of the probabilities

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((kBlockM + kBlockN) * (D + 4) + kBlockN * D +
                          kBlockM * kPS);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           float* __restrict__ out, int seq, int heads,
                           int kv_heads, float scale) {
  constexpr int kCols = D / 16;
  constexpr int kS = D + 4;   // row stride of the q and k tiles
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // kBlockM x kS
  float* ks = qs + kBlockM * kS;                 // kBlockN x kS
  float* vs = ks + kBlockN * kS;                 // kBlockN x D
  float* ps = vs + kBlockN * D;                  // kBlockM x kPS

  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int q0 = blockIdx.x * kBlockM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (heads / kv_heads);
  const int64_t q_pos = (int64_t)heads * D;      // elements per position
  const int64_t kv_pos = (int64_t)kv_heads * D;
  const float* qb = q + (int64_t)b * seq * q_pos + (int64_t)h * D;
  const float* kb = k + (int64_t)b * seq * kv_pos + (int64_t)hk * D;
  const float* vb = v + (int64_t)b * seq * kv_pos + (int64_t)hk * D;
  float* ob = out + (int64_t)b * seq * q_pos + (int64_t)h * D;

  for (int i = tid; i < kBlockM * D; i += kThreads) {
    const int r = i / D;
    const int d = i % D;
    const int s = q0 + r;
    qs[r * kS + d] = s < seq ? qb[(int64_t)s * q_pos + d] : 0.0f;
  }

  float m[kRows], l[kRows], acc[kRows][kCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.0f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[r][j] = 0.0f;
  }

  const int last = min(q0 + kBlockM, seq) - 1;   // last query row stored
  for (int n0 = 0; n0 <= last; n0 += kBlockN) {
    __syncthreads();   // q is staged; the previous tile's readers are done
    for (int i = tid; i < kBlockN * D; i += kThreads) {
      const int r = i / D;
      const int d = i % D;
      const int s = n0 + r;
      const bool ok = s < seq;
      ks[r * kS + d] = ok ? kb[(int64_t)s * kv_pos + d] : 0.0f;
      vs[r * D + d] = ok ? vb[(int64_t)s * kv_pos + d] : 0.0f;
    }
    __syncthreads();

    float sc[kRows][kKeys];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kKeys; ++c) sc[r][c] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[kRows], kv[kKeys];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        qv[r] = *reinterpret_cast<const float4*>(&qs[(ty + 16 * r) * kS + d]);
#pragma unroll
      for (int c = 0; c < kKeys; ++c)
        kv[c] = *reinterpret_cast<const float4*>(&ks[(tx + 16 * c) * kS + d]);
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < kKeys; ++c) {
          float a = sc[r][c];
          a = fmaf(qv[r].x, kv[c].x, a);
          a = fmaf(qv[r].y, kv[c].y, a);
          a = fmaf(qv[r].z, kv[c].z, a);
          a = fmaf(qv[r].w, kv[c].w, a);
          sc[r][c] = a;
        }
    }

#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qpos = q0 + ty + 16 * r;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < kKeys; ++c) {
        const int kpos = n0 + tx + 16 * c;
        sc[r][c] = kpos <= qpos ? sc[r][c] * scale : -INFINITY;
        mx = fmaxf(mx, sc[r][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < kKeys; ++c) {
        const float p = expf(sc[r][c] - m_new);
        ps[(ty + 16 * r) * kPS + tx + 16 * c] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[r] = l[r] * alpha + sum;
      m[r] = m_new;
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[r][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int n = 0; n < kBlockN; ++n) {
      float pv[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) pv[r] = ps[(ty + 16 * r) * kPS + n];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float vv = vs[n * D + tx + 16 * j];
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r][j] = fmaf(pv[r], vv, acc[r][j]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int s = q0 + ty + 16 * r;
    if (s < seq) {
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        ob[(int64_t)s * q_pos + tx + 16 * j] = acc[r][j] / l[r];
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int batch, int seq, int heads, int kv_heads, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  // above 48 KB a block's dynamic shared memory must be allowed first;
  // once per instance, so that no attribute call falls inside a CUDA
  // graph capture (callers launch once before capturing)
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 grid((seq + kBlockM - 1) / kBlockM, heads, batch);
  flash_attention_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), seq, heads,
      kv_heads, scale);
  return cudaGetLastError();
}

template <int D>
void attributes(int* out) {
  cudaFuncAttributes a;
  if (cudaFuncGetAttributes(&a, flash_attention_kernel<D>) != cudaSuccess) {
    out[0] = out[1] = out[2] = -1;
    return;
  }
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)smem_bytes<D>();
}

}  // namespace

// q/out: device (batch, seq, heads, head_dim), k/v: device (batch, seq,
// kv_heads, head_dim), contiguous f32; kv_heads divides heads; head_dim is
// 16, 32, 64 or 128.  Launches on `stream`; returns cudaGetLastError()
// (cudaErrorInvalidValue for a head_dim or head count the kernel does not
// take).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int batch,
                                      int seq, int heads, int kv_heads,
                                      int head_dim, float scale,
                                      void* stream) {
  if (kv_heads <= 0 || heads % kv_heads) return (int)cudaErrorInvalidValue;
  if (batch == 0 || seq == 0 || heads == 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  switch (head_dim) {
    case 16:
      return (int)launch<16>(q, k, v, out, batch, seq, heads, kv_heads,
                             scale, s);
    case 32:
      return (int)launch<32>(q, k, v, out, batch, seq, heads, kv_heads,
                             scale, s);
    case 64:
      return (int)launch<64>(q, k, v, out, batch, seq, heads, kv_heads,
                             scale, s);
    case 128:
      return (int)launch<128>(q, k, v, out, batch, seq, heads, kv_heads,
                              scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// registers a thread, local (spill) bytes a thread and dynamic shared
// bytes a block of the instance for head_dim, into out[0..2] (-1 each for
// a head_dim without an instance)
extern "C" void flash_attention_attributes(int head_dim, int* out) {
  switch (head_dim) {
    case 16: return attributes<16>(out);
    case 32: return attributes<32>(out);
    case 64: return attributes<64>(out);
    case 128: return attributes<128>(out);
    default: out[0] = out[1] = out[2] = -1;
  }
}
