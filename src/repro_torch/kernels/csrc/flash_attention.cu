// Causal flash attention with grouped-query heads (GQA).
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
// with f32 scores, probabilities and accumulators; q/k/v and out are bf16
// or f32, in the model's (B, S, H, Dh) and (B, S, Hkv, Dh) layouts.  k and
// v are read un-repeated (the reference's wrapper broadcasts them G-fold),
// and Dh is not padded to 128 (the reference's wrapper pads it).
//
// Bound on the card: operations.  At the main path's shape (B = 8, S =
// 1024, H = 32, Hkv = 8, Dh = 128, bf16) the causal half of Q.K^T and P.V
// is 68.7 GFLOP against 167.8 MB of q, k, v and out: 69.5 us at the bf16
// tensor-core peak, 50.1 us at the memory rate.  This first kernel does
// its FLOPs as f32 FMAs on the SIMT lanes (67 TFLOP/s peak), about 15
// times slower than the tensor cores could; mma.sync / wgmma and TMA
// staging are left to a later kernel.
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
#include <cuda_bf16.h>
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

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((kBlockM + kBlockN) * (D + 4) + kBlockN * D +
                          kBlockM * kPS);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           int seq, int heads, int kv_heads, float scale) {
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
  const T* qb = q + (int64_t)b * seq * q_pos + (int64_t)h * D;
  const T* kb = k + (int64_t)b * seq * kv_pos + (int64_t)hk * D;
  const T* vb = v + (int64_t)b * seq * kv_pos + (int64_t)hk * D;
  T* ob = out + (int64_t)b * seq * q_pos + (int64_t)h * D;

  for (int i = tid; i < kBlockM * D; i += kThreads) {
    const int r = i / D;
    const int d = i % D;
    const int s = q0 + r;
    qs[r * kS + d] = s < seq ? to_f32(qb[(int64_t)s * q_pos + d]) : 0.0f;
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
      ks[r * kS + d] = ok ? to_f32(kb[(int64_t)s * kv_pos + d]) : 0.0f;
      vs[r * D + d] = ok ? to_f32(vb[(int64_t)s * kv_pos + d]) : 0.0f;
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
        store(&ob[(int64_t)s * q_pos + tx + 16 * j], acc[r][j] / l[r]);
    }
  }
}

template <typename T, int D>
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
        flash_attention_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 grid((seq + kBlockM - 1) / kBlockM, heads, batch);
  flash_attention_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), seq, heads, kv_heads,
      scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dtype(const void* q, const void* k, const void* v,
                         void* out, int batch, int seq, int heads,
                         int kv_heads, int head_dim, float scale,
                         cudaStream_t stream) {
  switch (head_dim) {
    case 16:
      return launch<T, 16>(q, k, v, out, batch, seq, heads, kv_heads, scale,
                           stream);
    case 32:
      return launch<T, 32>(q, k, v, out, batch, seq, heads, kv_heads, scale,
                           stream);
    case 64:
      return launch<T, 64>(q, k, v, out, batch, seq, heads, kv_heads, scale,
                           stream);
    case 128:
      return launch<T, 128>(q, k, v, out, batch, seq, heads, kv_heads, scale,
                            stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q/out: device (batch, seq, heads, head_dim), k/v: device (batch, seq,
// kv_heads, head_dim), contiguous, all f32 (dtype 0) or bf16 (dtype 1);
// kv_heads divides heads; head_dim is 16, 32, 64 or 128.  Launches on
// `stream`; returns cudaGetLastError() (cudaErrorInvalidValue for a
// head_dim, dtype or head count the kernel does not take).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int batch,
                                      int seq, int heads, int kv_heads,
                                      int head_dim, int dtype, float scale,
                                      void* stream) {
  if (kv_heads <= 0 || heads % kv_heads) return (int)cudaErrorInvalidValue;
  if (batch == 0 || seq == 0 || heads == 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return (int)launch_dtype<float>(q, k, v, out, batch, seq, heads,
                                      kv_heads, head_dim, scale, s);
    case 1:
      return (int)launch_dtype<__nv_bfloat16>(q, k, v, out, batch, seq,
                                              heads, kv_heads, head_dim,
                                              scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
