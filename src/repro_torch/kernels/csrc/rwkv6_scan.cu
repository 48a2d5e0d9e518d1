// RWKV-6 WKV scan: data-dependent per-channel decay and the bonus u.
//
// Replaces the TPU kernel src/repro/kernels/rwkv6_scan.py::rwkv6_wkv_bh
// and the layout of its wrapper src/repro/kernels/ops.py::rwkv6_wkv.  For
// each sequence n and head h, from a zero state S (D x D, f32):
//
//   o_t = r_t . (S_{t-1} + diag(u) k_t^T v_t)
//   S_t = diag(exp(lw_t)) S_{t-1} + k_t^T v_t
//
// r, k, v (bf16 or f32) and lw (f32) are read in the model's (N, S, H, D)
// layout, u (f32) as (H, D) with an N-stride of 0 or as (N, H, D); o is
// written f32 in (N, S, H, D).
//
// Bound on the card: f32 operations, close to the bytes.  At rwkv6-7b's
// shape (N = 8, S = 1024, H = 64, D = 64, bf16 r/k/v) the least work is
// the chunked form at chunks of 6 tokens with only the causal pairs
// computed, about 18.6 thousand f32 operations per token and head (9.75
// GFLOP, 145 us at 67 TFLOP/s), against 469.8 MB of r, k, v, lw and o
// (140 us at 3.35 TB/s).  The per-token recurrence this kernel runs does
// 5 D^2 + 6 D (10.9 GFLOP), every product as f32 FMAs on the SIMT lanes,
// with no tensor cores.
//
// Design: the upstream RWKV CUDA kernel's per-token recurrence, not the
// TPU kernel's chunked algebra.  It is simpler, it needs no factorised
// exponentials (the chunked form's exp(-cumsum) reaches e^80 at the -5
// floor, and its unused pairs j >= t can overflow), and every column of
// the state evolves on its own, so the state never leaves registers.  One
// block per (head, sequence); the TPU's sequential chunk grid axis becomes
// a loop inside the block.  Thread (c, q) of the block's D / 4 x kSplit
// threads owns the 4 x 4 tiles of the state at value columns 4c .. 4c + 3
// and key rows 4 (q + kSplit g) .. +3: 4 D / kSplit f32 registers (32 at
// D = 64, kSplit = 8).  Per token it reads r, k and exp(lw) of its rows
// and v of its columns from shared memory as float4s, so each 16-byte
// read feeds 16 FMAs; the kSplit threads of a column group read
// neighbouring 16-byte words, the groups of a warp the same ones
// (broadcast).  It adds r_i (S_ij + u_i k_i v_j) into its partial o_j and
// updates S_ij; the kSplit partials are summed with warp shuffles.  The
// serial chain over the tokens, not a unit of the SM, bounds the kernel:
// 512 blocks leave few warps an SM to hide latency, and spreading a column
// group's rows over 8 threads rather than 4 (twice the warps, shorter
// per-token chains, one more shuffle) made it faster, where 4 columns a
// thread rather than 1 (fewer shared-memory reads) barely did.  The
// tokens are staged in chunks of 16: r, k, v and lw of the next chunk are
// loaded into registers while the current chunk is computed from shared
// memory, so the global loads' latency is paid once per block, not once
// per chunk.  The last chunk may be short.  At rwkv6-7b's shape the 512
// blocks of 128 threads are resident in one wave.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 16;   // tokens staged in shared memory at a time

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// threads sharing one group of 4 value columns (kSplit): 8 at D = 64,
// else as many as leave every thread one float4 of key rows
template <int D>
__host__ __device__ constexpr int split() {
  return D == 64 ? 8 : D / 4;
}

template <int D>
__host__ __device__ constexpr int threads() {
  return D / 4 * split<D>();
}

// r, k, v and lw of the chunk starting at token t0, into registers:
// element e = tid + kThreads l is token t0 + e / D, channel e % D
// (neighbouring threads, neighbouring channels); tokens past seq are not
// read.
template <typename T, int D, int kThreads, int kLoads>
__device__ __forceinline__ void load_chunk(
    const T* __restrict__ r, const T* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ lw, int64_t base,
    int64_t row, int seq, int t0, int tid, float (&pr)[kLoads],
    float (&pk)[kLoads], float (&pv)[kLoads], float (&pw)[kLoads]) {
#pragma unroll
  for (int l = 0; l < kLoads; ++l) {
    const int e = tid + kThreads * l;
    const int t = t0 + e / D;
    if (t < seq) {
      const int64_t off = base + t * row + e % D;
      pr[l] = to_f32(r[off]);
      pk[l] = to_f32(k[off]);
      pv[l] = to_f32(v[off]);
      pw[l] = lw[off];
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(threads<D>())
    rwkv6_wkv_kernel(const T* __restrict__ r, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ lw,
                     const float* __restrict__ u, float* __restrict__ out,
                     int seq, int heads, int64_t u_stride_n) {
  constexpr int kSplit = split<D>();
  constexpr int kThreads = threads<D>();
  constexpr int kGroups = D / (4 * kSplit);     // float4s of rows a thread
  constexpr int kLoads = kChunk * D / kThreads;  // staged values a thread
  static_assert(kGroups >= 1 && kChunk * D % kThreads == 0, "head size");
  __shared__ __align__(16) float rs[kChunk][D];
  __shared__ __align__(16) float ks[kChunk][D];
  __shared__ __align__(16) float ws[kChunk][D];
  __shared__ __align__(16) float vs[kChunk][D];

  const int tid = threadIdx.x;
  const int c = tid / kSplit;   // value columns 4c .. 4c + 3
  const int q = tid % kSplit;   // slice of key rows
  const int h = blockIdx.x;
  const int64_t n = blockIdx.y;
  const int64_t row = (int64_t)heads * D;   // stride between tokens
  const int64_t base = n * seq * row + (int64_t)h * D;
  const unsigned lanes =
      kThreads >= 32 ? 0xffffffffu : (1u << kThreads) - 1u;

  // the thread's block of the state: key rows 4 (q + kSplit g) + a, value
  // columns 4c + b, at st[4 g + a][b]
  float uu[4 * kGroups];
  float st[4 * kGroups][4];
  const float* un = u + n * u_stride_n + (int64_t)h * D;
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      uu[4 * g + a] = un[4 * (q + kSplit * g) + a];
#pragma unroll
      for (int b = 0; b < 4; ++b) st[4 * g + a][b] = 0.f;
    }
  }

  // the staged chunk in registers (see load_chunk)
  float pr[kLoads], pk[kLoads], pv[kLoads], pw[kLoads];
  load_chunk<T, D, kThreads, kLoads>(r, k, v, lw, base, row, seq, 0, tid, pr,
                                    pk, pv, pw);
  for (int t0 = 0; t0 < seq; t0 += kChunk) {
    const int len = min(kChunk, seq - t0);
    __syncthreads();   // the previous chunk's reads are done
#pragma unroll
    for (int l = 0; l < kLoads; ++l) {
      const int e = tid + kThreads * l;
      if (e / D < len) {
        rs[e / D][e % D] = pr[l];
        ks[e / D][e % D] = pk[l];
        vs[e / D][e % D] = pv[l];
        ws[e / D][e % D] = expf(pw[l]);
      }
    }
    __syncthreads();
    if (t0 + kChunk < seq)   // in flight while this chunk is computed
      load_chunk<T, D, kThreads, kLoads>(r, k, v, lw, base, row, seq,
                                         t0 + kChunk, tid, pr, pk, pv, pw);

    for (int t = 0; t < len; ++t) {
      const float4 v4 = *reinterpret_cast<const float4*>(&vs[t][4 * c]);
      const float vb[4] = {v4.x, v4.y, v4.z, v4.w};
      float y[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        const int i = 4 * (q + kSplit * g);
        const float4 r4 = *reinterpret_cast<const float4*>(&rs[t][i]);
        const float4 k4 = *reinterpret_cast<const float4*>(&ks[t][i]);
        const float4 w4 = *reinterpret_cast<const float4*>(&ws[t][i]);
        const float ra[4] = {r4.x, r4.y, r4.z, r4.w};
        const float ka[4] = {k4.x, k4.y, k4.z, k4.w};
        const float wa[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int a = 0; a < 4; ++a) {
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            float& sab = st[4 * g + a][b];
            const float kv = ka[a] * vb[b];
            y[b] = fmaf(ra[a], fmaf(uu[4 * g + a], kv, sab), y[b]);
            sab = fmaf(sab, wa[a], kv);
          }
        }
      }
      // every lane of the column group gets the sums; lane q stores the
      // columns b with b % kSplit == q
#pragma unroll
      for (int off = 1; off < kSplit; off <<= 1) {
#pragma unroll
        for (int b = 0; b < 4; ++b) y[b] += __shfl_xor_sync(lanes, y[b], off);
      }
      float* o = out + base + (t0 + t) * row + 4 * c;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (b % kSplit == q) o[b] = y[b];
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* lw, const void* u, void* out, int n, int seq,
                   int heads, int64_t u_stride_n, cudaStream_t stream) {
  const dim3 grid(heads, n);
  rwkv6_wkv_kernel<T, D><<<grid, threads<D>(), 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(lw),
      static_cast<const float*>(u), static_cast<float*>(out), seq, heads,
      u_stride_n);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dtype(const void* r, const void* k, const void* v,
                         const void* lw, const void* u, void* out, int n,
                         int seq, int heads, int head_dim, int64_t u_stride_n,
                         cudaStream_t stream) {
  switch (head_dim) {
    case 16:
      return launch<T, 16>(r, k, v, lw, u, out, n, seq, heads, u_stride_n,
                           stream);
    case 64:
      return launch<T, 64>(r, k, v, lw, u, out, n, seq, heads, u_stride_n,
                           stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// r/k/v: device (n, seq, heads, head_dim), contiguous, f32 (dtype 0) or
// bf16 (dtype 1); lw/out: f32 of the same shape; u: f32 (heads, head_dim)
// with u_stride_n = 0, or (n, heads, head_dim) with u_stride_n =
// heads * head_dim; head_dim is 16 or 64 (the card paths' head sizes).
// Launches on `stream`; returns cudaGetLastError() (cudaErrorInvalidValue
// for a head_dim or dtype the kernel does not take).
extern "C" int rwkv6_wkv_launch(const void* r, const void* k, const void* v,
                                const void* lw, const void* u, void* out,
                                int n, int seq, int heads, int head_dim,
                                int64_t u_stride_n, int dtype, void* stream) {
  if (n == 0 || seq == 0 || heads == 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return (int)launch_dtype<float>(r, k, v, lw, u, out, n, seq, heads,
                                      head_dim, u_stride_n, s);
    case 1:
      return (int)launch_dtype<__nv_bfloat16>(r, k, v, lw, u, out, n, seq,
                                              heads, head_dim, u_stride_n, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
