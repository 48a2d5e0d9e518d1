// Flash attention with grouped-query heads (GQA), f32 q/k/v on the
// tensor cores: every product a 3xTF32 mma.sync; causal, causal with a
// sliding window, or without a mask over a key length of its own.
//
// Replaces the TPU kernel
// src/repro/kernels/flash_attention.py::flash_attention_bhsd and the head
// mapping of its wrapper src/repro/kernels/ops.py::flash_attention; with
// window > 0, also the band of the reference model's
// src/repro/models/attention.py::attend(window=), and without causality
// its attend(causal=False) (the audio family's encoder and
// cross-attention), both of which the reference runs in XLA.  For each
// batch row b, query head h (kv head hk = h / (H / Hkv)) and query
// position i, over the visible keys j (causal: j <= i and, with
// window > 0, j > i - window; non-causal: every j < Sk):
//
//   out[b, i, h, :] = sum_j softmax_j(scale * q[b,i,h,:] . k[b,j,hk,:])
//                     * v[b, j, hk, :]
//
// with f32 scores, probabilities and accumulators; q/k/v and out are f32,
// in the model's (B, Sq, H, Dh) and (B, Sk, Hkv, Dh) layouts (Sq = Sk
// unless non-causal).  k and v are read un-repeated (the reference's
// wrapper broadcasts them G-fold), and Dh is not padded to 128 (the
// reference's wrapper pads it).  bf16 inputs go to the wgmma kernel of
// flash_attention_sm90.cu.
//
// Bound on the card: operations.  At llama3-8b's attention in f32
// ((8, 1024, 32, 8, 128)) the causal pairs need 68.79 GFLOP and the
// bytes are 335.5 MB (0.100 ms).  f32-accurate products take three TF32
// passes (tf32x3.cuh; one pass keeps 11 bits and breaks the kernel's 2e-5
// agreement with its plain version): 0.417 ms at the 495 TFLOP/s TF32
// rate, below the 1.027 ms the same FLOPs take as f32 FMAs at 67 TFLOP/s.
//
// Design (FlashAttention-2): a block of W warps takes 16 W query rows of
// one (query head, batch row), W = min(8, ceil(Sq / 16)), so a 32-token
// sequence runs 2 warps and no idle rows; the heaviest query tiles are
// launched first.  The block walks the K/V tiles of 64 keys up to its
// last row (the TPU's sequential kv grid axis and its pl.when skip; all
// ceil(Sk / 64) of them without causality), brought into shared memory
// by cp.async (keys past Sk zero-filled), double-buffered, two barriers a
// tile.  Each warp owns 16 query rows and keeps their running max and sum
// and their output accumulator (mma accumulators) in registers; it skips
// a tile past its last row.  Per tile and warp:
//   S = Q K^T as mma m16n8k8, q the A operand: the two k-steps of each
//     16-dim group take slots (t4, t4 + 4) as dims (4 t4 + 0, + 1) and
//     (+ 2, + 3), so K is read as the B operand of both by one
//     conflict-free LDS.128 (row stride = 16 mod 32 words);
//   scale (times log2 e), the causal mask on the diagonal tile (without
//     causality, keys past Sk on a ragged last tile), the row max over the
//     quad (two shuffles), the f32 online softmax in exp2;
//   O += P V: the score accumulators are P's A fragment as they stand,
//     with slots (t4, t4 + 4) taken as keys (2 t4, 2 t4 + 1), and V is
//     read as the B operand at those keys (row stride = 4 mod 16 words,
//     conflict-free).
// Every operand is split into hi + lo as it is read, and each product is
// summed in three passes, issued over four accumulators at a time (four
// key groups of S, four 8-dim tiles of O): a tile's three passes back to
// back would wait on the mma latency.  Each thread keeps its q in shared
// memory as A fragments, one float4 a k-step in mma order, read back by
// itself alone: registers are short at Dh 128, and q in load order would
// be gathered into a register quad before every mma.  The diagonal tile
// is computed whole and masked: branches around its key groups cost more
// than the work they skip.  mma.sync reaches only part of the tensor
// cores' TF32 rate on Hopper, and the splits and the softmax issue beside
// it; wgmma (m64nNk8, B from shared memory, asynchronous) is the route
// to the rest.
// Head dim 96 (phi-3-vision) is 6 groups of 16 dims and 12 output tiles.
// Head dim 256 (recurrentgemma-9b) takes 32-key tiles and at most 4 warps
// (Layout<256>): its q fragments (64 rows x 256 x 4 B, 64 KB) and two K/V
// stages of 32 keys (2 x 66.5 KB) fit the 227 KB a block may take, where
// 64-key stages alone would take 266 KB.
// Ragged S: query rows past Sq load as zero and are not stored; without a
// window the first tile holds key 0, which every row sees, so the running
// max is finite from then on and masked scores add exp2(-inf) = 0.
// The band (window > 0): the block walks the tiles from the one holding
// key q0 - window + 1 (q0 its first row); a warp skips a tile wholly below
// its first row's band, and masks the tiles that cross its last row's
// lower edge as it masks the diagonal one.  A row may then see no key of
// its first tile: its running max stays -inf, and the softmax takes 0 as
// its base there, so such scores add exp2(-inf) = 0 and not NaN.
// Without causality (the encoder's self-attention, cross-attention) no
// zero-filled key past Sk may reach the softmax, where it would add
// exp2(0 - max) to the sum: the last key tile masks keys >= Sk when Sk is
// not a multiple of the tile.  The mask is a template parameter: the
// causal instance carries none of the band's or the tail's code, and keeps
// its registers.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

using tf32x3::cp_async16;
using tf32x3::mma;
using tf32x3::split;
using tf32x3::split_b;

// the mask: causal, causal banded to a window, or none over Sk keys
enum Mask : int { kMaskCausal = 0, kMaskBand = 1, kMaskNone = 2 };

template <int D>
struct Layout {
  // keys a K/V tile and warps a block (head dim 256: 32 and 4)
  static constexpr int kKeys = D > 128 ? 32 : 64;
  static constexpr int kMaxWarps = D > 128 ? 4 : 8;
  static constexpr int kKS = D % 32 == 0 ? D + 16 : D;   // = 16 mod 32
  static constexpr int kVS = D + 4;                      // = 4 mod 16
  static constexpr int kStage = kKeys * (kKS + kVS);     // floats a stage
  // each warp's q fragments (16 rows x D), then two K/V stages
  static constexpr size_t smem(int warps) {
    return (16 * warps * D + 2 * kStage) * sizeof(float);
  }
};

template <int D, int M>
__global__ void __launch_bounds__(32 * Layout<D>::kMaxWarps,
                                  D <= 32 ? 2 : 1)
    flash_attention_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           float* __restrict__ out, int seq_q, int seq_k,
                           int heads, int kv_heads, float scale,
                           int window) {
  using L = Layout<D>;
  constexpr bool kBand = M == kMaskBand, kFull = M == kMaskNone;
  constexpr int kKS = L::kKS, kVS = L::kVS, kKeys = L::kKeys;
  constexpr int kGroups = D / 16;   // 16-dim groups of q and k
  constexpr int kDimTiles = D / 8;  // 8-dim tiles of the output
  constexpr int kKeyTiles = kKeys / 8;
  extern __shared__ float4 smem4[];

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const int rows_block = nthreads / 2;   // 16 rows a warp
  float* kv0 = reinterpret_cast<float*>(smem4) + rows_block * D;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * rows_block;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (heads / kv_heads);
  const int64_t q_pos = (int64_t)heads * D;   // elements per position
  const int64_t kv_pos = (int64_t)kv_heads * D;
  const float* qb = q + (int64_t)b * seq_q * q_pos + (int64_t)h * D;
  const float* kb = k + (int64_t)b * seq_k * kv_pos + (int64_t)hk * D;
  const float* vb = v + (int64_t)b * seq_k * kv_pos + (int64_t)hk * D;
  float* ob = out + (int64_t)b * seq_q * q_pos + (int64_t)h * D;

  // causal: the tiles up to the block's last row; else all of Sk
  const int tiles = kFull ? (seq_k + kKeys - 1) / kKeys
                          : (min(q0 + rows_block, seq_q) - 1) / kKeys + 1;
  // the band's first tile: the one holding key q0 - window + 1
  const int t_first = kBand && q0 >= window ? (q0 - window + 1) / kKeys : 0;
  const int w0 = q0 + 16 * warp;   // the warp's first row
  const int w_last = w0 + 15;
  const int r0 = w0 + g, r1 = r0 + 8;   // this thread's two rows
  const float scale_log2 = scale * 1.4426950408889634f;   // log2 e

  // K/V tile t into stage t % 2 as one cp.async group (an empty group
  // past the last tile, so every wait counts alike)
  auto stage = [&](int t) {
    if (t < tiles) {
      float* ks = kv0 + (t & 1) * L::kStage;
      float* vs = ks + kKeys * kKS;
      const int n0 = t * kKeys;
      for (int i = tid; i < kKeys * (D / 4); i += nthreads) {
        const int r = i / (D / 4), c = (i % (D / 4)) * 4;
        const bool in = n0 + r < seq_k;
        const int64_t off = (int64_t)(n0 + r) * kv_pos + c;
        cp_async16(ks + r * kKS + c, in ? kb + off : kb, in);
        cp_async16(vs + r * kVS + c, in ? vb + off : vb, in);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  stage(t_first);

  // this thread's q (rows r0 and r1, dims 16 j + 4 t4 .. + 3 of each
  // group j) as A fragments, kept in shared memory for want of registers:
  // one float4 a k-step, {(r0, d), (r1, d), (r0, d + 1), (r1, d + 1)}
  // with d = 16 j + 4 t4 (+ 2 for the second k-step), so that each
  // fragment is one LDS.128 into the four consecutive registers the mma
  // reads.  Each thread reads back only what it wrote.
  float4* qf = reinterpret_cast<float4*>(smem4) + warp * 2 * kGroups * 32 +
               lane;
#pragma unroll
  for (int j = 0; j < kGroups; ++j) {
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    const float* p0 = qb + (int64_t)r0 * q_pos + 16 * j + 4 * t4;
    const float4 a = r0 < seq_q ? *reinterpret_cast<const float4*>(p0)
                                : zero;
    const float4 c = r1 < seq_q ? *reinterpret_cast<const float4*>(
                                    p0 + 8 * q_pos)
                              : zero;
    qf[(2 * j) * 32] = make_float4(a.x, c.x, a.y, c.y);
    qf[(2 * j + 1) * 32] = make_float4(a.z, c.z, a.w, c.w);
  }

  float o[kDimTiles][4];
#pragma unroll
  for (int d = 0; d < kDimTiles; ++d)
    o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.0f;
  float m0 = -INFINITY, m1 = -INFINITY;   // running max of rows r0, r1
  float l0 = 0.0f, l1 = 0.0f;             // this thread's part of the sums

  for (int t = t_first; t < tiles; ++t) {
    stage(t + 1);
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();   // tile t has landed for every thread
    const int n0 = t * kKeys;
    // the warp's rows see keys up to w_last (every key without
    // causality) and, with a window, from w0 - window + 1
    if ((kFull || n0 <= w_last) && w0 < seq_q &&
        (!kBand || n0 + kKeys - 1 > w0 - window)) {
      const float* ks = kv0 + (t & 1) * L::kStage;
      const float* vs = ks + kKeys * kKS;

      float s[kKeyTiles][4];
#pragma unroll
      for (int nt = 0; nt < kKeyTiles; ++nt)
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.0f;
#pragma unroll
      for (int j = 0; j < kGroups; ++j) {
        // A fragments of the group's two k-steps: slots (t4, t4 + 4) are
        // dims (+0, +1), then (+2, +3)
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int st = 0; st < 2; ++st) {
          const float4 a = qf[(2 * j + st) * 32];
          split(a.x, ah[st][0], al[st][0]);
          split(a.y, ah[st][1], al[st][1]);
          split(a.z, ah[st][2], al[st][2]);
          split(a.w, ah[st][3], al[st][3]);
        }
        // four key groups at a time, each pass over all four before the
        // next, so consecutive mma's accumulate into different tiles
#pragma unroll
        for (int n4 = 0; n4 < kKeyTiles; n4 += 4) {
          uint32_t bb[2][4][4];   // [k-step][key group] {hi0, hi1, lo0, lo1}
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float4 kv = *reinterpret_cast<const float4*>(
                ks + (8 * (n4 + i) + g) * kKS + 16 * j + 4 * t4);
            split_b(kv.x, kv.y, bb[0][i]);
            split_b(kv.z, kv.w, bb[1][i]);
          }
#pragma unroll
          for (int st = 0; st < 2; ++st) {
#pragma unroll
            for (int i = 0; i < 4; ++i)
              mma(s[n4 + i], al[st], bb[st][i][0], bb[st][i][1]);
#pragma unroll
            for (int i = 0; i < 4; ++i)
              mma(s[n4 + i], ah[st], bb[st][i][2], bb[st][i][3]);
#pragma unroll
            for (int i = 0; i < 4; ++i)
              mma(s[n4 + i], ah[st], bb[st][i][0], bb[st][i][1]);
          }
        }
      }

      // scale (times log2 e, for exp2), the causal mask on the diagonal
      // tile, the band's on a tile across its lower edge, and without
      // causality keys past Sk on a ragged last tile; the row max over
      // the quad
      const bool diag = !kFull && n0 + kKeys - 1 > w0;
      const bool edge = kBand && n0 <= w_last - window;
      const bool tail = kFull && n0 + kKeys > seq_k;
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < kKeyTiles; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = n0 + 8 * nt + 2 * t4 + e;
          const float x0 = s[nt][e] * scale_log2;
          const float x1 = s[nt][2 + e] * scale_log2;
          const bool past = tail && key >= seq_k;
          s[nt][e] = (diag && key > r0) || (edge && key <= r0 - window) ||
                             past
                         ? -INFINITY
                         : x0;
          s[nt][2 + e] = (diag && key > r1) ||
                                 (edge && key <= r1 - window) || past
                             ? -INFINITY
                             : x1;
          mx0 = fmaxf(mx0, s[nt][e]);
          mx1 = fmaxf(mx1, s[nt][2 + e]);
        }
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      // the softmax's base: the running max, or 0 for a row that has
      // seen no key yet (only under a band)
      const float b0 = kBand && mn0 == -INFINITY ? 0.0f : mn0;
      const float b1 = kBand && mn1 == -INFINITY ? 0.0f : mn1;
      const float alpha0 = exp2f(m0 - b0), alpha1 = exp2f(m1 - b1);
      m0 = mn0;
      m1 = mn1;
      float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
      for (int nt = 0; nt < kKeyTiles; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[nt][e] = exp2f(s[nt][e] - b0);
          s[nt][2 + e] = exp2f(s[nt][2 + e] - b1);
          sum0 += s[nt][e];
          sum1 += s[nt][2 + e];
        }
      }
      l0 = l0 * alpha0 + sum0;
      l1 = l1 * alpha1 + sum1;
#pragma unroll
      for (int d = 0; d < kDimTiles; ++d) {
        o[d][0] *= alpha0;
        o[d][1] *= alpha0;
        o[d][2] *= alpha1;
        o[d][3] *= alpha1;
      }

      // O += P V over the key groups: P's A fragment is the scores'
      // accumulator, slots (t4, t4 + 4) = keys (2 t4, 2 t4 + 1); four
      // output tiles at a time, each pass over all four before the next
      constexpr int kDG = kDimTiles < 4 ? kDimTiles : 4;
#pragma unroll
      for (int nt = 0; nt < kKeyTiles; ++nt) {
        uint32_t ph[4], pl[4];
        split(s[nt][0], ph[0], pl[0]);
        split(s[nt][2], ph[1], pl[1]);
        split(s[nt][1], ph[2], pl[2]);
        split(s[nt][3], ph[3], pl[3]);
        const float* vr = vs + (8 * nt + 2 * t4) * kVS + g;
#pragma unroll
        for (int d4 = 0; d4 < kDimTiles; d4 += kDG) {
          uint32_t bb[kDG][4];
#pragma unroll
          for (int i = 0; i < kDG; ++i)
            split_b(vr[8 * (d4 + i)], vr[kVS + 8 * (d4 + i)], bb[i]);
#pragma unroll
          for (int i = 0; i < kDG; ++i)
            mma(o[d4 + i], pl, bb[i][0], bb[i][1]);
#pragma unroll
          for (int i = 0; i < kDG; ++i)
            mma(o[d4 + i], ph, bb[i][2], bb[i][3]);
#pragma unroll
          for (int i = 0; i < kDG; ++i)
            mma(o[d4 + i], ph, bb[i][0], bb[i][1]);
        }
      }
    }
    __syncthreads();   // stage t % 2 is free for tile t + 2
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
#pragma unroll
  for (int d = 0; d < kDimTiles; ++d) {
    const int col = 8 * d + 2 * t4;
    if (r0 < seq_q)
      *reinterpret_cast<float2*>(ob + (int64_t)r0 * q_pos + col) =
          make_float2(o[d][0] / l0, o[d][1] / l0);
    if (r1 < seq_q)
      *reinterpret_cast<float2*>(ob + (int64_t)r1 * q_pos + col) =
          make_float2(o[d][2] / l1, o[d][3] / l1);
  }
}

template <int D, int M>
cudaError_t launch_instance(const void* q, const void* k, const void* v,
                            void* out, int batch, int seq_q, int seq_k,
                            int heads, int kv_heads, float scale, int window,
                            cudaStream_t stream) {
  using L = Layout<D>;
  const int warps = min(L::kMaxWarps, (seq_q + 15) / 16);
  const size_t smem = L::smem(warps);
  // above 48 KB a block's dynamic shared memory must be allowed first;
  // once per instance, so that no attribute call falls inside a CUDA
  // graph capture (callers launch once before capturing)
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_kernel<D, M>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)L::smem(L::kMaxWarps));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const int rows = 16 * warps;
  const dim3 grid((seq_q + rows - 1) / rows, heads, batch);
  flash_attention_kernel<D, M><<<grid, 32 * warps, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), seq_q, seq_k,
      heads, kv_heads, scale, window);
  return cudaGetLastError();
}

// the instance of the mask: none without causality, else the banded one
// with a window and the causal one without
template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int batch, int seq_q, int seq_k, int heads, int kv_heads,
                   float scale, int window, int causal, cudaStream_t stream) {
  if (!causal)
    return launch_instance<D, kMaskNone>(q, k, v, out, batch, seq_q, seq_k,
                                         heads, kv_heads, scale, 0, stream);
  return window > 0
             ? launch_instance<D, kMaskBand>(q, k, v, out, batch, seq_q,
                                             seq_k, heads, kv_heads, scale,
                                             window, stream)
             : launch_instance<D, kMaskCausal>(q, k, v, out, batch, seq_q,
                                               seq_k, heads, kv_heads, scale,
                                               0, stream);
}

template <int D, int M>
void attributes(int* out) {
  cudaFuncAttributes a;
  if (cudaFuncGetAttributes(&a, flash_attention_kernel<D, M>) !=
      cudaSuccess) {
    out[0] = out[1] = out[2] = -1;
    return;
  }
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)Layout<D>::smem(Layout<D>::kMaxWarps);
}

template <int M>
void attributes_of(int head_dim, int* out) {
  switch (head_dim) {
    case 16: return attributes<16, M>(out);
    case 32: return attributes<32, M>(out);
    case 64: return attributes<64, M>(out);
    case 96: return attributes<96, M>(out);
    case 128: return attributes<128, M>(out);
    case 256: return attributes<256, M>(out);
    default: out[0] = out[1] = out[2] = -1;
  }
}

}  // namespace

// q/out: device (batch, seq_q, heads, head_dim), k/v: device (batch,
// seq_k, kv_heads, head_dim), contiguous f32 at 16-byte aligned
// addresses; kv_heads divides heads; head_dim is 16, 32, 64, 96, 128 or
// 256; causal != 0: seq_q == seq_k and window >= 0 (0: causal only; else
// key j is visible to query i iff i - window < j <= i); causal == 0:
// window 0, every one of the seq_k >= 1 keys visible to every query.
// Launches on `stream`; returns cudaGetLastError()
// (cudaErrorInvalidValue for a head_dim, head count, length or window the
// kernel does not take).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int batch,
                                      int seq_q, int seq_k, int heads,
                                      int kv_heads, int head_dim, float scale,
                                      int window, int causal, void* stream) {
  if (kv_heads <= 0 || heads % kv_heads || window < 0 ||
      (causal ? seq_q != seq_k : window != 0 || (seq_q > 0 && seq_k <= 0)))
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || seq_q == 0 || heads == 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
#define FLASH_CASE(D)                                                      \
  case D:                                                                  \
    return (int)launch<D>(q, k, v, out, batch, seq_q, seq_k, heads,        \
                          kv_heads, scale, window, causal, s);
  switch (head_dim) {
    FLASH_CASE(16)
    FLASH_CASE(32)
    FLASH_CASE(64)
    FLASH_CASE(96)
    FLASH_CASE(128)
    FLASH_CASE(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FLASH_CASE
}

// registers a thread, local (spill) bytes a thread and dynamic shared
// bytes a block of the instance for head_dim and mask (0 causal, 1
// banded, 2 none), into out[0..2] (-1 each for one without an instance)
extern "C" void flash_attention_attributes(int head_dim, int mask,
                                           int* out) {
  switch (mask) {
    case kMaskCausal: return attributes_of<kMaskCausal>(head_dim, out);
    case kMaskBand: return attributes_of<kMaskBand>(head_dim, out);
    case kMaskNone: return attributes_of<kMaskNone>(head_dim, out);
    default: out[0] = out[1] = out[2] = -1;
  }
}
