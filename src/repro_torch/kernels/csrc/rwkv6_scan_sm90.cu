// RWKV-6 WKV scan on Hopper's tensor cores: the chunked form, 16 tokens a
// chunk, every product a 3xTF32 mma.sync.
//
// Replaces the TPU kernel src/repro/kernels/rwkv6_scan.py::rwkv6_wkv_bh
// (its body _kernel, the chunked algebra) and the layout of its wrapper
// src/repro/kernels/ops.py::rwkv6_wkv.  For each sequence n and head h,
// from a zero state S (D x D, f32):
//
//   o_t = r_t . (S_{t-1} + diag(u) k_t^T v_t)
//   S_t = diag(exp(lw_t)) S_{t-1} + k_t^T v_t
//
// r, k, v (bf16 or f32) and lw (f32, in [-5, 0]) are read in the model's
// (N, S, H, D) layout, u (f32) as (H, D) with an N-stride of 0 or as
// (N, H, D); o is written f32 in (N, S, H, D).  D is 16 or 64.
//
// Bound on the card: bytes.  At rwkv6-7b's shape (N = 8, S = 1024, H = 64,
// D = 64, bf16 r/k/v) the kernel must move 469.8 MB (r, k, v, lw in, o out:
// 140 us at 3.35 TB/s); the chunked form's products are about 11 GFLOP
// (22 us at the 495 TFLOP/s TF32 rate) and its elementwise terms 0.5
// GFLOP of f32 (8 us at 67 TFLOP/s).  Its predecessor, the upstream
// per-token recurrence as f32 FMAs on the SIMT lanes, walked 1,024 tokens
// per (sequence, head) as one serial chain.
//
// Algebra, per chunk of 16 tokens (cum the inclusive prefix sum of lw in
// the chunk, excl = cum - lw, total = cum of the last token, ref = cum of
// token 7):
//
//   A    = (r e^{excl-ref}) (k e^{ref-cum})^T, kept for j < t only; the
//          bonus (r u k) summed over keys on its diagonal
//   o    = A v + (r e^{excl}) S_in
//   S    = S_in e^{total} + (k e^{total-cum})^T v
//
// Overflow: at the -5 floor e^{+-cum} reaches e^{80} in 16 tokens.  The
// score factors are taken relative to token 7's cumulative decay, so
// neither exceeds e^{40}, their low TF32 parts stay normal f32 numbers,
// and the pairs j > t, which can be large, are dropped by selection after
// the product, never by multiplying with a 0/1 mask.  Chunks stay at 16.
//
// Accuracy: one TF32 pass keeps 11 significant bits, about 1e-3 of max |o|
// against a tolerance of 1e-5 (tests/test_torch_rwkv6_scan.py emulates
// both on the CPU).  Each f32 operand x is split as hi = x with its 13 low
// mantissa bits masked off and lo = x - hi (exact), and a.b is summed as
// lo_a.hi_b + hi_a.lo_b + hi_a.hi_b (3xTF32; the lo.lo term is below f32's
// rounding).  bf16 values are exact in TF32, so products with v at bf16
// take two passes, not three.  All exponentials are the exact expf.
//
// Why mma.sync m16n8k8 and not wgmma: a chunk is 16 tokens, the m16 tile;
// the state is 64 x 16 a warp and stays in registers as mma accumulators
// from one chunk to the next; wgmma's 64-row tiles would need four chunks
// or all value columns stacked, its TF32 B operand must be K-major in
// shared memory, and its A operand from registers must be split afresh
// every chunk all the same.  The tensor cores are not what bounds this
// kernel: one pass instead of three, or no global loads at all, each
// changed its time little; its instruction count and the serial chain of
// each block did (below).
//
// Design: one block per (head, sequence), D / 16 warps; warp w owns value
// columns 16 w .. 16 w + 15 and carries S^T of those columns (16 x D, the
// mma accumulator layout, 32 registers at D = 64) through every chunk in
// registers.  S^T is the A operand of the carry's product as it stands:
// the accumulator holds the key pair (2 t4, 2 t4 + 1) where the A
// fragment expects keys (t4, t4 + 4), and since the keys are summed over,
// the B operand is read in the same permuted order (a float2 a lane).
// Every product is written transposed (M = the warp's 16 value columns),
// so o^T comes out of the same accumulators.  Per chunk, between three
// block barriers:
//   1. the next chunk's r, k, v and lw are issued by cp.async (16-byte
//      pieces, zero-filled past S, so pad tokens change nothing) into the
//      other of two stages, to land while this chunk is computed; each
//      thread forms the decayed factors of two channels at four tokens:
//      r e^{excl} and k e^{total-cum} already split into hi and lo (every
//      warp reads them, so the split is made once a block), k e^{ref-cum}
//      and v; and the bonus r u k, summed over the keys by two halving
//      shuffle exchanges and a short reduction;
//   2. warp w sums the scores over keys 16 w .. 16 w + 15 (3 passes);
//   3. each warp adds the warps' partial scores as it reads A^T, selects
//      j < t and the bonus on the diagonal, and computes o^T = v^T A^T +
//      S^T r_dec^T and S^T = S^T e^{total} + v^T k_dec, the carry's and
//      the update's mma chains interleaved key block by key block; o is
//      stored from the accumulators.
// Shared rows are padded (D + 8 floats for float2 fragment reads, token
// pairs 2 D + 8) so a warp's fragment reads hit distinct banks.  512
// blocks of 128 threads at rwkv6-7b's shape, 128 registers and 52 KB of
// shared memory each: four blocks an SM, one wave.  What moved the time,
// in order: fewer instructions a chunk (the split made once a block, the
// bonus reduced by exchanges rather than a butterfly per token, two
// channels a thread); a second barrier-free buffer for the factors, a
// lighter exponential, fewer load instructions and freeing the mma
// chains did not measurably.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tf32x3.cuh"

namespace {

using tf32x3::cp_async16;
using tf32x3::mma_split;
using tf32x3::split;
using tf32x3::split_b;

constexpr int kT = 16;    // tokens a chunk: the mma's 16 rows
constexpr int kRef = 7;   // the token whose cumulative decay the scores'
                          // factors are taken relative to
constexpr int kScoreRow = kT + 8;   // padded row of the partial scores

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
// two neighbouring elements as f32
__device__ __forceinline__ float2 load2(const float* x) {
  return *reinterpret_cast<const float2*>(x);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* x) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x));
}
// two neighbouring elements copied as they are
template <typename T>
__device__ __forceinline__ void copy2(T* dst, const T* src) {
  using P = typename std::conditional<sizeof(T) == 4, float2, uint32_t>::type;
  *reinterpret_cast<P*>(dst) = *reinterpret_cast<const P*>(src);
}

template <typename T, int D>
struct Smem {
  static constexpr int kWarps = D / 16;
  static constexpr int kPair = D + 8;       // rows read as float2 pairs
  static constexpr int kPairT = 2 * D + 8;  // rows of token pairs
  // the staged chunks (two stages), as cp.async writes them
  T r[2][kT][D];
  T k[2][kT][D];
  T v[2][kT][D];
  float lw[2][kT][D];
  // the chunk's decayed factors.  The carry's and the state update's B
  // operands, which every warp reads, are stored split (hi + lo), so the
  // split is made once a block
  float rc_hi[kT][kPair];     // r e^{excl}
  float rc_lo[kT][kPair];
  // k e^{total - cum}: row j / 2 holds tokens j and j + 1 of each key as
  // a pair
  float kd_hi[kT / 2][kPairT];
  float kd_lo[kT / 2][kPairT];
  float k_sc[kT][kPair];      // k e^{ref - cum}: the scores'
  T vc[kT][kPair];            // v, the A operand (transposed)
  float e_nref[D];            // e^{-ref}: r e^{excl - ref} = rc e^{-ref}
  float decay[D];             // e^{total}
  float bonus[kT];            // r u k, summed over the keys
  float score[kWarps][kT][kScoreRow];   // each warp's partial scores
};

// one (kT, D) slice of x (the chunk at x + off, rows `row` apart) into
// dst, as 16-byte pieces: the thread's first piece is at token tid / kRow,
// the next kThreads / kRow tokens on; tokens from `valid` on are
// zero-filled
template <typename E, int D, int kThreads>
__device__ __forceinline__ void stage_one(E (*dst)[D], const E* __restrict__ x,
                                          int64_t off, int64_t row,
                                          int valid, int tid) {
  constexpr int kPiece = 16 / (int)sizeof(E);
  constexpr int kRow = D / kPiece;
  constexpr int kStep = kThreads / kRow;
  static_assert(kThreads % kRow == 0 && kT % kStep == 0, "whole pieces");
  const int t = tid / kRow, col = (tid % kRow) * kPiece;
  const E* src = x + off + t * row + col;
#pragma unroll
  for (int i = 0; i < kT / kStep; ++i) {
    const bool in = t + i * kStep < valid;
    cp_async16(&dst[t + i * kStep][col], in ? src + i * kStep * row : x, in);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(2 * D, D == 64 ? 4 : 1)
    rwkv6_wkv_kernel(const T* __restrict__ r, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const float* __restrict__ lw,
                          const float* __restrict__ u,
                          float* __restrict__ out, int seq, int heads,
                          int64_t u_stride_n) {
  constexpr int kThreads = 2 * D;
  constexpr int kPairs = D / 2;   // lanes of one token quarter
  constexpr bool kSplitV = sizeof(T) == 4;     // bf16 is exact in TF32
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<T, D>& sm = *reinterpret_cast<Smem<T, D>*>(smem_raw);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int vb = 16 * warp;           // the warp's value columns
  // the thread's factor work: channels 2 p, 2 p + 1 at tokens 4 q .. + 3
  const int p = tid % kPairs, q = tid / kPairs;
  const int h = blockIdx.x;
  const int64_t n = blockIdx.y;
  const int64_t row = (int64_t)heads * D;
  const int64_t base = n * seq * row + (int64_t)h * D;
  const int chunks = (seq + kT - 1) / kT;
  const float* un = u + n * u_stride_n + (int64_t)h * D + 2 * p;
  const float2 u2 = make_float2(un[0], un[1]);

  // chunk ci's r, k, v and lw into stage ci % 2, as one cp.async group
  // (an empty group past the last chunk, so every wait counts alike)
  auto stage = [&](int ci) {
    if (ci < chunks) {
      const int b = ci & 1, t0 = ci * kT;
      const int64_t off = base + t0 * row;
      stage_one<T, D, kThreads>(sm.r[b], r, off, row, seq - t0, tid);
      stage_one<T, D, kThreads>(sm.k[b], k, off, row, seq - t0, tid);
      stage_one<T, D, kThreads>(sm.v[b], v, off, row, seq - t0, tid);
      stage_one<float, D, kThreads>(sm.lw[b], lw, off, row, seq - t0, tid);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  // the decayed factors of chunk ci, channels 2 p and 2 p + 1 at tokens
  // 4 q .. 4 q + 3, from stage ci % 2: two exponentials an element, the
  // per-channel ones once
  auto factors = [&](int ci) {
    const int b = ci & 1;
    // the prefix sum of lw, one sequence of additions for every thread:
    // at the quarters' starts, at token 7 (ref) and at the end (total)
    float2 run = make_float2(0.f, 0.f), ref, at[3];
#pragma unroll
    for (int t = 0; t < kT; ++t) {
      if (t % 4 == 0 && t) at[t / 4 - 1] = run;
      const float2 l = load2(&sm.lw[b][t][2 * p]);
      run.x += l.x;
      run.y += l.y;
      if (t == kRef) ref = run;
    }
    const float2 total = run;
    const float2 e_tail =
        make_float2(expf(total.x - ref.x), expf(total.y - ref.y));
    if (q == 0) {
      *reinterpret_cast<float2*>(&sm.decay[2 * p]) =
          make_float2(expf(total.x), expf(total.y));
      *reinterpret_cast<float2*>(&sm.e_nref[2 * p]) =
          make_float2(expf(-ref.x), expf(-ref.y));
    }
    float2 cum = q == 0 ? make_float2(0.f, 0.f) : at[0];
    if (q >= 2) cum = q == 2 ? at[1] : at[2];
    float ruk[4];
    float2 kd[2];   // k_dec of the pair's even token
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = 4 * q + i;
      const float2 excl = cum;
      const float2 l = load2(&sm.lw[b][t][2 * p]);
      cum.x += l.x;
      cum.y += l.y;
      const float2 rr = load2(&sm.r[b][t][2 * p]);
      const float2 kk = load2(&sm.k[b][t][2 * p]);
      const float2 ks = make_float2(kk.x * expf(ref.x - cum.x),
                                    kk.y * expf(ref.y - cum.y));
      uint32_t h0, l0, h1, l1;
      split(rr.x * expf(excl.x), h0, l0);
      split(rr.y * expf(excl.y), h1, l1);
      *reinterpret_cast<uint2*>(&sm.rc_hi[t][2 * p]) = make_uint2(h0, h1);
      *reinterpret_cast<uint2*>(&sm.rc_lo[t][2 * p]) = make_uint2(l0, l1);
      *reinterpret_cast<float2*>(&sm.k_sc[t][2 * p]) = ks;
      kd[i % 2] = make_float2(ks.x * e_tail.x, ks.y * e_tail.y);
      if (i % 2) {   // tokens t - 1 and t of both channels
        uint4 hi, lo;
        split(kd[0].x, hi.x, lo.x);
        split(kd[1].x, hi.y, lo.y);
        split(kd[0].y, hi.z, lo.z);
        split(kd[1].y, hi.w, lo.w);
        *reinterpret_cast<uint4*>(&sm.kd_hi[t / 2][4 * p]) = hi;
        *reinterpret_cast<uint4*>(&sm.kd_lo[t / 2][4 * p]) = lo;
      }
      copy2(&sm.vc[t][2 * p], &sm.v[b][t][2 * p]);
      ruk[i] = rr.x * u2.x * kk.x + rr.y * u2.y * kk.y;
    }
    // the bonus of the 4 tokens summed over the kPairs lanes (keys) of the
    // quarter: two halving exchanges leave each lane one token's partial,
    // then a plain reduction; lane (kPairs / 4) j holds token j's sum
    constexpr int kO = kPairs / 2;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const bool up = lane & kO;
      const float send = up ? ruk[i] : ruk[i + 2];
      ruk[i] = (up ? ruk[i + 2] : ruk[i]) + __shfl_xor_sync(~0u, send, kO);
    }
    {
      const bool up = lane & (kO / 2);
      const float send = up ? ruk[0] : ruk[1];
      ruk[0] = (up ? ruk[1] : ruk[0]) + __shfl_xor_sync(~0u, send, kO / 2);
    }
#pragma unroll
    for (int off = kO / 4; off; off >>= 1)
      ruk[0] += __shfl_xor_sync(~0u, ruk[0], off);
    if (lane % (kO / 2) == 0)
      sm.bonus[4 * q + 2 * !!(lane & kO) + !!(lane & (kO / 2))] = ruk[0];
  };

  // S^T of the warp's columns: st[j] holds value rows g, g + 8 and key
  // columns 8 j + 2 t4, + 1 (c0 = (g, 2 t4), c1 = (g, 2 t4 + 1), c2 and c3
  // the same at g + 8)
  float st[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) st[j][e] = 0.f;

  stage(0);
  for (int ci = 0; ci < chunks; ++ci) {
    const int t0 = ci * kT;
    asm volatile("cp.async.wait_group 0;\n" ::);
    // chunk ci staged; every warp done with chunk ci - 1
    __syncthreads();
    stage(ci + 1);
    factors(ci);
    __syncthreads();

    // the warp's partial scores over keys vb .. vb + 15: M = t, N = j,
    // K = keys (slot t4 holds key 2 t4, slot t4 + 4 key 2 t4 + 1)
    {
      float sc[2][4] = {};
#pragma unroll
      for (int kt = 0; kt < 2; ++kt) {
        const int key = vb + 8 * kt + 2 * t4;
        const float2 e = *reinterpret_cast<const float2*>(&sm.e_nref[key]);
        // r e^{excl - ref} = (hi + lo, exactly r e^{excl}) e^{-ref}
        auto r_sc = [&](int t) {
          const float2 hi = load2(&sm.rc_hi[t][key]);
          const float2 lo = load2(&sm.rc_lo[t][key]);
          return make_float2((hi.x + lo.x) * e.x, (hi.y + lo.y) * e.y);
        };
        const float2 x0 = r_sc(g), x1 = r_sc(g + 8);
        uint32_t ah[4], al[4];
        split(x0.x, ah[0], al[0]);
        split(x1.x, ah[1], al[1]);
        split(x0.y, ah[2], al[2]);
        split(x1.y, ah[3], al[3]);
#pragma unroll
        for (int nj = 0; nj < 2; ++nj) {
          const float2 y =
              *reinterpret_cast<const float2*>(&sm.k_sc[8 * nj + g][key]);
          uint32_t bb[4];
          split_b(y.x, y.y, bb);
          mma_split<true>(sc[nj], ah, al, bb);
        }
      }
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        *reinterpret_cast<float2*>(&sm.score[warp][g][8 * nj + 2 * t4]) =
            make_float2(sc[nj][0], sc[nj][1]);
        *reinterpret_cast<float2*>(&sm.score[warp][g + 8][8 * nj + 2 * t4]) =
            make_float2(sc[nj][2], sc[nj][3]);
      }
    }
    __syncthreads();

    // o^T and S^T of the warp's value columns.  v^T is the A operand of
    // the in-chunk product and of the state update (M = values, K = tokens
    // j, slot t4 holding token 2 t4)
    uint32_t vh[2][4], vl[2][4];
#pragma unroll
    for (int kt = 0; kt < 2; ++kt) {
      const int j = 8 * kt + 2 * t4;
      const float x[4] = {to_f32(sm.vc[j][vb + g]),
                          to_f32(sm.vc[j][vb + g + 8]),
                          to_f32(sm.vc[j + 1][vb + g]),
                          to_f32(sm.vc[j + 1][vb + g + 8])};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (kSplitV) {
          split(x[e], vh[kt][e], vl[kt][e]);
        } else {
          vh[kt][e] = __float_as_uint(x[e]);
          vl[kt][e] = 0u;
        }
      }
    }
    float o[2][4] = {};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int t = 8 * nt + g;
      const float bon = sm.bonus[t];
#pragma unroll
      for (int kt = 0; kt < 2; ++kt) {
        // A^T (K = j, N = t): the warps' partial scores summed, j < t
        // kept, the bonus on the diagonal, the rest dropped
        const int j = 8 * kt + 2 * t4;
        float2 a = make_float2(0.f, 0.f);
#pragma unroll
        for (int w = 0; w < Smem<T, D>::kWarps; ++w) {
          const float2 pw =
              *reinterpret_cast<const float2*>(&sm.score[w][t][j]);
          a.x += pw.x;
          a.y += pw.y;
        }
        const float a0 = j < t ? a.x : (j == t ? bon : 0.f);
        const float a1 = j + 1 < t ? a.y : (j + 1 == t ? bon : 0.f);
        uint32_t bb[4];
        split_b(a0, a1, bb);
        mma_split<kSplitV>(o[nt], vh[kt], vl[kt], bb);
      }
    }
    // the carry r_dec S_in and the state the next chunk enters with, key
    // block by key block, so the two products' chains interleave; the
    // carry sums into two accumulators (even and odd key blocks) to halve
    // its chain.  Both run in every chunk: the state is zero before the
    // first, and the one after the last is not read
    float oc[2][2][4] = {};
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      uint32_t ah[4], al[4];
      split(st[kk][0], ah[0], al[0]);
      split(st[kk][2], ah[1], al[1]);
      split(st[kk][1], ah[2], al[2]);
      split(st[kk][3], ah[3], al[3]);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const uint2 hi = *reinterpret_cast<const uint2*>(
            &sm.rc_hi[8 * nt + g][8 * kk + 2 * t4]);
        const uint2 lo = *reinterpret_cast<const uint2*>(
            &sm.rc_lo[8 * nt + g][8 * kk + 2 * t4]);
        const uint32_t bb[4] = {hi.x, hi.y, lo.x, lo.y};
        mma_split<true>(oc[kk & 1][nt], ah, al, bb);
      }
      const float2 dd =
          *reinterpret_cast<const float2*>(&sm.decay[8 * kk + 2 * t4]);
      st[kk][0] *= dd.x;
      st[kk][1] *= dd.y;
      st[kk][2] *= dd.x;
      st[kk][3] *= dd.y;
#pragma unroll
      for (int kt = 0; kt < 2; ++kt) {
        // tokens 8 kt + 2 t4 and + 1 of key 8 kk + g
        const uint2 hi = *reinterpret_cast<const uint2*>(
            &sm.kd_hi[4 * kt + t4][2 * (8 * kk + g)]);
        const uint2 lo = *reinterpret_cast<const uint2*>(
            &sm.kd_lo[4 * kt + t4][2 * (8 * kk + g)]);
        const uint32_t bb[4] = {hi.x, hi.y, lo.x, lo.y};
        mma_split<kSplitV>(st[kk], vh[kt], vl[kt], bb);
      }
    }
    // o^T: rows vb + g (+ 8), tokens 8 nt + 2 t4 (+ 1)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = t0 + 8 * nt + 2 * t4 + (e & 1);
        if (t < seq)
          out[base + t * row + vb + g + 8 * (e >> 1)] =
              o[nt][e] + oc[0][nt][e] + oc[1][nt][e];
      }
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* lw, const void* u, void* out, int n, int seq,
                   int heads, int64_t u_stride_n, cudaStream_t stream) {
  constexpr int kSmem = (int)sizeof(Smem<T, D>);
  static bool configured = false;   // once per instance, outside capture
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        rwkv6_wkv_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 grid(heads, n);
  rwkv6_wkv_kernel<T, D><<<grid, 2 * D, kSmem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(lw),
      static_cast<const float*>(u), static_cast<float*>(out), seq, heads,
      u_stride_n);
  return cudaGetLastError();
}

template <typename T, int D>
void attributes(int* vals) {
  cudaFuncAttributes a{};
  cudaFuncGetAttributes(&a, rwkv6_wkv_kernel<T, D>);
  vals[0] = a.numRegs;
  vals[1] = (int)a.localSizeBytes;
  vals[2] = (int)sizeof(Smem<T, D>);
}

}  // namespace

// r/k/v: device (n, seq, heads, head_dim), contiguous, 16-byte aligned,
// f32 (dtype 0) or bf16 (dtype 1); lw/out: f32 of the same shape; u: f32
// (heads, head_dim) with u_stride_n = 0, or (n, heads, head_dim) with
// u_stride_n = heads * head_dim; head_dim is 16 or 64.  Launches on
// `stream`; returns cudaGetLastError() (cudaErrorInvalidValue for a
// head_dim or dtype the kernel does not take).
extern "C" int rwkv6_wkv_sm90_launch(const void* r, const void* k,
                                     const void* v, const void* lw,
                                     const void* u, void* out, int n,
                                     int seq, int heads, int head_dim,
                                     int64_t u_stride_n, int dtype,
                                     void* stream) {
  if (n == 0 || seq == 0 || heads == 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  const bool bf16 = dtype == 1;
  if (dtype != 0 && !bf16) return (int)cudaErrorInvalidValue;
  switch (head_dim) {
    case 16:
      return (int)(bf16 ? launch<__nv_bfloat16, 16>(r, k, v, lw, u, out, n,
                                                    seq, heads, u_stride_n, s)
                        : launch<float, 16>(r, k, v, lw, u, out, n, seq,
                                            heads, u_stride_n, s));
    case 64:
      return (int)(bf16 ? launch<__nv_bfloat16, 64>(r, k, v, lw, u, out, n,
                                                    seq, heads, u_stride_n, s)
                        : launch<float, 64>(r, k, v, lw, u, out, n, seq,
                                            heads, u_stride_n, s));
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// (registers a thread, local (spill) bytes a thread, dynamic shared bytes
// a block) of the instance at head_dim (16 or 64) and dtype (0 f32, 1
// bf16) into vals[0..2]
extern "C" void rwkv6_wkv_sm90_attributes(int head_dim, int dtype,
                                          int* vals) {
  const bool bf16 = dtype == 1;
  if (head_dim == 16) {
    bf16 ? attributes<__nv_bfloat16, 16>(vals) : attributes<float, 16>(vals);
  } else {
    bf16 ? attributes<__nv_bfloat16, 64>(vals) : attributes<float, 64>(vals);
  }
}
