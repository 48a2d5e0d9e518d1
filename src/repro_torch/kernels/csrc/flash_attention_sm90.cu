// Flash attention with grouped-query heads (GQA), bf16 q/k/v on Hopper's
// tensor cores: causal, causal with a sliding window, or without a mask
// over a key length of its own.
//
// Replaces the TPU kernel
// src/repro/kernels/flash_attention.py:78 (flash_attention_bhsd) and the
// head mapping of its wrapper src/repro/kernels/ops.py::flash_attention,
// for bf16 inputs (f32 inputs go to the 3xTF32 kernel of
// flash_attention.cu); with window > 0, also the band of the reference
// model's src/repro/models/attention.py::attend(window=), and without
// causality its attend(causal=False) (the audio family's encoder and
// cross-attention), both of which the reference runs in XLA.  For each
// batch row b, query head h (kv head hk = h / (H / Hkv)) and query
// position i, over the visible keys j (causal: j <= i and, with
// window > 0, j > i - window; non-causal: every j < Sk):
//
//   out[b, i, h, :] = sum_j softmax_j(scale * q[b,i,h,:] . k[b,j,hk,:])
//                     * v[b, j, hk, :]
//
// with f32 scores, softmax statistics and accumulators, in the model's
// (B, Sq, H, Dh) and (B, Sk, Hkv, Dh) layouts (Sq = Sk unless
// non-causal; k and v un-repeated, Dh not padded).  The probabilities
// are rounded to bf16 before P.V, as every tensor-core flash kernel does
// and as the reference model does before its P.V
// (src/repro/models/attention.py::_combine_grouped); the running sum l
// is taken over the unrounded f32 probabilities.
//
// Bound on the card: operations, on the bf16 tensor cores.  At the main
// path's shape (B = 8, S = 1024, H = 32, Hkv = 8, Dh = 128) the causal
// half of Q.K^T and P.V is 68.7 GFLOP: 69.5 us at the 989 TFLOP/s dense
// bf16 peak, against 50.1 us to move the 167.8 MB of q, k, v and out.
//
// Design, for that bound:
// * every product is a warpgroup MMA (wgmma.mma_async m64nNk16, f32
//   accumulate): S = Q.K^T with Q and K both read from shared memory
//   (K-major as they lie), O += P.V with P from registers (the S
//   accumulator's fragment, packed to bf16 pairs, is the A fragment of the
//   next wgmma) and V from shared memory with the transpose bit set (V is
//   (keys, Dh) row-major: MN-major for this product);
// * a work item is 128 query rows of one (query head, batch row): two
//   consumer warpgroups take 64 rows each, and one producer warpgroup,
//   whose single thread issues every TMA load, keeps K and V tiles of 128
//   keys in flight through a ring of kStages stages (an mbarrier that TMA
//   completes for K and one for V, and one that the 8 consumer warps
//   arrive on to free the stage).  setmaxnreg moves registers from the
//   producer (24 a thread) to the consumers (240);
// * the grid is persistent, one block per SM, each walking the items
//   longest causal tile first (without causality every item walks all
//   of Sk, and the order is only the query tiles', last first).  A
//   block's fixed costs (its first Q and K loads, its epilogue) took
//   about a fifth of the time at the path shape with one block per item:
//   here the producer loads the next item's Q as soon as both warpgroups
//   have issued their last Q.K^T, and its K and V tiles as the ring
//   frees, while the consumers finish the current item;
//   O is staged in a buffer of its own, so its TMA store overlaps the
//   next item;
// * TMA boxes of (<= 64 columns, 1 head, 64 or 128 rows, 1 batch row) over
//   4-D tensor maps of the model's own strides (q and out over Sq, k and v
//   over Sk): Dh 128 is two 64-column boxes at the 128-byte swizzle,
//   Dh 64 / 32 / 16 one box at the 128 / 64 / 32-byte swizzle, and Dh 96
//   (phi-3-vision) three 32-column boxes at the 64-byte swizzle: 96 bf16
//   columns are 192 bytes, past the 128-byte swizzle's span, and
//   padding Dh to 128 would move 4/3 of the bytes.  Each wgmma descriptor
//   names the same swizzle: Q.K^T takes Dh as 6 k-steps of 16, two a
//   box, and P.V takes N = 96 over 3 swizzle atoms, one a box.  Rows past
//   S load as zeros and are clipped on the store;
// * the online softmax runs in registers on the accumulator fragment:
//   row max and sum over the 4 threads that share a row (shuffles xor 1
//   and 2), exp2 with scale * log2(e) folded in; only the tile on the
//   diagonal is masked, and tiles wholly above it are never loaded.
//   Without causality (the encoder's self-attention, cross-attention) an
//   item walks all ceil(Sk / kBlockN) key tiles, and only a ragged last
//   tile is masked, at keys >= Sk: the keys TMA fills with zeros there
//   would add exp2(0 - max) to the sum, as nothing else hides them.
//   GQA needs no packing: all of K and V at the path shape (33.5 MB) fits
//   the 50 MB L2, and consecutive items are heads of one kv group.
// * the band (window > 0): an item loads only the key tiles from the one
//   holding key q0 - window + 1 (q0 its first row) up to the diagonal;
//   the tiles that cross the band's lower edge are masked as the diagonal
//   one is.  An item's cost is its number of in-band tiles, which does
//   not fall as its query tile moves later, so the longest-first order
//   stays the order of the query tiles, last first;
// * head dim 256 (recurrentgemma-9b) takes tiles of its own (Tile<256>):
//   at 128 x 128 tiles its Q, staged O and two K/V stages would need 384
//   KB of shared memory, past the 227 KB a block may take, and two
//   consumer warpgroups' O (64 x 256 f32, 128 registers a thread) beside
//   S and P would pass the 168 registers a thread of a 384-thread block.
//   So one consumer warpgroup takes 64 query rows against tiles of 64
//   keys, in a block of 256 threads (255 registers a thread, no
//   setmaxnreg): Q 32 KB, O 32 KB, K and V 2 x 2 x 32 KB, 192 KB; four
//   64-column TMA boxes span Dh at the 128-byte swizzle.  It issues half
//   the wgmma of the 128-row tiles a block, a simple instance first.
// The mask (causal, band, none) is a template parameter: the causal
// instances carry none of the band's or the tail's code, and keep their
// registers.
// Not done: FA3's overlap of a warpgroup's softmax with its own next
// Q.K^T, and its ping-pong turns between the two warpgroups.  Both keep S,
// O and P live at once, and ptxas allocates one register count for the
// whole kernel, the launch bound's 168, whatever setmaxnreg grants at run
// time.  Measured at the path shape: on a grid of one block per item
// the overlap fit only without mbar_wait's hang guard and then ran no
// faster than without it; on this persistent grid it spilled and ran
// slower, with ping-pong turns slower still.
#include <cuda.h>   // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWgRows = 64;      // query rows a consumer warpgroup
constexpr int kStages = 2;       // K/V ring depth

// the mask: causal, causal banded to a window, or none over Sk keys
enum Mask : int { kMaskCausal = 0, kMaskBand = 1, kMaskNone = 2 };

// Per head dim: the block's shape, TMA box width, swizzle and the wgmma
// descriptor fields.  Dh <= 128: two consumer warpgroups, 128 query rows
// and 128-key tiles; Dh 256: one, 64 and 64.  kBlockM = kBlockN, so a
// causal item's last tile is its diagonal one.
template <int D>
struct Tile {
  static constexpr int kConsumers = D > 128 ? 1 : 2;  // consumer warpgroups
  static constexpr int kBlockM = kWgRows * kConsumers;   // query rows a block
  static constexpr int kBlockN = kBlockM;                // keys a K/V tile
  static constexpr int kThreads = 128 * (1 + kConsumers);
  static constexpr int kConsumerWarps = 4 * kConsumers;
  // columns a TMA box: Dh itself up to 64, 64 for a multiple of 64, else
  // 32 (Dh 96: three boxes)
  static constexpr int kBoxCols = D <= 64 ? D : D % 64 ? 32 : 64;
  static constexpr int kBoxes = D / kBoxCols;        // boxes across Dh
  static constexpr int kRowBytes = 2 * kBoxCols;     // = the swizzle span
  // swizzle of the 16-byte chunks: Swizzle<kSwzBits, 4, 3>
  static constexpr int kSwzBits = kRowBytes == 128 ? 3 : kRowBytes == 64 ? 2
                                                                          : 1;
  // wgmma descriptor layout type: 1 = 128 B, 2 = 64 B, 3 = 32 B swizzle
  static constexpr uint64_t kLayout = kRowBytes == 128 ? 1
                                      : kRowBytes == 64 ? 2 : 3;
  static constexpr int kQBytes = kBlockM * D * 2;
  static constexpr int kKVBytes = kBlockN * D * 2;   // K or V, one stage
  static constexpr int kQBox = kBlockM * kRowBytes;  // Q or O: one box
  static constexpr int kKVBox = kBlockN * kRowBytes;
  // Q, O, then the K stages, then the V stages, then the barriers; the
  // base is rounded up to 1024 bytes, the 128-byte swizzle's period
  static constexpr int kBarOffset = 2 * kQBytes + 2 * kStages * kKVBytes;
  static constexpr int kSmem = kBarOffset + 8 * (2 + 3 * kStages) + 1024;
};

// ---- PTX helpers ----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Wait until the phase of parity `parity` of the barrier has completed.
// A barrier that does not complete within 10 s traps, so a fault in the
// pipeline ends the launch with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  uint64_t t0 = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    const uint64_t now = global_ns();
    if (t0 == 0) {
      t0 = now;
    } else if (now - t0 > 10000000000ull) {
      __trap();
    }
  }
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          uint32_t src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle layout type.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of registers that an
// in-flight wgmma owns across the fence and wait instructions.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define R8(d, i)                                                        \
  "+f"(d[i + 0]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),       \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define R16(d, i) R8(d, i), R8(d, i + 8)
#define R32(d, i) R16(d, i), R16(d, i + 16)
#define R64(d, i) R32(d, i), R32(d, i + 32)
#define L8 "%0, %1, %2, %3, %4, %5, %6, %7"
#define L16 L8 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define L32                                                              \
  L16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, " \
      "%29, %30, %31"
#define L64                                                              \
  L32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, " \
      "%45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "   \
      "%58, %59, %60, %61, %62, %63"

#define R48(d, i) R32(d, i), R16(d, i + 32)
#define L48                                                              \
  L32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, " \
      "%45, %46, %47"

#define R128(d, i) R64(d, i), R64(d, i + 64)
#define L128                                                              \
  L64 ", %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, " \
      "%77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, "   \
      "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, " \
      "%103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, "  \
      "%114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, "  \
      "%125, %126, %127"

// S (64 x N, f32) = Q (64 x 16) . K^T (16 x N) (+ S when scale_d), both
// operands from shared memory, K-major.
template <int N>
struct WgmmaQK;

#define WGMMA_QK(N, LIST, OUTS, DA, DB, SCALE)                            \
  template <>                                                             \
  struct WgmmaQK<N> {                                                     \
    __device__ __forceinline__ static void run(float (&d)[N / 2],         \
                                               uint64_t da, uint64_t db,  \
                                               int scale_d) {             \
      asm volatile(                                                       \
          "{\n.reg .pred p;\nsetp.ne.b32 p, " SCALE ", 0;\n"              \
          "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {"    \
          LIST "}, " DA ", " DB ", p, 1, 1, 0, 0;\n}\n"                    \
          : OUTS                                                          \
          : "l"(da), "l"(db), "r"(scale_d));                              \
    }                                                                     \
  };

WGMMA_QK(64, L32, R32(d, 0), "%32", "%33", "%34")
WGMMA_QK(128, L64, R64(d, 0), "%64", "%65", "%66")

// O (64 x N, f32) += P (64 x 16, bf16 pairs in registers) . V (16 x N),
// V from shared memory, MN-major (transpose bit set).
template <int N>
struct WgmmaPV;

#define WGMMA_PV(N, LIST, OUTS, A, DESC, SCALE)                           \
  template <>                                                             \
  struct WgmmaPV<N> {                                                     \
    __device__ __forceinline__ static void run(float (&d)[N / 2],         \
                                               const uint32_t* a,         \
                                               uint64_t db) {             \
      asm volatile(                                                       \
          "{\n.reg .pred p;\nsetp.ne.b32 p, " SCALE ", 0;\n"              \
          "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {"    \
          LIST "}, {" A "}, " DESC ", p, 1, 1, 1;\n}\n"                    \
          : OUTS                                                          \
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)); \
    }                                                                     \
  };

WGMMA_PV(16, L8, R8(d, 0), "%8, %9, %10, %11", "%12", "%13")
WGMMA_PV(32, L16, R16(d, 0), "%16, %17, %18, %19", "%20", "%21")
WGMMA_PV(64, L32, R32(d, 0), "%32, %33, %34, %35", "%36", "%37")
WGMMA_PV(96, L48, R48(d, 0), "%48, %49, %50, %51", "%52", "%53")
WGMMA_PV(128, L64, R64(d, 0), "%64, %65, %66, %67", "%68", "%69")
WGMMA_PV(256, L128, R128(d, 0), "%128, %129, %130, %131", "%132", "%133")

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// ---- the kernel -----------------------------------------------------------

// A work item is kBlockM query rows of one (query head, batch row).
// Items are numbered longest first: every (head, batch row) of the last
// query tile, then of the one before, and so on.
struct Item {
  int m_tile, h, b;
  __device__ __forceinline__ Item(int idx, int n_m, int heads, int batch)
      : m_tile(n_m - 1 - idx / (heads * batch)),
        h(idx % heads),
        b(idx / heads % batch) {}
};

// The first key tile of an item whose rows start at q0: the one holding
// key q0 - window + 1 (0 without a band).
template <int D, int M>
__device__ __forceinline__ int first_tile(int q0, int window) {
  return M == kMaskBand && q0 >= window
             ? (q0 - window + 1) / Tile<D>::kBlockN
             : 0;
}

// q_map / out_map: bf16 (Dh, H, Sq, B), boxes of (kBoxCols, 1, 64, 1);
// k_map / v_map: bf16 (Dh, Hkv, Sk, B), boxes of (kBoxCols, 1, kBlockN,
// 1).  A persistent grid: block i takes items i, i + gridDim.x, ...
template <int D, int M>
__global__ void __launch_bounds__(Tile<D>::kThreads, 1)
    flash_attention_kernel_sm90(const __grid_constant__ CUtensorMap q_map,
                                const __grid_constant__ CUtensorMap k_map,
                                const __grid_constant__ CUtensorMap v_map,
                                const __grid_constant__ CUtensorMap out_map,
                                int seq_q, int seq_k, int heads, int batch,
                                int group, float scale, int window) {
  using T = Tile<D>;
  constexpr bool kBand = M == kMaskBand, kFull = M == kMaskNone;
  constexpr int kBlockM = T::kBlockM, kBlockN = T::kBlockN;
  constexpr int kConsumerWarps = T::kConsumerWarps;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t q_s = smem_u32(smem);
  const uint32_t o_s = q_s + T::kQBytes;
  const uint32_t k_s = o_s + T::kQBytes;
  const uint32_t v_s = k_s + kStages * T::kKVBytes;
  const uint32_t bars = q_s + T::kBarOffset;
  const uint32_t q_full = bars, q_free = bars + 8;
  auto k_full = [&](int st) { return bars + 8 * (2 + st); };
  auto v_full = [&](int st) { return bars + 8 * (2 + kStages + st); };
  auto kv_free = [&](int st) { return bars + 8 * (2 + 2 * kStages + st); };

  const int n_m = (seq_q + kBlockM - 1) / kBlockM;
  const int n_items = n_m * heads * batch;
  // without causality every item walks the key tiles 0 .. n_n - 1, the
  // last of them ragged when Sk is not a multiple of kBlockN
  const int n_n = (seq_k + kBlockN - 1) / kBlockN;
  const bool ragged = seq_k % kBlockN != 0;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_free, kConsumerWarps);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(kv_free(st), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread issues every TMA load.  The K/V ring runs
    // on across items, and the next item's Q loads as soon as every
    // consumer warpgroup has issued its last S = Q . K^T ----
    if constexpr (T::kConsumers == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      int ring = 0;   // K/V tiles loaded so far
      for (int idx = blockIdx.x, n = 0; idx < n_items;
           idx += gridDim.x, ++n) {
        const Item w(idx, n_m, heads, batch);
        const int hk = w.h / group;
        mbar_wait(q_free, (n & 1) ^ 1);
        mbar_expect_tx(q_full, T::kQBytes);
        for (int half = 0; half < T::kConsumers; ++half)
          for (int bx = 0; bx < T::kBoxes; ++bx)
            tma_load(q_s + bx * T::kQBox + half * kWgRows * T::kRowBytes,
                     &q_map, q_full, bx * T::kBoxCols, w.h,
                     w.m_tile * kBlockM + half * kWgRows, w.b);
        const int last = kFull ? n_n - 1 : w.m_tile;
        for (int it = first_tile<D, M>(w.m_tile * kBlockM, window);
             it <= last; ++it, ++ring) {
          const int st = ring % kStages;
          mbar_wait(kv_free(st), ((ring / kStages) & 1) ^ 1);
          mbar_expect_tx(k_full(st), T::kKVBytes);
          for (int bx = 0; bx < T::kBoxes; ++bx)
            tma_load(k_s + st * T::kKVBytes + bx * T::kKVBox, &k_map,
                     k_full(st), bx * T::kBoxCols, hk, it * kBlockN, w.b);
          mbar_expect_tx(v_full(st), T::kKVBytes);
          for (int bx = 0; bx < T::kBoxes; ++bx)
            tma_load(v_s + st * T::kKVBytes + bx * T::kKVBox, &v_map,
                     v_full(st), bx * T::kBoxCols, hk, it * kBlockN, w.b);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup c takes query rows 64 c .. 64 c + 63 of
    // each item ----
    if constexpr (T::kConsumers == 2)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int c = wg - 1;
    const int t = threadIdx.x % 128;
    const int warp = t / 32;
    const int lane = t % 32;
    // this thread's two rows in the item (fragment rows lane/4 and +8)
    const int row0 = c * kWgRows + warp * 16 + lane / 4;
    const float sl2 = scale * 1.4426950408889634f;   // scale * log2(e)
    const uint32_t q_wg = q_s + c * kWgRows * T::kRowBytes;
    const uint32_t o_wg = o_s + c * kWgRows * T::kRowBytes;

    int ring = 0;   // K/V tiles consumed so far
    for (int idx = blockIdx.x, n = 0; idx < n_items; idx += gridDim.x, ++n) {
      const Item w(idx, n_m, heads, batch);
      const int q0 = w.m_tile * kBlockM;
      // key tiles from the band's first up to the diagonal, or all of Sk
      const int t0 = first_tile<D, M>(q0, window);
      const int last = kFull ? n_n - 1 : w.m_tile;
      // tiles at or below this one cross the band's lower edge: they
      // hold a key at or below the last row's minus the window
      const int low = q0 + kBlockM - 1 - window;
      const int edge = kBand && low >= 0 ? low / kBlockN : -1;
      float o[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
      float m[2] = {-INFINITY, -INFINITY};
      float l[2] = {0.0f, 0.0f};   // this thread's share of the row sums

      mbar_wait(q_full, n & 1);
      for (int it = t0; it <= last; ++it, ++ring) {
        const int st = ring % kStages;
        const uint32_t ph = (ring / kStages) & 1;

        // S = Q . K^T over Dh / 16 k-steps
        float s[kBlockN / 2];
        mbar_wait(k_full(st), ph);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int bx = kk * 16 / T::kBoxCols;
          const int off = (kk * 16 % T::kBoxCols) * 2;
          WgmmaQK<kBlockN>::run(
              s,
              smem_desc(q_wg + bx * T::kQBox + off, 16, 8 * T::kRowBytes,
                        T::kLayout),
              smem_desc(k_s + st * T::kKVBytes + bx * T::kKVBox + off, 16,
                        8 * T::kRowBytes, T::kLayout),
              kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(s);

        if (it == last) {
          // the last S of this item is in: Q may take the next item's
          __syncwarp();
          if (lane == 0) mbar_arrive(q_free);
        }
        if (kFull ? it == last && ragged : it == w.m_tile || it <= edge) {
          // the tile on the diagonal, or across the band's lower edge:
          // keys past the row, past S, or window or more before the row
          // are out; without causality, the ragged last tile: keys past
          // Sk are out
          const int n0 = it * kBlockN;
#pragma unroll
          for (int j = 0; j < kBlockN / 8; ++j)
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int key = n0 + 8 * j + 2 * (lane % 4) + e;
                const int row = q0 + row0 + 8 * i;
                if ((!kFull && key > row) || key >= seq_k ||
                    (kBand && key <= row - window))
                  s[4 * j + 2 * i + e] = -INFINITY;
              }
        }

        // online softmax on the fragment: rows row0 (i = 0) and row0 + 8
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float mx = m[i];
#pragma unroll
          for (int j = 0; j < kBlockN / 8; ++j)
            mx = fmaxf(mx, fmaxf(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          // without a window key 0 is visible to every row (causal or
          // not), so mx is finite from the first tile on; with one, a row
          // may see no key
          // of its item's first tiles: the guard keeps such a row at
          // exp2(-inf) = 0 rather than NaN
          const float base = mx == -INFINITY ? 0.0f : mx * sl2;
          const float alpha = exp2_approx(m[i] * sl2 - base);
          m[i] = mx;
          float sum = 0.0f;
#pragma unroll
          for (int j = 0; j < kBlockN / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float p =
                  exp2_approx(fmaf(s[4 * j + 2 * i + e], sl2, -base));
              s[4 * j + 2 * i + e] = p;
              sum += p;
            }
          l[i] = l[i] * alpha + sum;
#pragma unroll
          for (int j = 0; j < D / 8; ++j) {
            o[4 * j + 2 * i] *= alpha;
            o[4 * j + 2 * i + 1] *= alpha;
          }
        }

        // P in bf16: the S fragment of keys 16 kk .. 16 kk + 15 is the A
        // fragment of the k-step kk
        uint32_t p[kBlockN / 4];
#pragma unroll
        for (int r = 0; r < kBlockN / 4; ++r)
          p[r] = pack_bf16(s[2 * r], s[2 * r + 1]);

        // O += P . V over kBlockN / 16 k-steps
        mbar_wait(v_full(st), ph);
        fence_regs(o);
        fence_regs(p);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBlockN / 16; ++kk)
          WgmmaPV<D>::run(o, &p[4 * kk],
                          smem_desc(v_s + st * T::kKVBytes +
                                        kk * 16 * T::kRowBytes,
                                    T::kKVBox, 8 * T::kRowBytes, T::kLayout));
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(o);
        fence_regs(p);
        __syncwarp();
        if (lane == 0) mbar_arrive(kv_free(st));
      }

      // epilogue: O / l in bf16 into this warpgroup's rows of the O
      // buffer, in the TMA swizzle, once the previous item's store has
      // read them; then one TMA store per box
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
        l[i] = 1.0f / l[i];
      }
      if (t == 0)
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int col = 8 * j + 2 * (lane % 4);
          const int row = warp * 16 + lane / 4 + 8 * i;   // in the warpgroup
          const uint32_t off = (col / T::kBoxCols) * T::kQBox +
                               (c * kWgRows + row) * T::kRowBytes +
                               (col % T::kBoxCols) * 2;
          const uint32_t swz =
              off ^ (((off >> 7) & ((1u << T::kSwzBits) - 1)) << 4);
          *reinterpret_cast<uint32_t*>(smem + T::kQBytes + swz) =
              pack_bf16(o[4 * j + 2 * i] * l[i], o[4 * j + 2 * i + 1] * l[i]);
        }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
      if (t == 0 && q0 + c * kWgRows < seq_q) {
        for (int bx = 0; bx < T::kBoxes; ++bx)
          tma_store(&out_map, o_wg + bx * T::kQBox, bx * T::kBoxCols, w.h,
                    q0 + c * kWgRows, w.b);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
    }
    if (t == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// ---- host side ------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, got through the runtime so that the
// library needs no -lcuda; looked up once (never inside a graph capture:
// callers launch once before capturing).
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 (Dh, heads, S, B) map over a contiguous (B, S, heads, Dh) tensor,
// boxes of (box_cols, 1, box_rows, 1); rows past S read as zeros.
template <int D>
bool encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int batch,
            int seq, int heads, int box_rows) {
  using T = Tile<D>;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads,
                              (cuuint64_t)seq, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)seq * heads * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)T::kBoxCols, 1, (cuuint32_t)box_rows,
                             1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swz =
      T::kRowBytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
      : T::kRowBytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                           : CU_TENSOR_MAP_SWIZZLE_32B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, int M>
cudaError_t launch_instance(const void* q, const void* k, const void* v,
                            void* out, int batch, int seq_q, int seq_k,
                            int heads, int kv_heads, float scale, int window,
                            cudaStream_t stream) {
  using T = Tile<D>;
  // above 48 KB a block's dynamic shared memory must be allowed first;
  // once per instance, so that no attribute call falls inside a CUDA
  // graph capture (callers launch once before capturing)
  static bool configured = false;
  static int sm_count = 0;
  if (!configured) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sm_count, cudaDevAttrMultiProcessorCount,
                                 dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(flash_attention_kernel_sm90<D, M>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               T::kSmem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return cudaErrorNotSupported;
  // the encode is host arithmetic only, safe inside a graph capture
  CUtensorMap qm, km, vm, om;
  if (!encode<D>(fn, &qm, q, batch, seq_q, heads, kWgRows) ||
      !encode<D>(fn, &km, k, batch, seq_k, kv_heads, T::kBlockN) ||
      !encode<D>(fn, &vm, v, batch, seq_k, kv_heads, T::kBlockN) ||
      !encode<D>(fn, &om, out, batch, seq_q, heads, kWgRows))
    return cudaErrorInvalidValue;
  // one block per SM (a block fills one), each walking the items
  const int items = (seq_q + T::kBlockM - 1) / T::kBlockM * heads * batch;
  const int grid = items < sm_count ? items : sm_count;
  flash_attention_kernel_sm90<D, M><<<grid, T::kThreads, T::kSmem, stream>>>(
      qm, km, vm, om, seq_q, seq_k, heads, batch, heads / kv_heads, scale,
      window);
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
  if (cudaFuncGetAttributes(&a, flash_attention_kernel_sm90<D, M>) !=
      cudaSuccess) {
    out[0] = out[1] = out[2] = -1;
    return;
  }
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = Tile<D>::kSmem;
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
// seq_k, kv_heads, head_dim), contiguous bf16, 16-byte aligned; kv_heads
// divides heads; head_dim is 16, 32, 64, 96, 128 or 256; causal != 0:
// seq_q == seq_k and window >= 0 (0: causal only; else key j is visible
// to query i iff i - window < j <= i); causal == 0: window 0, every one of
// the seq_k >= 1 keys visible to every query.  Launches on `stream`;
// returns cudaGetLastError() (cudaErrorInvalidValue for shapes the kernel
// does not take or maps that cuTensorMapEncodeTiled refuses,
// cudaErrorNotSupported where libcuda has no cuTensorMapEncodeTiled).
extern "C" int flash_attention_sm90_launch(const void* q, const void* k,
                                           const void* v, void* out,
                                           int batch, int seq_q, int seq_k,
                                           int heads, int kv_heads,
                                           int head_dim, float scale,
                                           int window, int causal,
                                           void* stream) {
  if (kv_heads <= 0 || heads % kv_heads || window < 0 ||
      (causal ? seq_q != seq_k : window != 0 || (seq_q > 0 && seq_k <= 0)) ||
      (int64_t)((seq_q + kWgRows - 1) / kWgRows) * heads * batch > INT32_MAX)
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
extern "C" void flash_attention_sm90_attributes(int head_dim, int mask,
                                                int* out) {
  switch (mask) {
    case kMaskCausal: return attributes_of<kMaskCausal>(head_dim, out);
    case kMaskBand: return attributes_of<kMaskBand>(head_dim, out);
    case kMaskNone: return attributes_of<kMaskNone>(head_dim, out);
    default: out[0] = out[1] = out[2] = -1;
  }
}
