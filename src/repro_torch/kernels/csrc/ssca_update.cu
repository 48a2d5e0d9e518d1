// Fused SSCA server update (Algorithm 1, eqs. (13)-(17) and (4)).
//
// Replaces the TPU kernel src/repro/kernels/ssca_update.py::ssca_update_2d.
// Per element, with the scalars [rho, gamma, tau, lam], in two variants of
// one template:
//
//   beta (kBeta = true), every lam:
//     lin'  = (1 - rho) lin + rho (g - 2 tau w)
//     beta' = (1 - rho) beta + rho w
//     wbar  = -(lin' + 2 lam beta') / (2 tau)
//     w'    = (1 - gamma) w + gamma wbar
//
//   lambda0 (kBeta = false), lam = 0: the reference's lam = 0 path
//   (src/repro/core/ssca.py::solve_surrogate without beta), which never
//   reads or advances beta:
//     lin'  = (1 - rho) lin + rho (g - 2 tau w)
//     wbar  = -lin' / (2 tau)
//     w'    = (1 - gamma) w + gamma wbar
//
// Bound on the card: device memory.  The beta variant reads four f32
// tensors and writes three, 28 bytes per element; lambda0 reads three and
// writes two, 20 bytes; 14 and 9 flops an element, far below the H100's
// ridge point.  At the MLP's n = 101,632 that is 2.85 MB, under a
// microsecond at 3.35 TB/s, so the launch itself dominates; the design
// does nothing about that (one launch per round).  At the LM paths' full
// width the bytes set the time, and lambda0 is the design that moves
// fewer: at lam = 0 beta' is discarded, so reading beta and writing beta'
// is waste.  Design: one thread per element, a grid-stride loop,
// coalesced 4-byte loads (wider loads, streaming stores, TMA bulk copies
// and SM-sized grids measured no faster on the beta variant), so views
// at any 4-byte offset are taken as they are.
//
// Every operation is an explicitly rounded intrinsic (__fmul_rn, ...), so
// nvcc does not contract a multiply and an add into an FMA: the kernel
// computes each step exactly as the plain PyTorch version does, and the
// two agree bit for bit.  The division stays IEEE (no --use_fast_math).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <bool kBeta>
__global__ void ssca_update_kernel(const float* __restrict__ w,
                                   const float* __restrict__ lin,
                                   const float* __restrict__ g,
                                   const float* __restrict__ beta,
                                   const float* __restrict__ scalars,
                                   float* __restrict__ w_out,
                                   float* __restrict__ lin_out,
                                   float* __restrict__ beta_out,
                                   int64_t n) {
  const float rho = scalars[0];
  const float gamma = scalars[1];
  const float tau = scalars[2];
  const float lam = scalars[3];
  const float keep_rho = __fsub_rn(1.0f, rho);
  const float keep_gamma = __fsub_rn(1.0f, gamma);
  const float two_tau = __fmul_rn(2.0f, tau);
  const float two_lam = __fmul_rn(2.0f, lam);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float wi = w[i];
    const float lin_new =
        __fadd_rn(__fmul_rn(keep_rho, lin[i]),
                  __fmul_rn(rho, __fsub_rn(g[i], __fmul_rn(two_tau, wi))));
    float beta_new = 0.0f;
    float wbar;
    if constexpr (kBeta) {
      beta_new = __fadd_rn(__fmul_rn(keep_rho, beta[i]), __fmul_rn(rho, wi));
      wbar = __fdiv_rn(-__fadd_rn(lin_new, __fmul_rn(two_lam, beta_new)),
                       two_tau);
    } else {
      wbar = __fdiv_rn(-lin_new, two_tau);
    }
    w_out[i] = __fadd_rn(__fmul_rn(keep_gamma, wi), __fmul_rn(gamma, wbar));
    lin_out[i] = lin_new;
    if constexpr (kBeta) {
      beta_out[i] = beta_new;
    }
  }
}

}  // namespace

// All pointers are device pointers to contiguous f32 buffers of n elements
// (scalars: 4).  With beta and beta_out both null it launches the lambda0
// variant, else the beta variant.  Launches on `stream`; returns
// cudaGetLastError().
extern "C" int ssca_update_launch(const float* w, const float* lin,
                                  const float* g, const float* beta,
                                  const float* scalars, float* w_out,
                                  float* lin_out, float* beta_out, int64_t n,
                                  void* stream) {
  if ((beta == nullptr) != (beta_out == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n > 0) {
    const int64_t want = (n + kThreads - 1) / kThreads;
    const int blocks = (int)(want < 65535 ? want : 65535);
    if (beta != nullptr) {
      ssca_update_kernel<true><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
          w, lin, g, beta, scalars, w_out, lin_out, beta_out, n);
    } else {
      ssca_update_kernel<false><<<blocks, kThreads, 0,
                                  (cudaStream_t)stream>>>(
          w, lin, g, nullptr, scalars, w_out, lin_out, nullptr, n);
    }
  }
  return (int)cudaGetLastError();
}
