// RG-LRU linear recurrence for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel src/repro/kernels/rglru_scan.py (rglru_scan_fwd,
// body _rglru_kernel): h_t = a_t·h_{t−1} + b_t per channel, from h_0 = 0,
// over a/b (B, S, W); h_t is written in a's dtype at every step while the
// carry stays fp32 (the rounded output is never read back).
//
// What bounds it on this card: memory.  Two flops per element against
// 3 × 2 bytes in bf16, so the floor is reading a and b and writing h once.
// A serial chain per channel cannot reach it with one thread per channel:
// each step waits on the previous one, and B·W threads (2560 at
// recurrentgemma-2b, B=1) fill ~20 of 132 SMs.
//
// What the design does about it:
// * The TPU ran block_w channels as vector lanes and carried h across a
//   sequential grid axis.  Here one thread per (batch, channel) walks all
//   of S in a loop; the loads of step t are coalesced across the warp's
//   channels, since W is the contiguous axis.  A ragged W is masked, S
//   needs no padding.
// * The walk loads UNROLL steps of a and b before it computes them, so
//   that many loads are in flight for each round trip to HBM.
// * The update is a rounded product, then a rounded sum (no FMA), as the
//   reference writes it: a_t * h + b_t.
// A scan split across S (chunk carries combined in a second pass) is
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int THREADS = 128;
constexpr int UNROLL = 16;

template <typename T>
__global__ void __launch_bounds__(THREADS)
rglru_kernel(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ h,
             int S, int W) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  if (w >= W) return;
  const long base = (long)blockIdx.y * S * W + w;
  float carry = 0.f;
  int t = 0;
  for (; t + UNROLL <= S; t += UNROLL) {
    float av[UNROLL], bv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      av[u] = to_f(a[base + (long)(t + u) * W]);
      bv[u] = to_f(b[base + (long)(t + u) * W]);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      carry = __fadd_rn(__fmul_rn(av[u], carry), bv[u]);
      h[base + (long)(t + u) * W] = from_f<T>(carry);
    }
  }
  for (; t < S; ++t) {
    carry = __fadd_rn(__fmul_rn(to_f(a[base + (long)t * W]), carry),
                      to_f(b[base + (long)t * W]));
    h[base + (long)t * W] = from_f<T>(carry);
  }
}

template <typename T>
cudaError_t launch(const void* a, const void* b, void* h, int B, int S, int W,
                   cudaStream_t stream) {
  const dim3 grid((W + THREADS - 1) / THREADS, B);
  rglru_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(h), S, W);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// a/b/h: (B, S, W), one dtype, contiguous.  Returns cudaGetLastError()
// after the launch.
extern "C" int repro_rglru_scan_fwd(const void* a, const void* b, void* h, int B,
                                    int S, int W, int dtype, void* stream) {
  using namespace repro_torch;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || B > 65535 || S <= 0 || W <= 0) return cudaErrorInvalidValue;
  if (dtype == kFloat32) return launch<float>(a, b, h, B, S, W, st);
  if (dtype == kBFloat16) return launch<__nv_bfloat16>(a, b, h, B, S, W, st);
  return cudaErrorInvalidValue;
}
