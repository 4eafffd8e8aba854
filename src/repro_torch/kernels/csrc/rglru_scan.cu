// RG-LRU linear recurrence for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel src/repro/kernels/rglru_scan.py (rglru_scan_fwd,
// body _rglru_kernel): h_t = a_t·h_{t−1} + b_t per channel, from h_0 = 0,
// over a/b (B, S, W); h_t is written in a's dtype at every step while the
// carry stays fp32 (the rounded output is never read back).
//
// What bounds it on this card: memory.  Two flops per element against
// 3 × 2 bytes in bf16, so the floor is reading a and b and writing h once
// (31.5 MB at recurrentgemma-2b, B=1, S=2048, W=2560: 9.4 µs).  A serial
// chain per channel cannot get near it: B·W threads (2560) fill ~20 of
// 132 SMs and each step waits on the one before.
//
// What the design does about it: a scan split across S.  S is cut into
// chunks of CHUNK steps; a block holds THREADS channels of one chunk, one
// thread per channel, and the chunk's map h ↦ (Π a)·h + h_local composes
// across chunks.  Three launches on one stream:
// 1. aggregate_kernel, grid (⌈W/THREADS⌉, chunks − 1, B): each chunk but
//    the last walks its steps from h = 0 and writes (Π a, h_local), fp32.
// 2. carry_kernel, grid (⌈W/THREADS⌉, 1, B): per channel, the carry into
//    every chunk, carry(c+1) = (Π a)(c)·carry(c) + h_local(c), in place of
//    h_local.  The only walk over chunks, one rounded product and sum a
//    chunk.
// 3. replay_kernel, grid (⌈W/THREADS⌉, chunks, B): each chunk replays its
//    steps from its true incoming carry and writes h.
// One channel a thread keeps ~80k threads and their loads in flight at
// recurrentgemma-2b; 16 bytes of channels a thread leaves a tenth of the
// threads, and measured slower (PERF.md §6).
// Passes 1 and 3 each read a and b; at these sizes the second read finds
// them in the 50 MB L2.  A single-pass scan with decoupled look-back
// would read them once, at the price of flags, spinning and an atomic
// ticket; that is later work if the second read shows in the time.
// The replay does a rounded product, then a rounded sum (no FMA), as the
// reference writes it (a_t * h + b_t); only the carry at a chunk edge is
// rounded differently from the serial chain (a few ulps, decaying, since
// 0 < a < 1).  One chunk (S ≤ CHUNK) runs the replay alone, from 0: the
// serial chain itself.  Within a chunk the walk loads UNROLL steps of a
// and b before it computes them, coalesced across the warp's channels (W
// is the contiguous axis); a ragged W is masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int THREADS = 128;  // channels per block (rglru_scan.py::THREADS)
constexpr int CHUNK = 64;     // steps per chunk (rglru_scan.py::CHUNK)
constexpr int UNROLL = 32;    // steps loaded before they are computed
static_assert(CHUNK % UNROLL == 0, "whole batches in a full chunk");

// the affine map of a full chunk, from h = 0: (Π a, h_local)
template <typename T>
__global__ void __launch_bounds__(THREADS)
aggregate_kernel(const T* __restrict__ a, const T* __restrict__ b, float* __restrict__ prod,
                 float* __restrict__ local, int S, int W, int chunks) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  if (w >= W) return;
  const int c = blockIdx.y, bb = blockIdx.z;
  const long base = ((long)bb * S + (long)c * CHUNK) * W + w;
  float p = 1.f, h = 0.f;
#pragma unroll 1
  for (int t = 0; t < CHUNK; t += UNROLL) {
    float av[UNROLL], bv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      av[u] = to_f(a[base + (long)(t + u) * W]);
      bv[u] = to_f(b[base + (long)(t + u) * W]);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      h = __fadd_rn(__fmul_rn(av[u], h), bv[u]);
      p = __fmul_rn(p, av[u]);
    }
  }
  const long o = ((long)bb * chunks + c) * W + w;
  prod[o] = p;
  local[o] = h;
}

// local[c] ← the carry into chunk c (0 for c = 0), chunks > 1
__global__ void __launch_bounds__(THREADS)
carry_kernel(const float* __restrict__ prod, float* __restrict__ local, int W, int chunks) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  if (w >= W) return;
  const long base = (long)blockIdx.z * chunks * W + w;
  constexpr int BATCH = 8;  // loads in flight ahead of the dependent chain
  float carry = 0.f;
  for (int c0 = 0; c0 < chunks - 1; c0 += BATCH) {
    float p[BATCH], l[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const bool in = c0 + u < chunks - 1;
      p[u] = in ? prod[base + (long)(c0 + u) * W] : 0.f;
      l[u] = in ? local[base + (long)(c0 + u) * W] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      if (c0 + u >= chunks - 1) break;
      local[base + (long)(c0 + u) * W] = carry;
      carry = __fadd_rn(__fmul_rn(p[u], carry), l[u]);
    }
  }
  local[base + (long)(chunks - 1) * W] = carry;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
replay_kernel(const T* __restrict__ a, const T* __restrict__ b, const float* __restrict__ carry,
              T* __restrict__ h, int S, int W, int chunks) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  if (w >= W) return;
  const int c = blockIdx.y, bb = blockIdx.z;
  const int t0 = c * CHUNK, steps = min(CHUNK, S - t0);
  const long base = ((long)bb * S + t0) * W + w;
  float x = c == 0 ? 0.f : carry[((long)bb * chunks + c) * W + w];
  int t = 0;
#pragma unroll 1
  for (; t + UNROLL <= steps; t += UNROLL) {
    float av[UNROLL], bv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      av[u] = to_f(a[base + (long)(t + u) * W]);
      bv[u] = to_f(b[base + (long)(t + u) * W]);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      x = __fadd_rn(__fmul_rn(av[u], x), bv[u]);
      h[base + (long)(t + u) * W] = from_f<T>(x);
    }
  }
  for (; t < steps; ++t) {
    x = __fadd_rn(__fmul_rn(to_f(a[base + (long)t * W]), x), to_f(b[base + (long)t * W]));
    h[base + (long)t * W] = from_f<T>(x);
  }
}

template <typename T>
cudaError_t launch(const void* a, const void* b, float* ws, void* h, int B, int S, int W,
                   int chunks, cudaStream_t stream) {
  const T* at = static_cast<const T*>(a);
  const T* bt = static_cast<const T*>(b);
  const int wb = (W + THREADS - 1) / THREADS;
  float* prod = ws;                                  // (B, chunks, W)
  float* local = ws + (long)B * chunks * W;          // (B, chunks, W)
  if (chunks > 1) {
    aggregate_kernel<T><<<dim3(wb, chunks - 1, B), THREADS, 0, stream>>>(
        at, bt, prod, local, S, W, chunks);
    carry_kernel<<<dim3(wb, 1, B), THREADS, 0, stream>>>(prod, local, W, chunks);
  }
  replay_kernel<T><<<dim3(wb, chunks, B), THREADS, 0, stream>>>(
      at, bt, local, static_cast<T*>(h), S, W, chunks);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// a/b/h: (B, S, W), one dtype, contiguous.  chunks = ⌈S / 64⌉; ws: fp32
// scratch of 2·B·chunks·W floats where chunks > 1 (kernels/rglru_scan.py::
// rglru_plan), else unused.  Returns cudaGetLastError() after the last
// launch.
extern "C" int repro_rglru_scan_fwd(const void* a, const void* b, void* ws, void* h, int B,
                                    int S, int W, int chunks, int dtype, void* stream) {
  using namespace repro_torch;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || B > 65535 || S <= 0 || W <= 0 || chunks != (S + CHUNK - 1) / CHUNK ||
      chunks > 65535 || (chunks > 1 && ws == nullptr))
    return cudaErrorInvalidValue;
  float* w = static_cast<float*>(ws);
  if (dtype == kFloat32) return launch<float>(a, b, w, h, B, S, W, chunks, st);
  if (dtype == kBFloat16) return launch<__nv_bfloat16>(a, b, w, h, B, S, W, chunks, st);
  return cudaErrorInvalidValue;
}
