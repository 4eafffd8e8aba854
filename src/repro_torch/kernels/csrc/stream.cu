// STREAM triad for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel src/repro/kernels/stream.py (triad, body
// _triad_kernel): out = a + alpha·b over (N,).
//
// What bounds it on this card: memory, by definition of STREAM — two
// reads and one write per element, two flops.
//
// What the design does about it:
// * Each thread moves one 16-byte vector of a, of b and of out (four fp32
//   or eight bf16 values); the first N % vector threads also take one
//   element of the scalar tail.  The TPU's blocks through VMEM and the
//   padding of N to a block multiple are not needed.
// * Rounding is the reference's: the product alpha·b is rounded to the
//   storage dtype, then the sum is (__fmul_rn / __fadd_rn, so nvcc cannot
//   contract them into one FMA that rounds once).  The kernel is then bit
//   for bit equal to `a + alpha * b` in both dtypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int THREADS = 256;

template <typename T>
__device__ __forceinline__ T triad_one(T a, T b, float alpha) {
  const T prod = from_f<T>(__fmul_rn(alpha, to_f(b)));
  return from_f<T>(__fadd_rn(to_f(a), to_f(prod)));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
triad_kernel(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ o,
             long long n, float alpha) {
  constexpr int VEC = 16 / sizeof(T);
  const long long nvec = n / VEC;
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i < nvec) {
    const uint4 ra = reinterpret_cast<const uint4*>(a)[i];
    const uint4 rb = reinterpret_cast<const uint4*>(b)[i];
    uint4 ro;
    const T* ea = reinterpret_cast<const T*>(&ra);
    const T* eb = reinterpret_cast<const T*>(&rb);
    T* eo = reinterpret_cast<T*>(&ro);
#pragma unroll
    for (int e = 0; e < VEC; ++e) eo[e] = triad_one(ea[e], eb[e], alpha);
    reinterpret_cast<uint4*>(o)[i] = ro;
  }
  const long long tail = nvec * VEC + i;
  if (tail < n) o[tail] = triad_one(a[tail], b[tail], alpha);
}

template <typename T>
cudaError_t launch(const void* a, const void* b, void* o, long long n, float alpha,
                   cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const long long work = n / VEC > 0 ? n / VEC : 1;  // the tail is < VEC
  const long long blocks = (work + THREADS - 1) / THREADS;
  triad_kernel<T><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(o), n,
      alpha);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// a/b/o: (n,), one dtype, contiguous and 16-byte aligned.  Returns
// cudaGetLastError() after the launch.
extern "C" int repro_stream_triad(const void* a, const void* b, void* o,
                                  long long n, float alpha, int dtype,
                                  void* stream) {
  using namespace repro_torch;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || n / 4 / 256 >= 0x7fffffffLL) return cudaErrorInvalidValue;
  if (dtype == kFloat32) return launch<float>(a, b, o, n, alpha, st);
  if (dtype == kBFloat16) return launch<__nv_bfloat16>(a, b, o, n, alpha, st);
  return cudaErrorInvalidValue;
}
