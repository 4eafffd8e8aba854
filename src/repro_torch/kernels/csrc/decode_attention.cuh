// One-token decode attention for Hopper (sm_90a): the block body shared
// by the paged kernel (paged_decode_attention.cu) and the dense one
// (decode_attention.cu).
//
// What bounds both on this card: memory.  Each K/V element read feeds G
// multiply-adds (G = query heads per KV head, 12 for starcoder2-3b), about
// 12 FLOP/byte in bf16 against the H100's ~295 FLOP/byte ridge, so the
// floor is the bytes of live K/V over HBM bandwidth.
//
// What the design does about it:
// * One block per (request b, KV head) computes all G query heads of that
//   group, so each K/V tile is read from HBM once, not G times — the
//   counterpart of the TPU index map that routes rows to their KV head.
// * The block reads its own lengths[b] (and, paged, its page_table[b, :];
//   the TPU prefetched them into SMEM) and walks only tiles whose start is
//   below the length.  A tile is one page of the pool, or `tile`
//   consecutive tokens of the dense cache.
// * Tiles (tile × Dh, 4 KB each for K and V at 16 × 128 bf16) move into
//   shared memory with 16-byte cp.async copies, double-buffered: tile j+1
//   is in flight while tile j is scored, so the walk pays the HBM latency
//   once, not once per tile.  K rows are padded by 16 bytes so the lanes
//   of a warp, one token each, read their rows in distinct banks.
// * A warp owns up to four query rows; per row, lane t scores token t
//   (and t + 32) with four independent FMA chains over the head dim, max
//   and sum reduce with warp shuffles, and each lane
//   keeps its Dh/32 accumulator columns and the row's (m, l) in fp32
//   registers.
// Splitting one request's walk across blocks (flash-decoding, with an
// exact log-sum-exp combine) is later work.
#pragma once

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace repro_torch {
namespace decode {

constexpr int RPW = 4;         // query rows per warp
constexpr int MIN_WARPS = 4;   // enough threads to keep tile copies in flight
constexpr int MAX_TILE = 64;   // two tokens per lane at most
constexpr int MAX_WARPS = 32;  // so G <= RPW * MAX_WARPS = 128
constexpr unsigned FULL = 0xffffffffu;

// shared memory: Q as fp32, then two tile buffers of K (rows padded by 16
// bytes) and V, in the input dtype
inline size_t smem_bytes(int G, int Dh, int tile, int elem) {
  return (size_t)G * Dh * 4 + 2 * (size_t)tile * ((size_t)Dh * elem * 2 + 16);
}

inline int warps_for(int G) { return max(MIN_WARPS, (G + RPW - 1) / RPW); }

// eight bf16 or four fp32 values from one 16-byte chunk
__device__ __forceinline__ void unpack16(const uint4& raw, float* out, float) {
  out[0] = __uint_as_float(raw.x);
  out[1] = __uint_as_float(raw.y);
  out[2] = __uint_as_float(raw.z);
  out[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void unpack16(const uint4& raw, float* out, __nv_bfloat16) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 h2 = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
    const float2 f = __bfloat1622float2(h2);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// DENSE: k/v are (B, extent, KV, DH) caches and page_table is unused.
// Paged: k/v are (P, tile, KV, DH) pools, page_table (B, extent).
// q/o: (B, H, DH) with rows in KV-major head order, as the reference
// flattens them.  Positions at or past lengths[b] are masked with -1e30; a
// row with no position below its length gives 0 (acc / max(l, 1e-20)).
template <typename T, int DH, bool DENSE>
__global__ void kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const int* __restrict__ page_table,
                       const int* __restrict__ lengths, T* __restrict__ o,
                       int H, int KV, int tile, int extent, float scale) {
  constexpr int VEC = 16 / sizeof(T);          // elements per 16-byte chunk
  constexpr int CPR = DH / VEC;                // chunks per K/V row
  constexpr int KROW = DH + VEC;               // padded K row (elements)
  constexpr int DPL = (DH + 31) / 32;          // accumulator columns per lane
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int G = H / KV;
  float* Qs = reinterpret_cast<float*>(smem_raw);          // [G][DH]
  T* Kb = reinterpret_cast<T*>(Qs + G * DH);               // [2][tile][KROW]
  T* Vb = Kb + 2 * tile * KROW;                            // [2][tile][DH]

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int len = DENSE ? min(lengths[b], extent) : lengths[b];
  const int* pt = DENSE ? nullptr : page_table + (long)b * extent;
  const long tok_stride = (long)KV * DH;  // between consecutive tokens

  const T* qb = q + ((long)b * H + (long)kvh * G) * DH;
  for (int idx = tid; idx < G * DH; idx += nthreads) Qs[idx] = to_f(qb[idx]);

  const int ntiles = len <= 0 ? 0
                     : DENSE ? (len + tile - 1) / tile
                             : min(extent, (len + tile - 1) / tile);
  auto issue = [&](int j) {  // start copying tile j into buffer j % 2
    const long base = (DENSE ? ((long)b * extent + (long)j * tile)
                             : (long)pt[j] * tile) * tok_stride + (long)kvh * DH;
    T* kdst = Kb + (j & 1) * tile * KROW;
    T* vdst = Vb + (j & 1) * tile * DH;
    for (int c = tid; c < tile * CPR; c += nthreads) {
      const int t = c / CPR, ch = c % CPR;
      T* kd = kdst + t * KROW + ch * VEC;
      T* vd = vdst + t * DH + ch * VEC;
      if (DENSE && j * tile + t >= len) {
        // past the length (maybe past the cache): never read, zero so the
        // masked p = 0 meets a finite V
        *reinterpret_cast<uint4*>(kd) = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(vd) = make_uint4(0, 0, 0, 0);
        continue;
      }
      const long src = base + t * tok_stride + ch * VEC;
      __pipeline_memcpy_async(kd, k + src, 16);
      __pipeline_memcpy_async(vd, v + src, 16);
    }
    __pipeline_commit();
  };
  if (ntiles > 0) issue(0);

  float m[RPW], l[RPW], acc[RPW][DPL];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }

  for (int j = 0; j < ntiles; ++j) {
    if (j + 1 < ntiles) {
      issue(j + 1);                 // overlaps this tile's arithmetic
      __pipeline_wait_prior(1);     // tile j has landed (for this thread)
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();                // ... and for every thread; Q visible
    const T* Ks = Kb + (j & 1) * tile * KROW;
    const T* Vs = Vb + (j & 1) * tile * DH;

    const int t0 = j * tile;
    const bool has0 = lane < tile, has1 = lane + 32 < tile;
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int g = warp * RPW + r;
      if (g >= G) continue;  // warp-uniform
      const float* qr = Qs + g * DH;
      // score tokens lane and lane + 32; tokens past the tile end do not
      // exist (-inf), tokens past the length are masked (-1e30)
      float s0 = -INFINITY, s1 = -INFINITY;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int t = lane + 32 * half;
        if (!(half ? has1 : has0)) continue;
        const uint4* kr = reinterpret_cast<const uint4*>(Ks + t * KROW);
        float part[4] = {0.f, 0.f, 0.f, 0.f};  // four independent FMA chains
#pragma unroll
        for (int ch = 0; ch < CPR; ++ch) {
          float kf[VEC];
          unpack16(kr[ch], kf, T());
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            part[e & 3] = fmaf(qr[ch * VEC + e], kf[e], part[e & 3]);
        }
        const float dot = (part[0] + part[1]) + (part[2] + part[3]);
        const float sv = (t0 + t < len) ? dot * scale : kNegInf;
        if (half) s1 = sv; else s0 = sv;
      }
      float mcur = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mcur = fmaxf(mcur, __shfl_xor_sync(FULL, mcur, off));
      const float m_new = fmaxf(m[r], mcur);
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      float psum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        psum += __shfl_xor_sync(FULL, psum, off);
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + psum;
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[r][i] *= alpha;
#pragma unroll 4
      for (int t = 0; t < tile; ++t) {
        const float p = __shfl_sync(FULL, t < 32 ? p0 : p1, t & 31);
        const T* vr = Vs + t * DH;
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          const int d = lane + 32 * i;
          if (d < DH) acc[r][i] = fmaf(p, to_f(vr[d]), acc[r][i]);
        }
      }
    }
    __syncthreads();  // buffer j % 2 is free for tile j + 2
  }

#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int g = warp * RPW + r;
    if (g >= G) continue;
    const float den = fmaxf(l[r], 1e-20f);
    T* orow = o + ((long)b * H + (long)kvh * G + g) * DH;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < DH) orow[d] = from_f<T>(acc[r][i] / den);
    }
  }
}

template <typename T, int DH, bool DENSE>
cudaError_t launch(const void* q, const void* k, const void* v, const int* pt,
                   const int* lens, void* o, int B, int H, int KV, int tile,
                   int extent, cudaStream_t stream) {
  const int G = H / KV;
  const size_t smem = smem_bytes(G, DH, tile, sizeof(T));
  cudaError_t err = allow_smem(kernel<T, DH, DENSE>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(KV, B);
  const float scale = 1.0f / sqrtf((float)DH);
  kernel<T, DH, DENSE><<<grid, 32 * warps_for(G), smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pt, lens, static_cast<T*>(o), H, KV, tile,
      extent, scale);
  return cudaGetLastError();
}

template <typename T, bool DENSE>
cudaError_t dispatch(int Dh, const void* q, const void* k, const void* v,
                     const int* pt, const int* lens, void* o, int B, int H,
                     int KV, int tile, int extent, cudaStream_t st) {
  switch (Dh) {
    case 16: return launch<T, 16, DENSE>(q, k, v, pt, lens, o, B, H, KV, tile, extent, st);
    case 32: return launch<T, 32, DENSE>(q, k, v, pt, lens, o, B, H, KV, tile, extent, st);
    case 64: return launch<T, 64, DENSE>(q, k, v, pt, lens, o, B, H, KV, tile, extent, st);
    case 128: return launch<T, 128, DENSE>(q, k, v, pt, lens, o, B, H, KV, tile, extent, st);
    case 256: return launch<T, 256, DENSE>(q, k, v, pt, lens, o, B, H, KV, tile, extent, st);
    default: return cudaErrorInvalidValue;
  }
}

template <bool DENSE>
cudaError_t dispatch_dtype(int dtype, int Dh, const void* q, const void* k,
                           const void* v, const int* pt, const int* lens,
                           void* o, int B, int H, int KV, int tile, int extent,
                           cudaStream_t st) {
  if (dtype == kFloat32)
    return dispatch<float, DENSE>(Dh, q, k, v, pt, lens, o, B, H, KV, tile, extent, st);
  if (dtype == kBFloat16)
    return dispatch<__nv_bfloat16, DENSE>(Dh, q, k, v, pt, lens, o, B, H, KV, tile, extent, st);
  return cudaErrorInvalidValue;
}

}  // namespace decode
}  // namespace repro_torch
