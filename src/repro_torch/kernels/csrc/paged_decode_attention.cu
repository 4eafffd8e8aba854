// Paged decode attention for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py
// (paged_decode_attention_fwd, body _paged_decode_kernel with
// _softmax_accumulate): one query token per head attends over its
// request's page list in a (P, page, KV, Dh) block pool, with an fp32
// online softmax over the pages whose start lies below lengths[b];
// positions at or past lengths[b] are masked with -1e30, pages past the
// fill are never read, and the output is acc / max(l, 1e-20).
//
// What bounds it on this card: memory.  Each K/V element read feeds G
// multiply-adds (G = query heads per KV head, 12 for starcoder2-3b), about
// 12 FLOP/byte in bf16 against the H100's ~295 FLOP/byte ridge, so the
// floor is the bytes of live K/V over HBM bandwidth.
//
// What the design does about it:
// * One block per (request b, KV head) computes all G query heads of that
//   group, so each K/V page is read from HBM once, not G times — the
//   counterpart of the TPU index map that routes rows to their KV head.
// * The block reads its own page_table[b, :] and lengths[b] (the TPU
//   prefetched them into SMEM) and walks only pages whose start is below
//   the length.
// * Pages (page × Dh, 4 KB each for K and V at 16 × 128 bf16) move into
//   shared memory with 16-byte cp.async copies, double-buffered: page j+1
//   is in flight while page j is scored, so the walk pays the HBM latency
//   once, not once per page.  K rows are padded by 16 bytes so the lanes
//   of a warp, one token each, read their rows in distinct banks.
// * A warp owns up to four query rows; per row, lane t scores token t
//   (and t + 32) with four independent FMA chains over the head dim, max
//   and sum reduce with warp shuffles, and each lane
//   keeps its Dh/32 accumulator columns and the row's (m, l) in fp32
//   registers.
// Splitting one request's walk across blocks (flash-decoding, with an
// exact log-sum-exp combine) is later work.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int RPW = 4;         // query rows per warp
constexpr int MIN_WARPS = 4;   // enough threads to keep page copies in flight
constexpr int MAX_PAGE = 64;   // two tokens per lane at most
constexpr unsigned FULL = 0xffffffffu;

// shared memory: Q as fp32, then two page buffers of K (rows padded by 16
// bytes) and V, in the input dtype
inline size_t decode_smem_bytes(int G, int Dh, int page, int elem) {
  return (size_t)G * Dh * 4 + 2 * (size_t)page * ((size_t)Dh * elem * 2 + 16);
}

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

template <typename T, int DH>
__global__ void paged_decode_kernel(const T* __restrict__ q,
                                    const T* __restrict__ k_pages,
                                    const T* __restrict__ v_pages,
                                    const int* __restrict__ page_table,
                                    const int* __restrict__ lengths,
                                    T* __restrict__ o, int H, int KV, int page,
                                    int maxp, float scale) {
  constexpr int VEC = 16 / sizeof(T);          // elements per 16-byte chunk
  constexpr int CPR = DH / VEC;                // chunks per K/V row
  constexpr int KROW = DH + VEC;               // padded K row (elements)
  constexpr int DPL = (DH + 31) / 32;          // accumulator columns per lane
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int G = H / KV;
  float* Qs = reinterpret_cast<float*>(smem_raw);          // [G][DH]
  T* Kb = reinterpret_cast<T*>(Qs + G * DH);               // [2][page][KROW]
  T* Vb = Kb + 2 * page * KROW;                            // [2][page][DH]

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int len = lengths[b];
  const int* pt = page_table + (long)b * maxp;
  const long tok_stride = (long)KV * DH;  // between tokens of one page

  // rows r = b·H + kvh·G + g: KV-major head order, as the reference flattens
  const T* qb = q + ((long)b * H + (long)kvh * G) * DH;
  for (int idx = tid; idx < G * DH; idx += nthreads) Qs[idx] = to_f(qb[idx]);

  const int npages = len > 0 ? min(maxp, (len + page - 1) / page) : 0;
  auto issue = [&](int j) {  // start copying page j into buffer j % 2
    const long base = (long)pt[j] * page * tok_stride + (long)kvh * DH;
    T* kdst = Kb + (j & 1) * page * KROW;
    T* vdst = Vb + (j & 1) * page * DH;
    for (int c = tid; c < page * CPR; c += nthreads) {
      const int t = c / CPR, ch = c % CPR;
      const long src = base + t * tok_stride + ch * VEC;
      __pipeline_memcpy_async(kdst + t * KROW + ch * VEC, k_pages + src, 16);
      __pipeline_memcpy_async(vdst + t * DH + ch * VEC, v_pages + src, 16);
    }
    __pipeline_commit();
  };
  if (npages > 0) issue(0);

  float m[RPW], l[RPW], acc[RPW][DPL];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }

  for (int j = 0; j < npages; ++j) {
    if (j + 1 < npages) {
      issue(j + 1);                 // overlaps this page's arithmetic
      __pipeline_wait_prior(1);     // page j has landed (for this thread)
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();                // ... and for every thread; Q visible
    const T* Ks = Kb + (j & 1) * page * KROW;
    const T* Vs = Vb + (j & 1) * page * DH;

    const int t0 = j * page;
    const bool has0 = lane < page, has1 = lane + 32 < page;
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int g = warp * RPW + r;
      if (g >= G) continue;  // warp-uniform
      const float* qr = Qs + g * DH;
      // score tokens lane and lane + 32; tokens past the page end do not
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
      for (int t = 0; t < page; ++t) {
        const float p = __shfl_sync(FULL, t < 32 ? p0 : p1, t & 31);
        const T* vr = Vs + t * DH;
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          const int d = lane + 32 * i;
          if (d < DH) acc[r][i] = fmaf(p, to_f(vr[d]), acc[r][i]);
        }
      }
    }
    __syncthreads();  // buffer j % 2 is free for page j + 2
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

template <typename T, int DH>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const int* pt, const int* lens, void* o, int B, int H,
                   int KV, int page, int maxp, cudaStream_t stream) {
  const int G = H / KV;
  const int warps = max(MIN_WARPS, (G + RPW - 1) / RPW);
  const size_t smem = decode_smem_bytes(G, DH, page, sizeof(T));
  cudaError_t err = allow_smem(paged_decode_kernel<T, DH>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(KV, B);
  const float scale = 1.0f / sqrtf((float)DH);
  paged_decode_kernel<T, DH><<<grid, 32 * warps, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), pt, lens, static_cast<T*>(o), H, KV, page,
      maxp, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int Dh, const void* q, const void* kp, const void* vp,
                     const int* pt, const int* lens, void* o, int B, int H,
                     int KV, int page, int maxp, cudaStream_t st) {
  switch (Dh) {
    case 16: return launch<T, 16>(q, kp, vp, pt, lens, o, B, H, KV, page, maxp, st);
    case 32: return launch<T, 32>(q, kp, vp, pt, lens, o, B, H, KV, page, maxp, st);
    case 64: return launch<T, 64>(q, kp, vp, pt, lens, o, B, H, KV, page, maxp, st);
    case 128: return launch<T, 128>(q, kp, vp, pt, lens, o, B, H, KV, page, maxp, st);
    case 256: return launch<T, 256>(q, kp, vp, pt, lens, o, B, H, KV, page, maxp, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro_torch

// q/o: (B, H, Dh); k_pages/v_pages: (P, page, KV, Dh); page_table: (B, maxp)
// int32 with valid pool indices everywhere; lengths: (B,) int32.  All
// contiguous.  Returns cudaGetLastError() after the launch.
extern "C" int repro_paged_decode_attention_fwd(
    const void* q, const void* k_pages, const void* v_pages,
    const void* page_table, const void* lengths, void* o, int B, int H,
    int KV, int Dh, int page, int maxp, int dtype, void* stream) {
  using namespace repro_torch;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || KV <= 0 || H % KV != 0 || page <= 0 || page > MAX_PAGE ||
      (H / KV + RPW - 1) / RPW > 32)
    return cudaErrorInvalidValue;
  const int* pt = static_cast<const int*>(page_table);
  const int* lens = static_cast<const int*>(lengths);
  if (dtype == kFloat32)
    return dispatch<float>(Dh, q, k_pages, v_pages, pt, lens, o, B, H, KV, page, maxp, st);
  if (dtype == kBFloat16)
    return dispatch<__nv_bfloat16>(Dh, q, k_pages, v_pages, pt, lens, o, B, H, KV, page, maxp, st);
  return cudaErrorInvalidValue;
}
