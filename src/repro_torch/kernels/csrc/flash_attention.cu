// Flash attention forward for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention_fwd, body _flash_fwd_kernel): softmax(q·kᵀ/√Dh + mask)·v
// with an fp32 online-softmax carry, masks for K positions at or past
// valid_len, causal (kpos ≤ qpos) and sliding window (kpos > qpos − window),
// fully masked K blocks skipped, output acc / max(l, 1e-20).
//
// What bounds it on this card: at prefill lengths (S of a few hundred to a
// few thousand, Dh = 128) attention does ~Dh·S/2 multiply-adds per byte of
// q/k/v it must read, far above the H100's ~295 FLOP/byte ridge, so it is
// bound by arithmetic: the tensor cores for bf16, the fp32 FMA pipes for
// fp32 inputs (which must stay exact fp32, so no TF32).
//
// What the design does about it:
// * One block per (batch·q-head, 64-row q tile).  The TPU's sequential K
//   grid axis becomes a loop inside the block, bounded by the causal /
//   window limits, so masked tiles are never loaded.
// * bf16 with head_dim ≤ 128 (the serving path): four warps of 16 q rows
//   run mma.sync m16n8k16 (bf16 in, fp32 accumulate) for Q·Kᵀ and P·V; Q
//   stays in registers, K/V tiles arrive by double-buffered 16-byte
//   cp.async into row-padded shared memory and reach the tensor cores by
//   ldmatrix.  The (m, l) carry and the output stay in fp32 registers; P
//   is rounded to bf16 only as the P·V operand.  wgmma + TMA is later work.
// * fp32, or head_dim 256: K and V tiles of 64 rows are staged in shared
//   memory as fp32 (K transposed, padded rows), four threads share a q row
//   and do fp32 FMAs; row max and sum reduce over the quad with two
//   shuffles, and P reaches the P·V loop through shuffles.
// * GQA is routed in the indexing (kv head = h / G): the kernel reads the
//   (B, S, KV, Dh) K/V directly, nothing is repeated per group.
// * The ragged sequence edge is masked in the kernel (rows ≥ S load zeros
//   and are not stored), so callers never pad.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace repro_torch {
namespace {

constexpr int BQ = 64;        // q rows per block
constexpr int BK = 64;        // k rows per tile
constexpr int TPR = 4;        // threads per q row
constexpr int THREADS = BQ * TPR;
constexpr int KT = BK + 4;    // transposed-K row stride (16-byte aligned)
constexpr unsigned FULL = 0xffffffffu;

template <int DH>
constexpr size_t flash_smem_floats() {
  return (size_t)BQ * (DH + 1) + (size_t)DH * KT + (size_t)BK * DH;
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 int S, int H, int KV, int causal, int window, int valid_len,
                 float scale) {
  constexpr int QS = DH + 1;         // padded Q row stride
  constexpr int NC = BK / TPR;       // score columns per thread (16)
  constexpr int NV = DH / 16;        // float4 groups of accumulator columns
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                  // [BQ][QS]
  float* Kt = Qs + BQ * QS;          // [DH][KT]   (K tile, transposed)
  float* Vs = Kt + DH * KT;          // [BK][DH]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int row = tid / TPR;
  const int sub = tid % TPR;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / KV);
  const int q_start = blockIdx.x * BQ;
  const int qpos = q_start + row;

  const long q_rs = (long)H * DH;    // stride between sequence positions
  const long kv_rs = (long)KV * DH;
  const T* qb = q + (long)b * S * q_rs + (long)h * DH;
  const T* kb = k + (long)b * S * kv_rs + (long)kvh * DH;
  const T* vb = v + (long)b * S * kv_rs + (long)kvh * DH;

  for (int idx = tid; idx < BQ * DH; idx += THREADS) {
    const int r = idx / DH, d = idx % DH;
    const int s = q_start + r;
    Qs[r * QS + d] = (s < S) ? to_f(qb[(long)s * q_rs + d]) : 0.f;
  }

  // K tiles this q tile needs: causal stops after the tile's last row,
  // a window starts at the first row's window edge
  int k_end = valid_len;
  if (causal) k_end = min(k_end, q_start + BQ);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q_start - window + 1);
  k_begin = (k_begin / BK) * BK;

  float m = kNegInf, l = 0.f;
  float acc[DH / TPR];
#pragma unroll
  for (int i = 0; i < DH / TPR; ++i) acc[i] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // previous tile fully consumed
    for (int idx = tid; idx < BK * DH; idx += THREADS) {
      const int r = idx / DH, d = idx % DH;
      const int s = k0 + r;
      const bool in = s < S;
      Kt[d * KT + r] = in ? to_f(kb[(long)s * kv_rs + d]) : 0.f;
      Vs[r * DH + d] = in ? to_f(vb[(long)s * kv_rs + d]) : 0.f;
    }
    __syncthreads();

    // scores for columns c(n) = 4·sub + 16·(n/4) + n%4
    float sc[NC];
#pragma unroll
    for (int n = 0; n < NC; ++n) sc[n] = 0.f;
    const float* qr = Qs + row * QS;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      const float qd = qr[d];
      const float* kr = Kt + d * KT + 4 * sub;
#pragma unroll
      for (int jj = 0; jj < NC / 4; ++jj) {
        const float4 kv4 = *reinterpret_cast<const float4*>(kr + 16 * jj);
        sc[4 * jj + 0] = fmaf(qd, kv4.x, sc[4 * jj + 0]);
        sc[4 * jj + 1] = fmaf(qd, kv4.y, sc[4 * jj + 1]);
        sc[4 * jj + 2] = fmaf(qd, kv4.z, sc[4 * jj + 2]);
        sc[4 * jj + 3] = fmaf(qd, kv4.w, sc[4 * jj + 3]);
      }
    }
    float mcur = kNegInf;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const int kpos = k0 + 4 * sub + 16 * (n / 4) + (n % 4);
      bool ok = kpos < valid_len;
      if (causal) ok = ok && (kpos <= qpos);
      if (window > 0) ok = ok && (kpos > qpos - window);
      sc[n] = ok ? sc[n] * scale : kNegInf;
      mcur = fmaxf(mcur, sc[n]);
    }
    mcur = fmaxf(mcur, __shfl_xor_sync(FULL, mcur, 1));
    mcur = fmaxf(mcur, __shfl_xor_sync(FULL, mcur, 2));
    const float m_new = fmaxf(m, mcur);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      sc[n] = expf(sc[n] - m_new);
      psum += sc[n];
    }
    psum += __shfl_xor_sync(FULL, psum, 1);
    psum += __shfl_xor_sync(FULL, psum, 2);
    l = l * alpha + psum;
    m = m_new;
#pragma unroll
    for (int i = 0; i < DH / TPR; ++i) acc[i] *= alpha;

    // acc columns d(i, e) = 4·sub + 16·i + e; p of column c comes from the
    // quad lane that scored it
    const int quad = lane & ~3;
#pragma unroll
    for (int c = 0; c < BK; ++c) {
      const float p = __shfl_sync(FULL, sc[(c >> 4) * 4 + (c & 3)],
                                  quad | ((c >> 2) & 3));
      const float* vr = Vs + c * DH + 4 * sub;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const float4 v4 = *reinterpret_cast<const float4*>(vr + 16 * i);
        acc[4 * i + 0] = fmaf(p, v4.x, acc[4 * i + 0]);
        acc[4 * i + 1] = fmaf(p, v4.y, acc[4 * i + 1]);
        acc[4 * i + 2] = fmaf(p, v4.z, acc[4 * i + 2]);
        acc[4 * i + 3] = fmaf(p, v4.w, acc[4 * i + 3]);
      }
    }
  }

  if (qpos < S) {
    const float den = fmaxf(l, 1e-20f);
    T* orow = o + ((long)b * S + qpos) * q_rs + (long)h * DH + 4 * sub;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) orow[16 * i + e] = from_f<T>(acc[4 * i + e] / den);
    }
  }
}

// ---------------------------------------------------------------------
// bf16 tensor-core variant (head_dim ≤ 128): mma.sync m16n8k16 with fp32
// accumulation.  Four warps, each owning 16 of the tile's 64 q rows; Q
// stays in registers as A fragments, K/V tiles arrive by cp.async into
// double-buffered, row-padded shared memory and feed ldmatrix (V
// transposed).  The score tile's accumulator layout is the A fragment of
// the P·V product, so P goes from registers to the tensor cores rounded to
// bf16 (the row sums l use the fp32 p).
constexpr int MMA_WARPS = 4;
constexpr int MMA_THREADS = 32 * MMA_WARPS;

template <int DH>
constexpr size_t flash_mma_smem_bytes() {
  return (size_t)(BQ + 4 * BK) * (DH + 8) * 2;  // Q + 2×K + 2×V, bf16
}

template <int DH>
__global__ void __launch_bounds__(MMA_THREADS)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, int S, int H, int KV,
                     int causal, int window, int valid_len, float scale) {
  constexpr int RS = DH + 8;     // padded row (elements): ldmatrix rows in distinct banks
  constexpr int CPR = DH / 8;    // 16-byte chunks per row
  constexpr int NS = BK / 8;     // n-tiles of the score tile
  constexpr int NO = DH / 8;     // n-tiles of the output
  constexpr int KSTEPS = DH / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BQ][RS]
  __nv_bfloat16* Ks = Qs + BQ * RS;                                // [2][BK][RS]
  __nv_bfloat16* Vs = Ks + 2 * BK * RS;                            // [2][BK][RS]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / KV);
  const int q_start = blockIdx.x * BQ;
  const int row0 = q_start + warp * 16;  // this warp's first q row

  const long q_rs = (long)H * DH;
  const long kv_rs = (long)KV * DH;
  const __nv_bfloat16* qb = q + (long)b * S * q_rs + (long)h * DH;
  const __nv_bfloat16* kb = k + (long)b * S * kv_rs + (long)kvh * DH;
  const __nv_bfloat16* vb = v + (long)b * S * kv_rs + (long)kvh * DH;
  const uint4 zero = make_uint4(0, 0, 0, 0);

  // rows past S are zero-filled: a masked p of exactly 0 must not meet
  // garbage in V (0 · NaN = NaN)
  for (int c = tid; c < BQ * CPR; c += MMA_THREADS) {
    const int r = c / CPR, ch = c % CPR, s = q_start + r;
    __nv_bfloat16* dst = Qs + r * RS + ch * 8;
    if (s < S) __pipeline_memcpy_async(dst, qb + s * q_rs + ch * 8, 16);
    else *reinterpret_cast<uint4*>(dst) = zero;
  }
  __pipeline_commit();

  int k_end = valid_len;
  if (causal) k_end = min(k_end, q_start + BQ);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q_start - window + 1);
  k_begin = (k_begin / BK) * BK;

  auto issue = [&](int k0, int buf) {
    __nv_bfloat16* kd = Ks + buf * BK * RS;
    __nv_bfloat16* vd = Vs + buf * BK * RS;
    for (int c = tid; c < BK * CPR; c += MMA_THREADS) {
      const int r = c / CPR, ch = c % CPR, s = k0 + r;
      if (s < S) {
        __pipeline_memcpy_async(kd + r * RS + ch * 8, kb + s * kv_rs + ch * 8, 16);
        __pipeline_memcpy_async(vd + r * RS + ch * 8, vb + s * kv_rs + ch * 8, 16);
      } else {
        *reinterpret_cast<uint4*>(kd + r * RS + ch * 8) = zero;
        *reinterpret_cast<uint4*>(vd + r * RS + ch * 8) = zero;
      }
    }
    __pipeline_commit();
  };
  if (k_begin < k_end) issue(k_begin, 0);
  __pipeline_wait_prior(0);
  __syncthreads();

  // Q A-fragments: matrices (rows 0-7 | 8-15) × (dims 0-7 | 8-15)
  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks)
    ldmatrix_x4(qf[ks], Qs + (warp * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * RS +
                            ks * 16 + 8 * (lane >> 4));

  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};
  float oacc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;

  int it = 0;
  for (int k0 = k_begin; k0 < k_end; k0 += BK, ++it) {
    const int buf = it & 1;
    if (k0 + BK < k_end) {
      issue(k0 + BK, buf ^ 1);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    // a tile entirely masked for all 16 of this warp's rows adds nothing
    const bool skip = (causal && k0 > row0 + 15) ||
                      (window > 0 && k0 + BK - 1 <= row0 - window);
    if (!skip) {
      const __nv_bfloat16* Kt = Ks + buf * BK * RS;
      const __nv_bfloat16* Vt = Vs + buf * BK * RS;
      float sacc[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n) sacc[n][0] = sacc[n][1] = sacc[n][2] = sacc[n][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
#pragma unroll
        for (int np = 0; np < NS / 2; ++np) {
          uint32_t kf[4];  // (keys 0-7 | 8-15) × (dims 0-7 | 8-15) of this pair
          ldmatrix_x4(kf, Kt + (np * 16 + (lane & 7) + 8 * (lane >> 4)) * RS +
                              ks * 16 + 8 * ((lane >> 3) & 1));
          mma_bf16(sacc[2 * np], qf[ks], kf[0], kf[1]);
          mma_bf16(sacc[2 * np + 1], qf[ks], kf[2], kf[3]);
        }
      }
      // scale, mask, online softmax; thread holds rows g (e<2) and g+8
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qpos = row0 + g + 8 * (e >> 1);
          const int kpos = k0 + n * 8 + 2 * t + (e & 1);
          bool ok = kpos < valid_len;
          if (causal) ok = ok && (kpos <= qpos);
          if (window > 0) ok = ok && (kpos > qpos - window);
          sacc[n][e] = ok ? sacc[n][e] * scale : kNegInf;
          mx[e >> 1] = fmaxf(mx[e >> 1], sacc[n][e]);
        }
      }
      float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 2));
        const float m_new = fmaxf(m_r[i], mx[i]);
        alpha[i] = expf(m_r[i] - m_new);
        m_r[i] = m_new;
      }
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sacc[n][e] = expf(sacc[n][e] - m_r[e >> 1]);
          rs[e >> 1] += sacc[n][e];
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        rs[i] += __shfl_xor_sync(FULL, rs[i], 1);
        rs[i] += __shfl_xor_sync(FULL, rs[i], 2);
        l_r[i] = l_r[i] * alpha[i] + rs[i];
      }
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        oacc[n][0] *= alpha[0];
        oacc[n][1] *= alpha[0];
        oacc[n][2] *= alpha[1];
        oacc[n][3] *= alpha[1];
      }
      // P·V: two score n-tiles form one k16 A fragment
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint32_t pa[4] = {
            pack_bf16(sacc[2 * kk][0], sacc[2 * kk][1]),
            pack_bf16(sacc[2 * kk][2], sacc[2 * kk][3]),
            pack_bf16(sacc[2 * kk + 1][0], sacc[2 * kk + 1][1]),
            pack_bf16(sacc[2 * kk + 1][2], sacc[2 * kk + 1][3])};
#pragma unroll
        for (int dp = 0; dp < NO / 2; ++dp) {
          uint32_t vf[4];  // (keys 0-7 | 8-15) × (dims 0-7 | 8-15), transposed
          ldmatrix_x4_trans(vf, Vt + (kk * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * RS +
                                    dp * 16 + 8 * (lane >> 4));
          mma_bf16(oacc[2 * dp], pa, vf[0], vf[1]);
          mma_bf16(oacc[2 * dp + 1], pa, vf[2], vf[3]);
        }
      }
    }
    __syncthreads();  // buffer `buf` is free for the tile after next
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qpos = row0 + g + 8 * i;
    if (qpos >= S) continue;
    const float den = fmaxf(l_r[i], 1e-20f);
    __nv_bfloat16* orow = o + ((long)b * S + qpos) * q_rs + (long)h * DH + 2 * t;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) =
          __floats2bfloat162_rn(oacc[n][2 * i] / den, oacc[n][2 * i + 1] / den);
  }
}

template <int DH>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o,
                       int B, int S, int H, int KV, int causal, int window,
                       int valid_len, cudaStream_t stream) {
  const size_t smem = flash_mma_smem_bytes<DH>();
  cudaError_t err = allow_smem(flash_fwd_mma_kernel<DH>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  const float scale = 1.0f / sqrtf((float)DH);
  flash_fwd_mma_kernel<DH><<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), S, H,
      KV, causal, window, valid_len, scale);
  return cudaGetLastError();
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B,
                   int S, int H, int KV, int causal, int window, int valid_len,
                   cudaStream_t stream) {
  const size_t smem = flash_smem_floats<DH>() * sizeof(float);
  cudaError_t err = allow_smem(flash_fwd_kernel<T, DH>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  const float scale = 1.0f / sqrtf((float)DH);
  flash_fwd_kernel<T, DH><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H, KV, causal, window,
      valid_len, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int Dh, const void* q, const void* k, const void* v,
                     void* o, int B, int S, int H, int KV, int causal,
                     int window, int valid_len, cudaStream_t st) {
  switch (Dh) {
    case 16: return launch<T, 16>(q, k, v, o, B, S, H, KV, causal, window, valid_len, st);
    case 32: return launch<T, 32>(q, k, v, o, B, S, H, KV, causal, window, valid_len, st);
    case 64: return launch<T, 64>(q, k, v, o, B, S, H, KV, causal, window, valid_len, st);
    case 128: return launch<T, 128>(q, k, v, o, B, S, H, KV, causal, window, valid_len, st);
    case 256: return launch<T, 256>(q, k, v, o, B, S, H, KV, causal, window, valid_len, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro_torch

// q: (B, S, H, Dh), k/v: (B, S, KV, Dh), o: (B, S, H, Dh), all contiguous,
// one dtype.  Returns cudaGetLastError() after the launch.
extern "C" int repro_flash_attention_fwd(const void* q, const void* k,
                                         const void* v, void* o, int B, int S,
                                         int H, int KV, int Dh, int causal,
                                         int window, int valid_len, int dtype,
                                         void* stream) {
  using namespace repro_torch;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV != 0) return cudaErrorInvalidValue;
  if (dtype == kFloat32)
    return dispatch<float>(Dh, q, k, v, o, B, S, H, KV, causal, window, valid_len, st);
  if (dtype == kBFloat16) {
    switch (Dh) {  // tensor cores up to head_dim 128 (register budget)
      case 16: return launch_mma<16>(q, k, v, o, B, S, H, KV, causal, window, valid_len, st);
      case 32: return launch_mma<32>(q, k, v, o, B, S, H, KV, causal, window, valid_len, st);
      case 64: return launch_mma<64>(q, k, v, o, B, S, H, KV, causal, window, valid_len, st);
      case 128: return launch_mma<128>(q, k, v, o, B, S, H, KV, causal, window, valid_len, st);
      default:
        return dispatch<__nv_bfloat16>(Dh, q, k, v, o, B, S, H, KV, causal, window, valid_len, st);
    }
  }
  return cudaErrorInvalidValue;
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
