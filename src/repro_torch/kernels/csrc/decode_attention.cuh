// One-token decode attention for Hopper (sm_90a): the body shared by the
// paged kernel (paged_decode_attention.cu) and the dense one
// (decode_attention.cu), with the walk over the cache split across blocks
// (flash-decoding) and an exact log-sum-exp combine.
//
// What bounds it on this card.  At serving shapes the bytes are few: a
// B=8 step of starcoder2-3b reads ~2.6 MB of live K/V, under 1 µs at
// 3.35 TB/s, and each K/V element feeds G = 12 multiply-adds, far below
// the ~295 FLOP/byte ridge.  What sets the time there is parallelism and
// latency: one block per (request, KV head) gives 16 blocks for 132 SMs,
// and a block that walks a whole request alone pays one chain of
// dependent HBM round trips and softmax steps per tile.  Only at long
// contexts (16k tokens per request) do the bytes dominate; there the body
// reaches about half the HBM rate, as masked SDPA does (PERF.md §6), and
// the 16-byte cp.async copies are the suspect (TMA bulk copies are later
// work).
//
// What the design does about it:
// * Split-KV.  The grid is (KV heads × m-tiles, B, splits).  Each block
//   walks one contiguous range of whole tiles (pages of the pool, or
//   DENSE_TILE tokens of the dense cache) for the query heads of one
//   m-tile of its KV head, so each K/V tile is read from HBM once for up
//   to 16 heads.  The wrapper chooses `splits` and the cut `tps` (tiles
//   per split) from static shapes (kernels/decode_attention.py::
//   split_plan), so no length is read on the host.  A split that starts
//   at or past lengths[b] writes (m = −1e30, l = 0, acc = 0) and reads no
//   K/V.
// * Exact combine.  Each split writes its fp32 partial (m, l, acc[Dh]) per
//   query head to a workspace the wrapper keeps (a torch allocation per
//   stream); combine_kernel merges the partials by log-sum-exp in split
//   order.  No atomics: the output does not depend on block timing.  With one split the block writes the
//   output itself and no combine runs.
// * Tensor cores for bf16.  The up-to-16 query rows of an m-tile are the A
//   operand of mma.sync m16n8k16 (bf16 in, fp32 accumulate).  Each of the
//   four warps scores its own 16 tokens of a 64-token chunk against all
//   rows and keeps its own (m, l, acc) in fp32 registers, in the mma
//   accumulator layout; the warps merge through shared memory at the end.
//   P·V runs on mma too, with P split into bf16 hi + lo parts (p = hi + lo
//   to ~2⁻¹⁶), so P is not rounded to bf16 as flash rounds it.  wgmma is
//   not used: it takes 64 rows per warpgroup, so at G ≤ 16 at least 75 %
//   of every instruction would be empty.
// * fp32 inputs keep exact fp32 FMAs in the same accumulator layout
//   (scores from shared memory, P through a per-warp shared tile).
// * Chunks of K and V move into row-padded shared memory (16 bytes per row,
//   so ldmatrix rows fall in distinct banks) with 16-byte cp.async copies,
//   STAGES deep, so each block keeps two chunks in flight while it scores
//   a third.  Tokens at or past the length (or past the split) are
//   zero-filled in shared memory, never read: the ragged dense tile and the
//   pages past the fill cost no HBM traffic.
#pragma once

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "common.cuh"
#include "mma.cuh"

namespace repro_torch {
namespace decode {

constexpr int M_ROWS = 16;      // query rows per m-tile (mma's M)
constexpr int MAX_GROUP = 128;  // query heads per KV head (8 m-tiles)
constexpr int DENSE_TILE = 64;  // the dense cache's split granule (tokens)
constexpr int STAGES = 3;       // chunks in shared memory
constexpr unsigned FULL = 0xffffffffu;

// A read-only load the compiler must issue where it stands (not sink into
// the branch that uses it), so it overlaps the loads around it.
__device__ __forceinline__ int load_now(const int* p) {
  int x;
  asm volatile("ld.global.nc.s32 %0, [%1];" : "=r"(x) : "l"(p));
  return x;
}

template <typename T, int DH>
struct Shape {
  static constexpr bool MMA = sizeof(T) == 2;          // bf16: tensor cores
  static constexpr int NW = (!MMA && DH == 256) ? 2 : 4;  // warps (fp32 at 256: smem)
  static constexpr int CT = 16 * NW;                   // tokens per chunk
  static constexpr int VEC = 16 / (int)sizeof(T);      // elements per 16 bytes
  static constexpr int RS = DH + VEC;                  // padded row (elements)
  static constexpr int CPR = DH / VEC;                 // 16-byte pieces per row
  static constexpr int NO = DH / 8;                    // output n-tiles
  static constexpr size_t q_bytes = (size_t)M_ROWS * RS * sizeof(T);
  static constexpr size_t stage_bytes = 2 * (size_t)CT * RS * sizeof(T);  // K + V
  static constexpr size_t p_bytes = MMA ? 0 : (size_t)NW * 16 * 16 * 4;
  static constexpr size_t ml_bytes = (size_t)(2 * NW + 2) * M_ROWS * 4;
  static constexpr size_t smem = q_bytes + STAGES * stage_bytes + p_bytes + ml_bytes;
  static_assert((size_t)NW * M_ROWS * DH * 4 <= STAGES * stage_bytes,
                "the warps' merge reuses the chunk buffers");
  static_assert(smem <= kMaxSmemBytes, "shared memory");
};

// Grid (KV × m-tiles, B, splits), 32·NW threads.  DENSE: k/v are (B, ntok,
// KV, DH) caches and page_table is unused.  Paged: k/v are (P, tile, KV,
// DH) pools and page_table is (B, ntiles).  q/o: (B, H, DH) with rows in
// KV-major head order, as the reference flattens them.  Split s walks
// tiles [s·tps, (s+1)·tps), tokens below min(lengths[b], ntok); positions
// at or past the length count as −1e30 (p = 0).  ws: splits > 1 only,
// partial acc (B·H, splits, DH) then (m, l) (B·H, splits, 2), fp32.
template <typename T, int DH, bool DENSE>
__global__ void __launch_bounds__(128)
split_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const int* __restrict__ page_table,
             const int* __restrict__ lengths, float* __restrict__ ws,
             T* __restrict__ o, int H, int KV, int tile, int ntiles, int ntok,
             int tps, float scale) {
  using S = Shape<T, DH>;
  constexpr int NW = S::NW, CT = S::CT, VEC = S::VEC, RS = S::RS, CPR = S::CPR,
                NO = S::NO;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);                           // [16][RS]
  T* Kb = reinterpret_cast<T*>(smem_raw + S::q_bytes);              // [STAGES][CT][RS]
  T* Vb = Kb + STAGES * CT * RS;                                    // [STAGES][CT][RS]
  float* Ps = reinterpret_cast<float*>(smem_raw + S::q_bytes + STAGES * S::stage_bytes);
  float* Ms = Ps + S::p_bytes / 4;                                  // [NW][16]
  float* Ls = Ms + NW * M_ROWS;                                     // [NW][16]
  float* Mrow = Ls + NW * M_ROWS;                                   // [16]
  float* Lrow = Mrow + M_ROWS;                                      // [16]

  const int G = H / KV;
  const int MT = (G + M_ROWS - 1) / M_ROWS;
  const int kvh = blockIdx.x / MT, mt = blockIdx.x % MT;
  const int b = blockIdx.y, split = blockIdx.z, splits = gridDim.z;
  const int rows = min(M_ROWS, G - mt * M_ROWS);  // live rows of this m-tile
  const long row0 = (long)b * H + (long)kvh * G + mt * M_ROWS;  // its first (b, head)
  constexpr int THREADS = 32 * NW;
  constexpr int PER = CT * CPR / THREADS;  // 16-byte pieces per thread per chunk
  static_assert(CT * CPR % THREADS == 0, "pieces per thread");
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int s0 = split * tps * tile;             // this split's first token
  const int s1 = min(s0 + tps * tile, ntok);     // ... and its end
  const int* pt = DENSE ? nullptr : page_table + (long)b * ntiles;
  const long tok_stride = (long)KV * DH;  // between consecutive tokens

  // the page ids of this thread's pieces u0 .. u0 + PB − 1 of chunk j
  // (paged only; 0 past the split), PB at a time so their loads are in
  // flight together.  The page table holds valid pool indices everywhere,
  // so this needs no length.
  constexpr int PB = PER < 8 ? PER : 8;
  static_assert(PER % PB == 0, "page-id batches");
  auto pages = [&](int j, int u0, int (&pg)[PB]) {
#pragma unroll
    for (int u = 0; u < PB; ++u) {
      const int pos = s0 + j * CT + (tid + (u0 + u) * THREADS) / CPR;
      pg[u] = DENSE || pos >= s1 ? 0 : load_now(pt + pos / tile);
    }
  };
  int first[PB];
  pages(0, 0, first);  // the first chunk's first page ids load beside the length
  const int len = min(lengths[b], ntok);
  const int end = min(len, s1);  // this split's last token below the length + 1
  float* ws_acc = ws;
  float* ws_ml = ws + (long)gridDim.y * H * splits * DH;

  if (end <= s0) {  // nothing below the length: the neutral partial (or zeros)
    for (int idx = tid; idx < rows * DH; idx += THREADS) {
      const long r = row0 + idx / DH;
      if (splits == 1) o[r * DH + idx % DH] = from_f<T>(0.f);
      else ws_acc[(r * splits + split) * DH + idx % DH] = 0.f;
    }
    if (splits > 1 && tid < rows) {
      ws_ml[((row0 + tid) * splits + split) * 2] = kNegInf;
      ws_ml[((row0 + tid) * splits + split) * 2 + 1] = 0.f;
    }
    return;
  }

  const int nchunks = (end - s0 + CT - 1) / CT;
  auto copy = [&](int j, int u0, const int (&pg)[PB]) {  // into buffer j % STAGES
    T* kdst = Kb + (j % STAGES) * CT * RS;
    T* vdst = Vb + (j % STAGES) * CT * RS;
#pragma unroll
    for (int u = 0; u < PB; ++u) {
      const int c = tid + (u0 + u) * THREADS, i = c / CPR, ch = c % CPR;
      const int pos = s0 + j * CT + i;
      T* kd = kdst + i * RS + ch * VEC;
      T* vd = vdst + i * RS + ch * VEC;
      if (pos >= end) {
        // past the length or the split: never read; zero, so the masked
        // p = 0 meets a finite V
        *reinterpret_cast<uint4*>(kd) = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(vd) = make_uint4(0, 0, 0, 0);
        continue;
      }
      const long row = DENSE ? (long)b * ntok + pos : (long)pg[u] * tile + pos % tile;
      const long src = row * tok_stride + (long)kvh * DH + ch * VEC;
      __pipeline_memcpy_async(kd, k + src, 16);
      __pipeline_memcpy_async(vd, v + src, 16);
    }
  };
  auto issue = [&](int j) {
    // batches in a loop: unrolled, their addresses would be hoisted out of
    // the chunk loop into registers (spills at head_dim 256)
#pragma unroll 1
    for (int u0 = 0; u0 < PER; u0 += PB) {
      int pg[PB];
      pages(j, u0, pg);
      copy(j, u0, pg);
    }
  };
  // Q joins the first chunk's copies; rows past G are zero
  if ((reinterpret_cast<uintptr_t>(q) & 15) == 0) {
#pragma unroll
    for (int idx = tid; idx < M_ROWS * CPR; idx += THREADS) {
      const int r = idx / CPR, ch = idx % CPR;
      T* dst = Qs + r * RS + ch * VEC;
      if (r < rows) __pipeline_memcpy_async(dst, q + (row0 + r) * DH + ch * VEC, 16);
      else *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
  } else {
    for (int idx = tid; idx < M_ROWS * DH; idx += THREADS) {
      const int r = idx / DH, d = idx % DH;
      Qs[r * RS + d] = r < rows ? q[(row0 + r) * DH + d] : from_f<T>(0.f);
    }
  }
  copy(0, 0, first);
#pragma unroll 1
  for (int u0 = PB; u0 < PER; u0 += PB) {
    int pg[PB];
    pages(0, u0, pg);
    copy(0, u0, pg);
  }
  __pipeline_commit();
#pragma unroll
  for (int s = 1; s < STAGES - 1; ++s) {
    if (s < nchunks) issue(s);
    __pipeline_commit();
  }

  // this warp's rows g and g + 8, in the mma accumulator layout
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};
  float oacc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;

  for (int j = 0; j < nchunks; ++j) {
    __pipeline_wait_prior(STAGES - 2);  // chunk j has landed (this thread's copies)
    __syncthreads();                    // ... everyone's; chunk j − 1 is consumed
    if (j + STAGES - 1 < nchunks) issue(j + STAGES - 1);
    __pipeline_commit();
    const T* Kt = Kb + (j % STAGES) * CT * RS + warp * 16 * RS;  // this warp's 16 tokens
    const T* Vt = Vb + (j % STAGES) * CT * RS + warp * 16 * RS;
    const int p0 = s0 + j * CT + warp * 16;  // position of its first token

    // scores: sacc[n][e] is row g + 8·(e / 2), token 8·n + 2·t + e % 2
    float sacc[2][4];
    if constexpr (S::MMA) {
#pragma unroll
      for (int n = 0; n < 2; ++n) sacc[n][0] = sacc[n][1] = sacc[n][2] = sacc[n][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < DH / 16; ++ks) {
        uint32_t qf[4], kf[4];  // Q: (rows 0-7 | 8-15) × (dims 0-7 | 8-15)
        ldmatrix_x4(qf, Qs + ((lane & 7) + 8 * ((lane >> 3) & 1)) * RS + ks * 16 +
                            8 * (lane >> 4));
        // K: (tokens 0-7 | 8-15) × (dims 0-7 | 8-15)
        ldmatrix_x4(kf, Kt + ((lane & 7) + 8 * (lane >> 4)) * RS + ks * 16 +
                            8 * ((lane >> 3) & 1));
        mma_bf16(sacc[0], qf, kf[0], kf[1]);
        mma_bf16(sacc[1], qf, kf[2], kf[3]);
      }
    } else {
      const float4* q0 = reinterpret_cast<const float4*>(Qs + g * RS);
      const float4* q1 = reinterpret_cast<const float4*>(Qs + (g + 8) * RS);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const float4* k0 = reinterpret_cast<const float4*>(Kt + (8 * n + 2 * t) * RS);
        const float4* k1 = reinterpret_cast<const float4*>(Kt + (8 * n + 2 * t + 1) * RS);
        float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
        for (int c = 0; c < DH / 4; ++c) {
          const float4 a = q0[c], bq = q1[c], x = k0[c], y = k1[c];
          d[0] = fmaf(a.x, x.x, fmaf(a.y, x.y, fmaf(a.z, x.z, fmaf(a.w, x.w, d[0]))));
          d[1] = fmaf(a.x, y.x, fmaf(a.y, y.y, fmaf(a.z, y.z, fmaf(a.w, y.w, d[1]))));
          d[2] = fmaf(bq.x, x.x, fmaf(bq.y, x.y, fmaf(bq.z, x.z, fmaf(bq.w, x.w, d[2]))));
          d[3] = fmaf(bq.x, y.x, fmaf(bq.y, y.y, fmaf(bq.z, y.z, fmaf(bq.w, y.w, d[3]))));
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[n][e] = d[e];
      }
    }

    // online softmax over this warp's tokens; a row's four values live in
    // the quad of lanes 4g .. 4g + 3
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = p0 + 8 * n + 2 * t + (e & 1) < end;
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
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = p0 + 8 * n + 2 * t + (e & 1) < end;
        sacc[n][e] = ok ? expf(sacc[n][e] - m_r[e >> 1]) : 0.f;
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

    // P·V over this warp's 16 tokens
    if constexpr (S::MMA) {
      // the score accumulators are the A fragment, in register order (row
      // g, tokens 0-7), (g + 8, 0-7), (g, 8-15), (g + 8, 8-15); p = hi + lo,
      // each part bf16
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const float x = sacc[f >> 1][2 * (f & 1)], y = sacc[f >> 1][2 * (f & 1) + 1];
        __nv_bfloat162 h2 = __floats2bfloat162_rn(x, y);
        hi[f] = *reinterpret_cast<uint32_t*>(&h2);
        lo[f] = pack_bf16(x - __low2float(h2), y - __high2float(h2));
      }
#pragma unroll
      for (int dp = 0; dp < NO / 2; ++dp) {
        uint32_t vf[4];  // (tokens 0-7 | 8-15) × (dims 0-7 | 8-15), transposed
        ldmatrix_x4_trans(vf, Vt + ((lane & 7) + 8 * ((lane >> 3) & 1)) * RS + dp * 16 +
                                  8 * (lane >> 4));
        mma_bf16(oacc[2 * dp], hi, vf[0], vf[1]);
        mma_bf16(oacc[2 * dp], lo, vf[0], vf[1]);
        mma_bf16(oacc[2 * dp + 1], hi, vf[2], vf[3]);
        mma_bf16(oacc[2 * dp + 1], lo, vf[2], vf[3]);
      }
    } else {
      float* P = Ps + warp * 256;  // [16 rows][16 tokens]
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          P[(g + 8 * (e >> 1)) * 16 + 8 * n + 2 * t + (e & 1)] = sacc[n][e];
      }
      __syncwarp();
#pragma unroll 4
      for (int tk = 0; tk < 16; ++tk) {
        const float pr0 = P[g * 16 + tk], pr1 = P[(g + 8) * 16 + tk];
        const T* vr = Vt + tk * RS + 2 * t;
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          const float2 x = *reinterpret_cast<const float2*>(vr + 8 * n);
          oacc[n][0] = fmaf(pr0, x.x, oacc[n][0]);
          oacc[n][1] = fmaf(pr0, x.y, oacc[n][1]);
          oacc[n][2] = fmaf(pr1, x.x, oacc[n][2]);
          oacc[n][3] = fmaf(pr1, x.y, oacc[n][3]);
        }
      }
      __syncwarp();  // P is rewritten for the next chunk
    }
  }

  // merge the warps' (m, l, acc) in warp order, through shared memory
  __pipeline_wait_prior(0);
  __syncthreads();  // every warp is done with the chunk buffers
  float* Acc = reinterpret_cast<float*>(Kb);  // [NW][16][DH], over the buffers
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      Ms[warp * M_ROWS + g + 8 * i] = m_r[i];
      Ls[warp * M_ROWS + g + 8 * i] = l_r[i];
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = g + 8 * i;
    float mrow = kNegInf;
    for (int w = 0; w < NW; ++w) mrow = fmaxf(mrow, Ms[w * M_ROWS + r]);
    const float sc = expf(m_r[i] - mrow);
    float* dst = Acc + (warp * M_ROWS + r) * DH + 2 * t;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<float2*>(dst + 8 * n) =
          make_float2(oacc[n][2 * i] * sc, oacc[n][2 * i + 1] * sc);
  }
  if (tid < M_ROWS) {
    float mrow = kNegInf, lrow = 0.f;
    for (int w = 0; w < NW; ++w) mrow = fmaxf(mrow, Ms[w * M_ROWS + tid]);
    for (int w = 0; w < NW; ++w)
      lrow += Ls[w * M_ROWS + tid] * expf(Ms[w * M_ROWS + tid] - mrow);
    Mrow[tid] = mrow;
    Lrow[tid] = lrow;
  }
  __syncthreads();
  for (int idx = tid; idx < rows * DH; idx += THREADS) {
    const int r = idx / DH, d = idx % DH;
    float a = 0.f;
    for (int w = 0; w < NW; ++w) a += Acc[(w * M_ROWS + r) * DH + d];
    if (splits == 1) o[(row0 + r) * DH + d] = from_f<T>(a / fmaxf(Lrow[r], 1e-20f));
    else ws_acc[((row0 + r) * splits + split) * DH + d] = a;
  }
  if (splits > 1 && tid < rows) {
    ws_ml[((row0 + tid) * splits + split) * 2] = Mrow[tid];
    ws_ml[((row0 + tid) * splits + split) * 2 + 1] = Lrow[tid];
  }
}

// One block per (b, head) row, DH threads: o = Σ_s e^(m_s − M)·acc_s /
// max(Σ_s e^(m_s − M)·l_s, 1e-20) over the splits in order, M = max_s m_s.
// Empty splits (m = −1e30, l = 0, acc = 0) add nothing; a row whose
// splits are all empty gives 0.  The partials are read BATCH splits at a
// time, so their loads are in flight together.
template <typename T>
__global__ void combine_kernel(const float* __restrict__ ws, T* __restrict__ o,
                               int rows, int splits) {
  constexpr int BATCH = 16;
  const int DH = blockDim.x, d = threadIdx.x;
  const long r = blockIdx.x;
  const float* acc = ws + r * splits * DH;
  const float* ml = ws + (long)rows * splits * DH + r * splits * 2;
  float mrow = kNegInf;
  for (int s0 = 0; s0 < splits; s0 += BATCH) {
    float m[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) m[u] = s0 + u < splits ? ml[2 * (s0 + u)] : kNegInf;
#pragma unroll
    for (int u = 0; u < BATCH; ++u) mrow = fmaxf(mrow, m[u]);
  }
  float l = 0.f, a = 0.f;
  for (int s0 = 0; s0 < splits; s0 += BATCH) {
    float m[BATCH], ls[BATCH], x[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const bool ok = s0 + u < splits;
      m[u] = ok ? ml[2 * (s0 + u)] : kNegInf;
      ls[u] = ok ? ml[2 * (s0 + u) + 1] : 0.f;
      x[u] = ok ? acc[(long)(s0 + u) * DH + d] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const float w = expf(m[u] - mrow);  // 0 past the last split (l, x are 0)
      l = fmaf(w, ls[u], l);
      a = fmaf(w, x[u], a);
    }
  }
  o[r * DH + d] = from_f<T>(a / fmaxf(l, 1e-20f));
}

// `tile`: tokens per tile (a page, or DENSE_TILE); `ntiles`: tiles per
// request (page-table columns, or ⌈T / DENSE_TILE⌉); `ntok`: tokens per
// request the cache can hold.  Split s walks tiles [s·tps, (s+1)·tps); the
// cut `tps` comes from decode_attention.py::split_plan, the one place that
// defines it.
template <typename T, int DH, bool DENSE>
cudaError_t launch(const void* q, const void* k, const void* v, const int* pt,
                   const int* lens, float* ws, void* o, int B, int H, int KV,
                   int tile, int ntiles, int ntok, int splits, int tps,
                   cudaStream_t stream) {
  using S = Shape<T, DH>;
  // the shared-memory opt-in once per device: a CUDA API call on every
  // launch would add to the host's share of each decode step
  static std::atomic<unsigned long long> opted{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (!(opted.load(std::memory_order_relaxed) & bit)) {
    err = allow_smem(split_kernel<T, DH, DENSE>, S::smem);
    if (err != cudaSuccess) return err;
    opted.fetch_or(bit, std::memory_order_relaxed);
  }
  const int G = H / KV;
  const dim3 grid(KV * ((G + M_ROWS - 1) / M_ROWS), B, splits);
  const float scale = 1.0f / sqrtf((float)DH);
  split_kernel<T, DH, DENSE><<<grid, 32 * S::NW, S::smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      pt, lens, ws, static_cast<T*>(o), H, KV, tile, ntiles, ntok, tps, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  combine_kernel<T><<<B * H, DH, 0, stream>>>(ws, static_cast<T*>(o), B * H, splits);
  return cudaGetLastError();
}

template <typename T, bool DENSE>
cudaError_t dispatch(int Dh, const void* q, const void* k, const void* v,
                     const int* pt, const int* lens, float* ws, void* o, int B,
                     int H, int KV, int tile, int ntiles, int ntok, int splits,
                     int tps, cudaStream_t st) {
  switch (Dh) {
    case 16: return launch<T, 16, DENSE>(q, k, v, pt, lens, ws, o, B, H, KV, tile, ntiles, ntok, splits, tps, st);
    case 32: return launch<T, 32, DENSE>(q, k, v, pt, lens, ws, o, B, H, KV, tile, ntiles, ntok, splits, tps, st);
    case 64: return launch<T, 64, DENSE>(q, k, v, pt, lens, ws, o, B, H, KV, tile, ntiles, ntok, splits, tps, st);
    case 128: return launch<T, 128, DENSE>(q, k, v, pt, lens, ws, o, B, H, KV, tile, ntiles, ntok, splits, tps, st);
    case 256: return launch<T, 256, DENSE>(q, k, v, pt, lens, ws, o, B, H, KV, tile, ntiles, ntok, splits, tps, st);
    default: return cudaErrorInvalidValue;
  }
}

// Checks shared by both entry points, then the dtype dispatch.
template <bool DENSE>
cudaError_t run(int dtype, int Dh, const void* q, const void* k, const void* v,
                const int* pt, const int* lens, void* ws, void* o, int B, int H,
                int KV, int tile, int ntiles, int ntok, int splits, int tps,
                cudaStream_t st) {
  if (B <= 0 || B > 65535 || KV <= 0 || H % KV != 0 || H / KV > MAX_GROUP ||
      tile <= 0 || ntiles <= 0 || splits < 1 || splits > 65535 || tps < 1 ||
      // the splits cover the tiles, and none starts past them
      (long)splits * tps < ntiles || (long)(splits - 1) * tps >= ntiles ||
      (splits > 1 && ws == nullptr))
    return cudaErrorInvalidValue;
  float* w = static_cast<float*>(ws);
  if (dtype == kFloat32)
    return dispatch<float, DENSE>(Dh, q, k, v, pt, lens, w, o, B, H, KV, tile, ntiles, ntok, splits, tps, st);
  if (dtype == kBFloat16)
    return dispatch<__nv_bfloat16, DENSE>(Dh, q, k, v, pt, lens, w, o, B, H, KV, tile, ntiles, ntok, splits, tps, st);
  return cudaErrorInvalidValue;
}

}  // namespace decode
}  // namespace repro_torch
