// Mamba-2 SSD chunked scan for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py (ssd_scan_fwd,
// body _ssd_kernel).  Per (batch b, head h) and chunk c of Q steps, with
// cum = inclusive cumsum of dt·A inside the chunk and S_in(c) the fp32
// (N, P) state entering chunk c:
//   y_i = Σ_{j≤i} (C_i·B_j)·exp(cum_i − cum_j)·dt_j·x_j + exp(cum_i)·C_i·S_in(c)
//   S_in(c+1) = S_in(c)·exp(cum_end(c)) + Σ_j exp(cum_end(c) − cum_j)·dt_j·B_jᵀ x_j
//
// What bounds it on this card: memory and the tensor cores about equally.
// At mamba2-780m (B=1, S=2048, H=48, P=64, N=128, bf16) the function moves
// 26.4 MB (x and y dominate: 7.9 µs at 3.35 TB/s) and its chunked form
// does ~8 GFLOP of products, ~12 GFLOP as this kernel runs them with the
// split operands below (~12 µs on bf16 tensor cores).  What holds it far
// from that is latency: dependent chains of mma.sync and copies that a
// block waits for, with 8–16 warps an SM.
//
// What the design does about it: the GPU form of SSD (Mamba-2 paper,
// arXiv:2405.21060, §6–7), chunks in parallel across blocks and only an
// elementwise pass sequential, where the TPU kernel walked the chunks in
// order with S carried in VMEM.  Three launches on one stream:
// 1. chunk_state_kernel, grid (chunks, H, B): the chunk's cum by a block
//    scan (written to the workspace with cum_end), then its local state
//    s_c = Bᵀ·(w ⊙ x), w_j = exp(cum_end − cum_j)·dt_j, an (N×Q)·(Q×P)
//    product, written fp32 to the workspace.  The last chunk's state is
//    formed only when the caller asks for the final state.  The copies of
//    B and x are in flight during the scan.
// 2. state_pass_kernel, grid (⌈N·P/256⌉, H, B): S_in(0) = 0 and
//    S_in(c) = S_in(c−1)·exp(cum_end(c−1)) + s(c−1), in fp32.  The only
//    walk over chunks, one (n, p) per thread.  Asked for it, it also
//    writes the final state S_in(last)·exp(cum_end(last)) + s(last), fp32
//    (B, H, P, N); cum_end is taken at the last real step, so a ragged
//    tail adds nothing.
// 3. The chunk outputs: y = exp(cum_i)·C·S_in(c), then the causal C·Bᵀ
//    tiles on and below the diagonal, masked and decayed, times x.
// bf16 runs the products on the tensor cores (mma.sync m16n8k16, bf16 in,
// fp32 accumulate): C·Bᵀ, scores·x, C·S_in and (w ⊙ x)ᵀ·B (pass 1 forms
// s_cᵀ, so that w ⊙ x is the A operand, weighted and split in registers
// once per warp).  C, B and x go in as they are; the fp32 operands (the
// masked scores, S_in, w ⊙ x) are split into bf16 hi + lo (v = hi + lo to
// ~2⁻¹⁸ relative) and each of those products runs twice, lo then hi, all
// lo products of a step before the hi ones, so that no mma waits on the
// one just issued.  The bf16 states and S_in lie (P, N): pass 1's stores
// then fill whole sectors, and pass 2 writes S_in as hi and lo planes that
// pass 3 copies as they lie.  The output pass (chunk_output_mma_kernel)
// takes one block per (chunk, head) with the chunk's B, x and S_in planes
// in shared memory, copied once in two mbarrier-tracked groups; its 8
// warps take the 16 row tiles of 16 in pairs (w, 15 − w), 17 column tiles
// each however the causal mask falls, with C's fragments loaded straight
// into registers, the decay as 2^x of log2(e)-scaled cumsums, and y staged
// in shared memory so that each lane stores 16 contiguous bytes.  Blocks
// of fewer rows would each copy S_in and the earlier B and x tiles again;
// with 64-row blocks that copying was about half the pass (PERF.md §6).
// fp32 runs the same passes on fp32 FMAs from shared memory, the output
// pass (chunk_output_fma_kernel) as blocks of 64 rows that stream B and x
// through a ring of two buffers; C_i·B_j is summed over n in order, as
// the plain version's einsum does: on the tensor cores, even with every
// operand split in three, the worst row of a steep decay (where C_i·B_i
// nearly cancels, and the row error measures the summation order) went
// past its 1e-3 limit.
// Overflow: only exponents ≤ 0 are formed.  exp(cum_i − cum_j) is taken
// for j ≤ i alone (the mask comes before the exponential), never as
// exp(cum_i)·exp(−cum_j): a steep decay (dt·A ≈ −60 a step) takes cum to
// −16,000 within a chunk, where exp(−cum_j) is inf.
// dt: in x's dtype or fp32 (the model's dt is an fp32 softplus, with
// bf16 x, B and C); it is read as it lies and turned to fp32 at once.
// Layouts as the public ones lie: A by head, B and C by group
// g = h / (H/G), x and y at (b, t, h); a ragged last chunk, N and P off
// the mma tile and chunks off 16 are zero-filled in shared memory.  Rows
// in shared memory are padded by 16 bytes, so ldmatrix's eight row
// addresses (and the FMA body's float4 rows) fall in distinct banks.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"
#include "wgmma.cuh"

namespace repro_torch {
namespace {

using bf16 = __nv_bfloat16;

constexpr int MAX_CHUNK = 256;   // pass 1: one scan element per thread
constexpr int MAX_N = 128;       // pass 1: one warp per 16 rows of N
constexpr int MAX_P = 128;       // the accumulators: P/8 tiles of 8 columns per warp
constexpr int SCAN_THREADS = 256;
constexpr int PASS_THREADS = 256;
constexpr int MMA_THREADS = 256;  // bf16 pass 3: 8 warps, 16 row tiles in pairs
constexpr int FMA_THREADS = 128;  // fp32 pass 3: 4 warps of 16 rows
constexpr int ROW_TILE = 64;      // fp32 pass 3: chunk rows per block
constexpr int JB = 64;            // fp32: steps (or rows of S_in) staged per round
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ constexpr int round16(int n) { return (n + 15) / 16 * 16; }

// a row of `width` elements (N rounded up to 16, or PP = 16·PT ≥ P) plus
// 16 bytes
template <typename T>
__host__ __device__ constexpr int row_stride(int width) {
  return width + 16 / (int)sizeof(T);
}

// shared-memory bytes: pass 1 (B and x, the whole chunk in bf16, JB rows
// a round in fp32), the bf16 output pass (the chunk's B and x, S_in's
// planes) and the fp32 output pass (C, a ring of two B and x rounds, JB
// rows of S_in, the warps' score tiles)
template <typename T>
size_t state_smem(int Q, int PP, int N) {
  const int rows = sizeof(T) == 2 ? round16(Q) : JB;
  return 4 * (2 * MAX_CHUNK + 32) +
         sizeof(T) * (size_t)rows * (row_stride<T>(round16(N)) + row_stride<T>(PP));
}
constexpr int Y_SLAB = 64;  // bf16 pass 3: columns of y a warp stages at a time
size_t output_mma_smem(int Q, int PP, int N) {
  const size_t rn = row_stride<bf16>(round16(N));
  return 4 * 2 * MAX_CHUNK +
         2 * ((size_t)round16(Q) * (rn + row_stride<bf16>(PP)) + 2 * (size_t)PP * rn +
              (MMA_THREADS / 32) * 16 * row_stride<bf16>(Y_SLAB));
}
size_t output_fma_smem(int PP, int N) {
  return 4 * 2 * MAX_CHUNK +
         4 * ((size_t)(ROW_TILE + 2 * JB) * row_stride<float>(round16(N)) +
              (size_t)3 * JB * row_stride<float>(PP)) +
         4 * (FMA_THREADS / 32) * 16 * 17;
}

// Copy rows [0, tile_rows) × columns [0, colsP) of a row-major source
// (row r at src + r·src_stride) into shared memory (row stride `stride`),
// rows at or past `rows` and columns at or past `cols` as zeros (colsP: a
// multiple of 16).  `vec`: every row start is 16-byte aligned and cols a
// multiple of 16 bytes: 16-byte cp.async copies, the zeros too, which the
// caller commits and waits for before its __syncthreads (landed()) or
// tracks with an mbarrier (cp_async_arrive); else element by element.
template <typename T>
__device__ void copy_rows(T* dst, int stride, const T* src, long src_stride, int rows,
                          int tile_rows, int cols, int colsP, bool vec, int tid, int nthreads) {
  if (vec) {
    constexpr int VEC = 16 / (int)sizeof(T);
    const int pieces = colsP / VEC;
    for (int idx = tid; idx < tile_rows * pieces; idx += nthreads) {
      const int r = idx / pieces, c = (idx % pieces) * VEC;
      T* d = dst + r * stride + c;
      if (r < rows && c < cols) __pipeline_memcpy_async(d, src + r * src_stride + c, 16);
      else __pipeline_memcpy_async(d, src, 16, 16);  // reads nothing, writes 16 zero bytes
    }
  } else {
    for (int idx = tid; idx < tile_rows * colsP; idx += nthreads) {
      const int r = idx / colsP, c = idx % colsP;
      dst[r * stride + c] = r < rows && c < cols ? src[r * src_stride + c] : from_f<T>(0.f);
    }
  }
}

// One arrival on `bar` once this thread's cp.async copies so far have
// landed (noinc: the barrier is set up for one arrival per thread).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void landed() {
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
}

// u and v as PARTS pairs of bf16 parts: hi, then what hi left over
template <int PARTS>
__device__ __forceinline__ void split2(float u, float v, uint32_t (&out)[PARTS]) {
#pragma unroll
  for (int k = 0; k < PARTS; ++k) {
    const __nv_bfloat162 h2 = __floats2bfloat162_rn(u, v);
    out[k] = *reinterpret_cast<const uint32_t*>(&h2);
    u -= __low2float(h2);
    v -= __high2float(h2);
  }
}

// c[n][e] += a_e · b[8n + 2·t4 + e % 2] for the thread's two rows (a0:
// row g4, e < 2; a1: row g4 + 8) and 2·PT tiles of 8 columns of fp32 row b
template <int PT>
__device__ __forceinline__ void fma_row(float (&c)[2 * PT][4], float a0, float a1,
                                        const float* b, int t4) {
#pragma unroll
  for (int n = 0; n < 2 * PT; ++n) {
    const float2 v = *reinterpret_cast<const float2*>(b + 8 * n + 2 * t4);
    c[n][0] = fmaf(a0, v.x, c[n][0]);
    c[n][1] = fmaf(a0, v.y, c[n][1]);
    c[n][2] = fmaf(a1, v.x, c[n][2]);
    c[n][3] = fmaf(a1, v.y, c[n][3]);
  }
}

// The block's inclusive cumsum of v over its threads (tid order).
__device__ __forceinline__ float block_cumsum(float v, float* wsum, int tid) {
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float n = __shfl_up_sync(FULL, v, off);
    if (lane >= off) v += n;
  }
  if (lane == 31) wsum[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float s = lane < SCAN_THREADS / 32 ? wsum[lane] : 0.f;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float n = __shfl_up_sync(FULL, s, off);
      if (lane >= off) s += n;
    }
    wsum[lane] = s;
  }
  __syncthreads();
  return warp > 0 ? v + wsum[warp - 1] : v;
}

// The thread's accumulators (rows g4, g4 + 8 of a 16-row tile; columns
// 8n + 2·t4, + 1) stored to row-major fp32 or T rows of `stride`, rows
// below `rows` and columns below P only.
template <typename T, int PT>
__device__ __forceinline__ void store_tile(T* out, long stride, const float (&acc)[2 * PT][4],
                                           int g4, int t4, int rows, int P) {
#pragma unroll
  for (int n = 0; n < 2 * PT; ++n) {
    const int p = 8 * n + 2 * t4;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = g4 + 8 * r;
      if (row >= rows) continue;
      if (p < P) out[row * stride + p] = from_f<T>(acc[n][2 * r]);
      if (p + 1 < P) out[row * stride + p + 1] = from_f<T>(acc[n][2 * r + 1]);
    }
  }
}

// Row-scale the accumulators: rows g4 by e0, g4 + 8 by e1.
template <int PT>
__device__ __forceinline__ void scale_rows(float (&acc)[2 * PT][4], float e0, float e1) {
#pragma unroll
  for (int n = 0; n < 2 * PT; ++n) {
    acc[n][0] *= e0;
    acc[n][1] *= e0;
    acc[n][2] *= e1;
    acc[n][3] *= e1;
  }
}

__device__ __forceinline__ float ex2(float x) {  // 2^x, one MUFU op (~2 ulp)
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// exp of a cumsum difference: bf16 takes the cumsums times log2(e) and
// 2^x (its output rounds at 2⁻⁹; the product's rounding moves the factor
// by ~|cum|·1e-7 relative), fp32 the accurate expf
template <bool FAST>
__device__ __forceinline__ float decay(float d) { return FAST ? ex2(d) : expf(d); }

// The masked, decayed scores of a 16 × 16 tile in place: row i = r0 + g4
// + 8·(e / 2), column j = jg + 8n + 2·t4 + e % 2 (chunk steps).  Masked
// before the exponential: j ≤ i only, where cum_i ≤ cum_j.
template <bool FAST>
__device__ __forceinline__ void mask_scores(float (&s)[2][4], const float* cum,
                                            const float* dts, int r0, int jg, int g4, int t4,
                                            int Qc) {
#pragma unroll
  for (int n = 0; n < 2; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = r0 + g4 + 8 * (e >> 1), j = jg + 8 * n + 2 * t4 + (e & 1);
      s[n][e] = (j <= i && i < Qc) ? s[n][e] * decay<FAST>(cum[i] - cum[j]) * dts[j] : 0.f;
    }
  }
}

// Pass 1.  Grid (chunks, H, B).  cum_ws (B, H, S) and cum_end (B, H,
// chunks); states (B, H, chunks, N, P): the local state of every chunk but
// the last, and the last one's too where ``form_last``.  PT: P rounded up
// to 16·PT; TD: dt's type.  bf16 copies the chunk's B and x whole and
// weights x's fragments in registers; fp32 copies JB rows a round and
// folds w into B's values.
template <typename T, typename TD, int PT>
__global__ void __launch_bounds__(SCAN_THREADS)
chunk_state_kernel(const T* __restrict__ x, const TD* __restrict__ dt,
                   const float* __restrict__ A, const T* __restrict__ Bm,
                   float* __restrict__ states, float* __restrict__ cum_end,
                   float* __restrict__ cum_ws, int S, int H, int P, int G, int N, int Q,
                   bool vec_b, bool vec_x, bool form_last) {
  constexpr bool MMA = sizeof(T) == 2;
  constexpr int PP = 16 * PT, RP = row_stride<T>(PP);
  const int NP = round16(N), RN = row_stride<T>(NP);
  const int ROWS = MMA ? round16(Q) : JB;  // steps copied a round
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* cum = reinterpret_cast<float*>(smem_raw);  // [MAX_CHUNK]
  float* w = cum + MAX_CHUNK;                       // [MAX_CHUNK] dt, then the weights
  float* wsum = w + MAX_CHUNK;                      // [32]
  T* Bs = reinterpret_cast<T*>(wsum + 32);          // [ROWS][RN]
  T* Xs = Bs + ROWS * RN;                           // [ROWS][RP]

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, chunks = gridDim.x;
  const int g = h / (H / G);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g4 = lane >> 2, t4 = lane & 3;
  const int t0 = c * Q, Qc = min(Q, S - t0);
  const long bh = (long)b * H + h;
  // no S_in follows the last chunk: its state is only the final state's
  const bool skip = c == chunks - 1 && !form_last;
  auto issue = [&](int r) {  // round r's B and x
    const int j0 = r * ROWS, jn = min(ROWS, Qc - j0);
    copy_rows<T>(Bs, RN, Bm + (((long)b * S + t0 + j0) * G + g) * N, (long)G * N, jn, ROWS, N,
                 NP, vec_b, tid, SCAN_THREADS);
    copy_rows<T>(Xs, RP, x + (((long)b * S + t0 + j0) * H + h) * P, (long)H * P, jn, ROWS, P,
                 PP, vec_x, tid, SCAN_THREADS);
  };
  if (!skip) issue(0);
  __pipeline_commit();

  float d = 0.f;
  if (tid < Qc) d = to_f(dt[((long)b * S + t0 + tid) * H + h]);
  const float a = block_cumsum(d * A[h], wsum, tid);
  if (tid < Qc) {
    cum[tid] = a;
    cum_ws[bh * S + t0 + tid] = a;
  }
  w[tid] = d;  // 0 past the chunk
  __syncthreads();
  const float cend = cum[Qc - 1];  // at the last real step of a ragged chunk
  if (tid == 0) cum_end[bh * chunks + c] = cend;
  if (skip) return;
  if (tid < Qc) w[tid] *= expf(cend - cum[tid]);  // cum_end ≤ cum_j: at most 1

  // s_c (N × P) = Bᵀ (N × Q) · (w ⊙ x) (Q × P).  fp32: warp w holds rows
  // n 16w .. 16w + 15.  bf16 computes s_cᵀ = (w ⊙ x)ᵀ · B, so w ⊙ x is the
  // A operand, weighted and split in registers once for 2·PT tiles of 8
  // columns of N: warp w holds rows p 16·(w % PT) .. + 15 and those tiles
  // from 2·PT·(w / PT) on.
  const int mt = warp % PT, n8 = 2 * PT * (warp / PT);
  const bool active = MMA ? n8 < NP / 8 : 16 * warp < NP;
  float acc[2 * PT][4];
#pragma unroll
  for (int n = 0; n < 2 * PT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const int rounds = (Qc + ROWS - 1) / ROWS;
  for (int r = 0; r < rounds; ++r) {
    const int j0 = r * ROWS, jn = min(ROWS, Qc - j0);
    if (r > 0) {
      __syncthreads();  // round r − 1 is consumed
      issue(r);
    }
    landed();  // round r has landed; w is ready
    if (!active) continue;
    if constexpr (MMA) {
      for (int ks = 0; 16 * ks < jn; ++ks) {
        uint32_t xa[4];  // xᵀ: rows p, columns j; x lies [j][p], so transposed
        ldmatrix_x4_trans(xa, Xs + (16 * ks + (lane & 7) + 8 * (lane >> 4)) * RP + 16 * mt +
                                  8 * ((lane >> 3) & 1));
        // × the weights of steps 2·t4, + 1 (registers 0, 1) and + 8, + 9 (2, 3)
        const float* wk = w + j0 + 16 * ks + 2 * t4;
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&xa[f]);
          uint32_t parts[2];
          split2<2>(__low2float(v) * wk[8 * (f >> 1)], __high2float(v) * wk[8 * (f >> 1) + 1],
                    parts);
          hi[f] = parts[0];
          lo[f] = parts[1];
        }
        // the lo products into every accumulator, then the hi ones, so
        // that no product waits on the one just issued
        uint32_t bb[PT][4];  // B: rows j, columns n (tiles n8 + 2q, + 1; steps 0-7, 8-15)
#pragma unroll
        for (int q = 0; q < PT; ++q)
          if (n8 + 2 * q < NP / 8)
            ldmatrix_x4_trans(bb[q], Bs + (16 * ks + (lane & 7) + 8 * ((lane >> 3) & 1)) * RN +
                                         8 * (n8 + 2 * q) + 8 * (lane >> 4));
#pragma unroll
        for (int part = 0; part < 2; ++part)
#pragma unroll
          for (int q = 0; q < PT; ++q) {
            if (n8 + 2 * q >= NP / 8) break;
            mma_bf16(acc[2 * q], part ? hi : lo, bb[q][0], bb[q][1]);
            mma_bf16(acc[2 * q + 1], part ? hi : lo, bb[q][2], bb[q][3]);
          }
      }
    } else {
      for (int j = 0; j < jn; ++j) {
        const float k = w[j0 + j];
        const T* br = Bs + j * RN + 16 * warp + g4;
        fma_row<PT>(acc, br[0] * k, br[8] * k, Xs + j * RP, t4);
      }
    }
  }
  if (!active) return;
  float* out = states + (bh * chunks + c) * N * P;
  if constexpr (MMA) {
    // s_cᵀ, stored (P, N): acc[i] holds rows p 16·mt + g4 (+ 8), columns
    // n 8·(n8 + i) + 2·t4, + 1, so a warp's store fills whole sectors
#pragma unroll
    for (int i = 0; i < 2 * PT; ++i) {
      const int n = 8 * (n8 + i) + 2 * t4;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int pr = 16 * mt + g4 + 8 * r;
        if (pr >= P || n >= N) continue;
        float* o = out + (long)pr * N + n;
        if (n + 1 < N && (N & 1) == 0)
          *reinterpret_cast<float2*>(o) = make_float2(acc[i][2 * r], acc[i][2 * r + 1]);
        else {
          o[0] = acc[i][2 * r];
          if (n + 1 < N) o[1] = acc[i][2 * r + 1];
        }
      }
    }
  } else {
    store_tile<float, PT>(out + (long)16 * warp * P, P, acc, g4, t4, N - 16 * warp, P);
  }
}

// Pass 2.  Grid (⌈N·P / PASS_THREADS⌉, H, B); chunks > 1.  The local
// states s(c) (N, P) in fp32 calls, (P, N) in bf16 ones become the states
// entering each chunk, S_in(c): in place (fp32), or as bf16 hi and lo
// planes (B, H, chunks, 2, P, N) for the tensor cores of a bf16 call,
// which then copy them as they lie.  With ``final_state`` (B, H, P, N)
// it also writes the state after the last step: S_in(last)·exp(cum_end)
// + s(last), which pass 1 formed; then it may run with one chunk.
template <bool PLANES>
__global__ void __launch_bounds__(PASS_THREADS)
state_pass_kernel(float* __restrict__ states, const float* __restrict__ cum_end,
                  bf16* __restrict__ planes, float* __restrict__ final_state, int P, int N,
                  int H, int chunks) {
  const int NPe = N * P;
  const int e = blockIdx.x * PASS_THREADS + threadIdx.x;
  if (e >= NPe) return;
  const long bh = (long)blockIdx.z * H + blockIdx.y;
  float* st = states + bh * chunks * NPe + e;
  bf16* pl = planes + bh * chunks * 2 * NPe + e;
  const float* ce = cum_end + bh * chunks;
  auto put_in = [&](int c, float v) {  // S_in(c)
    if constexpr (PLANES) {
      const bf16 hi = __float2bfloat16(v);
      pl[(long)c * 2 * NPe] = hi;
      pl[(long)c * 2 * NPe + NPe] = __float2bfloat16(v - __bfloat162float(hi));
    } else {
      st[(long)c * NPe] = v;
    }
  };
  constexpr int BATCH = 8;  // loads in flight ahead of the dependent chain
  float carry = 0.f;
  for (int c0 = 0; c0 < chunks - 1; c0 += BATCH) {
    float s[BATCH], k[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int c = c0 + u;
      s[u] = c < chunks - 1 ? st[(long)c * NPe] : 0.f;
      k[u] = c < chunks - 1 ? expf(ce[c]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int c = c0 + u;
      if (c >= chunks - 1) break;
      if (c > 0) put_in(c, carry);  // chunk c reads the state entering it; S_in(0) = 0
      carry = fmaf(carry, k[u], s[u]);
    }
  }
  if (final_state != nullptr) {
    // read before put_in: fp32 calls write S_in over the local states
    const float fin = fmaf(carry, expf(ce[chunks - 1]), st[(long)(chunks - 1) * NPe]);
    // bf16 states lie (P, N) as the final state does; fp32 ones (N, P)
    final_state[bh * NPe + (PLANES ? e : (e % P) * N + e / P)] = fin;
  }
  if (chunks > 1) put_in(chunks - 1, carry);
}

// Pass 3, bf16.  Grid (chunks, H, B), MMA_THREADS.  The chunk's B and x
// rows and S_in's planes are copied whole, in two groups that an mbarrier
// each tracks: S_in and the first 128 steps, then the rest.  Warp w takes
// the row tiles w and 15 − w of 16 rows, each against its column tiles on
// and below the diagonal: tile w needs the first group only, so the second
// lands while it is computed.
template <typename TD, int PT>
__global__ void __launch_bounds__(MMA_THREADS)
chunk_output_mma_kernel(const bf16* __restrict__ x, const TD* __restrict__ dt,
                        const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
                        const bf16* __restrict__ planes, const float* __restrict__ cum_ws,
                        bf16* __restrict__ y, int S, int H, int P, int G, int N, int Q,
                        bool vec_b, bool vec_x, bool vec_s) {
  constexpr int PP = 16 * PT, RP = row_stride<bf16>(PP);
  const int NP = round16(N), RN = row_stride<bf16>(NP);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* cum = reinterpret_cast<float*>(smem_raw);  // [MAX_CHUNK]
  float* dts = cum + MAX_CHUNK;                     // [MAX_CHUNK]
  bf16* Bs = reinterpret_cast<bf16*>(dts + MAX_CHUNK);  // [round16(Q)][RN]
  bf16* Xs = Bs + round16(Q) * RN;                  // [round16(Q)][RP]
  bf16* Ss = Xs + round16(Q) * RP;                  // [2][PP][RN]  S_in(c)ᵀ, hi and lo
  // this warp's staging of 16 rows × Y_SLAB columns of y
  bf16* Yw = Ss + 2 * PP * RN + (threadIdx.x >> 5) * 16 * row_stride<bf16>(Y_SLAB);

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, chunks = gridDim.x;
  const int g = h / (H / G);
  const int t0 = c * Q, Qc = min(Q, S - t0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g4 = lane >> 2, t4 = lane & 3;
  const long bh = (long)b * H + h;
  const long brow = ((long)b * S + t0) * G + g;  // B/C row of the chunk's first step
  const long xrow = ((long)b * S + t0) * H + h;  // x/y row of it (dt's index too)

  __shared__ uint64_t landed_bar[2];  // steps [0, 128) with S_in, then [128, Qc)
  if (tid == 0) {
    mbar_init(&landed_bar[0], MMA_THREADS);
    mbar_init(&landed_bar[1], MMA_THREADS);
  }
  __syncthreads();
  constexpr int HALF = MAX_CHUNK / 2;
  for (int k = 0; k < 2 && c > 0; ++k)  // hi, lo
    copy_rows<bf16>(Ss + k * PP * RN, RN, planes + ((bh * chunks + c) * 2 + k) * P * N, N, P,
                    PP, N, NP, vec_s, tid, MMA_THREADS);
  for (int half = 0; half < 2; ++half) {
    const int j0 = half * HALF, jn = min(HALF, Qc - j0);
    if (jn > 0) {
      copy_rows<bf16>(Bs + j0 * RN, RN, Bm + (brow + (long)j0 * G) * N, (long)G * N, jn,
                      round16(jn), N, NP, vec_b, tid, MMA_THREADS);
      copy_rows<bf16>(Xs + j0 * RP, RP, x + (xrow + (long)j0 * H) * P, (long)H * P, jn,
                      round16(jn), P, PP, vec_x, tid, MMA_THREADS);
    }
    cp_async_arrive(&landed_bar[half]);
  }
  for (int j = tid; j < Qc; j += MMA_THREADS) {
    cum[j] = cum_ws[bh * S + t0 + j] * 1.4426950408889634f;  // log2(e)
    dts[j] = to_f(dt[xrow + (long)j * H]);
  }
  __syncthreads();  // cum and dts (and copies made element by element) are in place

  const bool even = (N & 1) == 0;
  for (int pair = 0; pair < 2; ++pair) {
    const int t = pair == 0 ? warp : 15 - warp;  // this warp's row tile
    const int r0 = 16 * t;
    if (r0 >= Qc) continue;
    // C's rows r0 .. r0 + 15 as A fragments, from global memory: register
    // f holds row g4 + 8·(f % 2), columns 16·ks + 2·t4 + 8·(f / 2), + 1
    uint32_t cf[MAX_N / 16][4];
#pragma unroll
    for (int ks = 0; ks < MAX_N / 16; ++ks) {
      if (ks >= NP / 16) break;
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int i = r0 + g4 + 8 * (f & 1), k = 16 * ks + 2 * t4 + 8 * (f >> 1);
        const bf16* src = Cm + (brow + (long)i * G) * N + k;
        if (i >= Qc || k >= N) cf[ks][f] = 0;
        else if (even) cf[ks][f] = *reinterpret_cast<const uint32_t*>(src);
        else cf[ks][f] = pack_bf16(__bfloat162float(src[0]),
                                   k + 1 < N ? __bfloat162float(src[1]) : 0.f);
      }
    }
    mbar_wait(&landed_bar[pair], 0);  // tile w: steps below 128 and S_in; 15 − w: the rest
    float yacc[2 * PT][4];
#pragma unroll
    for (int n = 0; n < 2 * PT; ++n) yacc[n][0] = yacc[n][1] = yacc[n][2] = yacc[n][3] = 0.f;
    if (c > 0) {  // the carried state exp(cum_i)·C_i·S_in(c); S_in(0) = 0
#pragma unroll
      for (int ks = 0; ks < MAX_N / 16; ++ks) {
        if (ks >= NP / 16) break;
        uint32_t sf[2][PT][4];  // S_in: rows n, columns p (it lies [p][n]); lo and hi
#pragma unroll
        for (int part = 0; part < 2; ++part)
#pragma unroll
          for (int dp = 0; dp < PT; ++dp)
            ldmatrix_x4(sf[part][dp], Ss + (1 - part) * PP * RN +
                                          (16 * dp + (lane & 7) + 8 * (lane >> 4)) * RN +
                                          16 * ks + 8 * ((lane >> 3) & 1));
#pragma unroll
        for (int part = 0; part < 2; ++part)  // lo, then hi
#pragma unroll
          for (int dp = 0; dp < PT; ++dp) {
            mma_bf16(yacc[2 * dp], cf[ks], sf[part][dp][0], sf[part][dp][1]);
            mma_bf16(yacc[2 * dp + 1], cf[ks], sf[part][dp][2], sf[part][dp][3]);
          }
      }
      // cum_i ≤ 0: the factor is at most 1
      scale_rows<PT>(yacc, r0 + g4 < Qc ? ex2(cum[r0 + g4]) : 0.f,
                     r0 + g4 + 8 < Qc ? ex2(cum[r0 + g4 + 8]) : 0.f);
    }
    for (int jt = 0; jt <= t; ++jt) {  // this chunk's steps j ≤ i
      // four accumulator pairs (k-steps mod 4), so that no product waits
      // on one of the last eight issued
      float part[4][2][4] = {};
      uint32_t bfr[MAX_N / 16][4];  // B: rows j, columns n
#pragma unroll
      for (int ks = 0; ks < MAX_N / 16; ++ks)
        if (ks < NP / 16)
          ldmatrix_x4(bfr[ks], Bs + (16 * jt + (lane & 7) + 8 * (lane >> 4)) * RN + 16 * ks +
                                   8 * ((lane >> 3) & 1));
#pragma unroll
      for (int ks = 0; ks < MAX_N / 16; ++ks) {
        if (ks >= NP / 16) break;
        mma_bf16(part[ks & 3][0], cf[ks], bfr[ks][0], bfr[ks][1]);
        mma_bf16(part[ks & 3][1], cf[ks], bfr[ks][2], bfr[ks][3]);
      }
      float sacc[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sacc[n][e] = (part[0][n][e] + part[1][n][e]) + (part[2][n][e] + part[3][n][e]);
      mask_scores<true>(sacc, cum, dts, r0, 16 * jt, g4, t4, Qc);
      // the score accumulators are the A fragment, in register order (row
      // g4, columns 0-7), (g4 + 8, 0-7), (g4, 8-15), (g4 + 8, 8-15); hi + lo
      uint32_t sh[4], sl[4];
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        uint32_t parts[2];
        split2<2>(sacc[f >> 1][2 * (f & 1)], sacc[f >> 1][2 * (f & 1) + 1], parts);
        sh[f] = parts[0];
        sl[f] = parts[1];
      }
      uint32_t xf[PT][4];  // x: rows j, columns p
#pragma unroll
      for (int dp = 0; dp < PT; ++dp)
        ldmatrix_x4_trans(xf[dp], Xs + (16 * jt + (lane & 7) + 8 * ((lane >> 3) & 1)) * RP +
                                      16 * dp + 8 * (lane >> 4));
#pragma unroll
      for (int k = 0; k < 2; ++k)  // lo, then hi
#pragma unroll
        for (int dp = 0; dp < PT; ++dp) {
          mma_bf16(yacc[2 * dp], k ? sh : sl, xf[dp][0], xf[dp][1]);
          mma_bf16(yacc[2 * dp + 1], k ? sh : sl, xf[dp][2], xf[dp][3]);
        }
    }
    if (P % 8 == 0) {
      // through the warp's staging, Y_SLAB columns at a time, so that each
      // lane stores 16 contiguous bytes of a row
      constexpr int YR = row_stride<bf16>(Y_SLAB);
#pragma unroll
      for (int slab = 0; slab < (2 * PT + 7) / 8; ++slab) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int n = 8 * slab + i;
          if (n >= 2 * PT) break;
          *reinterpret_cast<uint32_t*>(Yw + g4 * YR + 8 * i + 2 * t4) =
              pack_bf16(yacc[n][0], yacc[n][1]);
          *reinterpret_cast<uint32_t*>(Yw + (g4 + 8) * YR + 8 * i + 2 * t4) =
              pack_bf16(yacc[n][2], yacc[n][3]);
        }
        __syncwarp();
        const int cpr = min(Y_SLAB, PP - Y_SLAB * slab) / 8;  // 16-byte pieces a row
        for (int q = lane; q < 16 * cpr; q += 32) {
          const int row = q / cpr, col = Y_SLAB * slab + 8 * (q % cpr);
          if (r0 + row < Qc && col < P)
            *reinterpret_cast<uint4*>(y + (xrow + (long)(r0 + row) * H) * P + col) =
                *reinterpret_cast<const uint4*>(Yw + row * YR + 8 * (q % cpr));
        }
        __syncwarp();  // the next slab reuses the staging
      }
    } else {
      store_tile<bf16, PT>(y + (xrow + (long)r0 * H) * P, (long)H * P, yacc, g4, t4, Qc - r0,
                           P);
    }
  }
}

// Pass 3, fp32.  Grid (row_tiles · chunks, H, B), FMA_THREADS: warp w of
// row tile rt holds chunk rows 64·rt + 16w .. + 15; row tiles start heavy
// first.  The columns j ≤ i come in rounds of JB steps through a ring of
// two B and x buffers (round r + 1's copies in flight while round r is
// computed), S_in in rounds of JB rows.
template <int PT>
__global__ void __launch_bounds__(FMA_THREADS)
chunk_output_fma_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                        const float* __restrict__ Bm, const float* __restrict__ Cm,
                        const float* __restrict__ states, const float* __restrict__ cum_ws,
                        float* __restrict__ y, int S, int H, int P, int G, int N, int Q,
                        int chunks, int row_tiles, bool vec_b, bool vec_x, bool vec_s) {
  constexpr int PP = 16 * PT, RP = row_stride<float>(PP);
  const int NP = round16(N), RN = row_stride<float>(NP);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* cum = reinterpret_cast<float*>(smem_raw);  // [MAX_CHUNK]
  float* dts = cum + MAX_CHUNK;                     // [MAX_CHUNK]
  float* Cs = dts + MAX_CHUNK;                      // [ROW_TILE][RN]
  float* Bs = Cs + ROW_TILE * RN;                   // [2][JB][RN]
  float* Xs = Bs + 2 * JB * RN;                     // [2][JB][RP]
  float* Ss = Xs + 2 * JB * RP;                     // [JB][RP]  JB rows of S_in(c)
  float* Pw = Ss + JB * RP;                         // [4][16][17]  the warps' scores

  const int c = blockIdx.x / row_tiles;
  const int rt = row_tiles - 1 - blockIdx.x % row_tiles;  // heavy first
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G);
  const int t0 = c * Q, Qc = min(Q, S - t0);
  const int i0 = ROW_TILE * rt;
  if (i0 >= Qc) return;  // a ragged last chunk has fewer row tiles
  const int i_end = min(i0 + ROW_TILE, Qc);
  const int rounds = (i_end + JB - 1) / JB;  // the last one holds the diagonal
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g4 = lane >> 2, t4 = lane & 3;
  const long bh = (long)b * H + h;
  const long brow = ((long)b * S + t0) * G + g;
  const long xrow = ((long)b * S + t0) * H + h;

  auto issue = [&](int r) {  // round r's B and x into ring buffer r % 2
    const int j0 = r * JB, jn = min(JB, Qc - j0);
    copy_rows<float>(Bs + (r & 1) * JB * RN, RN, Bm + (brow + (long)j0 * G) * N, (long)G * N,
                     jn, JB, N, NP, vec_b, tid, FMA_THREADS);
    copy_rows<float>(Xs + (r & 1) * JB * RP, RP, x + (xrow + (long)j0 * H) * P, (long)H * P,
                     jn, JB, P, PP, vec_x, tid, FMA_THREADS);
  };
  copy_rows<float>(Cs, RN, Cm + (brow + (long)i0 * G) * N, (long)G * N, i_end - i0, ROW_TILE,
                   N, NP, vec_b, tid, FMA_THREADS);
  issue(0);
  __pipeline_commit();
  for (int j = tid; j < i_end; j += FMA_THREADS) {
    cum[j] = cum_ws[bh * S + t0 + j];
    dts[j] = dt[xrow + (long)j * H];
  }

  const int r0 = i0 + 16 * warp;  // this warp's first chunk row
  const bool live = r0 < Qc;
  const float* Cw = Cs + 16 * warp * RN;  // its rows of C
  float yacc[2 * PT][4];
#pragma unroll
  for (int n = 0; n < 2 * PT; ++n) yacc[n][0] = yacc[n][1] = yacc[n][2] = yacc[n][3] = 0.f;

  // the carried state exp(cum_i)·C_i·S_in(c); S_in(0) = 0
  const float* s_in = states + (bh * chunks + c) * N * P;
  for (int k0 = 0; k0 < NP && c > 0; k0 += JB) {
    __syncthreads();  // the previous round's rows are consumed
    copy_rows<float>(Ss, RP, s_in + (long)k0 * P, P, N - k0, JB, P, PP, vec_s, tid,
                     FMA_THREADS);
    landed();
    if (!live) continue;
    for (int k = 0; k < min(JB, N - k0); ++k)
      fma_row<PT>(yacc, Cw[g4 * RN + k0 + k], Cw[(g4 + 8) * RN + k0 + k], Ss + k * RP, t4);
  }
  __pipeline_wait_prior(0);
  __syncthreads();
  if (c > 0)  // cum_i ≤ 0: the factor is at most 1
    scale_rows<PT>(yacc, r0 + g4 < Qc ? expf(cum[r0 + g4]) : 0.f,
                   r0 + g4 + 8 < Qc ? expf(cum[r0 + g4 + 8]) : 0.f);

  for (int r = 0; r < rounds; ++r) {  // this chunk's steps j ≤ i
    if (r > 0) {
      __pipeline_wait_prior(0);  // round r has landed ...
      __syncthreads();           // ... for every thread, and round r − 1 is consumed
    }
    if (r + 1 < rounds) issue(r + 1);
    __pipeline_commit();
    if (!live) continue;
    const float* Br = Bs + (r & 1) * JB * RN;
    const float* Xr = Xs + (r & 1) * JB * RP;
    for (int jt = 0; jt < JB / 16; ++jt) {
      const int jg = r * JB + 16 * jt;  // the column tile's first step
      if (jg > r0 + 15 || jg >= Qc) break;  // wholly above the diagonal, or past the chunk
      // C_i·B_j over n in order, one FMA at a time
      float sacc[2][4];
      const float* c0 = Cw + g4 * RN;
      const float* c1 = c0 + 8 * RN;
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const float* b0 = Br + (16 * jt + 8 * n + 2 * t4) * RN;
        const float* b1 = b0 + RN;
        float d0 = 0.f, d1 = 0.f, d2 = 0.f, d3 = 0.f;
        for (int k = 0; k < NP; k += 4) {
          const float4 u = *reinterpret_cast<const float4*>(c0 + k);
          const float4 v = *reinterpret_cast<const float4*>(c1 + k);
          const float4 p = *reinterpret_cast<const float4*>(b0 + k);
          const float4 q = *reinterpret_cast<const float4*>(b1 + k);
          d0 = fmaf(u.w, p.w, fmaf(u.z, p.z, fmaf(u.y, p.y, fmaf(u.x, p.x, d0))));
          d1 = fmaf(u.w, q.w, fmaf(u.z, q.z, fmaf(u.y, q.y, fmaf(u.x, q.x, d1))));
          d2 = fmaf(v.w, p.w, fmaf(v.z, p.z, fmaf(v.y, p.y, fmaf(v.x, p.x, d2))));
          d3 = fmaf(v.w, q.w, fmaf(v.z, q.z, fmaf(v.y, q.y, fmaf(v.x, q.x, d3))));
        }
        sacc[n][0] = d0;
        sacc[n][1] = d1;
        sacc[n][2] = d2;
        sacc[n][3] = d3;
      }
      mask_scores<false>(sacc, cum, dts, r0, jg, g4, t4, Qc);
      // the warp's 16 × 16 scores through shared memory, then y += s·x in j order
      float* Ps = Pw + warp * 16 * 17;
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          Ps[(g4 + 8 * (e >> 1)) * 17 + 8 * n + 2 * t4 + (e & 1)] = sacc[n][e];
      __syncwarp();
      for (int j = 0; j < 16; ++j)
        fma_row<PT>(yacc, Ps[g4 * 17 + j], Ps[(g4 + 8) * 17 + j], Xr + (16 * jt + j) * RP, t4);
      __syncwarp();  // the next tile rewrites the scores
    }
  }
  if (live) store_tile<float, PT>(y + (xrow + (long)r0 * H) * P, (long)H * P, yacc, g4, t4,
                                  Qc - r0, P);
}

template <typename T, typename TD, int PT>
cudaError_t launch(const T* x, const TD* dt, const float* A, const T* Bm, const T* Cm,
                   float* ws, T* y, float* final_state, int B, int S, int H, int P, int G,
                   int N, int Q, int chunks, cudaStream_t stream) {
  constexpr bool MMA = sizeof(T) == 2;
  const long nstate = (long)B * H * chunks * N * P;
  float* states = ws;                                        // (B, H, chunks, N, P)
  float* cum_end = states + nstate;                          // (B, H, chunks)
  float* cum_ws = cum_end + (long)B * H * chunks;            // (B, H, S)
  // bf16: S_in's planes (B, H, chunks, 2, P, N), from the next 16 bytes
  bf16* planes = reinterpret_cast<bf16*>(ws + (nstate + (long)B * H * (chunks + S) + 3) / 4 * 4);
  constexpr int VEC = 16 / (int)sizeof(T);
  const bool vec_b = N % VEC == 0 && reinterpret_cast<uintptr_t>(Bm) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(Cm) % 16 == 0;
  const bool vec_x = P % VEC == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  // S_in's rows (bf16: of N, fp32: of P); the workspace is 16-byte aligned
  const bool vec_s = (MMA ? N : P) % VEC == 0;

  const size_t s1 = state_smem<T>(Q, 16 * PT, N);
  const size_t s3 = MMA ? output_mma_smem(Q, 16 * PT, N) : output_fma_smem(16 * PT, N);
  if (s1 > kMaxSmemBytes || s3 > kMaxSmemBytes) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(chunk_state_kernel<T, TD, PT>, s1);
  if (err != cudaSuccess) return err;
  const bool fin = final_state != nullptr;
  chunk_state_kernel<T, TD, PT><<<dim3(chunks, H, B), SCAN_THREADS, s1, stream>>>(
      x, dt, A, Bm, states, cum_end, cum_ws, S, H, P, G, N, Q, vec_b, vec_x, fin);
  if (chunks > 1 || fin)
    state_pass_kernel<MMA><<<dim3((N * P + PASS_THREADS - 1) / PASS_THREADS, H, B),
                             PASS_THREADS, 0, stream>>>(states, cum_end, planes, final_state,
                                                        P, N, H, chunks);
  if constexpr (MMA) {
    err = allow_smem(chunk_output_mma_kernel<TD, PT>, s3);
    if (err != cudaSuccess) return err;
    chunk_output_mma_kernel<TD, PT><<<dim3(chunks, H, B), MMA_THREADS, s3, stream>>>(
        x, dt, Bm, Cm, planes, cum_ws, y, S, H, P, G, N, Q, vec_b, vec_x, vec_s);
  } else {
    err = allow_smem(chunk_output_fma_kernel<PT>, s3);
    if (err != cudaSuccess) return err;
    const int row_tiles = (Q + ROW_TILE - 1) / ROW_TILE;
    chunk_output_fma_kernel<PT><<<dim3(row_tiles * chunks, H, B), FMA_THREADS, s3, stream>>>(
        x, dt, Bm, Cm, states, cum_ws, y, S, H, P, G, N, Q, chunks, row_tiles, vec_b, vec_x,
        vec_s);
  }
  return cudaGetLastError();
}

template <typename T, typename TD>
cudaError_t dispatch(const void* x, const void* dt, const float* A, const void* Bm,
                     const void* Cm, float* ws, void* y, float* fin, int B, int S, int H,
                     int P, int G, int N, int Q, int chunks, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const TD* dtt = static_cast<const TD*>(dt);
  const T* bt = static_cast<const T*>(Bm);
  const T* ct = static_cast<const T*>(Cm);
  T* yt = static_cast<T*>(y);
  switch ((P + 15) / 16) {  // P rounded up to 16, 32, 64 or 128
    case 1:
      return launch<T, TD, 1>(xt, dtt, A, bt, ct, ws, yt, fin, B, S, H, P, G, N, Q, chunks, st);
    case 2:
      return launch<T, TD, 2>(xt, dtt, A, bt, ct, ws, yt, fin, B, S, H, P, G, N, Q, chunks, st);
    case 3:
    case 4:
      return launch<T, TD, 4>(xt, dtt, A, bt, ct, ws, yt, fin, B, S, H, P, G, N, Q, chunks, st);
    default:
      return launch<T, TD, 8>(xt, dtt, A, bt, ct, ws, yt, fin, B, S, H, P, G, N, Q, chunks, st);
  }
}

}  // namespace
}  // namespace repro_torch

// x/y: (B, S, H, P); dt: (B, S, H); A: (H,) float32; Bm/Cm: (B, S, G, N);
// x, Bm, Cm and y share one dtype; dt is in it (dt_dtype == dtype) or,
// with bf16 x, fp32.  All contiguous.  chunk in [1, 256], chunks =
// ⌈S / chunk⌉, N and P in [1, 128]; ws: 16-byte aligned fp32 scratch of
// B·H·(chunks·(N·P + 1) + S) floats, rounded up to 4, then (bf16) another
// B·H·chunks·N·P (kernels/ssd_scan.py::ssd_plan).  final_state: null, or
// fp32 (B, H, P, N) for the state after step S.  Two or three launches;
// returns cudaGetLastError() after the last.
extern "C" int repro_ssd_scan_fwd(const void* x, const void* dt, const void* A,
                                  const void* Bm, const void* Cm, void* ws, void* y,
                                  void* final_state, int B, int S, int H, int P, int G, int N,
                                  int chunk, int chunks, int dtype, int dt_dtype,
                                  void* stream) {
  using namespace repro_torch;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || B > 65535 || S <= 0 || H <= 0 || H > 65535 || P <= 0 || P > MAX_P ||
      N <= 0 || N > MAX_N || G <= 0 || H % G != 0 || chunk <= 0 || chunk > MAX_CHUNK ||
      chunks != (S + chunk - 1) / chunk || ws == nullptr ||
      reinterpret_cast<uintptr_t>(ws) % 16 != 0)
    return cudaErrorInvalidValue;
  const float* Af = static_cast<const float*>(A);
  float* w = static_cast<float*>(ws);
  float* fin = static_cast<float*>(final_state);
  if (dtype == kFloat32 && dt_dtype == kFloat32)
    return dispatch<float, float>(x, dt, Af, Bm, Cm, w, y, fin, B, S, H, P, G, N, chunk,
                                  chunks, st);
  if (dtype == kBFloat16 && dt_dtype == kBFloat16)
    return dispatch<bf16, bf16>(x, dt, Af, Bm, Cm, w, y, fin, B, S, H, P, G, N, chunk, chunks,
                                st);
  if (dtype == kBFloat16 && dt_dtype == kFloat32)
    return dispatch<bf16, float>(x, dt, Af, Bm, Cm, w, y, fin, B, S, H, P, G, N, chunk, chunks,
                                 st);
  return cudaErrorInvalidValue;
}
