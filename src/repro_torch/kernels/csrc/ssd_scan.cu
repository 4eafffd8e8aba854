// Mamba-2 SSD chunked scan for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py (ssd_scan_fwd,
// body _ssd_kernel).  Per (batch b, head h) and chunk of Q steps, with
// cum = inclusive cumsum of dt·A inside the chunk:
//   y_i = Σ_{j≤i} (C_i·B_j)·exp(cum_i − cum_j)·dt_j·x_j + exp(cum_i)·C_i·S
//   S  ← S·exp(cum_end) + Σ_j exp(cum_end − cum_j)·dt_j·B_j ⊗ x_j
// with the fp32 (N, P) state S carried from chunk to chunk.
//
// What bounds it on this card: operations.  Per chunk and head it does
// ~Q²/2·(N + P) + 2·Q·N·P multiply-adds on ~Q·(2N + 2P) inputs, about
// 250 FLOP per byte at mamba2-780m (Q=256, N=128, P=64), above the fp32
// ridge (~20 FLOP/byte at 67 TFLOP/s).  This first version runs them as
// fp32 FMAs from shared memory; tensor cores are later work.
//
// What the design does about it:
// * The TPU carried S in VMEM across a sequential grid axis.  Here one
//   block per (b, h) walks the chunks in order and keeps S in shared
//   memory (32 KB at N=128, P=64), so the state never leaves the SM.
// * The block reads the public layouts as they lie: A by head, B and C by
//   group g = h / (H/G), x and y at (b, t, h) — nothing repeated per head,
//   nothing padded; the ragged last chunk is masked (dt = 0 there would
//   give the same outputs).
// * The Q×Q score matrix is never held whole (256 KB in fp32 at Q=256):
//   rows i go in tiles of 32, each against the column tiles j ≤ i, with
//   C, B and x tiles staged in shared memory (rows padded by one float so
//   a warp's lanes, one column each, hit distinct banks).
// * exp(cum_i − cum_j) is formed only for j ≤ i, where cum_i ≤ cum_j and
//   the factor is at most 1.  For j > i the exponent is positive and can
//   overflow to inf, and inf·0 would be NaN.
// * The in-chunk cumsum is a block scan: warp shuffles, then the warps'
//   totals.
// B·H blocks (48 at mamba2-780m, B=1) fill 48 of 132 SMs; a split of the
// work inside a chunk across blocks is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int THREADS = 256;
constexpr int MAX_CHUNK = THREADS;  // one scan element per thread
constexpr int TILE = 32;            // score rows i and columns j per tile
constexpr unsigned FULL = 0xffffffffu;

// S (N×P), cum and dt (Q each), C and B tiles (TILE × (N+1)), x and y
// tiles (TILE × P), scores (TILE × (TILE+1)), the warps' scan totals
inline size_t ssd_smem_bytes(int Q, int P, int N) {
  return 4 * ((size_t)N * P + 2 * Q + 2 * TILE * (N + 1) + 2 * TILE * P +
              TILE * (TILE + 1) + 32);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_kernel(const T* __restrict__ x, const T* __restrict__ dt,
           const float* __restrict__ A, const T* __restrict__ Bm,
           const T* __restrict__ Cm, T* __restrict__ y, int S, int H, int P,
           int G, int N, int Q) {
  extern __shared__ float sm[];
  float* St = sm;                     // [N][P] carried state
  float* cum = St + N * P;            // [Q]
  float* dts = cum + Q;               // [Q]
  float* Ct = dts + Q;                // [TILE][N+1]
  float* Bt = Ct + TILE * (N + 1);    // [TILE][N+1]
  float* xt = Bt + TILE * (N + 1);    // [TILE][P]
  float* yt = xt + TILE * P;          // [TILE][P]
  float* sc = yt + TILE * P;          // [TILE][TILE+1]
  float* wsum = sc + TILE * (TILE + 1);  // [32]

  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (H / G);
  const float a_h = A[h];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int NB = N + 1;
  // element offsets of token t: x/y (B,S,H,P), dt (B,S,H), B/C (B,S,G,N)
  auto xoff = [&](int t) { return (((long)b * S + t) * H + h) * P; };
  auto boff = [&](int t) { return (((long)b * S + t) * G + g) * N; };

  for (int i = tid; i < N * P; i += THREADS) St[i] = 0.f;

  for (int t0 = 0; t0 < S; t0 += Q) {
    const int Qc = min(Q, S - t0);

    // 1. dt and the inclusive cumsum of dt·A over the chunk
    float d = 0.f, a = 0.f;
    if (tid < Qc) {
      d = to_f(dt[((long)b * S + t0 + tid) * H + h]);
      a = d * a_h;
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float n = __shfl_up_sync(FULL, a, off);
      if (lane >= off) a += n;
    }
    if (lane == 31) wsum[warp] = a;
    __syncthreads();
    if (warp == 0) {
      float s = lane < THREADS / 32 ? wsum[lane] : 0.f;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float n = __shfl_up_sync(FULL, s, off);
        if (lane >= off) s += n;
      }
      wsum[lane] = s;
    }
    __syncthreads();
    if (warp > 0) a += wsum[warp - 1];
    if (tid < Q) {
      cum[tid] = a;
      dts[tid] = d;
    }
    __syncthreads();

    // 2. outputs, TILE rows at a time
    for (int i0 = 0; i0 < Qc; i0 += TILE) {
      const int ni = min(TILE, Qc - i0);
      for (int idx = tid; idx < TILE * N; idx += THREADS) {
        const int i = idx / N, n = idx % N;
        Ct[i * NB + n] = i < ni ? to_f(Cm[boff(t0 + i0 + i) + n]) : 0.f;
      }
      __syncthreads();
      // the carried state: exp(cum_i)·C_i·S
      for (int idx = tid; idx < TILE * P; idx += THREADS) {
        const int i = idx / P, p = idx % P;
        float s = 0.f;
        for (int n = 0; n < N; ++n) s = fmaf(Ct[i * NB + n], St[n * P + p], s);
        yt[idx] = i < ni ? expf(cum[i0 + i]) * s : 0.f;
      }
      // this chunk's steps j ≤ i, TILE columns at a time
      for (int j0 = 0; j0 <= i0; j0 += TILE) {
        const int nj = min(TILE, Qc - j0);
        __syncthreads();  // the previous tile's B, x and scores are read
        for (int idx = tid; idx < TILE * N; idx += THREADS) {
          const int j = idx / N, n = idx % N;
          Bt[j * NB + n] = j < nj ? to_f(Bm[boff(t0 + j0 + j) + n]) : 0.f;
        }
        for (int idx = tid; idx < TILE * P; idx += THREADS) {
          const int j = idx / P, p = idx % P;
          xt[idx] = j < nj ? to_f(x[xoff(t0 + j0 + j) + p]) : 0.f;
        }
        __syncthreads();
        for (int idx = tid; idx < TILE * TILE; idx += THREADS) {
          const int i = idx / TILE, j = idx % TILE;
          const int gi = i0 + i, gj = j0 + j;
          float s = 0.f;
          if (gj <= gi && i < ni && j < nj) {  // never exp(cum_i − cum_j), j > i
            float dot = 0.f;
            for (int n = 0; n < N; ++n) dot = fmaf(Ct[i * NB + n], Bt[j * NB + n], dot);
            s = dot * expf(cum[gi] - cum[gj]) * dts[gj];
          }
          sc[i * (TILE + 1) + j] = s;
        }
        __syncthreads();
        for (int idx = tid; idx < TILE * P; idx += THREADS) {
          const int i = idx / P, p = idx % P;
          float acc = yt[idx];
#pragma unroll 8
          for (int j = 0; j < TILE; ++j)
            acc = fmaf(sc[i * (TILE + 1) + j], xt[j * P + p], acc);
          yt[idx] = acc;
        }
      }
      // each thread stores the entries it accumulated
      for (int idx = tid; idx < TILE * P; idx += THREADS) {
        const int i = idx / P, p = idx % P;
        if (i < ni) y[xoff(t0 + i0 + i) + p] = from_f<T>(yt[idx]);
      }
      __syncthreads();  // C tile and state reads done before they change
    }

    // 3. S ← S·exp(cum_end) + Σ_j exp(cum_end − cum_j)·dt_j·B_j ⊗ x_j
    const float cend = cum[Qc - 1];
    const float keep = expf(cend);
    for (int idx = tid; idx < N * P; idx += THREADS) St[idx] *= keep;
    for (int j0 = 0; j0 < Qc; j0 += TILE) {
      const int nj = min(TILE, Qc - j0);
      __syncthreads();
      for (int idx = tid; idx < TILE * N; idx += THREADS) {
        const int j = idx / N, n = idx % N;
        Bt[j * NB + n] = j < nj ? to_f(Bm[boff(t0 + j0 + j) + n]) : 0.f;
      }
      for (int idx = tid; idx < TILE * P; idx += THREADS) {
        const int j = idx / P, p = idx % P;
        // cum_end ≤ cum_j: the decay to the chunk's end is at most 1
        xt[idx] = j < nj ? expf(cend - cum[j0 + j]) * dts[j0 + j] *
                               to_f(x[xoff(t0 + j0 + j) + p])
                         : 0.f;
      }
      __syncthreads();
      for (int idx = tid; idx < N * P; idx += THREADS) {
        const int n = idx / P, p = idx % P;
        float acc = St[idx];
#pragma unroll 8
        for (int j = 0; j < TILE; ++j) acc = fmaf(Bt[j * NB + n], xt[j * P + p], acc);
        St[idx] = acc;
      }
    }
    __syncthreads();  // the next chunk rewrites cum and dt and reads S
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const float* A, const void* Bm,
                   const void* Cm, void* y, int B, int S, int H, int P, int G,
                   int N, int Q, cudaStream_t stream) {
  const size_t smem = ssd_smem_bytes(Q, P, N);
  cudaError_t err = allow_smem(ssd_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  ssd_kernel<T><<<dim3(H, B), THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt), A,
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), static_cast<T*>(y),
      S, H, P, G, N, Q);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// x/y: (B, S, H, P); dt: (B, S, H); A: (H,) float32; Bm/Cm: (B, S, G, N);
// x, dt, Bm, Cm and y share one dtype.  All contiguous.  chunk in
// [1, 256].  Returns cudaGetLastError() after the launch.
extern "C" int repro_ssd_scan_fwd(const void* x, const void* dt, const void* A,
                                  const void* Bm, const void* Cm, void* y, int B,
                                  int S, int H, int P, int G, int N, int chunk,
                                  int dtype, void* stream) {
  using namespace repro_torch;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || N <= 0 || G <= 0 || H % G != 0 ||
      chunk <= 0 || chunk > MAX_CHUNK || ssd_smem_bytes(chunk, P, N) > kMaxSmemBytes)
    return cudaErrorInvalidValue;
  const float* Af = static_cast<const float*>(A);
  if (dtype == kFloat32)
    return launch<float>(x, dt, Af, Bm, Cm, y, B, S, H, P, G, N, chunk, st);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(x, dt, Af, Bm, Cm, y, B, S, H, P, G, N, chunk, st);
  return cudaErrorInvalidValue;
}
