// Flash attention forward for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention_fwd, body _flash_fwd_kernel): softmax(q·kᵀ/√Dh + mask)·v
// with an fp32 online-softmax carry, masks for K positions at or past
// valid_len, causal (kpos ≤ qpos) and sliding window (kpos > qpos − window),
// fully masked K tiles skipped, output acc / max(l, 1e-20).
//
// What bounds it on this card: at prefill lengths (S of a few hundred to a
// few thousand, Dh = 128) attention does ~Dh·S/2 multiply-adds per byte of
// q/k/v it must read, far above the H100's ~295 FLOP/byte ridge, so it is
// bound by arithmetic: the tensor cores for bf16, the fp32 FMA pipes for
// fp32 inputs (which must stay exact fp32, so no TF32).  At the serving
// path's lengths a call is short (a few µs of tensor-core work), so what
// else costs time is latency: how fast tiles arrive, and how long the
// block with the most K tiles runs.
//
// bf16, every head dim (16–256): a warp-specialised wgmma body.
// * One block = `consumers` consumer warpgroups + one producer warpgroup:
//   two consumers; one at head_dim 256; two or three at head_dim 64 (see
//   Cfg).  A consumer holds 64 rows packing `group` q heads of one KV
//   group: row r is position first + r / group, head h0 + r % group
//   (group: the largest of 8/4/2/1 dividing H / KV), so each K/V tile it
//   reads serves `group` heads.  A block is one work item: one position
//   tile of one head group.  It runs in one of two modes:
//   - shared: the consumers hold consecutive rows and read the same K/V
//     tiles, each walking its own range, so a tile serves 64 × consumers
//     rows;
//   - split (two consumers): both hold the same 64 rows and cut the
//     block's K tiles between them, each with its own online softmax; the
//     second hands its (m, l, O) to the first through shared memory, which
//     merges and stores.  Twice the blocks, each walking half as far.
// * flash_attention.py::flash_grid picks consumers and mode from static
//   shapes and the SM count: the one whose predicted makespan (the last SM
//   to finish, in K-tile steps, under the greedy list schedule of the
//   blocks in the order they are issued) is least.  Three consumers fill
//   the card where two leave a second wave mostly empty (whisper_small's
//   non-causal encoder: 96 blocks of 192 rows at S = 1500 against 144 of
//   128 on 132 SMs).
// * The producer's one thread brings Q (a 4-d TMA box: Dh chunk × group
//   heads × positions) and then each K/V tile into a ring of stages by TMA
//   with the swizzle the wgmma descriptors read (split: the two
//   consumers' tiles in turns, so each stage's entries are one consumer's
//   and no parity wait can see a phase two back), signalling `full`
//   mbarriers; consumers release a stage through its `empty` mbarrier and
//   never issue copies.  setmaxnreg hands the producer's registers (down
//   to 24) to the consumers.
// * S = Q·Kᵀ is wgmma m64n64k16 with both operands in shared memory; the
//   S accumulator, rounded to bf16, is the A operand of O += P·V, a
//   register-A wgmma m64nDHk16 whose B (V) is read MN-major (transposed).
//   The (m, l) carry and O stay fp32 in registers.
// * Only the tiles that straddle an edge (causal diagonal, window's lower
//   edge, valid_len, S) take the elementwise mask; exp2 with
//   scale·log2(e) folded into one FMA.  Masked scores are −inf inside the
//   kernel and a row max of −inf is taken as 0, so a row with nothing
//   unmasked yet adds nothing (exp2(−inf) = 0) and a row with nothing
//   unmasked at all gives zeros.
// * Blocks start heavy first: under a causal mask from the last position
//   tile to the first, so the last wave is short
//   (flash_attention.py::work_item).
// * Out-of-range Q/K/V rows arrive from TMA as zeros: a masked p of 0
//   never meets garbage in V (0 · NaN = NaN); rows past S are not stored.
//
// fp32 (it takes no plan): K and V tiles of 64 rows are staged in shared
// memory as fp32 (K transposed, padded rows), four threads share a q row
// and do fp32 FMAs; row max and sum reduce over the quad with two
// shuffles, and P reaches the P·V loop through shuffles.  Masked scores are −inf there too, so a
// row with nothing unmasked gives zeros in both bodies.
//
// GQA is routed in the indexing (kv head = h / G): the kernel reads the
// (B, S, KV, Dh) K/V directly, nothing is repeated per group.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "common.cuh"
#include "mma.cuh"
#include "wgmma.cuh"

namespace repro_torch {
namespace {


// ---------------------------------------------------------------------
// bf16: the warp-specialised wgmma body.
namespace wg {

constexpr int WG_ROWS = 64;      // rows per consumer warpgroup (one wgmma M)
constexpr int BK = 64;           // K/V positions per tile (flash_attention.py::BK)
constexpr int PRODUCER_REGS = 24;

template <int DH, int CONS>
struct Cfg {
  // consumer warpgroups per block (flash_attention.py::consumer_counts).
  // Two make the kernel enter with 168 registers a thread (65,536 / 384),
  // and ptxas keeps the consumers to that, which the 64×256 fp32 output of
  // head_dim 256 does not fit; there one consumer (up to 255) walks alone.
  // Three (head_dim 64 only) enter with 128, which its 64×64 output
  // fits: a K/V tile then serves 192 rows
  static constexpr int CONSUMERS = CONS;
  static_assert(CONS == (DH == 256 ? 1 : CONS) && (CONS < 3 || DH == 64), "consumers");
  static constexpr int THREADS = 128 * (CONSUMERS + 1);
  // what setmaxnreg hands each consumer thread: all but the producer's 24
  static constexpr int CONSUMER_REGS = CONS == 3 ? 160 : 240;
  // a tile's rows are cut into chunks of one swizzle span: 128 bytes (64
  // elements) where Dh allows, else the whole row (32 or 64 bytes)
  static constexpr int SWB = DH * 2 >= 128 ? 128 : DH * 2;
  static constexpr int CW = SWB / 2;                       // elements per chunk row
  static constexpr int CHUNKS = DH / CW;
  static constexpr uint32_t SWIZZLE = SWB == 128 ? 1 : (SWB == 64 ? 2 : 3);  // descriptor
  static constexpr int Q_CHUNK = WG_ROWS * SWB;            // 64 rows of one chunk
  static constexpr int KV_CHUNK = BK * SWB;                // BK rows of one chunk
  static constexpr int Q_BYTES = WG_ROWS * DH * 2;         // one warpgroup's Q, bf16
  static constexpr int KV_BYTES = BK * DH * 2;             // one K (or V) tile
  static constexpr int STAGES = DH == 256 ? 3 : 4;         // K/V ring
  // the second consumer's partial (m, l, O) for the split merge (two
  // consumers only): per thread DH/2 + 4 floats, stored [register][thread]
  static constexpr int MERGE_BYTES = CONSUMERS == 2 ? (DH / 2 + 4) * 128 * 4 : 0;
  static constexpr size_t SMEM = 1024 + (size_t)Q_BYTES * CONSUMERS +
                                 (size_t)KV_BYTES * 2 * STAGES + MERGE_BYTES;  // + alignment
  static_assert(SMEM <= kMaxSmemBytes - 256, "shared memory");
  // byte offset (16-byte units) of k step kk in a K-major tile of `chunk`
  // bytes per chunk: 32 bytes per step inside a swizzle span
  __host__ __device__ static constexpr int koff(int kk, int chunk) {
    return ((kk / (CW / 16)) * chunk + (kk % (CW / 16)) * 32) >> 4;
  }
};

// K tiles [t0, t1) that positions [first, first + count) ∩ [0, S) walk
// (flash_attention.py::kv_tiles); t0 == t1 == 0 when none.
__device__ __forceinline__ void kv_tiles(int S, int first, int count, int causal,
                                         int window, int valid_len, int& t0, int& t1) {
  t0 = t1 = 0;
  if (first >= S) return;
  const int last = min(first + count, S) - 1;
  const int end = causal ? min(valid_len, last + 1) : valid_len;
  const int begin = window > 0 ? max(0, first - window + 1) : 0;
  if (begin >= end) return;
  t0 = begin / BK;
  t1 = (end + BK - 1) / BK;
}

// Whether K tile t needs the elementwise mask for those positions
// (flash_attention.py::tile_masked).
__device__ __forceinline__ bool tile_masked(int S, int first, int count, int t,
                                            int causal, int window, int valid_len) {
  const int last = min(first + count, S) - 1;
  const int k0 = t * BK, k1 = t * BK + BK - 1;
  const bool inside = k1 < valid_len && (!causal || k1 <= first) &&
                      (window == 0 || k0 > last - window);
  return !inside;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int DH, bool SPLIT, int CONS>
__global__ void __launch_bounds__(Cfg<DH, CONS>::THREADS, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       __nv_bfloat16* __restrict__ o, int B, int S, int H, int KV,
                       int causal, int window, int valid_len, int group,
                       float scale_log2) {
  using C = Cfg<DH, CONS>;
  constexpr int CONSUMERS = C::CONSUMERS;
  constexpr bool split = SPLIT && CONSUMERS > 1;
  static_assert(!split || CONSUMERS == 2, "split: two consumers");
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[C::STAGES];
  __shared__ __align__(8) uint64_t empty_bar[C::STAGES];
  __shared__ __align__(8) uint64_t q_bar;
  // TMA's swizzle repeats every 1024 bytes: tiles start on that boundary
  uint8_t* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* Qs = base;                                  // [CONSUMERS][CHUNKS][64][CW]
  uint8_t* Ks = Qs + CONSUMERS * C::Q_BYTES;           // [STAGES][CHUNKS][BK][CW]
  uint8_t* Vs = Ks + C::STAGES * C::KV_BYTES;          // [STAGES][CHUNKS][BK][CW]
  float* merge = reinterpret_cast<float*>(Vs + C::STAGES * C::KV_BYTES);

  // the work item (flash_attention.py::work_item): heavy first, so
  // position tiles from the last to the first under a causal mask
  const int G = H / KV;
  const int heads = G / group;
  const int positions = (split ? WG_ROWS : WG_ROWS * CONSUMERS) / group;
  const int ptiles = (S + positions - 1) / positions;
  const int per = B * KV * heads;
  const int ptile = causal ? ptiles - 1 - (int)(blockIdx.x / per) : (int)(blockIdx.x / per);
  int r = blockIdx.x % per;
  const int hg = r % heads;
  r /= heads;
  const int kvh = r % KV;
  const int b = r / KV;
  const int h0 = kvh * G + hg * group;
  const int p0 = ptile * positions;

  // Which K tiles each consumer walks (flash_attention.py::consumer_tiles).
  // Shared: consumer w holds positions p0 + w·wpos … (wpos of them) and
  // walks its own range; the ring holds the block's range [bt0, bt1) in
  // order, every entry for both consumers.  Split: both hold positions
  // p0 …, the block's range is cut (split_tiles) and consumer w's j-th
  // tile is ring entry j·CONSUMERS + w, so both walk at once.
  const int wpos = split ? positions : positions / CONSUMERS;
  int wt0[CONSUMERS], wt1[CONSUMERS];
  int bt0 = 0x7fffffff, bt1 = 0;
#pragma unroll
  for (int w = 0; w < CONSUMERS; ++w) {
    kv_tiles(S, p0 + (split ? 0 : w * wpos), wpos, causal, window, valid_len, wt0[w],
             wt1[w]);
    if (wt0[w] < wt1[w]) {
      bt0 = min(bt0, wt0[w]);
      bt1 = max(bt1, wt1[w]);
    }
  }
  if (bt1 == 0) bt0 = 0;
  const int n = bt1 - bt0;                          // ring entries
  const int cut = (n + CONSUMERS - 1) / CONSUMERS;  // split: tiles per consumer

  const int tid = threadIdx.x;
  const int wgi = __shfl_sync(0xffffffffu, tid / 128, 0);  // warp-uniform role
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full_bar[s], 1);
      // one arrival per warp of the consumers an entry is for
      mbar_init(&empty_bar[s], split ? 4 : 4 * CONSUMERS);
    }
    mbar_init(&q_bar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (wgi == CONSUMERS) {
    // ---- producer: one thread issues every copy
    if constexpr (CONSUMERS > 1) setmaxnreg_dec<PRODUCER_REGS>();
    if (tid == CONSUMERS * 128) {
      const int nq = split ? 1 : CONSUMERS;
      uint32_t q_bytes = 0;
      for (int w = 0; w < nq; ++w)
        if (p0 + w * wpos < S) q_bytes += C::Q_BYTES;
      mbar_expect_tx(&q_bar, q_bytes);
      for (int w = 0; w < nq; ++w) {
        if (p0 + w * wpos >= S) continue;
#pragma unroll
        for (int c = 0; c < C::CHUNKS; ++c)
          tma_load_4d(Qs + w * C::Q_BYTES + c * C::Q_CHUNK, &qmap, &q_bar, c * C::CW, h0,
                      p0 + w * wpos, b);
      }
      for (int k = 0; k < n; ++k) {
        const int t = split ? bt0 + (k % CONSUMERS) * cut + k / CONSUMERS : bt0 + k;
        const int stage = k % C::STAGES;
        mbar_wait(&empty_bar[stage], ((k / C::STAGES) & 1) ^ 1);
        mbar_expect_tx(&full_bar[stage], 2 * C::KV_BYTES);
#pragma unroll
        for (int c = 0; c < C::CHUNKS; ++c) {
          tma_load_4d(Ks + stage * C::KV_BYTES + c * C::KV_CHUNK, &kmap,
                      &full_bar[stage], c * C::CW, kvh, t * BK, b);
          tma_load_4d(Vs + stage * C::KV_BYTES + c * C::KV_CHUNK, &vmap,
                      &full_bar[stage], c * C::CW, kvh, t * BK, b);
        }
      }
    }
  } else {
    // ---- consumers
    if constexpr (CONSUMERS > 1) setmaxnreg_inc<C::CONSUMER_REGS>();
    const int first = p0 + (split ? 0 : wgi * wpos);
    // the ring entries this consumer waits for: `total` of them, entry
    // e0 + j·es for j = 0 …, the j-th being K tile base + j; of these its
    // own tiles are j in [lead, lead + own)
    int e0 = 0, es = 1, total = n, base_t = bt0, lead = 0, own = 0;
    {
      int my0 = wt0[0], my1 = wt1[0];
#pragma unroll
      for (int c = 1; c < CONSUMERS; ++c)
        if (wgi == c) {
          my0 = wt0[c];
          my1 = wt1[c];
        }
      if (split) {
        e0 = wgi;
        es = CONSUMERS;
        base_t = bt0 + wgi * cut;
        total = own = max(0, min(cut, n - wgi * cut));
      } else if (my0 < my1) {
        lead = my0 - bt0;
        own = my1 - my0;
      }
    }

    const int lane = tid & 31, warp = (tid & 127) >> 5;
    // this thread's two rows (the accumulator's rows lane/4 and lane/4 + 8
    // of its warp's 16): position, output offset, unmasked keys [lo, hi)
    int pos[2], lo[2], hi[2];
    long goff[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int rr = 16 * warp + (lane >> 2) + 8 * i;
      pos[i] = first + rr / group;
      goff[i] = ((long)(b * S + pos[i]) * H + h0 + rr % group) * DH;
      hi[i] = causal ? min(valid_len, pos[i] + 1) : valid_len;
      lo[i] = window > 0 ? pos[i] - window + 1 : -0x40000000;
    }
    float oacc[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) oacc[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    constexpr int NS = BK / 2;  // score registers per thread
    // descriptor words: Q and K K-major, V MN-major (Dh spans chunks of CW
    // at KV_CHUNK bytes); 8 rows of one chunk apart in the stride dimension
    constexpr uint32_t HI = wgmma_desc_hi(8 * C::SWB, C::SWIZZLE);
    const uint32_t q_lo = wgmma_desc_lo(smem_addr(Qs + (split ? 0 : wgi) * C::Q_BYTES), 16);

    // S = Q·Kᵀ (64 × BK) of the tile in `stage`, both K-major in shared
    // memory; committed, not waited for
    auto issue_qk = [&](float (&sc)[NS], int stage) {
      const uint32_t k_lo = wgmma_desc_lo(smem_addr(Ks + stage * C::KV_BYTES), 16);
      wgmma_fence();
      static_for<0, DH / 16>([&](auto kk) {
        constexpr int K = decltype(kk)::value;
        wgmma_ss<BK, C::koff(K, C::Q_CHUNK), C::koff(K, C::KV_CHUNK)>(sc, q_lo, k_lo, HI,
                                                                     K > 0);
      });
      wgmma_commit();
    };
    // O += P·V of the tile in `stage`; committed, not waited for
    auto issue_pv = [&](const uint32_t (&pa)[BK / 16][4], int stage) {
      const uint32_t v_lo = wgmma_desc_lo(smem_addr(Vs + stage * C::KV_BYTES), C::KV_CHUNK);
      wgmma_fence();
      static_for<0, BK / 16>([&](auto kk) {
        constexpr int K = decltype(kk)::value;
        wgmma_rs_tb<DH, ((K * 16 * C::SWB) >> 4)>(oacc, pa[K], v_lo, HI);
      });
      wgmma_commit();
    };
    // mask (edge tiles only), online softmax: sc becomes p; returns the
    // rescale factor of each row's earlier sum in alpha
    auto softmax = [&](float (&sc)[NS], int t, float (&alpha)[2]) {
      // element i: row (i >> 1) & 1, key 8·(i >> 2) + 2·(lane & 3) + (i & 1)
      if (tile_masked(S, first, wpos, t, causal, window, valid_len)) {
        const int k0 = t * BK + 2 * (lane & 3);
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          const int kpos = k0 + 8 * (i >> 2) + (i & 1);
          const int ri = (i >> 1) & 1;
          if (kpos < lo[ri] || kpos >= hi[ri]) sc[i] = -INFINITY;
        }
      }
      float mx[2] = {-INFINITY, -INFINITY}, neg[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < NS; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
#pragma unroll
      for (int ri = 0; ri < 2; ++ri) {
        mx[ri] = fmaxf(mx[ri], __shfl_xor_sync(0xffffffffu, mx[ri], 1));
        mx[ri] = fmaxf(mx[ri], __shfl_xor_sync(0xffffffffu, mx[ri], 2));
        const float m_new = fmaxf(m[ri], mx[ri]);
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        alpha[ri] = ex2((m[ri] - m_use) * scale_log2);
        neg[ri] = -m_use * scale_log2;
        m[ri] = m_new;
      }
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        sc[i] = ex2(fmaf(sc[i], scale_log2, neg[(i >> 1) & 1]));
        rs[(i >> 1) & 1] += sc[i];
      }
      // l stays a per-thread partial sum until the end
#pragma unroll
      for (int ri = 0; ri < 2; ++ri) l[ri] = l[ri] * alpha[ri] + rs[ri];
    };
    // P as bf16 A fragments: keys 16·kk … 16·kk + 15
    auto to_frags = [&](const float (&sc)[NS], uint32_t (&pa)[BK / 16][4]) {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          pa[kk][j] = pack_bf16(sc[8 * kk + 2 * j], sc[8 * kk + 2 * j + 1]);
      }
    };
    auto rescale = [&](const float (&alpha)[2]) {
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) oacc[i] *= alpha[(i >> 1) & 1];
    };
    auto release = [&](int st) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty_bar[st]);
    };
    auto entry_stage = [&](int j) { return (e0 + j * es) % C::STAGES; };
    auto entry_phase = [&](int j) { return ((e0 + j * es) / C::STAGES) & 1; };
    auto skip = [&](int j) {  // an entry of the block's that is not ours
      const int st = entry_stage(j);
      mbar_wait(&full_bar[st], entry_phase(j));
      release(st);
    };

    mbar_wait(&q_bar, 0);
    for (int j = 0; j < lead; ++j) skip(j);
    if (own > 0) {
      float sc[NS], alpha[2];
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int i = 0; i < NS; ++i) sc[i] = 0.f;
      int stage = entry_stage(lead);
      mbar_wait(&full_bar[stage], entry_phase(lead));
      issue_qk(sc, stage);
      wgmma_wait<0>();
      fence_regs(sc);
      softmax(sc, base_t + lead, alpha);
      to_frags(sc, pa);
      int prev = stage;
      // steady state: S(t) and P·V(t − 1) are issued together, and the
      // softmax of S(t) runs while P·V(t − 1) is still on the tensor cores
      for (int j = lead + 1; j < lead + own; ++j) {
        stage = entry_stage(j);
        mbar_wait(&full_bar[stage], entry_phase(j));
        issue_qk(sc, stage);
        issue_pv(pa, prev);
        wgmma_wait<1>();  // S(t) done, P·V(t − 1) may still run
        fence_regs(sc);
        softmax(sc, base_t + j, alpha);
        wgmma_wait<0>();
        fence_regs(oacc);
        release(prev);
        rescale(alpha);
        to_frags(sc, pa);
        prev = stage;
      }
      issue_pv(pa, prev);
      wgmma_wait<0>();
      fence_regs(oacc);
      release(prev);
    }
    for (int j = lead + own; j < total; ++j) skip(j);

    if constexpr (CONSUMERS > 1) if (split) {
      // merge: the second consumer's (m, l, O) goes to shared memory in
      // its accumulator layout, which is the first's, thread for thread
      const int lt = tid & 127;
      if (wgi == 1) {
#pragma unroll
        for (int i = 0; i < DH / 2; ++i) merge[i * 128 + lt] = oacc[i];
#pragma unroll
        for (int ri = 0; ri < 2; ++ri) {
          merge[(DH / 2 + ri) * 128 + lt] = m[ri];
          merge[(DH / 2 + 2 + ri) * 128 + lt] = l[ri];
        }
        __threadfence_block();
        named_arrive(1, 256);
        return;
      }
      named_sync(1, 256);
      float w0[2], w1[2];
#pragma unroll
      for (int ri = 0; ri < 2; ++ri) {
        const float m1 = merge[(DH / 2 + ri) * 128 + lt];
        const float l1 = merge[(DH / 2 + 2 + ri) * 128 + lt];
        const float m_new = fmaxf(m[ri], m1);
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        w0[ri] = ex2((m[ri] - m_use) * scale_log2);
        w1[ri] = ex2((m1 - m_use) * scale_log2);
        l[ri] = l[ri] * w0[ri] + l1 * w1[ri];
      }
#pragma unroll
      for (int i = 0; i < DH / 2; ++i)
        oacc[i] = oacc[i] * w0[(i >> 1) & 1] + merge[i * 128 + lt] * w1[(i >> 1) & 1];
    }

#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      l[ri] += __shfl_xor_sync(0xffffffffu, l[ri], 1);
      l[ri] += __shfl_xor_sync(0xffffffffu, l[ri], 2);
    }
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      if (pos[ri] >= S) continue;
      const float inv = 1.f / fmaxf(l[ri], 1e-20f);
      __nv_bfloat16* orow = o + goff[ri] + 2 * (lane & 3);
#pragma unroll
      for (int j = 0; j < DH / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) = __floats2bfloat162_rn(
            oacc[4 * j + 2 * ri] * inv, oacc[4 * j + 2 * ri + 1] * inv);
    }
  }
}

// cuTensorMapEncodeTiled from the driver, found once through the runtime
// (the library links nothing against libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &res) != cudaSuccess)
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &res) != cudaSuccess)
#endif
      return (EncodeTiled) nullptr;
    return res == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                              : (EncodeTiled) nullptr;
  }();
  return fn;
}

// A bf16 tensor (B, S, heads, Dh) as a 4-d TMA map, innermost first, with
// a box of one swizzle span of Dh × box_heads × box_rows positions × 1.
cudaError_t tensor_map(CUtensorMap* map, const void* ptr, int Dh, int heads, int S,
                       int B, int box_heads, int box_rows, int swb) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)Dh, (cuuint64_t)heads, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)Dh * 2, (cuuint64_t)heads * Dh * 2,
                                 (cuuint64_t)S * heads * Dh * 2};
  const cuuint32_t box[4] = {(cuuint32_t)(swb / 2), (cuuint32_t)box_heads,
                             (cuuint32_t)box_rows, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle sw = swb == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                : swb == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                            : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                        dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int DH, bool SPLIT, int CONS>
cudaError_t launch_kernel(const void* q, const void* k, const void* v, void* o, int B,
                          int S, int H, int KV, int causal, int window, int valid_len,
                          int group, cudaStream_t stream) {
  using C = Cfg<DH, CONS>;
  auto kernel = flash_fwd_wgmma_kernel<DH, SPLIT, CONS>;
  const int G = H / KV;
  // once per device: the shared-memory opt-in, and a check that the kernel
  // enters with the registers setmaxnreg hands out (else a consumer's
  // setmaxnreg.inc would wait for registers that never come)
  static std::atomic<unsigned long long> ready{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (!(ready.load(std::memory_order_relaxed) & bit)) {
    err = allow_smem(kernel, C::SMEM);
    if (err != cudaSuccess) return err;
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return err;
    if (C::CONSUMERS > 1 && attr.numRegs * C::THREADS <
                                (PRODUCER_REGS + C::CONSUMER_REGS * C::CONSUMERS) * 128)
      return cudaErrorInvalidConfiguration;
    ready.fetch_or(bit, std::memory_order_relaxed);
  }
  CUtensorMap qm, km, vm;
  if ((err = tensor_map(&qm, q, DH, H, S, B, group, WG_ROWS / group, C::SWB)) ||
      (err = tensor_map(&km, k, DH, KV, S, B, 1, BK, C::SWB)) ||
      (err = tensor_map(&vm, v, DH, KV, S, B, 1, BK, C::SWB)))
    return err;
  const int positions = (SPLIT ? WG_ROWS : WG_ROWS * C::CONSUMERS) / group;
  const long blocks = (long)((S + positions - 1) / positions) * B * KV * (G / group);
  if (blocks > 0x7fffffffL) return cudaErrorInvalidValue;
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)DH);
  kernel<<<(unsigned)blocks, C::THREADS, C::SMEM, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), B, S, H, KV, causal, window, valid_len,
      group, scale_log2);
  return cudaGetLastError();
}

// `consumers`: 2, 1 at head_dim 256, or 3 (shared only) at head_dim 64;
// `split`: the block's two consumers cut its K tiles
// (flash_attention.py::flash_grid)
template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int S,
                   int H, int KV, int causal, int window, int valid_len, int group,
                   int consumers, int split, cudaStream_t stream) {
  if (group < 1 || (H / KV) % group != 0 || WG_ROWS % group != 0)
    return cudaErrorInvalidValue;
#define REPRO_FLASH_LAUNCH(SP, CN)                                                       \
  return launch_kernel<DH, SP, CN>(q, k, v, o, B, S, H, KV, causal, window, valid_len, \
                                   group, stream)
  if constexpr (DH == 256) {
    if (consumers != 1 || split) return cudaErrorInvalidValue;
    REPRO_FLASH_LAUNCH(false, 1);
  } else {
    if (consumers == 2) {
      if (split) REPRO_FLASH_LAUNCH(true, 2);
      REPRO_FLASH_LAUNCH(false, 2);
    }
    if constexpr (DH == 64) {
      if (consumers == 3 && !split) REPRO_FLASH_LAUNCH(false, 3);
    }
    return cudaErrorInvalidValue;
  }
#undef REPRO_FLASH_LAUNCH
}

}  // namespace wg

// ---------------------------------------------------------------------
// fp32: the FMA body.
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

template <int DH>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
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
  const float* qb = q + (long)b * S * q_rs + (long)h * DH;
  const float* kb = k + (long)b * S * kv_rs + (long)kvh * DH;
  const float* vb = v + (long)b * S * kv_rs + (long)kvh * DH;

  for (int idx = tid; idx < BQ * DH; idx += THREADS) {
    const int r = idx / DH, d = idx % DH;
    const int s = q_start + r;
    Qs[r * QS + d] = (s < S) ? qb[(long)s * q_rs + d] : 0.f;
  }

  // K tiles this q tile needs: causal stops after the tile's last row,
  // a window starts at the first row's window edge
  int k_end = valid_len;
  if (causal) k_end = min(k_end, q_start + BQ);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q_start - window + 1);
  k_begin = (k_begin / BK) * BK;

  float m = -INFINITY, l = 0.f;
  float acc[DH / TPR];
#pragma unroll
  for (int i = 0; i < DH / TPR; ++i) acc[i] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // previous tile fully consumed
    for (int idx = tid; idx < BK * DH; idx += THREADS) {
      const int r = idx / DH, d = idx % DH;
      const int s = k0 + r;
      const bool in = s < S;
      Kt[d * KT + r] = in ? kb[(long)s * kv_rs + d] : 0.f;
      Vs[r * DH + d] = in ? vb[(long)s * kv_rs + d] : 0.f;
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
    float mcur = -INFINITY;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const int kpos = k0 + 4 * sub + 16 * (n / 4) + (n % 4);
      bool ok = kpos < valid_len;
      if (causal) ok = ok && (kpos <= qpos);
      if (window > 0) ok = ok && (kpos > qpos - window);
      sc[n] = ok ? sc[n] * scale : -INFINITY;
      mcur = fmaxf(mcur, sc[n]);
    }
    mcur = fmaxf(mcur, __shfl_xor_sync(FULL, mcur, 1));
    mcur = fmaxf(mcur, __shfl_xor_sync(FULL, mcur, 2));
    const float m_new = fmaxf(m, mcur);
    // a row max of −inf (nothing unmasked yet) is taken as 0: p = 0
    const float m_use = m_new == -INFINITY ? 0.f : m_new;
    const float alpha = expf(m - m_use);
    float psum = 0.f;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      sc[n] = expf(sc[n] - m_use);
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
    float* orow = o + ((long)b * S + qpos) * q_rs + (long)h * DH + 4 * sub;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) orow[16 * i + e] = acc[4 * i + e] / den;
    }
  }
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B,
                   int S, int H, int KV, int causal, int window, int valid_len,
                   cudaStream_t stream) {
  const size_t smem = flash_smem_floats<DH>() * sizeof(float);
  cudaError_t err = allow_smem(flash_fwd_kernel<DH>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  const float scale = 1.0f / sqrtf((float)DH);
  flash_fwd_kernel<DH><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, H, KV, causal, window,
      valid_len, scale);
  return cudaGetLastError();
}

cudaError_t dispatch(int Dh, const void* q, const void* k, const void* v,
                     void* o, int B, int S, int H, int KV, int causal,
                     int window, int valid_len, cudaStream_t st) {
  switch (Dh) {
    case 16: return launch<16>(q, k, v, o, B, S, H, KV, causal, window, valid_len, st);
    case 32: return launch<32>(q, k, v, o, B, S, H, KV, causal, window, valid_len, st);
    case 64: return launch<64>(q, k, v, o, B, S, H, KV, causal, window, valid_len, st);
    case 128: return launch<128>(q, k, v, o, B, S, H, KV, causal, window, valid_len, st);
    case 256: return launch<256>(q, k, v, o, B, S, H, KV, causal, window, valid_len, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro_torch

// q: (B, S, H, Dh), k/v: (B, S, KV, Dh), o: (B, S, H, Dh), all contiguous,
// one dtype; valid_len in [1, S]; bf16 packs `group` q heads per tile, runs
// `consumers` consumer warpgroups a block and `split`s the K tiles between
// them or not (flash_attention.py::flash_grid); fp32 takes none of these.
// Returns cudaGetLastError() after the launch.
extern "C" int repro_flash_attention_fwd(const void* q, const void* k, const void* v,
                                         void* o, int B, int S, int H, int KV, int Dh,
                                         int causal, int window, int valid_len, int group,
                                         int consumers, int split, int dtype, void* stream) {
  using namespace repro_torch;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV != 0 || valid_len < 1 || valid_len > S ||
      window < 0)
    return cudaErrorInvalidValue;
  if (dtype == kFloat32) {
    if ((long)B * H > 65535) return cudaErrorInvalidValue;  // grid y: B·H
    return dispatch(Dh, q, k, v, o, B, S, H, KV, causal, window, valid_len, st);
  }
  if (dtype == kBFloat16) {
#define REPRO_FLASH_WG(D)                                                                  \
  case D:                                                                                  \
    return wg::launch<D>(q, k, v, o, B, S, H, KV, causal, window, valid_len, group, consumers, \
                         split, st)
    switch (Dh) {
      REPRO_FLASH_WG(16);
      REPRO_FLASH_WG(32);
      REPRO_FLASH_WG(64);
      REPRO_FLASH_WG(128);
      REPRO_FLASH_WG(256);
      default: return cudaErrorInvalidValue;
    }
#undef REPRO_FLASH_WG
  }
  return cudaErrorInvalidValue;
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
