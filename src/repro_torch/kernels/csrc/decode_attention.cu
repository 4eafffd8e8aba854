// Dense decode attention for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py
// (decode_attention_fwd, body _decode_kernel with _softmax_accumulate):
// one query token per head attends over its request's dense cache
// k/v (B, T, KV, Dh), with an fp32 online softmax over the blocks whose
// start lies below lengths[b]; positions at or past lengths[b] are masked
// with -1e30 and the output is acc / max(l, 1e-20), so a row of length 0
// gives 0.  The TPU wrapper repeated K/V per GQA group into rows
// (B·KV·G, T, Dh) and padded T; this kernel reads the cache as it lies,
// once per KV head, and zero-fills the ragged last tile in shared memory
// instead of reading past the cache.
//
// The block body, what bounds it and what its design does about it are in
// decode_attention.cuh; here a tile is `tile` consecutive tokens of the
// cache: 64 where shared memory allows, halved until it fits (fp32 with
// head_dim 256).

#include "decode_attention.cuh"

// q/o: (B, H, Dh); k/v: (B, T, KV, Dh); lengths: (B,) int32 (clamped to T
// here too).  All contiguous.  Returns cudaGetLastError() after the launch.
extern "C" int repro_decode_attention_fwd(const void* q, const void* k,
                                          const void* v, const void* lengths,
                                          void* o, int B, int T, int H, int KV,
                                          int Dh, int dtype, void* stream) {
  using namespace repro_torch::decode;
  if (B <= 0 || T <= 0 || KV <= 0 || H % KV != 0 ||
      warps_for(H / KV) > MAX_WARPS)
    return cudaErrorInvalidValue;
  const int elem = dtype == repro_torch::kFloat32 ? 4 : 2;
  int tile = MAX_TILE;
  const size_t limit = repro_torch::kMaxSmemBytes;
  while (tile > 16 && smem_bytes(H / KV, Dh, tile, elem) > limit) tile /= 2;
  if (smem_bytes(H / KV, Dh, tile, elem) > limit) return cudaErrorInvalidValue;
  return dispatch_dtype<true>(dtype, Dh, q, k, v, nullptr,
                              static_cast<const int*>(lengths), o, B, H, KV,
                              tile, T, static_cast<cudaStream_t>(stream));
}
