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
// The body, what bounds it and what its design does about it are in
// decode_attention.cuh; here a tile (the split granule) is DENSE_TILE
// consecutive tokens of the cache.

#include "decode_attention.cuh"

// q/o: (B, H, Dh); k/v: (B, T, KV, Dh); lengths: (B,) int32 (clamped to T
// here too); ws: fp32 workspace of B·H·splits·(Dh + 2) floats, unused (may
// be null) when splits == 1.  All contiguous.  splits × tps tiles of
// DENSE_TILE tokens cover ⌈T / DENSE_TILE⌉, none of the splits empty
// (decode_attention.py::split_plan).  Returns cudaGetLastError() after the
// launches.
extern "C" int repro_decode_attention_fwd(const void* q, const void* k,
                                          const void* v, const void* lengths,
                                          void* ws, void* o, int B, int T, int H,
                                          int KV, int Dh, int splits, int tps,
                                          int dtype, void* stream) {
  using namespace repro_torch::decode;
  if (T <= 0) return cudaErrorInvalidValue;
  return run<true>(dtype, Dh, q, k, v, nullptr, static_cast<const int*>(lengths), ws,
                   o, B, H, KV, DENSE_TILE, (T + DENSE_TILE - 1) / DENSE_TILE, T,
                   splits, tps, static_cast<cudaStream_t>(stream));
}
