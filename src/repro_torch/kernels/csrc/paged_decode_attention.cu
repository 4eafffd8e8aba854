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
// The block body, what bounds it and what its design does about it are in
// decode_attention.cuh; here a tile is one page of the pool, found through
// the request's row of the page table.

#include "decode_attention.cuh"

// q/o: (B, H, Dh); k_pages/v_pages: (P, page, KV, Dh); page_table: (B, maxp)
// int32 with valid pool indices everywhere; lengths: (B,) int32.  All
// contiguous.  Returns cudaGetLastError() after the launch.
extern "C" int repro_paged_decode_attention_fwd(
    const void* q, const void* k_pages, const void* v_pages,
    const void* page_table, const void* lengths, void* o, int B, int H,
    int KV, int Dh, int page, int maxp, int dtype, void* stream) {
  using namespace repro_torch::decode;
  const int elem = dtype == repro_torch::kFloat32 ? 4 : 2;
  if (B <= 0 || KV <= 0 || H % KV != 0 || page <= 0 || page > MAX_TILE ||
      warps_for(H / KV) > MAX_WARPS ||
      smem_bytes(H / KV, Dh, page, elem) > repro_torch::kMaxSmemBytes)
    return cudaErrorInvalidValue;
  return dispatch_dtype<false>(dtype, Dh, q, k_pages, v_pages,
                               static_cast<const int*>(page_table),
                               static_cast<const int*>(lengths), o, B, H, KV,
                               page, maxp, static_cast<cudaStream_t>(stream));
}
