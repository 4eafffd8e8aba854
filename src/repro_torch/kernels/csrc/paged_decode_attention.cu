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
// The body, what bounds it and what its design does about it are in
// decode_attention.cuh; here a tile (the split granule) is one page of the
// pool, found through the request's row of the page table.

#include "decode_attention.cuh"

// q/o: (B, H, Dh); k_pages/v_pages: (P, page, KV, Dh); page_table: (B, maxp)
// int32 with valid pool indices everywhere; lengths: (B,) int32; ws: fp32
// workspace of B·H·splits·(Dh + 2) floats, unused (may be null) when
// splits == 1.  All contiguous.  splits × tps pages cover maxp, none of
// the splits empty (decode_attention.py::split_plan).  Returns
// cudaGetLastError() after the launches.
extern "C" int repro_paged_decode_attention_fwd(
    const void* q, const void* k_pages, const void* v_pages,
    const void* page_table, const void* lengths, void* ws, void* o, int B, int H,
    int KV, int Dh, int page, int maxp, int splits, int tps, int dtype,
    void* stream) {
  using namespace repro_torch::decode;
  if (page <= 0 || maxp <= 0 || (long)page * maxp > 0x7fffffff)
    return cudaErrorInvalidValue;
  return run<false>(dtype, Dh, q, k_pages, v_pages, static_cast<const int*>(page_table),
                    static_cast<const int*>(lengths), ws, o, B, H, KV, page, maxp,
                    page * maxp, splits, tps, static_cast<cudaStream_t>(stream));
}
