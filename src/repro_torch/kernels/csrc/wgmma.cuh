// Warpgroup tensor-core helpers for Hopper (sm_90a): wgmma.mma_async with
// fp32 accumulators, shared-memory matrix descriptors, TMA tensor loads and
// mbarriers, written as raw PTX (no CUTLASS headers, so the library builds
// in seconds).  Used by the flash kernel (flash_attention.cu); the SSD
// scan (ssd_scan.cu) takes its mbarriers.
//
// The wgmma wrappers spell out every accumulator register, as the PTX
// instruction requires; the widths differ in nothing else.
#pragma once

#include <cuda.h>
#include <stdint.h>

#include <type_traits>

#include "mma.cuh"

namespace repro_torch {

// --- mbarriers (shared::cta) ------------------------------------------
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

// Whether the phase of parity `parity` has completed.
__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the phase of parity `parity` has completed.  A wait of more
// than 2^34 cycles (~10 s) traps: a copy that never lands fails the launch
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > (1ll << 34)) __trap();
}

// --- named barriers (ids 1-15; 0 is __syncthreads) ----------------------
// `count` threads (a multiple of 32) complete a barrier: those that sync
// wait for it, those that arrive do not.
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// --- TMA ----------------------------------------------------------------
// A 4-d tile of `map` at coordinates (c0 innermost … c3) into shared memory
// at `dst`; completion counts the box's bytes on `bar`.  Out-of-range
// elements arrive as zeros.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3) : "memory");
}

// --- register budget (warp specialisation) -------------------------------
template <int N> __device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N> __device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// --- wgmma ----------------------------------------------------------------
// Shared-memory matrix descriptors: start address, leading and stride byte
// offsets (bytes; 16-byte units in the descriptor) and the swizzle mode
// (1 = 128-byte, 2 = 64-byte, 3 = 32-byte), which must match the TMA
// copy's.  Tiles start on 1024-byte boundaries, so the base offset is 0.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from touching accumulator registers across an
// in-flight wgmma (it does not know the asm writes them late).
template <int N> __device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Descriptors are passed as two 32-bit words: `lo` (start address and
// leading byte offset, wgmma_desc_lo) and `hi` (stride byte offset and
// swizzle, wgmma_desc_hi); the wrappers add a compile-time offset OFF (in
// 16-byte units) to the start address inside the asm, so a loop over k
// steps keeps one base register per operand instead of one descriptor
// per step.
__device__ __forceinline__ uint32_t wgmma_desc_lo(uint32_t saddr, uint32_t lbo) {
  return ((saddr & 0x3FFFF) >> 4) | (((lbo >> 4) & 0x3FFF) << 16);
}
__host__ __device__ constexpr uint32_t wgmma_desc_hi(uint32_t sbo, uint32_t swizzle) {
  return ((sbo >> 4) & 0x3FFF) | (swizzle << 30);
}

// Calls f(std::integral_constant<int, I>) for I in [B, E): a k-step loop
// whose step is a compile-time constant.
template <int B, int E, typename F>
__device__ __forceinline__ void static_for(F&& f) {
  if constexpr (B < E) {
    f(std::integral_constant<int, B>{});
    static_for<B + 1, E>(f);
  }
}

// d (64×N, fp32) (+)= A (64×16, K-major, shared) · B (16×N, K-major, shared),
// bf16 in; scale_d = 0 overwrites d.  A at lo_a + OA, B at lo_b + OB.
template <int N, int OA, int OB>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint32_t lo_a, uint32_t lo_b,
                                         uint32_t hi, int scale_d);

// d (64×N, fp32) += A (64×16 bf16, registers: the m16n8k16 A fragment of
// each warp's 16 rows) · B (16×N, MN-major in shared memory: transposed),
// B at lo_b + OB.
template <int N, int OB>
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[N / 2], const uint32_t (&a)[4],
                                            uint32_t lo_b, uint32_t hi);

template <int OA, int OB>
struct WgmmaSS64 {
  static __device__ __forceinline__ void run(float (&d)[32], uint32_t lo_a, uint32_t lo_b,
                                             uint32_t hi, int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        ".reg .b32 la, lb;\n"
        ".reg .b64 da, db;\n"
        "setp.ne.b32 p, %35, 0;\n"
        "add.u32 la, %32, %36;\n"
        "add.u32 lb, %33, %37;\n"
        "mov.b64 da, {la, %34};\n"
        "mov.b64 db, {lb, %34};\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "da, db, p, 1, 1, 0, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
        : "r"(lo_a), "r"(lo_b), "r"(hi), "r"(scale_d), "n"(OA), "n"(OB));
  }
};

template <int OB>
struct WgmmaRS16 {
  static __device__ __forceinline__ void run(float (&d)[8], const uint32_t (&a)[4],
                                             uint32_t lo_b, uint32_t hi) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        ".reg .b32 la, lb;\n"
        ".reg .b64 da, db;\n"
        "setp.ne.b32 p, %14, 0;\n"
        "add.u32 lb, %12, %15;\n"
        "mov.b64 db, {lb, %13};\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, db, p, 1, 1, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(lo_b), "r"(hi), "r"(1),
          "n"(OB));
  }
};

template <int OB>
struct WgmmaRS32 {
  static __device__ __forceinline__ void run(float (&d)[16], const uint32_t (&a)[4],
                                             uint32_t lo_b, uint32_t hi) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        ".reg .b32 la, lb;\n"
        ".reg .b64 da, db;\n"
        "setp.ne.b32 p, %22, 0;\n"
        "add.u32 lb, %20, %23;\n"
        "mov.b64 db, {lb, %21};\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, db, p, 1, 1, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(lo_b), "r"(hi), "r"(1),
          "n"(OB));
  }
};

template <int OB>
struct WgmmaRS64 {
  static __device__ __forceinline__ void run(float (&d)[32], const uint32_t (&a)[4],
                                             uint32_t lo_b, uint32_t hi) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        ".reg .b32 la, lb;\n"
        ".reg .b64 da, db;\n"
        "setp.ne.b32 p, %38, 0;\n"
        "add.u32 lb, %36, %39;\n"
        "mov.b64 db, {lb, %37};\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, db, p, 1, 1, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(lo_b), "r"(hi), "r"(1),
          "n"(OB));
  }
};

template <int OB>
struct WgmmaRS128 {
  static __device__ __forceinline__ void run(float (&d)[64], const uint32_t (&a)[4],
                                             uint32_t lo_b, uint32_t hi) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        ".reg .b32 la, lb;\n"
        ".reg .b64 da, db;\n"
        "setp.ne.b32 p, %70, 0;\n"
        "add.u32 lb, %68, %71;\n"
        "mov.b64 db, {lb, %69};\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, db, p, 1, 1, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(lo_b), "r"(hi), "r"(1),
          "n"(OB));
  }
};

template <int OB>
struct WgmmaRS256 {
  static __device__ __forceinline__ void run(float (&d)[128], const uint32_t (&a)[4],
                                             uint32_t lo_b, uint32_t hi) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        ".reg .b32 la, lb;\n"
        ".reg .b64 da, db;\n"
        "setp.ne.b32 p, %134, 0;\n"
        "add.u32 lb, %132, %135;\n"
        "mov.b64 db, {lb, %133};\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
        "{%128, %129, %130, %131}, db, p, 1, 1, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]),
        "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]),
        "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]),
        "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]),
        "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]),
        "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]),
        "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(lo_b), "r"(hi), "r"(1),
          "n"(OB));
  }
};

template <int N, int OA, int OB>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint32_t lo_a, uint32_t lo_b,
                                         uint32_t hi, int scale_d) {
  static_assert(N == 64, "S = Q·Kᵀ tiles are 64 keys wide");
  WgmmaSS64<OA, OB>::run(d, lo_a, lo_b, hi, scale_d);
}

template <int N, int OB>
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[N / 2], const uint32_t (&a)[4],
                                            uint32_t lo_b, uint32_t hi) {
  if constexpr (N == 16) WgmmaRS16<OB>::run(d, a, lo_b, hi);
  else if constexpr (N == 32) WgmmaRS32<OB>::run(d, a, lo_b, hi);
  else if constexpr (N == 64) WgmmaRS64<OB>::run(d, a, lo_b, hi);
  else if constexpr (N == 128) WgmmaRS128<OB>::run(d, a, lo_b, hi);
  else WgmmaRS256<OB>::run(d, a, lo_b, hi);
}

}  // namespace repro_torch
