// Hopper (sm_90a) building blocks shared by the tensor-core Gram kernels of
// wgram.cu (bf16 and 3xTF32 wgmma) and qgram.cu (s8 wgmma fed by TMA):
// shared-memory addresses, cp.async, wgmma's fences and its K-major
// descriptor, mbarriers and the 2-D TMA load. Everything is device code in
// an anonymous namespace, so each source that includes it has its own copy.
#pragma once

#include <cuda.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// cp.async with zero fill: src_size 0 writes N zero bytes, reads nothing
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool pred) {
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "r"(pred ? 16 : 0) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "n"(N), "r"(pred ? N : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The 64 results of an m64n128 wgmma (operands %0..%63); the descriptors
// and the accumulate flag follow as %64, %65, %66.
#define TNF_WG_D64 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// generic-proxy writes to shared memory (cp.async, st.shared) made visible to
// wgmma's reads, which go through the async proxy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Descriptor of a K-major 128-byte-swizzle operand tile at byte address
// `saddr` (1 KB aligned, or a 32-byte step into such a tile): 1 KB atoms of
// 8 rows (output columns) x 128 bytes of the summed dimension, row m at
// (m / 8) KB + (m % 8) * 128, its 16-byte chunk c at slot c ^ (m % 8). Stride
// byte offset 1 KB (the next 8 rows); the leading byte offset is unused (a
// stage's depth is one swizzle row). A wgmma's k-slice of 32 bytes (8 TF32
// or 32 int8 values) starts `32 * slice` bytes further.
__device__ __forceinline__ uint64_t tdesc(uint32_t saddr) {
  return (uint64_t)((saddr >> 4) & 0x3FFF) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

// ------------------------------------------------------------ mbarriers
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
// barrier inits made visible to the async proxy (TMA) and the other threads
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// arrive and expect `bytes` more from asynchronous copies in this phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes) : "memory");
}
// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred P1;\nTNF_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra TNF_DONE;\nbra TNF_WAIT;\nTNF_DONE:\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity) : "memory");
}

// 2-D TMA load of one box of `map` at coordinates (c0 innermost, c1) into
// shared memory at `dst`; the box's bytes (out-of-bounds elements read as
// zero, and count) complete on the barrier's transaction count.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

}  // namespace
