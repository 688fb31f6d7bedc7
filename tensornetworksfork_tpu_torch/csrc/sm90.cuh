// Hopper (sm_90a) building blocks shared by the tensor-core Gram kernels of
// wgram.cu (bf16 and 3xTF32 wgmma, and the bf16 Gram fed by TMA multicast)
// and qgram.cu (s8 wgmma fed by TMA): shared-memory addresses, cp.async,
// wgmma's fences and its K-major descriptor, setmaxnreg, mbarriers, the 2-D
// TMA load, thread-block clusters (rank, barrier, remote arrive, multicast
// load), and on the host the tensor-map encoder. Everything is in an
// anonymous namespace, so each source that includes it has its own copy.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
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

// A warpgroup's registers a thread: give some back (a producer) or take
// more (a consumer); every warp of the warpgroup executes it.
template <int N> __device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N> __device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
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

// ------------------------------------------------------------- clusters
// This CTA's rank in its cluster.
__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of every CTA of the cluster: what each did before is visible
// to all after (each CTA's barrier inits before a peer's copy or arrival).
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n"
               ::: "memory");
}

// Arrive on the mbarrier at `bar`'s offset in the shared memory of CTA `cta`
// of the cluster (this CTA's own included).
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar, uint32_t cta) {
  asm volatile(
      "{\n.reg .b32 ra;\nmapa.shared::cluster.u32 ra, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [ra];\n}\n" ::"r"(smem_u32(bar)), "r"(cta)
      : "memory");
}

// tma_load_2d into every CTA of the cluster whose bit `mask` sets: the box
// lands at `dst`'s offset in each one's shared memory, and its bytes complete
// on the barrier at `bar`'s offset in each.
__device__ __forceinline__ void tma_load_2d_multicast(void* dst, const CUtensorMap* map,
                                                      uint64_t* bar, int c0, int c1,
                                                      uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%2, %3}], [%4], %5;\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar)), "h"(mask)
      : "memory");
}

// ------------------------------------------------------------ host side
// cuTensorMapEncodeTiled, found through the runtime (the library does not
// link libcuda itself)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// Status codes beside cudaError_t's (which are positive)
constexpr int kNoEncoder = -1;        // libcuda has no cuTensorMapEncodeTiled
constexpr int kEncodeFailed = -1000;  // minus the CUresult of a failed encode

// A row-major 2-D operand (dims[1] rows of dims[0] values, rows `stride`
// bytes apart) as a TMA map of box[1] x box[0] boxes in 128-byte swizzle;
// elements past dims read as zero. Returns 0 or a status code above.
inline int encode_2d(CUtensorMap* map, CUtensorMapDataType type, const void* base,
                     cuuint64_t dim0, cuuint64_t dim1, cuuint64_t stride, cuuint32_t box0,
                     cuuint32_t box1) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return kNoEncoder;
  const cuuint64_t dims[2] = {dim0, dim1};
  const cuuint64_t strides[1] = {stride};
  const cuuint32_t box[2] = {box0, box1}, estr[2] = {1, 1};
  const CUresult r = fn(map, type, 2, const_cast<void*>(base), dims, strides, box, estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed - (int)r;
}

}  // namespace
