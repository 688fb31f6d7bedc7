// The float Gram kernels, hand-written for Hopper (sm_90a): the split Gram
// and, for K6 on f32 operands, the 3xTF32 Gram (at the end of this file).
//
// Replaces five Pallas kernels of tensornetworksfork_tpu/ops/pallas/gram.py:
//   _weighted_gram_jit       (K9: _weighted_kernel_tiled / _syrk_weighted_kernel)
//   _own_out_gram_jit        (K11: _make_own_out_kernel)
//   _gram_pair_jit           (K10: _pair_kernel_tiled, the flat symmetric Gram)
//   _weighted_gram_tiled_jit (K7: _make_weighted_kernel_tiled_acc)
//   _gram_pair_tiled_jit     (K6: _pair_kernel_tiled with a carry; K5,
//                             _add_packed_upper_jit, is its epilogue)
// K6 in bf16 runs on the clustered bf16 Gram (cluster_wgram_bf16_kernel)
// where TMA can address its operands, else on the split Gram; in f32 on
// gram_tf32x3_kernel. The split Gram computes, per class pair pq (K9, K10, K7, K6: one, pq = 0),
//   A_pq[d, e] (+)= sum_r round_T(X[r, d] * h[r * hstride + pq]) * Y[r, e]
// with the weighted operand multiplied in f32 and rounded once to the operand
// type T, as the reference's (j1 * w).astype(j1.dtype); Y = X for K9, K11 and
// K7, Y = K = H.J for K10, which has no weights (h null: X as it is). K9, K10
// and K7 need the upper triangle only; K11's blocks are whole (not symmetric
// in d for p != q, and for p = q only up to the rounding of the weighted
// operand). K7 and K6 add into a carry (has_acc): out = out + chunk sum.
//
// What bounds them on an H100 (132 SMs, 67 TFLOP/s f32 FMA, 989 TFLOP/s bf16
// and 495 TFLOP/s TF32 tensor cores, 3.35 TB/s):
//   K9,  65,536 x 1,032 f32, upper: 6.99e10 FLOP -> 1.04 ms (bytes 0.08 ms);
//   K11, 65,536 rows, C=1, DJ=1,032 f32, whole: 1.40e11 FLOP -> 2.08 ms;
//   K11, 8,192 rows, C=9 (45 pairs), DJ=900 bf16: 5.97e11 FLOP -> 0.60 ms on
//        the tensor cores (8.9 ms on f32 FMA); its 81 x Dp^2 f32 output 0.09 ms;
//   K10, 73,728 x 900 (the conv-TT flagship's A4), upper: 5.98e10 FLOP. bf16:
//        bytes, 0.080 ms for the two operands (0.060 ms of tensor-core work);
//        f32: operations, 0.89 ms (bytes 0.16 ms);
//   K7,  512 x 8,256 (Dp 8,704; the regression's A2 chunk) f32 with a carry,
//        upper over D: 3.49e10 FLOP -> 0.52 ms (bytes, the carry read and
//        written once, 0.17 ms);
//   K6,  18,432 x 16,200 (Dp 16,384; the flagship's A2/A3 chunk) with a
//        carry, upper over D: 4.84e12 FLOP -> bf16 4.9 ms on the tensor cores;
//        f32 on three TF32 products, 29 ms (72 ms on f32 FMA).
// So all but K10 in bf16 are bound by operations on paper. K6 in bf16 is
// bound by its reads from L2 first: each of its 8,128 CTAs reads two
// 128-column strips of all 18,432 rows, 8,128 x 18,432 x 2 x 128 x 2 B =
// 76.7 GB a call, 64 FLOP a byte; at the ~7.7-7.9 TB/s the int8 Gram (K3,
// qgram.cu, TMA-fed) draws from L2 that is ~10 ms, and 989 TFLOP/s would
// take 15.5 TB/s. Only reuse of a loaded strip by more than one tile lifts
// that, so K6 in bf16 runs in clusters of 2 x 2 tiles, each strip loaded
// once from L2 and multicast by TMA to the two CTAs that read it: 39.3 GB a
// call (cluster_wgram_bf16_kernel, below; 8.5 ms against the split Gram's
// 13.4 ms on an H100 at 700 W, where back-to-back calls hold the card at
// its power limit). 30 clusters of 4 fit on the card at once (120 SMs);
// clusters of 1 x 2 tiles fill all 132 but read 58.9 GB and ran 9.2 ms.
// What the design does:
//   - Row split. The grid is (output tiles) x (class pairs) x (row splits). A
//     1,032-wide output has only 45 upper (81 whole) 128x128 tiles and K10's
//     900-wide one 36 upper tiles, well under one CTA per SM, so the host
//     splits the rows until the grid fills the card (ops/cuda/gram.py
//     wgram_plan). Each split writes its partial sums to an f32 workspace,
//     and wgram_reduce_kernel adds the carry (if any), then split 0, 1, ...
//     in that fixed order: no atomics, the same result on every run. With one
//     split (the grid already fills the card: K7's 2,145 upper tiles, K11 on
//     the flagship) the kernel writes the output directly, adding the carry
//     in its epilogue; each output tile is owned by one CTA.
//   - f32 operands stay on f32 FMA, never TF32 (wgram_f32_kernel): 128x128
//     tiles, 8x8 accumulators per thread (four 4x4 quadrants), 32 rows a
//     stage in a ring of 3. (K6's f32 Gram, 8,128 tiles over 18,432 rows,
//     is 70x K9's work and runs on the 3xTF32 kernel instead.)
//   - bf16 operands go to the tensor cores (wgram_bf16_kernel): wgmma on bf16
//     with f32 results, 64 rows a stage in a ring of 4, the weighting of the
//     next stage (if any) overlapping the current stage's wgmmas. The
//     weighted operand is rounded to bf16 as the reference rounds it, so
//     every product is exact in f32; each 128-row tensor-core sum is added to
//     the thread's f32 sums with an IEEE add, so only the order of the f32
//     sums differs. K10 in bf16 is bound by its operand reads: each of its 36
//     tiles reads two 128-column strips of every row (1.36 GB from L2, the
//     operands themselves once from device memory), so its splits run in
//     step over the same rows.
//   - Operands reach shared memory by cp.async (16-byte chunks, zero-filled
//     past the rows of the split and past D; 8-byte chunks for a bf16 row
//     stride that is a multiple of 4 values but not of 8, as K10's 900); the
//     weighting is applied once per staged element, in place, after the stage
//     lands — not once per FMA.
//   - Padding: D = 1,032 is 8 tiles and 8 columns; the ninth tile is almost
//     empty (K10's 900 = 7 tiles and 4 columns, K7's 8,256 = 64 tiles and 64
//     columns). Rather than narrower tiles everywhere, the f32 kernel skips
//     work past D at 64-column granularity (quadrants), and the quadrant below
//     the diagonal of a diagonal tile in the upper-triangle mode, so its
//     computed area at D = 1,032 is ~1.18x the upper triangle (whole 128x128
//     tiles would be 1.38x). The bf16 kernel skips rows past D at 64-row
//     granularity (a warpgroup) and computes its tiles' columns whole. Tiles
//     past D (K7's tiled layout pads 8,256 to 8,704, K6's 16,200 to 16,384)
//     are not in the grid, and the upper tiles are listed in 12 x 12-tile
//     blocks (ops/cuda/gram.py GROUP), so the CTAs on the card at once share
//     their operand strips in L2.
//   Rows and columns are masked, so any (rows, D) with row stride ld works;
//   vector loads need ld and X, Y aligned to the chunk, else the stage is
//   loaded element by element (the same arithmetic). Columns past D are
//   never part of a written result.
//
// Entry points return cudaGetLastError() (or the attribute call's error), as
// in gram.cu; nothing here allocates or synchronises.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kWT = 128;        // output tile, kWT x kWT per CTA
constexpr int kWThreads = 256;  // 8 warps

// ---------------------------------------------------------------- f32
constexpr int kFK = 32;                                  // rows a stage
constexpr int kFStages = 3;                              // ring depth
constexpr int kFStageBytes = 2 * kFK * kWT * 4 + kFK * 4;  // X, Y, weights
constexpr int kFSmem = kFStages * kFStageBytes;

// One stage: rows r0 .. r0+kFK-1 (zero past rend) of X's d-columns (sX) and
// Y's e-columns (sY) of the tile, row-major with kWT columns, and, weighted,
// their weights (sW).
template <bool kVec, bool kWeighted>
__device__ __forceinline__ void fload_stage(float* sX, float* sY, float* sW,
                                            const float* __restrict__ X,
                                            const float* __restrict__ Y, int ld,
                                            const float* __restrict__ h, int hstride, int pq,
                                            int r0, int rend, int d0, int e0, int D, int tid) {
  if constexpr (kVec) {
#pragma unroll
    for (int i = 0; i < kFK * kWT / 4 / kWThreads; ++i) {
      const int idx = tid + i * kWThreads, rr = idx / 32, c = (idx % 32) * 4;
      const int r = r0 + rr;
      // a chunk that starts below D lies inside the row (ld % 4 == 0)
      const bool xin = r < rend && d0 + c < D, yin = r < rend && e0 + c < D;
      cp_async<16>(sX + rr * kWT + c, xin ? X + (size_t)r * ld + d0 + c : X, xin);
      cp_async<16>(sY + rr * kWT + c, yin ? Y + (size_t)r * ld + e0 + c : Y, yin);
    }
  } else {
#pragma unroll 4
    for (int idx = tid; idx < kFK * kWT; idx += kWThreads) {
      const int rr = idx / kWT, c = idx % kWT, r = r0 + rr;
      sX[rr * kWT + c] = (r < rend && d0 + c < D) ? X[(size_t)r * ld + d0 + c] : 0.f;
      sY[rr * kWT + c] = (r < rend && e0 + c < D) ? Y[(size_t)r * ld + e0 + c] : 0.f;
    }
  }
  if (kWeighted && tid < kFK) {
    const int r = r0 + tid;
    const bool in = r < rend;
    cp_async<4>(sW + tid, in ? h + (size_t)r * hstride + pq : h, in);
  }
}

// The weighting, once per staged element of the d-columns, in place.
__device__ __forceinline__ void fweight_stage(float* sX, const float* sW, int tid) {
#pragma unroll
  for (int i = 0; i < kFK * kWT / 4 / kWThreads; ++i) {
    const int idx = tid + i * kWThreads;
    float4* chunk = reinterpret_cast<float4*>(sX) + idx;
    const float w = sW[idx / 32];
    float4 v = *chunk;
    v.x = __fmul_rn(v.x, w);
    v.y = __fmul_rn(v.y, w);
    v.z = __fmul_rn(v.z, w);
    v.w = __fmul_rn(v.w, w);
    *chunk = v;
  }
}

// f32: thread (ty, tx) = (tid / 16, tid % 16) owns rows {ty*4 + i, 64 + ty*4 + i}
// and columns {tx*4 + j, 64 + tx*4 + j} of the tile: four 4x4 quadrants,
// acc[i * 8 + j] with i, j < 4 the low halves. Quadrant q (bit 0: high
// columns, bit 1: high rows) runs only where Q has bit q.
template <int Q>
__device__ __forceinline__ void compute_f32(const float* sX, const float* sY, float (&acc)[64],
                                            int tid) {
  constexpr int BK = kFK, P = kWT;
  const int tx = tid % 16, ty = tid / 16;
#pragma unroll 8
  for (int k = 0; k < BK; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(sX + k * P + ty * 4);
    const float4 a1 = *reinterpret_cast<const float4*>(sX + k * P + 64 + ty * 4);
    const float4 b0 = *reinterpret_cast<const float4*>(sY + k * P + tx * 4);
    const float4 b1 = *reinterpret_cast<const float4*>(sY + k * P + 64 + tx * 4);
    const float xs[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float ys[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (!((Q >> q) & 1)) continue;
      const int ib = (q >> 1) * 4, jb = (q & 1) * 4;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[(ib + i) * 8 + jb + j] = fmaf(xs[ib + i], ys[jb + j], acc[(ib + i) * 8 + jb + j]);
    }
  }
}

// One stage of f32 work with the quadrant set fixed at compile time: the
// sets a tile can have (past D: 1, 3, 5; a diagonal tile: 11; inside: 15).
__device__ __forceinline__ void compute_f32_quads(const float* sX, const float* sY,
                                                  float (&acc)[64], int quads, int tid) {
  switch (quads) {
    case 1: compute_f32<1>(sX, sY, acc, tid); break;
    case 3: compute_f32<3>(sX, sY, acc, tid); break;
    case 5: compute_f32<5>(sX, sY, acc, tid); break;
    case 11: compute_f32<11>(sX, sY, acc, tid); break;
    default: compute_f32<15>(sX, sY, acc, tid); break;
  }
}

// kWeighted: X weighted by h, and Y is X (K9, K11, K7), so one operand
// pointer is live; else no h (K10).
template <bool kVec, bool kWeighted>
__global__ void __launch_bounds__(kWThreads, 2)
wgram_f32_kernel(const float* __restrict__ X, const float* __restrict__ Yarg, int ld,
                 const float* __restrict__ h, int hstride, const int* __restrict__ cls,
                 const int* __restrict__ pairs, int upper, int rows, int rps, int D,
                 float* __restrict__ out, const int* __restrict__ ocls, long long ostride,
                 int ldo, long long sstride, int has_acc) {
  extern __shared__ __align__(16) unsigned char smem[];
  auto sX = [&](int s) { return reinterpret_cast<float*>(smem + s * kFStageBytes); };
  auto sY = [&](int s) { return sX(s) + kFK * kWT; };
  auto sW = [&](int s) { return sX(s) + 2 * kFK * kWT; };
  const float* __restrict__ Y = kWeighted ? X : Yarg;

  const int tid = threadIdx.x;
  const int* pr = pairs + 3 * blockIdx.x;
  const int d0 = pr[0] * kWT, e0 = pr[1] * kWT;
  const int pq = cls ? cls[blockIdx.y] : 0;
  const int ob = ocls ? ocls[blockIdx.y] : blockIdx.y;
  const int rbeg = blockIdx.z * rps;
  const int rend = min(rows, rbeg + rps);
  const int nk = rend > rbeg ? (rend - rbeg + kFK - 1) / kFK : 0;
  // the quadrants that hold work: below D, and not strictly below the
  // diagonal of a diagonal tile in the upper-triangle mode
  const bool dh = d0 + 64 < D, eh = e0 + 64 < D, diag = upper && d0 == e0;
  const int quads = 1 | (eh ? 2 : 0) | (dh && !diag ? 4 : 0) | (dh && eh ? 8 : 0);

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

#pragma unroll
  for (int s = 0; s < kFStages - 1; ++s) {
    if (s < nk)
      fload_stage<kVec, kWeighted>(sX(s), sY(s), sW(s), X, Y, ld, h, hstride, pq,
                                   rbeg + s * kFK, rend, d0, e0, D, tid);
    cp_async_commit();
  }
  for (int k = 0; k < nk; ++k) {
    cp_async_wait<kFStages - 2>();
    __syncthreads();  // stage k landed for every thread; stage k-1 is consumed
    const int nxt = k + kFStages - 1;
    if (nxt < nk) {
      const int sn = nxt % kFStages;
      fload_stage<kVec, kWeighted>(sX(sn), sY(sn), sW(sn), X, Y, ld, h, hstride, pq,
                                   rbeg + nxt * kFK, rend, d0, e0, D, tid);
    }
    cp_async_commit();
    const int s = k % kFStages;
    if constexpr (kWeighted) {
      fweight_stage(sX(s), sW(s), tid);
      __syncthreads();
    }
    compute_f32_quads(sX(s), sY(s), acc, quads, tid);
  }
  cp_async_wait<0>();

  // the carry: out = out + chunk sum, by the one CTA that owns the tile
  float* o = out + blockIdx.z * sstride + (long long)ob * ostride;
  const int tx = tid % 16, ty = tid / 16;
  const bool v4 = ldo % 4 == 0 && (reinterpret_cast<uintptr_t>(o) & 15) == 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int d = d0 + (i >> 2) * 64 + ty * 4 + (i & 3);
    if (d >= D) continue;
    float* row = o + (size_t)d * ldo;
#pragma unroll
    for (int jh = 0; jh < 2; ++jh) {
      const int e = e0 + jh * 64 + tx * 4;
      const float* a = acc + i * 8 + jh * 4;
      if (v4 && e + 3 < D) {
        float4* p = reinterpret_cast<float4*>(row + e);
        float4 v = make_float4(a[0], a[1], a[2], a[3]);
        if (has_acc) {
          const float4 c = *p;
          v = make_float4(c.x + v.x, c.y + v.y, c.z + v.z, c.w + v.w);
        }
        *p = v;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (e + j < D) row[e + j] = has_acc ? row[e + j] + a[j] : a[j];
      }
    }
  }
}

// ---------------------------------------------------------------- bf16
// wgmma (m64n128k16, f32 results) with both operands read from shared memory
// as MN-major (row, column) tiles: warpgroup g of the CTA computes rows
// g*64 .. +63 of the 128 x 128 tile, all 128 columns (a diagonal tile of the
// upper-triangle mode whole). Each stage is 64 rows.

constexpr int kGK = 64;                                 // rows a stage
constexpr int kGTileBytes = kGK * kWT * 2;              // one 64 x 128 bf16 tile
constexpr int kGStageBytes = 2 * kGTileBytes + 1024;    // X, Y, weights; 1 KB aligned
constexpr int kGStages = 4;                             // ring depth
constexpr int kGSmem = kGStages * kGStageBytes + 1024;  // + slack to align the base

// Byte offset of the 16-byte chunk (row r < 64, chunk c = column / 8 < 16) of
// a staged tile in wgmma's MN-major 128-byte-swizzle layout: 1 KB atoms of 8
// rows x 64 columns, atom (c / 8, r / 8) at (c / 8) * 8 KB + (r / 8) * 1 KB,
// row r % 8 at 128-byte steps, chunk c % 8 stored at slot (c % 8) ^ (r % 8).
__device__ __forceinline__ int gsw_offset(int r, int c) {
  return ((c >> 3) << 13) + ((r >> 3) << 10) + ((r & 7) << 7) + (((c & 7) ^ (r & 7)) << 4);
}

// Shared-memory matrix descriptor of that layout at byte address `saddr`:
// leading byte offset 8 KB (the next 64 columns), stride byte offset 1 KB
// (the next 8 rows), 128-byte swizzle.
__device__ __forceinline__ uint64_t gdesc(uint32_t saddr) {
  return (uint64_t)((saddr >> 4) & 0x3FFF) | ((uint64_t)(8192 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

#define TNF_WG_OUT64 "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

// d (+)= A^T-tile x B-tile over 16 rows: A 64 columns (d), B 128 columns (e),
// both MN-major (transposed) bf16; d is zeroed first unless `accumulate`.
__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " TNF_WG_D64
      ", %64, %65, p, 1, 1, 1, 1;\n}\n"
      : TNF_WG_OUT64
      : "l"(da), "l"(db), "r"(accumulate)
      : "memory");
}

// d (+)= A-tile x B-tile over 8 rows on TF32: A 64 columns (d), B 128 columns
// (e), both K-major (tf32 has no transpose); d is zeroed first unless
// `accumulate`.
__device__ __forceinline__ void wgmma_m64n128_tf32(float (&d)[64], uint64_t da, uint64_t db,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " TNF_WG_D64
      ", %64, %65, p, 1, 1;\n}\n"
      : TNF_WG_OUT64
      : "l"(da), "l"(db), "r"(accumulate)
      : "memory");
}

// One thread's part of loading a stage by kChunk-byte copies (16, or 8 for a
// row stride that is a multiple of 4 values but not of 8): kN chunks of X's
// d-columns and as many of Y's e-columns, all in one column chunk, kStep rows
// apart. What does not change from stage to stage (shared memory offset,
// column bounds, pointers) is set up once.
template <int kChunk>
struct GLoader {
  static constexpr int kCols = kChunk / 2;                  // bf16 values a chunk
  static constexpr int kStep = kWThreads * kCols / kWT;     // 16 or 8 rows
  static constexpr int kN = kGK / kStep;                    // 4 or 8 chunks
  int soff, rr;                     // first chunk's byte offset in a tile, row
  const __nv_bfloat16* px;          // row rr of the chunk's d- and e-columns
  const __nv_bfloat16* py;
  bool xin, yin;                    // chunk starts below D
  __device__ __forceinline__ GLoader(const __nv_bfloat16* X, const __nv_bfloat16* Y, int ld,
                                     int d0, int e0, int D, int tid) {
    const int c = (tid % (kWT / kCols)) * kCols;  // the chunk's first column
    rr = tid / (kWT / kCols);
    // kStep is a multiple of 8, so chunk i lies i * kStep / 8 atoms further
    soff = gsw_offset(rr, c >> 3) + (c & 7) * 2;
    xin = d0 + c < D;
    yin = e0 + c < D;
    px = X + (size_t)rr * ld + d0 + c;
    py = Y + (size_t)rr * ld + e0 + c;
  }
};

// kChunk = 0: element by element (any ld, any alignment).
template <int kChunk, bool kWeighted>
__device__ __forceinline__ void gload_stage(const GLoader<kChunk ? kChunk : 16>& L,
                                            unsigned char* sX, unsigned char* sY, float* sW,
                                            const __nv_bfloat16* __restrict__ X,
                                            const __nv_bfloat16* __restrict__ Y, int ld,
                                            const float* __restrict__ h, int hstride, int pq,
                                            int r0, int rend, int d0, int e0, int D, int tid) {
  if constexpr (kChunk > 0) {
    using G = GLoader<kChunk>;
#pragma unroll
    for (int i = 0; i < G::kN; ++i) {
      const int rrow = L.rr + i * G::kStep;
      const bool rin = r0 + rrow < rend;
      const size_t o = (size_t)(r0 + i * G::kStep) * ld;
      const int so = L.soff + i * G::kStep * 128;
      // a chunk that starts below D lies inside the row (ld a multiple of
      // the chunk's values)
      cp_async<kChunk>(sX + so, rin && L.xin ? L.px + o : X, rin && L.xin);
      cp_async<kChunk>(sY + so, rin && L.yin ? L.py + o : Y, rin && L.yin);
    }
  } else {
#pragma unroll 4
    for (int idx = tid; idx < kGK * kWT; idx += kWThreads) {
      const int rr = idx / kWT, col = idx % kWT, r = r0 + rr;
      const int o = gsw_offset(rr, col >> 3) + (col & 7) * 2;
      *reinterpret_cast<__nv_bfloat16*>(sX + o) =
          (r < rend && d0 + col < D) ? X[(size_t)r * ld + d0 + col] : __float2bfloat16_rn(0.f);
      *reinterpret_cast<__nv_bfloat16*>(sY + o) =
          (r < rend && e0 + col < D) ? Y[(size_t)r * ld + e0 + col] : __float2bfloat16_rn(0.f);
    }
  }
  if (kWeighted && tid < kGK) {
    const int r = r0 + tid;
    const bool in = r < rend;
    cp_async<4>(sW + tid, in ? h + (size_t)r * hstride + pq : h, in);
  }
}

// The weighting of a staged X tile, in place, 16 bytes (8 values of one row)
// at a time: chunk q of the layout holds row ((q >> 6) & 7) * 8 + ((q >> 3) & 7).
__device__ __forceinline__ void gweight_stage(unsigned char* sX, const float* sW, int tid) {
#pragma unroll
  for (int i = 0; i < kGTileBytes / 16 / kWThreads; ++i) {
    const int q = tid + i * kWThreads;
    uint4* chunk = reinterpret_cast<uint4*>(sX + q * 16);
    const float w = sW[((q >> 6) & 7) * 8 + ((q >> 3) & 7)];
    uint4 v = *chunk;
    uint32_t* u = &v.x;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(u + k));
      const __nv_bfloat162 b = __floats2bfloat162_rn(__fmul_rn(f.x, w), __fmul_rn(f.y, w));
      u[k] = *reinterpret_cast<const uint32_t*>(&b);
    }
    *chunk = v;
  }
}

// Store a warpgroup's 64 x 128 result acc (rows dbase.., columns e0..) into o,
// row stride ldo, masked to D. acc[4j + v]: row 16 w + lane / 4 (+8 for
// v >= 2), column 8 j + 2 (lane % 4) (+1 for odd v), w the warp within the
// warpgroup. With the carry: o = o + chunk sum, by the one CTA that owns the
// tile.
__device__ __forceinline__ void wg_store(const float (&acc)[64], float* o, int ldo, int dbase,
                                         int e0, int D, int has_acc, int tid) {
  const bool v2 = ldo % 2 == 0 && (reinterpret_cast<uintptr_t>(o) & 7) == 0;
  const int lane = tid % 32, w = (tid % 128) / 32;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int dd = dbase + w * 16 + hf * 8 + lane / 4;
    if (dd >= D) continue;
    float* row = o + (size_t)dd * ldo;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int e = e0 + j * 8 + (lane % 4) * 2;
      const float* a = acc + 4 * j + 2 * hf;
      if (v2 && e + 1 < D) {
        float2* p = reinterpret_cast<float2*>(row + e);
        float2 v = make_float2(a[0], a[1]);
        if (has_acc) {
          const float2 c = *p;
          v = make_float2(c.x + v.x, c.y + v.y);
        }
        *p = v;
      } else {
        if (e < D) row[e] = has_acc ? row[e] + a[0] : a[0];
        if (e + 1 < D) row[e + 1] = has_acc ? row[e + 1] + a[1] : a[1];
      }
    }
  }
}

// The pipeline: while the wgmmas of stage k run, stage k+3 loads and
// (weighted) stage k+1 is weighted. The wgmmas of two stages (128 rows) sum inside the
// tensor core from zero, and that sum is added to acc with __fadd_rn: summing
// inside the tensor core over thousands of rows loses bits on every step (its
// f32 accumulation does not round to nearest), an error that grows with the
// row count. kWeighted as for the f32 kernel.
template <int kChunk, bool kWeighted>
__global__ void __launch_bounds__(kWThreads, 1)
wgram_bf16_kernel(const __nv_bfloat16* __restrict__ X, const __nv_bfloat16* __restrict__ Yarg,
                  int ld, const float* __restrict__ h, int hstride, const int* __restrict__ cls,
                  const int* __restrict__ pairs, int rows, int rps, int D,
                  float* __restrict__ out, const int* __restrict__ ocls, long long ostride,
                  int ldo, long long sstride, int has_acc) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  auto sX = [&](int s) { return smem + s * kGStageBytes; };
  auto sY = [&](int s) { return smem + s * kGStageBytes + kGTileBytes; };
  auto sW = [&](int s) { return reinterpret_cast<float*>(smem + s * kGStageBytes + 2 * kGTileBytes); };
  const __nv_bfloat16* __restrict__ Y = kWeighted ? X : Yarg;

  const int tid = threadIdx.x, g = tid / 128;
  const int* pr = pairs + 3 * blockIdx.x;
  const int d0 = pr[0] * kWT, e0 = pr[1] * kWT;
  const int pq = cls ? cls[blockIdx.y] : 0;
  const int ob = ocls ? ocls[blockIdx.y] : blockIdx.y;
  const int rbeg = blockIdx.z * rps;
  const int rend = min(rows, rbeg + rps);
  const int nk = rend > rbeg ? (rend - rbeg + kGK - 1) / kGK : 0;
  const GLoader<kChunk ? kChunk : 16> L(X, Y, ld, d0, e0, D, tid);
  auto load = [&](int k) {
    const int s = k % kGStages;
    gload_stage<kChunk, kWeighted>(L, sX(s), sY(s), sW(s), X, Y, ld, h, hstride, pq,
                                   rbeg + k * kGK, rend, d0, e0, D, tid);
  };

  float acc[64], d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

#pragma unroll
  for (int s = 0; s < kGStages - 1; ++s) {
    if (s < nk) load(s);
    cp_async_commit();
  }
  cp_async_wait<kGStages - 2>();
  __syncthreads();
  if (kWeighted && nk > 0) gweight_stage(sX(0), sW(0), tid);
  fence_proxy_async();
  for (int k = 0; k < nk; ++k) {
    __syncthreads();  // stage k landed (and weighted) and visible
    const int s = k % kGStages;
    const uint32_t xa = smem_u32(sX(s)) + g * 8192, ya = smem_u32(sY(s));
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kGK / 16; ++ks)
      wgmma_m64n128(d, gdesc(xa + ks * 2048), gdesc(ya + ks * 2048), (k & 1) || ks > 0);
    wgmma_commit();
    wgmma_wait<1>();  // this warpgroup's wgmmas of stage k-1
    cp_async_wait<1>();  // this thread's copies of stage k+1 landed
    __syncthreads();  // ... and everyone's; stage k-1's buffer is free
    if (k + kGStages - 1 < nk) load(k + kGStages - 1);
    cp_async_commit();
    if (kWeighted && k + 1 < nk)
      gweight_stage(sX((k + 1) % kGStages), sW((k + 1) % kGStages), tid);
    fence_proxy_async();
    if ((k & 1) || k + 1 == nk) {
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = __fadd_rn(acc[i], d[i]);
    }
  }
  cp_async_wait<0>();
  if (d0 + g * 64 >= D) return;  // this warpgroup's rows lie past D

  wg_store(acc, out + blockIdx.z * sstride + (long long)ob * ostride, ldo, d0 + g * 64, e0, D,
           has_acc, tid);
}

// ------------------------------------------------- bf16, clustered (K6)
// K6 in bf16 with a carry: the bf16 kernel's arithmetic, fed by TMA multicast
// to clusters of kCM x 2 output tiles (2 x 2 on the card). Cluster rank
// r = 2 i + j owns tile (ti, tj) of its table row; the CTAs of one cluster
// row share ti (X's 128-column strip), those of one cluster column tj (Y's).
// A stage is 64 rows: X's strip as two 64 x 64 halves (8 KB each, the
// 128-byte swizzle gdesc reads, which TMA's SWIZZLE_128B writes), then Y's.
// Each CTA loads X half j of its row's strip for both CTAs of the row, and
// (kCM = 2) Y half i of its column's strip for both CTAs of the column (kCM =
// 1: its own Y strip), so a 2 x 2 cluster reads each strip from L2 once for
// two tiles. Roles as K3's (qgram.cu): a producer warpgroup, one thread of
// which issues the loads into a ring of kCStages stages behind full/empty
// mbarriers, and two consumer warpgroups of 64 x 128 outputs, each with two
// sets of tensor-core sums so that one 128-row chain runs while the last
// one is added. A stage's empty barrier counts the consumer warps of every
// CTA its producer writes into (this one, its row neighbour, and for kCM = 2
// its column neighbour), which arrive on it remotely; the producer then
// waits for each stage's last release, so no CTA leaves while a peer may
// still write to or arrive on it.
// A CTA whose tile is not stored (below the diagonal, or past D) loads its
// share and multiplies like the others but stores nothing. The stored tiles'
// wgmmas, their 128-row chains from zero, the __fadd_rn into acc and the
// carry add in wg_store are the bf16 kernel's, in the same order, so the
// result is bit-equal to it. TMA's zero fill past `rows` and past D takes
// the place of cp.async's.

constexpr int kCHalf = kGK * 64 * 2;      // one 64-row x 64-column bf16 half-strip
constexpr int kCStageBytes = 4 * kCHalf;  // X's two halves, then Y's
constexpr int kCStages = 7;               // ring depth (224 KB of the 227 KB)
constexpr int kCThreads = 384;            // producer + two consumer warpgroups
constexpr int kCSmem = kCStages * kCStageBytes + 2 * kCStages * 8 + 1024;  // + barriers, alignment

template <int kCM>
__global__ void __launch_bounds__(kCThreads, 1)
cluster_wgram_bf16_kernel(const __grid_constant__ CUtensorMap tmx,
                          const __grid_constant__ CUtensorMap tmy, const int* __restrict__ tiles,
                          int rows, int D, float* __restrict__ out, int ldo) {
  constexpr int kPeers = kCM == 2 ? 3 : 2;  // CTAs whose producers write into this one
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kCStages * kCStageBytes);
  uint64_t* empty = full + kCStages;
  // the warpgroup, broadcast from lane 0 so that ptxas sees it warp-uniform
  const int tid = threadIdx.x, wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const uint32_t rank = cluster_ctarank();
  const int ci = kCM == 2 ? (int)(rank >> 1) : 0, cj = (int)(rank & 1);
  const int* t = tiles + 3 * blockIdx.x;
  const int d0 = t[0] * kWT, e0 = t[1] * kWT, store = t[2];
  const int nk = (rows + kGK - 1) / kGK;
  if (tid == 0) {
    for (int s = 0; s < kCStages; ++s) {
      mbar_init(&full[s], 1);               // the producer's arrival, plus the bytes
      mbar_init(&empty[s], 8 * kPeers);     // one arrival per consumer warp of each peer
    }
    mbar_fence_init();
  }
  cluster_sync();

  if (wg == 0) {  // producer
    setmaxnreg_dec<40>();
    if (tid == 0) {
      const uint16_t xmask = (uint16_t)(3u << (2 * ci));               // this tile row
      const uint16_t ymask = (uint16_t)((1u << cj) | (1u << (2 + cj)));  // this tile column
      // k past nk: wait for the last release of every stage, then leave
      for (int k = 0; k < nk + kCStages; ++k) {
        const int s = k % kCStages;
        if (k >= kCStages) mbar_wait(&empty[s], (k / kCStages - 1) & 1);
        if (k >= nk) continue;
        unsigned char* st = smem + s * kCStageBytes;
        mbar_expect_tx(&full[s], kCStageBytes);
        tma_load_2d_multicast(st + cj * kCHalf, &tmx, &full[s], d0 + 64 * cj, k * kGK, xmask);
        if constexpr (kCM == 2) {
          tma_load_2d_multicast(st + (2 + ci) * kCHalf, &tmy, &full[s], e0 + 64 * ci, k * kGK,
                                ymask);
        } else {
          tma_load_2d(st + 2 * kCHalf, &tmy, &full[s], e0, k * kGK);
          tma_load_2d(st + 3 * kCHalf, &tmy, &full[s], e0 + 64, k * kGK);
        }
      }
    }
    return;
  }

  setmaxnreg_inc<232>();
  const int g = wg - 1;
  auto release = [&](int s) {  // this warp is done with stage s, in every peer
    if (tid % 32 == 0) {
      mbar_arrive_cluster(&empty[s], rank);
      mbar_arrive_cluster(&empty[s], rank ^ 1);
      if (kCM == 2) mbar_arrive_cluster(&empty[s], rank ^ 2);
    }
  };
  float acc[64], da[64], db[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  // stage k's four wgmmas into d, from zero where `first`
  auto mma = [&](float (&d)[64], int k, bool first) {
    const int s = k % kCStages;
    mbar_wait(&full[s], (k / kCStages) & 1);
    const uint32_t xa = smem_u32(smem + s * kCStageBytes) + g * kCHalf;
    const uint32_t ya = smem_u32(smem + s * kCStageBytes) + 2 * kCHalf;
#pragma unroll
    for (int ks = 0; ks < kGK / 16; ++ks)
      wgmma_m64n128(d, gdesc(xa + ks * 2048), gdesc(ya + ks * 2048), !first || ks > 0);
    wgmma_commit();
  };
  auto add = [&](const float (&d)[64]) {
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = __fadd_rn(acc[i], d[i]);
  };
  // Chain j sums stages 2j and 2j+1 (128 rows) from zero into da (j even)
  // or db (j odd); chain j-1 is retired, its stages released and its sum
  // added while chain j runs, so the tensor cores do not wait for the add.
  // The group counts are fixed (two a chain) and no wgmma sits in a
  // divergent branch: ptxas would otherwise serialise the wgmmas. Every CTA
  // multiplies, stored or not. A last stage of odd nk is a chain alone.
  auto chain = [&](float (&d)[64], int j) {
    wgmma_fence();
    mma(d, 2 * j, true);
    mma(d, 2 * j + 1, false);
  };
  auto retire = [&](int j) {
    release((2 * j) % kCStages);
    release((2 * j + 1) % kCStages);
  };
  const int np = nk / 2;
  if (np > 0) {
    chain(da, 0);
    int j = 1;
    for (; j + 1 < np; j += 2) {
      chain(db, j);
      wgmma_wait<2>();
      retire(j - 1);
      add(da);
      chain(da, j + 1);
      wgmma_wait<2>();
      retire(j);
      add(db);
    }
    if (j < np) {
      chain(db, j);
      wgmma_wait<2>();
      retire(j - 1);
      add(da);
      wgmma_wait<0>();
      retire(j);
      add(db);
    } else {
      wgmma_wait<0>();
      retire(j - 1);
      add(da);
    }
  }
  if (nk % 2) {
    wgmma_fence();
    mma(da, nk - 1, true);
    wgmma_wait<0>();
    release((nk - 1) % kCStages);
    add(da);
  }
  if (!store || d0 + g * 64 >= D) return;  // not stored, or this warpgroup's rows past D
  wg_store(acc, out, ldo, d0 + g * 64, e0, D, 1, tid);
}

// ---------------------------------------------------------------- 3xTF32
// K6 on f32 operands: A = X^T Y over a 128 x 128 tile on the TF32 tensor
// cores, each operand split as x = hi + lo (hi = x rounded to TF32, to
// nearest; lo = x - hi, exact in f32, rounded to TF32 again), and
// x^T y ~ lo_x^T hi_y + hi_x^T lo_y + hi_x^T hi_y (the lo^T lo term, ~2^-22
// of a product, dropped): the f32 tier's accuracy at three TF32 products
// per multiply-add. TF32 wgmma takes no transpose, so both operands must be
// K-major in shared memory, while X and Y are row-major (rows, ld), i.e.
// MN-major: each 32-row stage lands by cp.async as it is (the f32 kernel's
// fload_stage, a ring of kTRaw), then every thread splits its share and
// writes hi and lo K-major into a double-buffered 128-byte-swizzle tile (a
// 32-row stage is one 128-byte row of each column). The split of stage k+1
// runs while the tensor cores work on stage k.
constexpr int kTK = 32;                                    // rows a stage
constexpr int kTRaw = 3;                                   // landing ring depth
constexpr int kTRawBytes = 2 * kTK * kWT * 4;              // X and Y as landed
constexpr int kTOpBytes = kWT * kTK * 4;                   // one K-major operand tile
constexpr int kTConvBytes = 4 * kTOpBytes;                 // X hi, X lo, Y hi, Y lo
constexpr int kTSmem = 2 * kTConvBytes + kTRaw * kTRawBytes + 1024;  // + base alignment

__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// Byte offset of the 16-byte chunk (column m < 128, rows 4 kc .. 4 kc + 3 of
// the stage) in a K-major 128-byte-swizzle tile: 1 KB atoms of 8 columns x
// 32 rows, column m at (m / 8) KB + (m % 8) * 128, chunk kc at slot kc ^ (m % 8)
// (wgmma reads it through sm90.cuh's tdesc).
__device__ __forceinline__ int tk_offset(int m, int kc) {
  return ((m >> 3) << 10) + ((m & 7) << 7) + (((kc ^ (m & 7)) & 7) << 4);
}

// Split a landed stage (X then Y, each kTK x kWT row-major) into the four
// K-major tiles of `conv`. A warp takes 32 adjacent columns of one 4-row
// chunk: its shared-memory reads hit 32 banks and its 16-byte writes fill
// eight distinct slots of eight 128-byte rows per quarter-warp.
__device__ __forceinline__ void tsplit_stage(const float* raw, unsigned char* conv, int tid) {
#pragma unroll
  for (int i = 0; i < 2 * kTK * kWT / 4 / kWThreads; ++i) {
    const int q = tid + i * kWThreads;
    const int op = q >> 10, kc = (q >> 7) & 7, m = q & 127;
    const float* src = raw + op * kTK * kWT + kc * 4 * kWT + m;
    float hi[4], lo[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float x = src[j * kWT];
      hi[j] = tf32_rna(x);
      lo[j] = tf32_rna(__fsub_rn(x, hi[j]));
    }
    unsigned char* dst = conv + op * 2 * kTOpBytes + tk_offset(m, kc);
    *reinterpret_cast<float4*>(dst) = make_float4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<float4*>(dst + kTOpBytes) = make_float4(lo[0], lo[1], lo[2], lo[3]);
  }
}

// One CTA per listed tile, two warpgroups of 64 rows x 128 columns, over all
// the rows. Each chain of four stages (128 rows) sums inside the tensor core
// from zero, small products first, and is then added to acc with __fadd_rn
// (as the bf16 kernel). With has_acc the epilogue adds to the carry.
template <bool kVec>
__global__ void __launch_bounds__(kWThreads, 1)
gram_tf32x3_kernel(const float* __restrict__ X, const float* __restrict__ Y, int ld,
                   const int* __restrict__ pairs, int rows, int D, float* __restrict__ out,
                   int ldo, int has_acc) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  auto conv = [&](int b) { return smem + b * kTConvBytes; };
  auto raw = [&](int s) {
    return reinterpret_cast<float*>(smem + 2 * kTConvBytes + s * kTRawBytes);
  };
  const int tid = threadIdx.x, g = tid / 128;
  const int* pr = pairs + 3 * blockIdx.x;
  const int d0 = pr[0] * kWT, e0 = pr[1] * kWT;
  const int nk = (rows + kTK - 1) / kTK;
  const bool live = d0 + g * 64 < D;  // this warpgroup's rows hold results
  auto load = [&](int k) {
    float* s = raw(k % kTRaw);
    fload_stage<kVec, false>(s, s + kTK * kWT, nullptr, X, Y, ld, nullptr, 0, 0, k * kTK, rows,
                             d0, e0, D, tid);
  };

  float acc[64], d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = d[i] = 0.f;

#pragma unroll
  for (int s = 0; s < kTRaw; ++s) {
    if (s < nk) load(s);
    cp_async_commit();
  }
  cp_async_wait<kTRaw - 1>();
  __syncthreads();
  if (nk > 0) tsplit_stage(raw(0), conv(0), tid);
  fence_proxy_async();
  __syncthreads();
  for (int k = 0; k < nk; ++k) {
    if (live) {
      const uint32_t xa = smem_u32(conv(k & 1)) + g * 64 * 128;
      const uint32_t ya = smem_u32(conv(k & 1)) + 2 * kTOpBytes;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kTK / 8; ++ks) {
        const uint32_t o = ks * 32;  // 8 rows of TF32 further along the swizzle row
        wgmma_m64n128_tf32(d, tdesc(xa + kTOpBytes + o), tdesc(ya + o), (k & 3) || ks > 0);
        wgmma_m64n128_tf32(d, tdesc(xa + o), tdesc(ya + kTOpBytes + o), 1);
        wgmma_m64n128_tf32(d, tdesc(xa + o), tdesc(ya + o), 1);
      }
      wgmma_commit();
    }
    if (k + 1 < nk) {
      if (live) wgmma_wait<1>();  // this warpgroup's wgmmas of stage k-1
      cp_async_wait<kTRaw - 2>();  // this thread's copies of stage k+1 landed
      __syncthreads();  // ... and everyone's; conv((k+1)&1) and stage k's slot are free
      if (k + kTRaw < nk) load(k + kTRaw);
      cp_async_commit();
      tsplit_stage(raw((k + 1) % kTRaw), conv((k + 1) & 1), tid);
      fence_proxy_async();
    }
    if (live && ((k & 3) == 3 || k + 1 == nk)) {
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = __fadd_rn(acc[i], d[i]);
    }
    __syncthreads();  // stage k+1 split and visible
  }
  cp_async_wait<0>();
  if (!live) return;
  wg_store(acc, out, ldo, d0 + g * 64, e0, D, has_acc, tid);
}

// out[ocls[c]][d, e] = (carry +) sum over splits z, in order, of ws[z][c][d, e]
// (ws is (splits, ncls, D, D)); in the upper mode only the tiles the kernel
// computed (d / kWT <= e / kWT) are written. One thread per (c, d, e).
__global__ void wgram_reduce_kernel(const float* __restrict__ ws, int splits, long long sstride,
                                    int D, int upper, int has_acc, float* __restrict__ out,
                                    const int* __restrict__ ocls, long long ostride, int ldo) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x, d = blockIdx.y, c = blockIdx.z;
  if (e >= D || (upper && d / kWT > e / kWT)) return;
  const float* src = ws + ((long long)c * D + d) * D + e;
  float* dst = out + (long long)(ocls ? ocls[c] : c) * ostride + (long long)d * ldo + e;
  float s = has_acc ? __fadd_rn(*dst, src[0]) : src[0];
  for (int z = 1; z < splits; ++z) s = __fadd_rn(s, src[z * sstride]);
  *dst = s;
}

bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

template <bool kWeighted>
int launch_f32(const float* X, const float* Y, int ld, const float* h, int hstride,
               const int* cls, dim3 grid, const int* pairs, int upper, int rows, int rps, int D,
               float* out, const int* ocls, long long ostride, int ldo, long long sstride,
               int has_acc, cudaStream_t stream) {
  const bool vec = ld % 4 == 0 && aligned(X, 16) && aligned(Y, 16);
  auto kern = vec ? wgram_f32_kernel<true, kWeighted> : wgram_f32_kernel<false, kWeighted>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kFSmem);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, kWThreads, kFSmem, stream>>>(X, Y, ld, h, hstride, cls, pairs, upper, rows, rps,
                                            D, out, ocls, ostride, ldo, sstride, has_acc);
  return (int)cudaGetLastError();
}

template <bool kWeighted>
int launch_bf16(const __nv_bfloat16* X, const __nv_bfloat16* Y, int ld, const float* h,
                int hstride, const int* cls, dim3 grid, const int* pairs, int rows, int rps,
                int D, float* out, const int* ocls, long long ostride, int ldo,
                long long sstride, int has_acc, cudaStream_t stream) {
  auto kern = wgram_bf16_kernel<0, kWeighted>;
  if (ld % 8 == 0 && aligned(X, 16) && aligned(Y, 16))
    kern = wgram_bf16_kernel<16, kWeighted>;
  else if (ld % 4 == 0 && aligned(X, 8) && aligned(Y, 8))
    kern = wgram_bf16_kernel<8, kWeighted>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kGSmem);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, kWThreads, kGSmem, stream>>>(X, Y, ld, h, hstride, cls, pairs, rows, rps, D, out,
                                            ocls, ostride, ldo, sstride, has_acc);
  return (int)cudaGetLastError();
}

// The clustered kernel's launch configuration: grid `ctas`, clusters of
// 2 kCM CTAs along x.
template <int kCM>
struct ClusterLaunch {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  ClusterLaunch(int ctas, cudaStream_t stream) : attr{}, cfg{} {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 2 * kCM;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(ctas);
    cfg.blockDim = dim3(kCThreads);
    cfg.dynamicSmemBytes = kCSmem;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

template <int kCM>
int launch_cluster(const void* X, const void* Y, int ld, const int* tiles, int ctas, int rows,
                   int D, float* out, int ldo, cudaStream_t stream) {
  CUtensorMap mx, my;
  int st = encode_2d(&mx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, X, (cuuint64_t)D, (cuuint64_t)rows,
                     (cuuint64_t)ld * 2, 64, kGK);
  if (st == 0)
    st = encode_2d(&my, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, Y, (cuuint64_t)D, (cuuint64_t)rows,
                   (cuuint64_t)ld * 2, 64, kGK);
  if (st != 0) return st;
  auto kern = cluster_wgram_bf16_kernel<kCM>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kCSmem);
  if (err != cudaSuccess) return (int)err;
  ClusterLaunch<kCM> L(ctas, stream);
  err = cudaLaunchKernelEx(&L.cfg, kern, mx, my, tiles, rows, D, out, ldo);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

template <int kCM>
int cluster_occupancy() {
  auto kern = cluster_wgram_bf16_kernel<kCM>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kCSmem);
  if (err != cudaSuccess) return -(int)err;
  ClusterLaunch<kCM> L(2 * kCM, nullptr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, kern, &L.cfg);
  return err != cudaSuccess ? -(int)err : n;
}

// a weighted Gram is of X with itself (Y = X)
bool bad_split_args(const void* X, const void* Y, const void* h, int ncls, int npairs, int rows,
                    int rps, int splits, int D, int ld) {
  return ncls < 1 || ncls > 65535 || splits < 1 || splits > 65535 || npairs < 1 || rps < 1 ||
         (long long)(splits - 1) * rps >= (rows > 0 ? rows : 1) || D > ld || (h && Y != X);
}

}  // namespace

extern "C" {

// The split Gram (K9, K11, K10, K7). X and Y (rows, ld) with D <= ld columns
// used; h (rows, hstride) f32 with Y = X (the weighted Grams), or null for
// K10's unweighted Gram; cls (ncls class pairs, may be null with ncls = 1)
// picks the h column pq = cls[y] of grid row y; pairs (npairs, 3) int32 lists
// the kWT-tiles (ti, tj, -) to compute; `upper` marks the upper-triangle mode
// (the f32 kernel then skips the quadrant below a diagonal tile's diagonal).
// Split z covers rows [z*rps, min(rows, (z+1)*rps)). Output block of grid row
// y and split z: out + z*sstride + (ocls ? ocls[y] : y)*ostride, row stride
// ldo; with has_acc (one split only) the sums are added to it.
//
//   K9  <- _weighted_gram_jit gram.py:335: h, Y = X, upper, split to fill
//          the card (operations: 1.04 ms at 65,536 x 1,032 f32);
//   K11 <- _own_out_gram_jit :1373: h with a class pair per grid row;
//   K10 <- _gram_pair_jit :550: no h, Y = K, upper, split to fill the card
//          (73,728 x 900: 0.080 ms bf16, by bytes; 0.89 ms f32, by
//          operations); 8-byte chunks for bf16 rows of 900 values;
//   K7  <- _weighted_gram_tiled_jit :1439: h, Y = X, upper over the node's
//          D < Dp, has_acc into the (Dp, Dp) carry, one split (512 x 8,256
//          f32: 0.52 ms, by operations; its 2,145 tiles fill the card).
int tnf_wgram_split_f32(const void* X, const void* Y, int ld, const void* h, int hstride,
                        const void* cls, int ncls, const void* pairs, int npairs, int upper,
                        int rows, int rps, int splits, int D, void* out, const void* ocls,
                        long long ostride, int ldo, long long sstride, int has_acc,
                        void* stream) {
  if (bad_split_args(X, Y, h, ncls, npairs, rows, rps, splits, D, ld))
    return (int)cudaErrorInvalidValue;
  auto launch = h ? launch_f32<true> : launch_f32<false>;
  return launch((const float*)X, (const float*)Y, ld, (const float*)h, hstride, (const int*)cls,
                dim3(npairs, ncls, splits), (const int*)pairs, upper, rows, rps, D, (float*)out,
                (const int*)ocls, ostride, ldo, sstride, has_acc, (cudaStream_t)stream);
}

int tnf_wgram_split_bf16(const void* X, const void* Y, int ld, const void* h, int hstride,
                         const void* cls, int ncls, const void* pairs, int npairs, int upper,
                         int rows, int rps, int splits, int D, void* out, const void* ocls,
                         long long ostride, int ldo, long long sstride, int has_acc,
                         void* stream) {
  if (bad_split_args(X, Y, h, ncls, npairs, rows, rps, splits, D, ld))
    return (int)cudaErrorInvalidValue;
  auto launch = h ? launch_bf16<true> : launch_bf16<false>;
  return launch((const __nv_bfloat16*)X, (const __nv_bfloat16*)Y, ld, (const float*)h, hstride,
                (const int*)cls, dim3(npairs, ncls, splits), (const int*)pairs, rows, rps, D,
                (float*)out, (const int*)ocls, ostride, ldo, sstride, has_acc,
                (cudaStream_t)stream);
}

// Sum the split workspace ws (splits, ncls, D, D) in split order into
// out + (ocls ? ocls[c] : c) * ostride, row stride ldo; with has_acc the sum
// starts from what out holds (the carry), then adds split 0, 1, ...
int tnf_wgram_reduce(const void* ws, int splits, int ncls, int D, int upper, int has_acc,
                     void* out, const void* ocls, long long ostride, int ldo, void* stream) {
  if (splits < 1 || ncls < 1 || ncls > 65535 || D < 1 || D > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid((D + 255) / 256, D, ncls);
  wgram_reduce_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const float*)ws, splits, (long long)ncls * D * D, D, upper, has_acc, (float*)out,
      (const int*)ocls, ostride, ldo);
  return (int)cudaGetLastError();
}

// K6 on f32 operands <- _gram_pair_tiled_jit gram.py:873 (with
// _add_packed_upper_jit :1524, K5, as the carry epilogue): out (+)= X^T Y
// over the listed kWT-tiles (upper, over the node's D <= ld), X and Y
// (rows, ld) f32, on the 3xTF32 kernel; with has_acc the owning CTA adds the
// chunk sum to the carry out (row stride ldo). Bound on the card by TF32
// tensor-core work: three products per multiply-add (18,432 x 16,200:
// 29 ms at 495 TFLOP/s).
int tnf_gram_tf32x3(const void* X, const void* Y, int ld, const void* pairs, int npairs,
                    int rows, int D, void* out, int ldo, int has_acc, void* stream) {
  if (npairs < 1 || rows < 1 || D < 1 || D > ld || D > ldo) return (int)cudaErrorInvalidValue;
  const bool vec = ld % 4 == 0 && aligned(X, 16) && aligned(Y, 16);
  auto kern = vec ? gram_tf32x3_kernel<true> : gram_tf32x3_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kTSmem);
  if (err != cudaSuccess) return (int)err;
  kern<<<npairs, kWThreads, kTSmem, (cudaStream_t)stream>>>(
      (const float*)X, (const float*)Y, ld, (const int*)pairs, rows, D, (float*)out, ldo, has_acc);
  return (int)cudaGetLastError();
}

// K6 on bf16 operands with a carry, on the clustered kernel: out += X^T Y
// over the tiles of `tiles` (ctas, 3) int32 rows (ti, tj, store), clusters of
// 2 cluster_rows consecutive rows in rank order (ops/cuda/gram.py
// _cluster_table_np), the stored ones the upper kWT-tiles over D; X and Y
// (rows, ld) bf16, ld a multiple of 8 values and both 16-byte aligned (TMA's
// terms). cluster_rows 2 multicasts X and Y, 1 X alone. Returns a
// cudaError_t, or kNoEncoder / kEncodeFailed - CUresult.
int tnf_gram_bf16_cluster(const void* X, const void* Y, int ld, const void* tiles, int ctas,
                          int cluster_rows, int rows, int D, void* out, int ldo, void* stream) {
  if ((cluster_rows != 1 && cluster_rows != 2) || ctas < 1 || ctas % (2 * cluster_rows) ||
      rows < 1 || D < 1 || D > ld || D > ldo || ld % 8 || !aligned(X, 16) || !aligned(Y, 16))
    return (int)cudaErrorInvalidValue;
  auto launch = cluster_rows == 2 ? launch_cluster<2> : launch_cluster<1>;
  return launch(X, Y, ld, (const int*)tiles, ctas, rows, D, (float*)out, ldo,
                (cudaStream_t)stream);
}

// The clusters of the clustered kernel (2 cluster_rows CTAs each) the card
// holds at once, or minus a cudaError_t.
int tnf_gram_bf16_cluster_occupancy(int cluster_rows) {
  if (cluster_rows != 1 && cluster_rows != 2) return -(int)cudaErrorInvalidValue;
  return cluster_rows == 2 ? cluster_occupancy<2>() : cluster_occupancy<1>();
}

int tnf_wgram_tile() { return kWT; }

}  // extern "C"
