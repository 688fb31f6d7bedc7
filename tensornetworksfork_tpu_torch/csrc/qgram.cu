// The int8 Gram of the sweep trainer's int8 tier, on Hopper's s8 tensor
// cores (sm_90a): K3 and K4.
//
// Replaces two Pallas kernels of tensornetworksfork_tpu/ops/pallas/gram.py:
//   _gram_pair_band_q_jit  (K3: _make_band_kernel_q; band orientation, carry)
//   _gram_pair_tiled_q_jit (K4: _pair_kernel_tiled_q; natural orientation)
// Over the listed 128 x 128 tiles of the upper 512-slab pairs (diagonal
// slabs whole) both compute, block b of BS rows after block b in order,
//   A[d, e] <- A[d, e] + f32(sum_{r in b} X[r, d] Y[r, e]) * (sx[b, d] * sy[b, e])
// each block's sum exact in int32, the conversion, rescale and add in f32
// with IEEE rounding: bit-equal to gram_pair_q_plain and to the Pallas
// kernel. (X, sx, Y, sy) is (Q1, s1, Q2, s2), or (Q2, s2, Q1, s1) for a tile
// listed with swap (the band's far slab pairs); K4 starts from zero.
//
// Bound on an H100: int8 tensor-core work. The conv-TT flagship's A2/A3
// chunk (18,432 rows, Dp 16,384: 528 slab pairs x 16 tiles = 8,448 tiles) is
// 5.1e12 operations, 2.58 ms at 1,979 TOP/s; its codes are 0.6 GB of device
// memory, but every tile reads two 128-column strips of all the rows, ~40 GB
// from L2 a launch, so L2 may bind first. The design:
//   - The quantiser (gram.cu quantize_kernel) writes the codes K-major,
//     Qt (Dp, ldq) with each column's codes contiguous, which is the only
//     layout s8 wgmma takes: no transpose on the card.
//   - One CTA a tile, 384 threads: a producer warpgroup, one thread of which
//     issues 2-D TMA loads (128 rows x 128 columns of each operand, 16 KB in
//     128-byte swizzle) into a ring of kQStages 32 KB stages guarded by
//     full/empty mbarriers; two consumer warpgroups of 64 x 128 outputs.
//     setmaxnreg moves registers from the producer to the consumers (64
//     int32 and 64 f32 sums and 34 scales a thread).
//   - wgmma m64n128k32 s8 -> s32, four k-slices a stage. At a quantisation
//     block's end (a multiple of 32 rows, so also inside a stage) the
//     warpgroup waits for its wgmmas, converts, scales and adds in f32; the
//     next block's first wgmma starts its int32 sum from zero (scale-d 0).
//     The block's scales were loaded into registers when it started.
//   - Rows past Bp (the tail of the last stage, zero-filled by TMA) are
//     never multiplied and trigger no flush.
//   - Each tile has one owner, which reads the carry once and writes the
//     result once: no atomics, so the in-place carry is safe.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kQT = 128;                     // output tile side, and rows a stage
constexpr int kQOpBytes = kQT * kQT;         // one operand's stage: 128 x 128 int8
constexpr int kQStageBytes = 2 * kQOpBytes;  // X and Y
constexpr int kQStages = 6;                  // ring depth
constexpr int kQThreads = 384;               // producer + two consumer warpgroups
constexpr int kQSmem = kQStages * kQStageBytes + 2 * kQStages * 8 + 1024;  // + barriers, alignment

#define TNF_WG_S32_OUT64 "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])

// d (+)= A-tile x B-tile over 32 rows: A 64 columns (d), B 128 columns (e),
// both K-major int8 with int32 sums; d is overwritten unless `accumulate`.
__device__ __forceinline__ void wgmma_m64n128k32_s8(int (&d)[64], uint64_t da, uint64_t db,
                                                    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " TNF_WG_D64 ", %64, %65, p;\n}\n"
      : TNF_WG_S32_OUT64
      : "l"(da), "l"(db), "r"(accumulate)
      : "memory");
}

// A consumer thread holds rows row0 and row0 + 8 of the tile and columns
// col0 + 8 j, col0 + 8 j + 1 (j < 16): sums[4 j + v] is row + 8 for v >= 2,
// column + 1 for odd v (wgmma's accumulator layout). Its scales of a block:
struct QScales {
  float x[2];
  float2 y[16];
};

__device__ __forceinline__ void load_scales(QScales& sc, const float* __restrict__ sx,
                                            const float* __restrict__ sy, size_t off, int row0,
                                            int col0) {
  sc.x[0] = __ldg(sx + off + row0);
  sc.x[1] = __ldg(sx + off + row0 + 8);
#pragma unroll
  for (int j = 0; j < 16; ++j)
    sc.y[j] = __ldg(reinterpret_cast<const float2*>(sy + off + col0 + 8 * j));
}

// acc += f32(part) * (sx * sy), each step rounded as the reference rounds it
__device__ __forceinline__ void flush(float (&acc)[64], const int (&part)[64],
                                      const QScales& sc) {
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const float2 y = sc.y[i >> 2];
    const float s = __fmul_rn(sc.x[(i >> 1) & 1], (i & 1) ? y.y : y.x);
    acc[i] = __fadd_rn(acc[i], __fmul_rn(__int2float_rn(part[i]), s));
  }
}

__global__ void __launch_bounds__(kQThreads, 1)
gram_q_kernel(const __grid_constant__ CUtensorMap tm1, const __grid_constant__ CUtensorMap tm2,
              const float* __restrict__ s1, const float* __restrict__ s2, float* __restrict__ A,
              const int* __restrict__ pairs, int Bp, int Dp, int BS, int has_acc) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kQStages * kQStageBytes);
  uint64_t* empty = full + kQStages;
  const int tid = threadIdx.x, wg = tid / 128;
  const int* pr = pairs + 3 * blockIdx.x;
  const int d0 = pr[0] * kQT, e0 = pr[1] * kQT, swap = pr[2];
  const int nst = (Bp + kQT - 1) / kQT;  // stages; the last may be partly past Bp
  if (tid == 0) {
    for (int s = 0; s < kQStages; ++s) {
      mbar_init(&full[s], 1);   // the producer's arrival, plus the TMA bytes
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {  // producer
    setmaxnreg_dec<40>();
    if (tid == 0) {
      const CUtensorMap* mx = swap ? &tm2 : &tm1;
      const CUtensorMap* my = swap ? &tm1 : &tm2;
      for (int k = 0; k < nst; ++k) {
        const int s = k % kQStages;
        if (k >= kQStages) mbar_wait(&empty[s], (k / kQStages - 1) & 1);
        unsigned char* st = smem + s * kQStageBytes;
        mbar_expect_tx(&full[s], kQStageBytes);
        tma_load_2d(st, mx, &full[s], k * kQT, d0);
        tma_load_2d(st + kQOpBytes, my, &full[s], k * kQT, e0);
      }
    }
    return;
  }

  setmaxnreg_inc<232>();
  const int cg = wg - 1, lane = tid % 32, w = (tid % 128) / 32;
  const int row0 = d0 + cg * 64 + w * 16 + lane / 4;
  const int col0 = e0 + 2 * (lane % 4);
  const float* __restrict__ sx = swap ? s2 : s1;
  const float* __restrict__ sy = swap ? s1 : s2;
  float acc[64];
  int part[64];
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float2 c = make_float2(0.f, 0.f);
      if (has_acc) c = *reinterpret_cast<const float2*>(A + (size_t)(row0 + 8 * hf) * Dp + col0 + 8 * j);
      acc[4 * j + 2 * hf] = c.x;
      acc[4 * j + 2 * hf + 1] = c.y;
      part[4 * j + 2 * hf] = part[4 * j + 2 * hf + 1] = 0;
    }
  const int nsl = Bp / 32, spb = BS / 32, nb = Bp / BS;  // k-slices: all, a block
  QScales sc;
  load_scales(sc, sx, sy, 0, row0, col0);
  int b = 0, left = spb;  // the block being summed, and its slices still to come
  for (int k = 0; k < nst; ++k) {
    const int s = k % kQStages;
    mbar_wait(&full[s], (k / kQStages) & 1);
    const uint32_t xa = smem_u32(smem + s * kQStageBytes) + cg * (kQOpBytes / 2);
    const uint32_t ya = smem_u32(smem + s * kQStageBytes + kQOpBytes);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kQT / 32; ++ks) {
      if (4 * k + ks < nsl) {
        wgmma_m64n128k32_s8(part, tdesc(xa + 32 * ks), tdesc(ya + 32 * ks), left != spb);
        if (--left == 0) {  // block b ends: rescale and add in f32
          wgmma_commit();
          wgmma_wait<0>();
          flush(acc, part, sc);
          if (++b < nb) load_scales(sc, sx, sy, (size_t)b * Dp, row0, col0);
          left = spb;
          wgmma_fence();
        }
      }
    }
    wgmma_commit();
    wgmma_wait<1>();  // this warpgroup's wgmmas of stage k-1 are done
    if (k > 0 && lane == 0) mbar_arrive(&empty[(k - 1) % kQStages]);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      *reinterpret_cast<float2*>(A + (size_t)(row0 + 8 * hf) * Dp + col0 + 8 * j) =
          make_float2(acc[4 * j + 2 * hf], acc[4 * j + 2 * hf + 1]);
}

// The codes Qt (Dp columns, each of ldq bytes of which the first Bp are
// used) as a TMA map of 128-row x 128-column boxes in 128-byte swizzle;
// rows past Bp read as zero.
int encode_codes(CUtensorMap* map, const void* Qt, int ldq, int Bp, int Dp) {
  return encode_2d(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, Qt, (cuuint64_t)Bp, (cuuint64_t)Dp,
                   (cuuint64_t)ldq, kQT, kQT);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

extern "C" {

// K3 (has_acc: A += the chunk's Gram, band orientation from the pair table's
// swap column) and K4 (has_acc 0: A = it) <- _gram_pair_band_q_jit gram.py:1254,
// _gram_pair_tiled_q_jit :1101. Qkt (k = 1, 2) is (Dp, ldqk) int8, column d's
// codes at Qkt + d * ldqk, rows 0..Bp-1 used (quantize_tiled's K-major layout); sk is
// (Bp / BS, Dp) f32; A is (Dp, Dp) f32; pairs (npairs, 3) int32 lists the
// 128-tiles (ti, tj, swap). Returns a cudaError_t, or kNoEncoder /
// kEncodeFailed - CUresult when a tensor map cannot be made.
int tnf_gram_q(const void* Q1t, int ldq1, const void* s1, const void* Q2t, int ldq2,
               const void* s2, void* A, const void* pairs, int npairs, int Bp, int Dp, int BS,
               int has_acc, void* stream) {
  if (npairs < 1 || Bp < 32 || BS < 32 || Dp < kQT || Dp % kQT || BS % 32 || Bp % BS ||
      ldq1 < Bp || ldq2 < Bp || ldq1 % 16 || ldq2 % 16 || !aligned16(Q1t) || !aligned16(Q2t))
    return (int)cudaErrorInvalidValue;
  CUtensorMap m1, m2;
  int st = encode_codes(&m1, Q1t, ldq1, Bp, Dp);
  if (st == 0) st = encode_codes(&m2, Q2t, ldq2, Bp, Dp);
  if (st != 0) return st;
  const cudaError_t err =
      cudaFuncSetAttribute(gram_q_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kQSmem);
  if (err != cudaSuccess) return (int)err;
  gram_q_kernel<<<npairs, kQThreads, kQSmem, (cudaStream_t)stream>>>(
      m1, m2, (const float*)s1, (const float*)s2, (float*)A, (const int*)pairs, Bp, Dp, BS,
      has_acc);
  return (int)cudaGetLastError();
}

int tnf_gram_tile() { return kQT; }

}  // extern "C"
