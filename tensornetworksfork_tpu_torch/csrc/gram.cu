// Gram-path kernels of the sweep trainer, hand-written for Hopper (sm_90a).
//
// Port of the Pallas kernels in tensornetworksfork_tpu/ops/pallas/gram.py.
// Five kernels, each behind plain-C entry points that tensornetworksfork_tpu_torch/ops/cuda/gram.py
// binds with ctypes. Every entry launches on the caller's stream, allocates
// nothing, and returns cudaGetLastError() so the wrapper can raise.
//
//   retile_hmix  <- _make_retile_hmix_kernel / retile_hmix   (K1)
//   retile_rows  <- _retile_copy_kernel / retile_rows         (K8)
//   quantize     <- _quant_kernel / quantize_tiled           (K2)
//   gram_q       <- _make_band_kernel_q / gram_pair_band_q    (K3) and
//                   _pair_kernel_tiled_q / gram_pair_tiled_q  (K4)
//   gram_f       <- _pair_kernel_tiled / gram_pair_tiled      (K6, K5 folded
//                   into its carry epilogue) and
//                   _pair_kernel_tiled / gram_pair             (K10); its
//                   weighted form <- _make_weighted_kernel_tiled_acc /
//                   weighted_gram_tiled (K7), _weighted_kernel_tiled /
//                   weighted_gram (K9) and _make_own_out_kernel /
//                   own_out_gram (K11)
//
// Layouts: a Gram operand is row-major (rows, cols); rows are (class, sample)
// pairs, columns the node's flattened D. Gram outputs are (cols, cols) f32;
// only the tiles named in a host-built pair table are computed, each by
// exactly one CTA (no atomics, so an in-place carry is safe).
//
// Numerics that must match the reference bit for bit are written with
// explicit _rn intrinsics, so nvcc cannot contract a multiply and an add
// into one FMA: the class mix of K1, the weighting of K8, the quantiser of
// K2 and the per-block rescale of K3. Build without --use_fast_math.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kMaxC = 16;     // largest class count K1 keeps in registers
constexpr int kTile = 64;     // Gram output tile (kTile x kTile per CTA)
constexpr int kThreads = 256; // 16 x 16 threads, 4 x 4 outputs each

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// ---------------------------------------------------------------- K1
// One thread per (sample s, column d). Reads J[s, 0..C-1, d] once, writes
// the C class-major copies Jt[c*S + s, d] and the C mixed values
// Kt[c*S + s, d] = sum_e H[s, c, e] * J[s, e, d], mixed in f32 in order
// e = 0..C-1 and rounded once to T. Columns D..Dp-1 are written as zeros.
template <typename T>
__global__ void retile_hmix_kernel(const T* __restrict__ J, const float* __restrict__ H,
                                   T* __restrict__ Jt, T* __restrict__ Kt,
                                   int S, int C, int D, int Dp) {
  __shared__ float sH[kMaxC * kMaxC];
  const int s = blockIdx.x;
  for (int i = threadIdx.x; i < C * C; i += blockDim.x) sH[i] = H[(size_t)s * C * C + i];
  __syncthreads();
  const int d = blockIdx.y * blockDim.x + threadIdx.x;
  if (d >= Dp) return;
  float jf[kMaxC];
#pragma unroll
  for (int e = 0; e < kMaxC; ++e)
    jf[e] = (e < C && d < D) ? to_f32(J[((size_t)s * C + e) * D + d]) : 0.f;
  for (int c = 0; c < C; ++c) {
    const size_t o = ((size_t)c * S + s) * Dp + d;
    float acc = __fmul_rn(sH[c * C], jf[0]);
#pragma unroll
    for (int e = 1; e < kMaxC; ++e)
      if (e < C) acc = __fadd_rn(acc, __fmul_rn(sH[c * C + e], jf[e]));
    Jt[o] = from_f32<T>(jf[c]);
    Kt[o] = from_f32<T>(acc);
  }
}

// ---------------------------------------------------------------- K8
// Jt[r, c] = X[r, c] for c < D and 0 for D <= c < Dp (the tiled layout:
// row-major, columns zero-padded). With Kt, also Kt[r, c] = X[r, c] * h[r]
// multiplied in f32 and rounded once to T (0 in the padding): the int8
// diagonal route's K, formed while X is in registers. Threads run along the
// columns (coalesced), CTAs of the y grid stride over the rows.
template <typename T>
__global__ void retile_rows_kernel(const T* __restrict__ X, const float* __restrict__ h,
                                   T* __restrict__ Jt, T* __restrict__ Kt,
                                   int rows, int D, int Dp) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= Dp) return;
  for (int r = blockIdx.y; r < rows; r += gridDim.y) {
    const size_t o = (size_t)r * Dp + c;
    const bool in = c < D;
    const T x = in ? X[(size_t)r * D + c] : from_f32<T>(0.f);
    Jt[o] = x;
    if (Kt) Kt[o] = in ? from_f32<T>(__fmul_rn(to_f32(x), h[r])) : from_f32<T>(0.f);
  }
}

// ---------------------------------------------------------------- K2
// One CTA per (64-column strip, quantisation block of BS rows): a max pass
// over the block, then a quantise pass. s = m * f32(1/127) (1 for a zero
// column) — the reference's m / 127.0 as XLA evaluates a division by a
// constant — and q = round-half-even(x * (1/s)), 1/s an IEEE reciprocal.
// Rows >= `rows` read as zero (row padding).
__global__ void quantize_kernel(const __nv_bfloat16* __restrict__ X, int8_t* __restrict__ Q,
                                float* __restrict__ Sc, int rows, int Dp, int BS) {
  __shared__ float red[4][64];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int col = blockIdx.x * 64 + tx;
  const int r0 = blockIdx.y * BS;
  float m = 0.f;
  for (int r = r0 + ty; r < r0 + BS; r += 4)
    if (r < rows) m = fmaxf(m, fabsf(__bfloat162float(X[(size_t)r * Dp + col])));
  red[ty][tx] = m;
  __syncthreads();
  m = fmaxf(fmaxf(red[0][tx], red[1][tx]), fmaxf(red[2][tx], red[3][tx]));
  const float s = m > 0.f ? __fmul_rn(m, 1.0f / 127.0f) : 1.0f;
  const float inv = __frcp_rn(s);
  if (ty == 0) Sc[(size_t)blockIdx.y * Dp + col] = s;
  for (int r = r0 + ty; r < r0 + BS; r += 4) {
    const float x = r < rows ? __bfloat162float(X[(size_t)r * Dp + col]) : 0.f;
    Q[(size_t)r * Dp + col] = (int8_t)__float2int_rn(__fmul_rn(x, inv));
  }
}

// ---------------------------------------------------------------- K3 / K4
// A[d, e] (+)= sum_b (X_b[:, d] . Y_b[:, e]) * (sx[b, d] * sy[b, e]) over the
// quantisation blocks b of BS rows. Each block's dot is exact in int32
// (dp4a over 4 rows at a time; |q| <= 127, so 2048 rows stay below 2^31);
// the int32 sum is rescaled and added to the f32 accumulator at the end of
// its block and never carried into the next one. With swap set for a tile
// the two operands trade places, so the tile holds the product in the
// orientation the reference's band schedule computes for that slab pair.
// Bp (rows) is a multiple of 32 and of BS; Dp a multiple of kTile.
__global__ void __launch_bounds__(kThreads)
gram_q_kernel(const int8_t* __restrict__ Q1, const float* __restrict__ s1,
              const int8_t* __restrict__ Q2, const float* __restrict__ s2,
              float* __restrict__ A, const int* __restrict__ pairs,
              int Bp, int Dp, int BS, int has_acc) {
  __shared__ __align__(16) int sX[8][kTile];
  __shared__ __align__(16) int sY[8][kTile];
  const int* pr = pairs + 3 * blockIdx.x;
  const int d0 = pr[0] * kTile, e0 = pr[1] * kTile, swap = pr[2];
  const int8_t* X = swap ? Q2 : Q1;
  const int8_t* Y = swap ? Q1 : Q2;
  const float* sx = swap ? s2 : s1;
  const float* sy = swap ? s1 : s2;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  int acc_i[4][4];
  float acc_f[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc_i[i][j] = 0;
      acc_f[i][j] = has_acc ? A[(size_t)(d0 + ty * 4 + i) * Dp + e0 + tx * 4 + j] : 0.f;
    }

  // loader role: one 4x4 byte block (4 rows x 4 columns) of X or Y
  const int op = tid / 128, g = (tid % 128) / 16, c4 = tid % 16;
  const int8_t* src = (op ? Y : X) + (op ? e0 : d0) + c4 * 4;
  int* dst = op ? &sY[g][c4 * 4] : &sX[g][c4 * 4];

  for (int r0 = 0; r0 < Bp; r0 += 32) {
    const int8_t* p = src + (size_t)(r0 + 4 * g) * Dp;
    const uint32_t w0 = *reinterpret_cast<const uint32_t*>(p);
    const uint32_t w1 = *reinterpret_cast<const uint32_t*>(p + Dp);
    const uint32_t w2 = *reinterpret_cast<const uint32_t*>(p + 2 * (size_t)Dp);
    const uint32_t w3 = *reinterpret_cast<const uint32_t*>(p + 3 * (size_t)Dp);
    // 4x4 byte transpose: word c holds rows 0..3 of column c
    const uint32_t t0 = __byte_perm(w0, w1, 0x5140), t1 = __byte_perm(w0, w1, 0x7362);
    const uint32_t t2 = __byte_perm(w2, w3, 0x5140), t3 = __byte_perm(w2, w3, 0x7362);
    *reinterpret_cast<int4*>(dst) = make_int4((int)__byte_perm(t0, t2, 0x5410),
                                              (int)__byte_perm(t0, t2, 0x7632),
                                              (int)__byte_perm(t1, t3, 0x5410),
                                              (int)__byte_perm(t1, t3, 0x7632));
    __syncthreads();
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int4 xv = *reinterpret_cast<const int4*>(&sX[k][ty * 4]);
      const int4 yv = *reinterpret_cast<const int4*>(&sY[k][tx * 4]);
      const int xs[4] = {xv.x, xv.y, xv.z, xv.w};
      const int ys[4] = {yv.x, yv.y, yv.z, yv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc_i[i][j] = __dp4a(xs[i], ys[j], acc_i[i][j]);
    }
    __syncthreads();
    if ((r0 + 32) % BS == 0) {  // end of quantisation block b: rescale, flush
      const size_t b = (size_t)(r0 / BS) * Dp;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float sxi = sx[b + d0 + ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float sc = __fmul_rn(sxi, sy[b + e0 + tx * 4 + j]);
          acc_f[i][j] = __fadd_rn(acc_f[i][j], __fmul_rn(__int2float_rn(acc_i[i][j]), sc));
          acc_i[i][j] = 0;
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      A[(size_t)(d0 + ty * 4 + i) * Dp + e0 + tx * 4 + j] = acc_f[i][j];
}

// ---------------------------------------------------------------- K6 / K10
// A[d, e] = (carry[d, e] +) sum_r X[r, d] * Y[r, e] in f32 FMA (never TF32),
// operands f32 or bf16 (bf16 products are exact in f32). The chunk's sum is
// formed in registers and added to the carry once, in the epilogue. Rows
// and columns are masked, so any (rows, D) shape with row stride ld works.
//
// ---------------------------------------------------------------- K7 / K9 / K11
// The weighted form (kWeighted, Y = X): the left operand is X[r, d] * w_r
// multiplied in f32 and rounded once to T before the product — the
// reference's (j1 * w).astype(j1.dtype) — with w_r = h[r * hstride + pq].
// For K11 the grid's y index picks a class pair, pq = cls[blockIdx.y] =
// p*C + q, and the output block A + pq * ldc * ldc; K7/K9 pass no cls
// (pq = 0, one output).
template <typename T, bool kWeighted>
__global__ void __launch_bounds__(kThreads)
gram_f_kernel(const T* __restrict__ X, const T* __restrict__ Y, const float* __restrict__ h,
              int hstride, const int* __restrict__ cls, float* __restrict__ A,
              const int* __restrict__ pairs, int rows, int D, int ld, int ldc, int has_acc) {
  constexpr int BK = 16;
  __shared__ __align__(16) float sX[BK][kTile];
  __shared__ __align__(16) float sY[BK][kTile];
  const int* pr = pairs + 3 * blockIdx.x;
  const int d0 = pr[0] * kTile, e0 = pr[1] * kTile;
  const int pq = (kWeighted && cls) ? cls[blockIdx.y] : 0;
  A += (size_t)pq * ldc * ldc;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int r0 = 0; r0 < rows; r0 += BK) {
#pragma unroll
    for (int k = 0; k < BK * kTile / kThreads; ++k) {
      const int idx = tid + k * kThreads, rr = idx / kTile, cc = idx % kTile;
      const int r = r0 + rr;
      float x = 0.f;
      if (r < rows && d0 + cc < D) {
        x = to_f32(X[(size_t)r * ld + d0 + cc]);
        if constexpr (kWeighted)
          x = to_f32(from_f32<T>(__fmul_rn(x, h[(size_t)r * hstride + pq])));
      }
      sX[rr][cc] = x;
      sY[rr][cc] = (r < rows && e0 + cc < D) ? to_f32(Y[(size_t)r * ld + e0 + cc]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 xv = *reinterpret_cast<const float4*>(&sX[k][ty * 4]);
      const float4 yv = *reinterpret_cast<const float4*>(&sY[k][tx * 4]);
      const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
      const float ys[4] = {yv.x, yv.y, yv.z, yv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xs[i], ys[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int d = d0 + ty * 4 + i;
    if (d >= D) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = e0 + tx * 4 + j;
      if (e >= D) continue;
      float* out = A + (size_t)d * ldc + e;
      *out = has_acc ? *out + acc[i][j] : acc[i][j];
    }
  }
}

inline int launch_status() { return (int)cudaGetLastError(); }

}  // namespace

extern "C" {

int tnf_retile_hmix_bf16(const void* J, const void* H, void* Jt, void* Kt,
                         int S, int C, int D, int Dp, void* stream) {
  if (C > kMaxC) return (int)cudaErrorInvalidValue;
  dim3 grid(S, (Dp + 255) / 256);
  retile_hmix_kernel<__nv_bfloat16><<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)J, (const float*)H, (__nv_bfloat16*)Jt, (__nv_bfloat16*)Kt,
      S, C, D, Dp);
  return launch_status();
}

int tnf_retile_hmix_f32(const void* J, const void* H, void* Jt, void* Kt,
                        int S, int C, int D, int Dp, void* stream) {
  if (C > kMaxC) return (int)cudaErrorInvalidValue;
  dim3 grid(S, (Dp + 255) / 256);
  retile_hmix_kernel<float><<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const float*)J, (const float*)H, (float*)Jt, (float*)Kt, S, C, D, Dp);
  return launch_status();
}

int tnf_retile_rows_bf16(const void* X, const void* h, void* Jt, void* Kt, int rows, int D,
                         int Dp, void* stream) {
  dim3 grid((Dp + 255) / 256, rows < 65535 ? rows : 65535);
  retile_rows_kernel<__nv_bfloat16><<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)X, (const float*)h, (__nv_bfloat16*)Jt, (__nv_bfloat16*)Kt, rows,
      D, Dp);
  return launch_status();
}

int tnf_retile_rows_f32(const void* X, const void* h, void* Jt, void* Kt, int rows, int D,
                        int Dp, void* stream) {
  dim3 grid((Dp + 255) / 256, rows < 65535 ? rows : 65535);
  retile_rows_kernel<float><<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const float*)X, (const float*)h, (float*)Jt, (float*)Kt, rows, D, Dp);
  return launch_status();
}

int tnf_quantize_bf16(const void* X, void* Q, void* Sc, int rows, int Dp, int BS,
                      int nb, void* stream) {
  if (Dp % 64) return (int)cudaErrorInvalidValue;
  dim3 grid(Dp / 64, nb), block(64, 4);
  quantize_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)X, (int8_t*)Q, (float*)Sc, rows, Dp, BS);
  return launch_status();
}

int tnf_gram_q(const void* Q1, const void* s1, const void* Q2, const void* s2, void* A,
               const void* pairs, int npairs, int Bp, int Dp, int BS, int has_acc,
               void* stream) {
  if (Dp % kTile || Bp % 32 || BS % 32 || Bp % BS) return (int)cudaErrorInvalidValue;
  gram_q_kernel<<<npairs, kThreads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)Q1, (const float*)s1, (const int8_t*)Q2, (const float*)s2,
      (float*)A, (const int*)pairs, Bp, Dp, BS, has_acc);
  return launch_status();
}

int tnf_gram_f32(const void* X, const void* Y, void* A, const void* pairs, int npairs,
                 int rows, int D, int ld, int ldc, int has_acc, void* stream) {
  gram_f_kernel<float, false><<<npairs, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)X, (const float*)Y, nullptr, 0, nullptr, (float*)A, (const int*)pairs,
      rows, D, ld, ldc, has_acc);
  return launch_status();
}

int tnf_gram_bf16(const void* X, const void* Y, void* A, const void* pairs, int npairs,
                  int rows, int D, int ld, int ldc, int has_acc, void* stream) {
  gram_f_kernel<__nv_bfloat16, false><<<npairs, kThreads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)X, (const __nv_bfloat16*)Y, nullptr, 0, nullptr, (float*)A,
      (const int*)pairs, rows, D, ld, ldc, has_acc);
  return launch_status();
}

// The weighted Gram: h is (rows, hstride) f32; cls (ncls class pairs, may
// be null with ncls = 1) selects the h column and output block per grid row.
int tnf_wgram_f32(const void* X, const void* h, int hstride, const void* cls, int ncls,
                  void* A, const void* pairs, int npairs, int rows, int D, int ld, int ldc,
                  int has_acc, void* stream) {
  if (ncls < 1 || ncls > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid(npairs, ncls);
  gram_f_kernel<float, true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)X, (const float*)X, (const float*)h, hstride, (const int*)cls, (float*)A,
      (const int*)pairs, rows, D, ld, ldc, has_acc);
  return launch_status();
}

int tnf_wgram_bf16(const void* X, const void* h, int hstride, const void* cls, int ncls,
                   void* A, const void* pairs, int npairs, int rows, int D, int ld, int ldc,
                   int has_acc, void* stream) {
  if (ncls < 1 || ncls > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid(npairs, ncls);
  gram_f_kernel<__nv_bfloat16, true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)X, (const __nv_bfloat16*)X, (const float*)h, hstride,
      (const int*)cls, (float*)A, (const int*)pairs, rows, D, ld, ldc, has_acc);
  return launch_status();
}

int tnf_gram_tile() { return kTile; }

}  // extern "C"
