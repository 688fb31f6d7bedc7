// Gram-path kernels of the sweep trainer, hand-written for Hopper (sm_90a).
//
// Port of the Pallas kernels in tensornetworksfork_tpu/ops/pallas/gram.py
// (the float Grams K6, K7, K9, K10 and K11 are in wgram.cu). Four kernels,
// each behind plain-C entry points that tensornetworksfork_tpu_torch/ops/cuda/gram.py
// binds with ctypes. Every entry launches on the caller's stream, allocates
// nothing, and returns cudaGetLastError() so the wrapper can raise.
//
//   retile_hmix  <- _make_retile_hmix_kernel / retile_hmix   (K1)
//   retile_rows  <- _retile_copy_kernel / retile_rows         (K8)
//   quantize     <- _quant_kernel / quantize_tiled           (K2)
//   gram_q       <- _make_band_kernel_q / gram_pair_band_q    (K3) and
//                   _pair_kernel_tiled_q / gram_pair_tiled_q  (K4)
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
// diagonal route's K, formed while X is in registers. Bound by bytes: one
// read of X, one or two writes. A thread moves packs of V values (V = 16
// bytes' worth where D, Dp and the pointers allow, else 1): each grid-stride
// pass loads kRU packs before it stores them, and the grid is sized to the SMs.
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

constexpr int kRU = 4;  // packs a thread has in flight

template <typename T, int V>
__global__ void __launch_bounds__(256)
retile_rows_kernel(const T* __restrict__ X, const float* __restrict__ h, T* __restrict__ Jt,
                   T* __restrict__ Kt, int rows, int D, int Dp) {
  using P = Pack<T, V>;
  const int nv = Dp / V, nvd = D / V;  // packs a row, of them from X
  const long long n = (long long)rows * nv;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i0 = (long long)blockIdx.x * blockDim.x + threadIdx.x; i0 < n;
       i0 += kRU * stride) {
    P x[kRU];
    int r[kRU], c[kRU];
#pragma unroll
    for (int u = 0; u < kRU; ++u) {
      const long long i = i0 + u * stride;
      r[u] = (int)(i / nv);
      c[u] = (int)(i - (long long)r[u] * nv);
#pragma unroll
      for (int j = 0; j < V; ++j) x[u].v[j] = from_f32<T>(0.f);
      if (i < n && c[u] < nvd) x[u] = reinterpret_cast<const P*>(X + (size_t)r[u] * D)[c[u]];
    }
#pragma unroll
    for (int u = 0; u < kRU; ++u) {
      if (i0 + u * stride >= n) break;
      const size_t o = (size_t)r[u] * nv + c[u];
      reinterpret_cast<P*>(Jt)[o] = x[u];
      if (Kt) {
        P k = x[u];
        if (c[u] < nvd) {
          const float hr = h[r[u]];
#pragma unroll
          for (int j = 0; j < V; ++j) k.v[j] = from_f32<T>(__fmul_rn(to_f32(x[u].v[j]), hr));
        }
        reinterpret_cast<P*>(Kt)[o] = k;
      }
    }
  }
}

template <typename T>
int launch_retile_rows(const T* X, const float* h, T* Jt, T* Kt, int rows, int D, int Dp,
                       int sms, cudaStream_t stream) {
  if (rows < 1 || D < 1 || Dp < D || sms < 1) return (int)cudaErrorInvalidValue;
  constexpr int V = 16 / sizeof(T);
  auto al = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  const bool vec = D % V == 0 && Dp % V == 0 && al(X) && al(Jt) && (!Kt || al(Kt));
  const long long n = (long long)rows * (vec ? Dp / V : Dp);
  const long long want = (n + 256LL * kRU - 1) / (256LL * kRU);
  const int blocks = (int)(want < 8LL * sms ? want : 8LL * sms);  // 2,048 threads an SM
  if (vec)
    retile_rows_kernel<T, V><<<blocks, 256, 0, stream>>>(X, h, Jt, Kt, rows, D, Dp);
  else
    retile_rows_kernel<T, 1><<<blocks, 256, 0, stream>>>(X, h, Jt, Kt, rows, D, Dp);
  return (int)cudaGetLastError();
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
                         int Dp, int sms, void* stream) {
  return launch_retile_rows<__nv_bfloat16>((const __nv_bfloat16*)X, (const float*)h,
                                           (__nv_bfloat16*)Jt, (__nv_bfloat16*)Kt, rows, D, Dp,
                                           sms, (cudaStream_t)stream);
}

int tnf_retile_rows_f32(const void* X, const void* h, void* Jt, void* Kt, int rows, int D,
                        int Dp, int sms, void* stream) {
  return launch_retile_rows<float>((const float*)X, (const float*)h, (float*)Jt, (float*)Kt,
                                   rows, D, Dp, sms, (cudaStream_t)stream);
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

int tnf_gram_tile() { return kTile; }

}  // extern "C"
