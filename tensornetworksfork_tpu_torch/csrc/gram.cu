// Gram-path kernels of the sweep trainer, hand-written for Hopper (sm_90a).
//
// Port of the Pallas kernels in tensornetworksfork_tpu/ops/pallas/gram.py
// (the float Grams K6, K7, K9, K10 and K11 are in wgram.cu, the int8 Gram
// K3/K4 in qgram.cu). Three kernels, each behind plain-C entry points that
// tensornetworksfork_tpu_torch/ops/cuda/gram.py binds with ctypes. Every
// entry launches on the caller's stream, allocates nothing, and returns cudaGetLastError() so the wrapper can raise.
//
//   retile_hmix  <- _make_retile_hmix_kernel / retile_hmix   (K1)
//   retile_rows  <- _retile_copy_kernel / retile_rows         (K8)
//   quantize     <- _quant_kernel / quantize_tiled           (K2)
//
// Layouts: an operand is row-major (rows, cols); rows are (class, sample)
// pairs, columns the node's flattened D. The quantiser writes its int8
// codes K-major, (cols, ldq): each column's codes contiguous, as the int8
// Gram's tensor cores read them.
//
// Numerics that must match the reference bit for bit are written with
// explicit _rn intrinsics, so nvcc cannot contract a multiply and an add
// into one FMA: the class mix of K1, the weighting of K8 and the quantiser
// of K2 (and, in qgram.cu, the per-block rescale of K3). Build without
// --use_fast_math.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kMaxC = 16;  // largest class count K1 keeps in registers

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
// One CTA per (strip of W = 8, 16 or 32 columns, quantisation block of BS
// rows; ops/cuda/gram.py quant_strip picks W, 32 up to BS = 2,048), reading
// its block of X once into registers: thread t holds the unit of 16 rows
// (rg = t / (W/8)) x 8 columns (cc = t % (W/8)) as 16 loads of 16 bytes. The
// column max is reduced by warp shuffles and shared memory, then each thread
// quantises its unit and writes it K-major: for each of its 8 columns the
// 16 codes of its rows, one 16-byte store into Qt[column, rows]. s = m *
// f32(1/127) (1 for a zero column) — the reference's m / 127.0 as XLA
// evaluates a division by a constant — and q = round-half-even(x * (1/s)),
// 1/s an IEEE reciprocal. Rows >= `rows` read as zero (row padding); the
// last block's CTAs also write zero codes past Bp (up to ldq). Bound by
// bytes: the flagship's 18,432 x 16,384 bf16 operand is 604 MB read and
// 302 MB written, 0.27 ms at 3.35 TB/s.
constexpr int kQuantThreads = 512;  // at most (BS / 16) * (W / 8) units a CTA

__global__ void __launch_bounds__(kQuantThreads)
quantize_kernel(const __nv_bfloat16* __restrict__ X, int8_t* __restrict__ Qt,
                float* __restrict__ Sc, int rows, int Dp, int BS, int ldq, int Bp, int W) {
  __shared__ float red[kQuantThreads / 32][32];
  __shared__ float sinv[32];
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int ncc = W / 8, cc = t % ncc, rg = t / ncc;
  const bool live = rg < BS / 16;
  const int c0 = blockIdx.x * W + cc * 8;  // the unit's first column
  const int r0 = blockIdx.y * BS + rg * 16;  // and row
  uint4 v[16];
#pragma unroll
  for (int i = 0; i < 16; ++i)
    v[i] = live && r0 + i < rows
               ? __ldcs(reinterpret_cast<const uint4*>(X + (size_t)(r0 + i) * Dp + c0))
               : make_uint4(0u, 0u, 0u, 0u);
  auto value = [&](int i, int j) {  // X[r0 + i, c0 + j] in f32
    const __nv_bfloat162 h = reinterpret_cast<const __nv_bfloat162*>(&v[i])[j / 2];
    return (j & 1) ? __high2float(h) : __low2float(h);
  };
  // the column max of |x|, exact in bf16, on pairs of columns; lanes of one
  // column chunk differ in the bits at and above ncc
  __nv_bfloat162 m[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    m[k] = __habs2(reinterpret_cast<const __nv_bfloat162*>(&v[0])[k]);
#pragma unroll
    for (int i = 1; i < 16; ++i)
      m[k] = __hmax2(m[k], __habs2(reinterpret_cast<const __nv_bfloat162*>(&v[i])[k]));
  }
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1)
    if (off >= ncc) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint32_t o = __shfl_xor_sync(0xffffffffu, *reinterpret_cast<uint32_t*>(&m[k]), off);
        m[k] = __hmax2(m[k], *reinterpret_cast<const __nv_bfloat162*>(&o));
      }
    }
  if (lane < ncc) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      red[warp][cc * 8 + 2 * k] = __low2float(m[k]);
      red[warp][cc * 8 + 2 * k + 1] = __high2float(m[k]);
    }
  }
  __syncthreads();
  for (int c = t; c < W; c += blockDim.x) {
    float mm = 0.f;
    for (int w = 0; w < (int)blockDim.x / 32; ++w) mm = fmaxf(mm, red[w][c]);
    const float s = mm > 0.f ? __fmul_rn(mm, 1.0f / 127.0f) : 1.0f;
    sinv[c] = __frcp_rn(s);
    Sc[(size_t)blockIdx.y * Dp + blockIdx.x * W + c] = s;
  }
  __syncthreads();
  if (live) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float inv = sinv[cc * 8 + j];
      uint32_t word[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        word[q] = 0u;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int code = __float2int_rn(__fmul_rn(value(4 * q + u, j), inv));
          word[q] |= (uint32_t)(code & 0xff) << (8 * u);
        }
      }
      *reinterpret_cast<uint4*>(Qt + (size_t)(c0 + j) * ldq + r0) =
          make_uint4(word[0], word[1], word[2], word[3]);
    }
  }
  if (blockIdx.y == gridDim.y - 1) {  // zero codes past Bp
    const int nz = (ldq - Bp) / 16;
    for (int i = t; i < W * nz; i += blockDim.x)
      *reinterpret_cast<uint4*>(Qt + (size_t)(blockIdx.x * W + i / nz) * ldq + Bp + 16 * (i % nz)) =
          make_uint4(0u, 0u, 0u, 0u);
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

int tnf_quantize_bf16(const void* X, void* Qt, void* Sc, int rows, int Dp, int BS, int nb,
                      int ldq, int W, void* stream) {
  const int units = (BS / 16) * (W / 8);
  if ((W != 8 && W != 16 && W != 32) || Dp % W || BS < 32 || BS % 32 || nb < 1 ||
      units > kQuantThreads || ldq % 16 || ldq < nb * BS ||
      (reinterpret_cast<uintptr_t>(X) & 15) || (reinterpret_cast<uintptr_t>(Qt) & 15))
    return (int)cudaErrorInvalidValue;
  dim3 grid(Dp / W, nb);
  quantize_kernel<<<grid, (units + 31) / 32 * 32, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)X, (int8_t*)Qt, (float*)Sc, rows, Dp, BS, ldq, nb * BS, W);
  return launch_status();
}

}  // extern "C"
