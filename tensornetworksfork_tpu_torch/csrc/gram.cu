// Gram-path kernels of the sweep trainer, hand-written for Hopper (sm_90a).
//
// Port of the Pallas kernels in tensornetworksfork_tpu/ops/pallas/gram.py
// (the float Grams K6, K7, K9, K10 and K11 are in wgram.cu, the int8 Gram
// K3/K4 in qgram.cu). Three kernels, each behind plain-C entry points that
// tensornetworksfork_tpu_torch/ops/cuda/gram.py binds with ctypes. Every
// entry launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() so the wrapper can raise.
//
//   retile_hmix  <- _make_retile_hmix_kernel / retile_hmix   (K1; it also
//                   forms the rhs Jtᵀg, which the reference engine takes by
//                   a separate dot over Jt)
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

// A pack of V values of T, moved as one load or store (16 bytes where the
// shapes and pointers allow, else one value).
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ Pack<T, V> zero_pack() {
  Pack<T, V> z;
#pragma unroll
  for (int j = 0; j < V; ++j) z.v[j] = from_f32<T>(0.f);
  return z;
}

// ---------------------------------------------------------------- K1
// Jt[c*S + s, d] = J[s, c, d] and Kt[c*S + s, d] = sum_e H[s, c, e] J[s, e, d]:
// rows class-major, columns D..Dp-1 zero, the mix in f32 in order e = 0..C-1
// with _rn intrinsics, rounded once to T. With g ((C*S,) class-major, in T)
// also the rhs b = Jtᵀg: part[run, d] is the sum over the run's samples s,
// in order, and the classes c of g[c*S + s] * J[s, c, d] in f32 (written
// straight into b when there is one run; else hmix_b_reduce_kernel adds the
// runs in order, so b is the same from run to run: no atomics).
//
// Bound by bytes: one read of J and two writes of its size (g and b are
// smaller by a factor of D and of S*C). A CTA owns a strip of kHmixThreads packs of V
// columns (16 bytes: 8 bf16 or 4 f32 values; 8 bytes for bf16 beyond 10
// classes, below; V = 1 where D, Dp or a pointer is not aligned to them)
// and a run of samples; the wrapper sizes the grid
// (strips x runs) to the SMs. The CTA stages its samples' H rows and g
// values into shared memory kHmixChunk samples at a time, each in one
// coalesced copy; a thread then loads the C class packs of U samples (about
// kHmixValues values of J) before it mixes and stores them, so J is read
// once in 16-byte loads and Jt, Kt are written in 16-byte stores; padding
// packs are written as zero packs without a load. CC is the class count,
// fixed at compile time on the packed path so the packs stay in registers;
// 0 (the one-value path) reads C at run time, up to kMaxC.
//
// Registers: the mix reads each value of J C times, so nvcc widens all of a
// thread's bf16 values to f32 once and keeps them; at the 128 registers of
// two CTAs an SM, 16-byte bf16 packs of more than 10 classes (88 values and
// up) spill, and such class counts take 8-byte packs (hmix_pack_values).
constexpr int kHmixThreads = 256;
constexpr int kHmixChunk = 32;   // samples whose H rows a CTA stages at once
constexpr int kHmixValues = 64;  // values of J a thread loads before it stores

// values of T in a pack of the packed path for CC classes
template <typename T>
__host__ __device__ constexpr int hmix_pack_values(int CC) {
  return sizeof(T) == 2 && CC > 10 ? 4 : 16 / (int)sizeof(T);
}

// samples a thread holds at once: U = kHmixValues / (CC * V), at least 1
__host__ __device__ constexpr int hmix_samples(int CC, int V) {
  return CC == 0 || CC * V >= kHmixValues ? 1 : kHmixValues / (CC * V);
}

template <typename T, int V, int CC>
__global__ void __launch_bounds__(kHmixThreads, 2)
retile_hmix_kernel(const T* __restrict__ J, const float* __restrict__ H,
                   const T* __restrict__ g, T* __restrict__ Jt, T* __restrict__ Kt,
                   float* __restrict__ part, int S, int C, int D, int Dp, int rps) {
  using P = Pack<T, V>;
  constexpr int CM = CC ? CC : kMaxC;  // class slots in registers
  constexpr int U = hmix_samples(CC, V);
  extern __shared__ float smem[];
  const int nc = CC ? CC : C;
  float* sH = smem;                         // [kHmixChunk][C][C]
  float* sG = smem + kHmixChunk * nc * nc;  // [C][kHmixChunk]
  const int nv = Dp / V, nvd = D / V;       // packs a row, of them from J
  const int p = blockIdx.x * kHmixThreads + threadIdx.x;
  const bool live = p < nv, data = p < nvd;
  const int s0 = blockIdx.y * rps, s1 = min(S, s0 + rps);
  const P* Jp = reinterpret_cast<const P*>(J);
  P* Jtp = reinterpret_cast<P*>(Jt);
  P* Ktp = reinterpret_cast<P*>(Kt);
  float bs[V];
#pragma unroll
  for (int j = 0; j < V; ++j) bs[j] = 0.f;
  for (int c0 = s0; c0 < s1; c0 += kHmixChunk) {
    const int n = min(kHmixChunk, s1 - c0);
    __syncthreads();  // the last chunk's readers are done
    for (int i = threadIdx.x; i < n * nc * nc; i += kHmixThreads)
      sH[i] = H[(size_t)c0 * nc * nc + i];
    if (g)
      for (int i = threadIdx.x; i < nc * n; i += kHmixThreads)
        sG[(i / n) * kHmixChunk + i % n] = to_f32(g[(size_t)(i / n) * S + c0 + i % n]);
    __syncthreads();
    if (!live) continue;
    for (int k = 0; k < n; k += U) {
      P x[U][CM];
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int e = 0; e < CM; ++e)
          if (data && k + u < n && (CC || e < nc))
            x[u][e] = Jp[((size_t)(c0 + k + u) * nc + e) * nvd + p];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (k + u >= n) break;
        const int s = c0 + k + u;
        const float* h = sH + (k + u) * nc * nc;
#pragma unroll
        for (int c = 0; c < CM; ++c) {
          if (!(CC || c < nc)) break;
          const size_t o = ((size_t)c * S + s) * nv + p;
          if (!data) {
            Jtp[o] = zero_pack<T, V>();
            Ktp[o] = zero_pack<T, V>();
            continue;
          }
          float a[V];
          const float h0 = h[c * nc];
#pragma unroll
          for (int j = 0; j < V; ++j) a[j] = __fmul_rn(h0, to_f32(x[u][0].v[j]));
#pragma unroll
          for (int e = 1; e < CM; ++e) {
            if (!(CC || e < nc)) break;
            const float he = h[c * nc + e];
#pragma unroll
            for (int j = 0; j < V; ++j)
              a[j] = __fadd_rn(a[j], __fmul_rn(he, to_f32(x[u][e].v[j])));
          }
          P kp;
#pragma unroll
          for (int j = 0; j < V; ++j) kp.v[j] = from_f32<T>(a[j]);
          Jtp[o] = x[u][c];
          Ktp[o] = kp;
          if (g) {
            const float gc = sG[c * kHmixChunk + k + u];
#pragma unroll
            for (int j = 0; j < V; ++j) bs[j] = __fmaf_rn(gc, to_f32(x[u][c].v[j]), bs[j]);
          }
        }
      }
    }
  }
  if (g && live) {
    float* dst = part + (size_t)blockIdx.y * Dp + (size_t)p * V;
#pragma unroll
    for (int j = 0; j < V; ++j) dst[j] = bs[j];
  }
}

// b[d] = part[0, d] + part[1, d] + ..., in run order.
__global__ void hmix_b_reduce_kernel(const float* __restrict__ part, float* __restrict__ b,
                                     int runs, int Dp) {
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= Dp) return;
  float s = part[d];
  for (int z = 1; z < runs; ++z) s = __fadd_rn(s, part[(size_t)z * Dp + d]);
  b[d] = s;
}

struct HmixArgs {
  const void* J;
  const float* H;
  const void* g;
  void* Jt;
  void* Kt;
  float* part;
  int S, C, D, Dp, rps;
};

template <typename T, int V, int CC>
void launch_hmix_kernel(const HmixArgs& a, dim3 grid, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (kHmixChunk * a.C * a.C + a.C * kHmixChunk);
  retile_hmix_kernel<T, V, CC><<<grid, kHmixThreads, smem, stream>>>(
      (const T*)a.J, a.H, (const T*)a.g, (T*)a.Jt, (T*)a.Kt, a.part, a.S, a.C, a.D, a.Dp,
      a.rps);
}

// the packed kernel for the class count a.C (1..kMaxC), fixed at compile time
template <typename T, int CC>
void launch_hmix_packed(const HmixArgs& a, dim3 grid, cudaStream_t stream) {
  constexpr int V = hmix_pack_values<T>(CC);
  if constexpr (CC <= kMaxC) {
    if (a.C == CC)
      launch_hmix_kernel<T, V, CC>(a, grid, stream);
    else
      launch_hmix_packed<T, CC + 1>(a, grid, stream);
  }
}

// K1 over runs of rps samples, then (with g and more than one run) the
// reduction of b's partials from `part` ((runs, Dp) f32) into b.
template <typename T>
int launch_retile_hmix(HmixArgs a, float* b, cudaStream_t stream) {
  if (a.S < 1 || a.C < 1 || a.C > kMaxC || a.D < 1 || a.Dp < a.D || a.rps < 1 ||
      (a.g && !b))
    return (int)cudaErrorInvalidValue;
  const int runs = (a.S + a.rps - 1) / a.rps;
  if (a.g && runs > 1 && !a.part) return (int)cudaErrorInvalidValue;
  if (runs == 1) a.part = b;
  const int V = hmix_pack_values<T>(a.C);
  auto al = [V](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & (V * sizeof(T) - 1)) == 0;
  };
  const bool vec = a.D % V == 0 && a.Dp % V == 0 && al(a.J) && al(a.Jt) && al(a.Kt);
  const int nv = vec ? a.Dp / V : a.Dp;
  const dim3 grid((nv + kHmixThreads - 1) / kHmixThreads, runs);
  if (vec)
    launch_hmix_packed<T, 1>(a, grid, stream);
  else
    launch_hmix_kernel<T, 1, 0>(a, grid, stream);
  if (a.g && runs > 1) {
    const int status = (int)cudaGetLastError();
    if (status) return status;
    hmix_b_reduce_kernel<<<(a.Dp + 255) / 256, 256, 0, stream>>>(a.part, b, runs, a.Dp);
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- K8
// Jt[r, c] = X[r, c] for c < D and 0 for D <= c < Dp (the tiled layout:
// row-major, columns zero-padded). With Kt, also Kt[r, c] = X[r, c] * h[r]
// multiplied in f32 and rounded once to T (0 in the padding): the int8
// diagonal route's K, formed while X is in registers. Bound by bytes: one
// read of X, one or two writes. A thread moves packs of V values (V = 16
// bytes' worth where D, Dp and the pointers allow, else 1): each grid-stride
// pass loads kRU packs before it stores them, and the grid is sized to the SMs.
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

int tnf_retile_hmix_bf16(const void* J, const void* H, const void* g, void* Jt, void* Kt,
                         void* part, void* b, int S, int C, int D, int Dp, int rps,
                         void* stream) {
  return launch_retile_hmix<__nv_bfloat16>(
      HmixArgs{J, (const float*)H, g, Jt, Kt, (float*)part, S, C, D, Dp, rps}, (float*)b,
      (cudaStream_t)stream);
}

int tnf_retile_hmix_f32(const void* J, const void* H, const void* g, void* Jt, void* Kt,
                        void* part, void* b, int S, int C, int D, int Dp, int rps,
                        void* stream) {
  return launch_retile_hmix<float>(
      HmixArgs{J, (const float*)H, g, Jt, Kt, (float*)part, S, C, D, Dp, rps}, (float*)b,
      (cudaStream_t)stream);
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
