// Mamba-2 SSD (selective state space) scan for Hopper (sm_90a), plain C
// interface for ctypes.
//
// Replaces the Pallas TPU kernel `_ssd_kernel` / `ssd_bhsp`
// (src/repro/kernels/mamba2_ssd.py). Per (b, h), with group g = h / (H / G),
// from h_0 = 0:
//     h_t = exp(dt_t A) h_{t-1} + B_t (dt_t x_t)^T      (N x P, fp32)
//     y_t = C_t^T h_t + D x_t
// with fp32 accumulation and output in x's type.
//
// Bound on the H100: bytes. At the zamba2-7b prefill shape (B=4, S=2048,
// H=112, P=64, G=1, N=64; bf16 x, B, C and y, fp32 dt) the kernel must move
// x and y (117 MB each), dt (3.7 MB) and B and C (1 MB each), about 240 MB,
// about 0.072 ms at 3.35 TB/s, while its 4 N P FLOP per token and head come
// to 1.5e10 FLOP, about 15 us even at the bf16 tensor-core rate. What this
// first design does about it: x, dt and y are moved once, through the
// model's (B, S, H, P) strides with no transposed copy; B and C are read
// once per head that shares their group (the L2 cache serves the repeats);
// the state never leaves registers. It does not reach the bound: the walk
// over tokens is sequential inside a block.
//
// Design. The Pallas kernel's chunked matrix form carries the state across a
// sequential grid dimension in VMEM and factors the intra-chunk decay as
// exp(cum_t - tot/2) * exp(tot/2 - cum_j), which overflows fp32 once a
// chunk's summed log-decay passes about -176. Hopper's blocks run in no
// order, so one block per (b, h) walks the recurrence itself in time order:
// thread p owns column p of the state (N registers). Per token the only
// exponent is dt_t A <= 0, so nothing can overflow for any decay. Tokens are
// staged TCH at a time in shared memory (x by its own thread, B, C, dt and
// exp(dt A) by the whole block, all loads coalesced and issued together);
// per staged token each thread does
//     h_np = exp(dt A) h_np + B_n dt x_p,   y_p = sum_n C_n h_np + D x_p.
// Any S >= 1, P <= 128 and N <= 64 are handled by masking; no divisibility
// is assumed.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int TCH = 32;        // tokens staged in shared memory at a time
constexpr int NMAX = 64;
constexpr int PMAX = 128;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Args {
  long long x_sb, x_ss, x_sh;     // element strides (batch, sequence, head);
  long long dt_sb, dt_ss, dt_sh;  // P and N dims are contiguous
  long long b_sb, b_ss, b_sg;
  long long c_sb, c_ss, c_sg;
  long long y_sb, y_ss, y_sh;
  int S, H, G, P, N;
};

template <typename T, int NT, int PT>
__global__ void __launch_bounds__(PT)
ssd_fwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const T* __restrict__ Bm,
               const T* __restrict__ Cm, const float* __restrict__ D,
               T* __restrict__ y, Args a) {
  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh % a.H;
  const int g = h / (a.H / a.G);
  const int p = threadIdx.x;                  // state column and channel
  const bool live = p < a.P;

  __shared__ __align__(16) float s_B[TCH][NT];
  __shared__ __align__(16) float s_C[TCH][NT];
  __shared__ float s_x[TCH][PT];
  __shared__ float s_dt[TCH];
  __shared__ float s_a[TCH];                  // exp(dt A)

  const T* xb = x + b * a.x_sb + h * a.x_sh;
  const float* db = dt + b * a.dt_sb + h * a.dt_sh;
  const T* bb = Bm + b * a.b_sb + g * a.b_sg;
  const T* cb = Cm + b * a.c_sb + g * a.c_sg;
  T* yb = y + b * a.y_sb + h * a.y_sh;
  const float Ah = A[h], Dh = D[h];

  float st[NT];                               // st[n] = h_np
#pragma unroll
  for (int n = 0; n < NT; ++n) st[n] = 0.f;

  for (int t0 = 0; t0 < a.S; t0 += TCH) {
    const int cnt = min(TCH, a.S - t0);
    // stage; masked tokens and state rows get zeros (and decay 1), so they
    // leave the state and y unchanged
#pragma unroll 8
    for (int t = 0; t < TCH; ++t) {
      const bool ok = live && t < cnt;
      s_x[t][p] = ok ? to_f32(xb[(long long)(t0 + t) * a.x_ss + p]) : 0.f;
    }
    for (int i = p; i < TCH * NT; i += PT) {
      const int t = i / NT, n = i % NT;
      const bool ok = t < cnt && n < a.N;
      const long long ts = t0 + t;
      s_B[t][n] = ok ? to_f32(bb[ts * a.b_ss + n]) : 0.f;
      s_C[t][n] = ok ? to_f32(cb[ts * a.c_ss + n]) : 0.f;
    }
    for (int t = p; t < TCH; t += PT) {
      const float d = t < cnt ? db[(long long)(t0 + t) * a.dt_ss] : 0.f;
      s_dt[t] = d;
      s_a[t] = expf(d * Ah);
    }
    __syncthreads();

    for (int t = 0; t < cnt; ++t) {
      const float xv = s_x[t][p];
      const float xd = s_dt[t] * xv;
      const float at = s_a[t];
      float acc0 = 0.f, acc1 = 0.f;           // two chains of FMAs
#pragma unroll
      for (int n = 0; n < NT; n += 4) {
        const float4 b4 = *reinterpret_cast<const float4*>(&s_B[t][n]);
        const float4 c4 = *reinterpret_cast<const float4*>(&s_C[t][n]);
        st[n] = fmaf(at, st[n], b4.x * xd);
        acc0 = fmaf(c4.x, st[n], acc0);
        st[n + 1] = fmaf(at, st[n + 1], b4.y * xd);
        acc1 = fmaf(c4.y, st[n + 1], acc1);
        st[n + 2] = fmaf(at, st[n + 2], b4.z * xd);
        acc0 = fmaf(c4.z, st[n + 2], acc0);
        st[n + 3] = fmaf(at, st[n + 3], b4.w * xd);
        acc1 = fmaf(c4.w, st[n + 3], acc1);
      }
      if (live)
        yb[(long long)(t0 + t) * a.y_ss + p] = from_f32<T>(acc0 + acc1 + Dh * xv);
    }
    __syncthreads();                          // before the next stage
  }
}

template <typename T, int NT, int PT>
cudaError_t launch_t(const void* x, const void* dt, const float* A,
                     const void* Bm, const void* Cm, const float* D, void* y,
                     int B, const Args& a, cudaStream_t stream) {
  ssd_fwd_kernel<T, NT, PT><<<B * a.H, PT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), A,
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), D,
      static_cast<T*>(y), a);
  return cudaGetLastError();
}

template <typename T, int NT>
cudaError_t launch_n(const void* x, const void* dt, const float* A,
                     const void* Bm, const void* Cm, const float* D, void* y,
                     int B, const Args& a, cudaStream_t stream) {
  if (a.P <= 32) return launch_t<T, NT, 32>(x, dt, A, Bm, Cm, D, y, B, a, stream);
  if (a.P <= 64) return launch_t<T, NT, 64>(x, dt, A, Bm, Cm, D, y, B, a, stream);
  return launch_t<T, NT, 128>(x, dt, A, Bm, Cm, D, y, B, a, stream);
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const float* A,
                   const void* Bm, const void* Cm, const float* D, void* y,
                   int B, const Args& a, cudaStream_t stream) {
  if (a.N <= 16) return launch_n<T, 16>(x, dt, A, Bm, Cm, D, y, B, a, stream);
  if (a.N <= 32) return launch_n<T, 32>(x, dt, A, Bm, Cm, D, y, B, a, stream);
  return launch_n<T, 64>(x, dt, A, Bm, Cm, D, y, B, a, stream);
}

}  // namespace

// dtype (x, B, C, y): 0 = float32, 1 = bfloat16. dt is float32; A and D
// are float32 (H,), contiguous. Strides are in elements, ordered (batch,
// sequence, head or group). Returns a cudaError_t as int (0 = launched).
extern "C" int ssd_fwd(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, const void* D, void* y, int dtype, int B, int S,
    int H, int G, int P, int N, long long x_sb, long long x_ss, long long x_sh,
    long long dt_sb, long long dt_ss, long long dt_sh, long long b_sb,
    long long b_ss, long long b_sg, long long c_sb, long long c_ss,
    long long c_sg, long long y_sb, long long y_ss, long long y_sh, int device,
    void* stream) {
  if (B < 1 || S < 1 || H < 1 || G < 1 || H % G != 0 || P < 1 || P > PMAX ||
      N < 1 || N > NMAX)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Args a{x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh, b_sb, b_ss, b_sg,
               c_sb, c_ss, c_sg, y_sb, y_ss, y_sh, S, H, G, P, N};
  const float* Af = static_cast<const float*>(A);
  const float* Df = static_cast<const float*>(D);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = launch<float>(x, dt, Af, Bm, Cm, Df, y, B, a, st);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(x, dt, Af, Bm, Cm, Df, y, B, a, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)err;
}
