// RWKV-6 WKV recurrence for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel `_wkv6_kernel` / `wkv6_bhsk`
// (src/repro/kernels/rwkv6.py). Per (b, h), from S_0 = 0:
//     y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
//     S_t = diag(exp(logw_t)) S_{t-1} + k_t^T v_t
// with a (K x K) fp32 state, fp32 accumulation and output in r's type.
//
// Bound on the H100: bytes. At the rwkv6-7b prefill shape (B=4, S=2048,
// H=64, K=64; bf16 r, k, v and y, fp32 logw) the kernel must move
// 33.6 M elements x (3 x 2 B + 4 B + 2 B) = 403 MB, about 0.120 ms at
// 3.35 TB/s, while its 4 K^2 FLOP per token and head come to 8.6e9 FLOP,
// about 9 us even at the bf16 tensor-core rate. What this first design does
// about it: every input element is read from device memory exactly once and
// y is written once, through the model's (B, S, H, K) strides, with no
// transposed copy; the state never leaves registers. It does not reach the
// bound: the walk over tokens is sequential inside a block (as in RWKV's own
// CUDA kernel), so a block's time is S times the latency of one token step.
//
// Design. The Pallas kernel's chunked matrix form carries the state across
// a sequential grid dimension in VMEM and factors the intra-chunk decay as
// exp(a) * exp(b) with half-shifted exponents, which overflows fp32 once a
// chunk's summed log-decay passes about -176 (and gives inf * 0 = NaN at the
// mask from -88 on). Hopper's blocks run in no order, so nothing can be
// carried between blocks; instead one block per (b, h) walks the recurrence
// itself in time order. Thread j owns column j of the state (K registers).
// Per token every exponent is a single logw_t <= 0, so nothing can overflow
// for any decay. Tokens are staged TCH at a time in shared memory (each
// thread loads its own channel of r, k, v and logw, so the loads are
// coalesced and issued together); per staged token each thread does
//     y_j = sum_i r_i S_ij + v_j sum_i r_i u_i k_i,
//     S_ij = exp(logw_i) S_ij + k_i v_j,
// with the bonus sum taken once per token for the block. Any S >= 1 and any
// K <= 64 are handled by masking; no divisibility is assumed.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int TCH = 32;        // tokens staged in shared memory at a time
constexpr int KMAX = 64;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Args {
  long long r_sb, r_ss, r_sh;   // element strides (batch, sequence, head);
  long long k_sb, k_ss, k_sh;   // the K dim is contiguous
  long long v_sb, v_ss, v_sh;
  long long w_sb, w_ss, w_sh;
  long long y_sb, y_ss, y_sh;
  int S, H, K;
};

template <typename T, int KT>
__global__ void __launch_bounds__(KT)
wkv6_fwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ logw,
                const float* __restrict__ u, T* __restrict__ y, Args a) {
  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh % a.H;
  const int j = threadIdx.x;                  // state column and channel
  const bool live = j < a.K;

  __shared__ __align__(16) float s_r[TCH][KT];
  __shared__ __align__(16) float s_k[TCH][KT];
  __shared__ __align__(16) float s_w[TCH][KT];   // exp(logw)
  __shared__ float s_v[TCH][KT];
  __shared__ float s_ruk[TCH][KT];               // r_i u_i k_i
  __shared__ float s_bonus[TCH];                 // sum_i r_i u_i k_i

  const T* rb = r + b * a.r_sb + h * a.r_sh;
  const T* kb = k + b * a.k_sb + h * a.k_sh;
  const T* vb = v + b * a.v_sb + h * a.v_sh;
  const float* wb = logw + b * a.w_sb + h * a.w_sh;
  T* yb = y + b * a.y_sb + h * a.y_sh;
  const float uj = live ? u[h * a.K + j] : 0.f;

  float st[KT];                               // st[i] = S_ij
#pragma unroll
  for (int i = 0; i < KT; ++i) st[i] = 0.f;

  for (int t0 = 0; t0 < a.S; t0 += TCH) {
    const int n = min(TCH, a.S - t0);
    // stage: channel j of up to TCH tokens; masked channels and tokens get
    // r = k = v = 0 and decay 1, so they leave the state and y unchanged
#pragma unroll 8
    for (int t = 0; t < TCH; ++t) {
      const bool ok = live && t < n;
      const long long ts = t0 + t;
      const float rv = ok ? to_f32(rb[ts * a.r_ss + j]) : 0.f;
      const float kv = ok ? to_f32(kb[ts * a.k_ss + j]) : 0.f;
      const float vv = ok ? to_f32(vb[ts * a.v_ss + j]) : 0.f;
      const float lw = ok ? wb[ts * a.w_ss + j] : 0.f;
      s_r[t][j] = rv;
      s_k[t][j] = kv;
      s_v[t][j] = vv;
      s_w[t][j] = expf(lw);
      s_ruk[t][j] = rv * uj * kv;
    }
    __syncthreads();
    for (int t = j; t < n; t += KT) {
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < KT; ++i) acc += s_ruk[t][i];
      s_bonus[t] = acc;
    }
    __syncthreads();

    for (int t = 0; t < n; ++t) {
      const float vj = s_v[t][j];
      float acc0 = 0.f, acc1 = 0.f;           // two chains of FMAs
#pragma unroll
      for (int i = 0; i < KT; i += 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(&s_r[t][i]);
        const float4 k4 = *reinterpret_cast<const float4*>(&s_k[t][i]);
        const float4 w4 = *reinterpret_cast<const float4*>(&s_w[t][i]);
        acc0 = fmaf(r4.x, st[i], acc0);
        st[i] = fmaf(w4.x, st[i], k4.x * vj);
        acc1 = fmaf(r4.y, st[i + 1], acc1);
        st[i + 1] = fmaf(w4.y, st[i + 1], k4.y * vj);
        acc0 = fmaf(r4.z, st[i + 2], acc0);
        st[i + 2] = fmaf(w4.z, st[i + 2], k4.z * vj);
        acc1 = fmaf(r4.w, st[i + 3], acc1);
        st[i + 3] = fmaf(w4.w, st[i + 3], k4.w * vj);
      }
      if (live)
        yb[(long long)(t0 + t) * a.y_ss + j] =
            from_f32<T>(acc0 + acc1 + s_bonus[t] * vj);
    }
    __syncthreads();                          // before the next stage
  }
}

template <typename T, int KT>
cudaError_t launch_kt(const void* r, const void* k, const void* v,
                      const void* logw, const float* u, void* y, int B,
                      const Args& a, cudaStream_t stream) {
  wkv6_fwd_kernel<T, KT><<<B * a.H, KT, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(logw), u,
      static_cast<T*>(y), a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* logw, const float* u, void* y, int B,
                   const Args& a, cudaStream_t stream) {
  if (a.K <= 16) return launch_kt<T, 16>(r, k, v, logw, u, y, B, a, stream);
  if (a.K <= 32) return launch_kt<T, 32>(r, k, v, logw, u, y, B, a, stream);
  return launch_kt<T, 64>(r, k, v, logw, u, y, B, a, stream);
}

}  // namespace

// dtype (r, k, v, y): 0 = float32, 1 = bfloat16. logw is float32 with a
// contiguous K dim; u is float32 (H, K), contiguous. Strides are in
// elements, ordered (batch, sequence, head). Returns a cudaError_t as int
// (0 = launched).
extern "C" int wkv6_fwd(
    const void* r, const void* k, const void* v, const void* logw,
    const void* u, void* y, int dtype, int B, int S, int H, int K,
    long long r_sb, long long r_ss, long long r_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long w_sb, long long w_ss, long long w_sh,
    long long y_sb, long long y_ss, long long y_sh, int device, void* stream) {
  if (B < 1 || S < 1 || H < 1 || K < 1 || K > KMAX)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Args a{r_sb, r_ss, r_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
               w_sb, w_ss, w_sh, y_sb, y_ss, y_sh, S, H, K};
  const float* uf = static_cast<const float*>(u);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = launch<float>(r, k, v, logw, uf, y, B, a, st);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(r, k, v, logw, uf, y, B, a, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)err;
}
