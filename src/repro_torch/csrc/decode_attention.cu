// Decode attention (one query token against a KV cache) for Hopper (sm_90a),
// plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel `_decode_kernel` / `decode_attention_bhd`
// (src/repro/kernels/decode_attention.py): softmax(q k^T / sqrt(D)) v over
// the first cache_len[b] positions of each batch row, GQA through kv head
// h / (H / KV), accumulated in fp32, output in the input type.
//
// Bound on the H100: every valid cache position is read once per kv head
// (2 * sum_b cache_len[b] * KV * D elements) for 4 FLOP per element and head,
// so the kernel is bound by bytes: 33.5 MB, about 10 us at 3.35 TB/s, for
// B=4, 1024 valid positions, KV=16, D=128 in bf16. What the design does about
// it: it reads only the valid positions, reads the model's (B, S, KV, D) cache
// in place through its strides (no transposed copy), and splits the
// sequence so that enough blocks are in flight to keep the memory busy at a
// batch of four.
//
// Design (split-KV flash-decoding). Pass 1: grid (ceil(S / SPLIT), B*H),
// 4 warps per block. Each warp walks its share of the split's keys, UNROLL
// keys at a time with their loads issued together, each lane holding four of
// the D <= 128 dims; a score is a warp-shuffle sum. The warp keeps its own
// running max, sum and accumulator; the block merges its warps and writes one
// (max, sum, acc[D]) partial per split. Pass 2: one block per (b, head) merges
// the partials by their log-sum-exp. Positions >= cache_len[b] are skipped,
// which replaces the Pallas kernel's assert that block_k divides S. A row
// with no valid position gives zeros (the Pallas kernel's finite -1e30 mask
// averages all of V there; the model always has at least one position).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int SPLIT = 128;     // cache positions per pass-1 block
constexpr int WARPS = 4;
constexpr int UNROLL = 4;      // keys a warp loads at once
constexpr int DMAX = 128;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

struct Args {
  long long q_sb, q_sh;               // q (B, H, D)
  long long k_sb, k_ss, k_sh;         // caches (B, S, KV, D) through strides
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_sh;
  int S, H, KV, D, nsplit;
  float scale;
};

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const int* __restrict__ cache_len,
                      float* __restrict__ part_acc, float* __restrict__ part_ml,
                      Args a) {
  const int split = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int kvh = h / (a.H / a.KV);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int len = max(0, min(cache_len[b], a.S));
  const int start = split * SPLIT;
  const int end = min(start + SPLIT, len);

  const T* qb = q + b * a.q_sb + h * a.q_sh;
  const T* kb = k + b * a.k_sb + kvh * a.k_sh;
  const T* vb = v + b * a.v_sb + kvh * a.v_sh;

  float qv[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int d = lane * 4 + e;
    qv[e] = d < a.D ? to_f32(qb[d]) * a.scale : 0.f;
  }

  float m = -INFINITY, l = 0.f, acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int j0 = start + warp * UNROLL; j0 < end; j0 += WARPS * UNROLL) {
    float kx[UNROLL][4], vx[UNROLL][4];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = j0 + u;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = lane * 4 + e;
        const bool ok = j < end && d < a.D;
        kx[u][e] = ok ? to_f32(kb[j * a.k_ss + d]) : 0.f;
        vx[u][e] = ok ? to_f32(vb[j * a.v_ss + d]) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (j0 + u >= end) break;
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) s = fmaf(qv[e], kx[u][e], s);
      s = warp_sum(s);
      const float m_new = fmaxf(m, s);
      const float corr = expf(m - m_new);
      const float p = expf(s - m_new);
      l = l * corr + p;
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[e] = fmaf(p, vx[u][e], acc[e] * corr);
      m = m_new;
    }
  }

  __shared__ float sm_m[WARPS], sm_l[WARPS], sm_acc[WARPS][DMAX];
  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) sm_acc[warp][lane * 4 + e] = acc[e];
  __syncthreads();

  float mx = -INFINITY;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, sm_m[w]);
  const long long part = (long long)bh * a.nsplit + split;
  for (int d = threadIdx.x; d < a.D; d += blockDim.x) {
    float sum_acc = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w)
      if (sm_m[w] != -INFINITY) sum_acc += sm_acc[w][d] * expf(sm_m[w] - mx);
    part_acc[part * a.D + d] = sum_acc;
  }
  if (threadIdx.x == 0) {
    float sum_l = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w)
      if (sm_m[w] != -INFINITY) sum_l += sm_l[w] * expf(sm_m[w] - mx);
    part_ml[2 * part] = mx;
    part_ml[2 * part + 1] = sum_l;
  }
}

template <typename T>
__global__ void __launch_bounds__(DMAX)
decode_combine_kernel(const float* __restrict__ part_acc,
                      const float* __restrict__ part_ml, T* __restrict__ o,
                      Args a) {
  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh % a.H;
  const long long base = (long long)bh * a.nsplit;
  float mx = -INFINITY;
  for (int s = 0; s < a.nsplit; ++s) mx = fmaxf(mx, part_ml[2 * (base + s)]);
  const int d = threadIdx.x;
  if (d >= a.D) return;
  float sum_l = 0.f, sum_acc = 0.f;
  for (int s = 0; s < a.nsplit; ++s) {
    const float ms = part_ml[2 * (base + s)];
    if (ms == -INFINITY) continue;                   // split with no valid position
    const float c = expf(ms - mx);
    sum_l += part_ml[2 * (base + s) + 1] * c;
    sum_acc += part_acc[(base + s) * a.D + d] * c;
  }
  o[b * a.o_sb + h * a.o_sh + d] = from_f32<T>(sum_acc / fmaxf(sum_l, 1e-37f));
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* cache_len, void* o, float* part_acc,
                   float* part_ml, int B, const Args& a, cudaStream_t stream) {
  dim3 grid1(a.nsplit, B * a.H);
  decode_partial_kernel<T><<<grid1, WARPS * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), cache_len, part_acc, part_ml, a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<T><<<B * a.H, DMAX, 0, stream>>>(
      part_acc, part_ml, static_cast<T*>(o), a);
  return cudaGetLastError();
}

}  // namespace

// Number of splits the scratch buffers must hold for a cache of S positions.
extern "C" int decode_attention_nsplit(int S) { return (S + SPLIT - 1) / SPLIT; }

// dtype: 0 = float32, 1 = bfloat16. cache_len is int32 on the device.
// part_acc holds B*H*nsplit*D floats and part_ml B*H*nsplit*2 floats.
// Returns a cudaError_t as int (0 = launched).
extern "C" int decode_attention_fwd(
    const void* q, const void* k, const void* v, const void* cache_len, void* o,
    void* part_acc, void* part_ml, int dtype, int B, int S, int H, int KV, int D,
    long long q_sb, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_sh, float scale, int device, void* stream) {
  if (B < 1 || S < 1 || H < 1 || KV < 1 || H % KV != 0 || D < 1 || D > DMAX ||
      B * H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Args a{q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_sh,
               S, H, KV, D, decode_attention_nsplit(S), scale};
  const int* lens = static_cast<const int*>(cache_len);
  float* pa = static_cast<float*>(part_acc);
  float* pml = static_cast<float*>(part_ml);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = launch<float>(q, k, v, lens, o, pa, pml, B, a, st);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(q, k, v, lens, o, pa, pml, B, a, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)err;
}
