// Flash attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel `_flash_kernel` / `flash_attention_bhsd`
// (src/repro/kernels/flash_attention.py). Blocked online-softmax attention,
// forward only, causal or not, GQA through kv head h / (H / KV); running
// max, sum and accumulator in fp32; output in the input type.
//
// Bound on the H100: at the prefill shape (B=4, S=2048, H=16, D=128, causal,
// bf16) the work is 4*D*B*H*S(S+1)/2 = 6.9e10 FLOP against 134 MB of q, k, v
// and o, so it is bound by operations (69 us at 989 TFLOP/s) rather than
// bytes (40 us at 3.35 TB/s). This first version does its products with
// scalar fp32 FMA from shared memory, not tensor cores, so it runs far from
// that bound; what the design does about the bound is to keep scores and
// probabilities on chip (each q, k, v tile is read from device memory once per
// query block, o is written once) and to skip key tiles above the diagonal.
//
// Design. One block of 256 threads per (64-query tile, batch*head); the
// Pallas grid's sequential KV dimension becomes a loop inside the block.
// Q, K, V tiles are held in shared memory as fp32 (row strides padded against
// bank conflicts); each thread owns a 4x4 tile of the 64x64 score block and a
// 4x(D/16) tile of the output accumulator. Ragged S and head dims below the
// 64/128 template width are handled with masked loads and stores, not
// padding. q, k, v and o are read through their batch, sequence and head
// strides (the head dim must be contiguous), so the model's (B, S, H, D)
// activations are used in place.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int BM = 64;        // query rows per block
constexpr int BN = 64;        // keys per KV tile
constexpr int THREADS = 256;
constexpr int RPT = BM / (THREADS / 16);   // rows per thread: 4

struct Strides {
  long long b, s, h;          // element strides; the head dim is contiguous
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int DMAX>
constexpr size_t smem_bytes() {
  // Q (BM x DMAX+4), K (BN x DMAX+1), V (BN x DMAX), P (BM x BN+1), m, l, corr
  return sizeof(float) * (BM * (DMAX + 4) + BN * (DMAX + 1) + BN * DMAX +
                          BM * (BN + 1) + 3 * BM);
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 Strides qs, Strides ks, Strides vs, Strides os,
                 int S, int H, int KV, int D, int causal, float scale) {
  constexpr int QLD = DMAX + 4;
  constexpr int KLD = DMAX + 1;
  constexpr int VLD = DMAX;
  constexpr int PLD = BN + 1;
  constexpr int CPT = DMAX / 16;           // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BM * QLD;
  float* Vs = Ks + BN * KLD;
  float* Ps = Vs + BN * VLD;
  float* m_s = Ps + BM * PLD;              // running max per row
  float* l_s = m_s + BM;                   // running sum per row
  float* c_s = l_s + BM;                   // this tile's correction per row

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BM;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int kvh = h / (H / KV);
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;
  T* ob = o + b * os.b + h * os.h;

  // Q tile, pre-scaled; rows past S and columns past D are zero
  for (int i = tid; i < BM * DMAX; i += THREADS) {
    const int r = i / DMAX, c = i % DMAX;
    const int qi = q0 + r;
    float x = 0.f;
    if (qi < S && c < D) x = to_f32(qb[qi * qs.s + c]) * scale;
    Qs[r * QLD + c] = x;
  }
  if (tid < BM) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }

  const int ty = tid / 16;                 // rows ty*RPT .. ty*RPT+RPT-1
  const int tx = tid % 16;                 // columns tx + 16*j
  float acc[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  const int q_last = min(q0 + BM, S) - 1;
  const int kv_end = causal ? q_last + 1 : S;   // keys [0, kv_end) are needed

  for (int n0 = 0; n0 < kv_end; n0 += BN) {
    __syncthreads();                       // last tile's K, V, P reads are done
    for (int i = tid; i < BN * DMAX; i += THREADS) {
      const int r = i / DMAX, c = i % DMAX;
      const int kj = n0 + r;
      float kx = 0.f, vx = 0.f;
      if (kj < S && c < D) {
        kx = to_f32(kb[kj * ks.s + c]);
        vx = to_f32(vb[kj * vs.s + c]);
      }
      Ks[r * KLD + c] = kx;
      Vs[r * VLD + c] = vx;
    }
    __syncthreads();

    // scores for rows ty*RPT+i, keys tx+16*j
    float sc[RPT][4];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[RPT], kv[4];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = Qs[(ty * RPT + i) * QLD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * KLD + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int qi = q0 + ty * RPT + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = n0 + tx + 16 * j;
        const bool ok = kj < S && (!causal || kj <= qi);
        Ps[(ty * RPT + i) * PLD + tx + 16 * j] = ok ? sc[i][j] : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax, four neighbouring lanes per row
    {
      const int r = tid / 4, part = tid % 4;
      float* row = Ps + r * PLD;
      float mx = -INFINITY;
      for (int c = part; c < BN; c += 4) mx = fmaxf(mx, row[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      const float base = (m_new == -INFINITY) ? 0.f : m_new;   // all masked so far
      float sum = 0.f;
      for (int c = part; c < BN; c += 4) {
        const float p = expf(row[c] - base);
        row[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float corr = expf(m_old - base);
        c_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const float corr = c_s[ty * RPT + i];
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] *= corr;
    }
    const int n_valid = min(BN, kv_end - n0);
    for (int n = 0; n < n_valid; ++n) {
      float pv[RPT], vv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = Ps[(ty * RPT + i) * PLD + n];
#pragma unroll
      for (int j = 0; j < CPT; ++j) vv[j] = Vs[n * VLD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = ty * RPT + i;
    const int qi = q0 + r;
    if (qi >= S) continue;
    const float inv = 1.f / fmaxf(l_s[r], 1e-37f);
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = tx + 16 * j;
      if (c < D) ob[qi * os.s + c] = from_f32<T>(acc[i][j] * inv);
    }
  }
}

template <typename T, int DMAX>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   Strides qs, Strides ks, Strides vs, Strides os, int B, int S,
                   int H, int KV, int D, int causal, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DMAX>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + BM - 1) / BM, B * H);
  flash_fwd_kernel<T, DMAX><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), qs, ks, vs, os, S, H, KV, D,
      causal, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements, ordered
// (batch, sequence, head). Returns a cudaError_t as int (0 = launched).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int S, int H, int KV, int D, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long o_sb, long long o_ss,
    long long o_sh, int causal, float scale, int device, void* stream) {
  if (B < 1 || S < 1 || H < 1 || KV < 1 || H % KV != 0 || D < 1 || D > 128 ||
      B * H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh},
      os{o_sb, o_ss, o_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    err = D <= 64 ? launch<float, 64>(q, k, v, o, qs, ks, vs, os, B, S, H, KV, D, causal, scale, st)
                  : launch<float, 128>(q, k, v, o, qs, ks, vs, os, B, S, H, KV, D, causal, scale, st);
  } else if (dtype == 1) {
    err = D <= 64 ? launch<__nv_bfloat16, 64>(q, k, v, o, qs, ks, vs, os, B, S, H, KV, D, causal, scale, st)
                  : launch<__nv_bfloat16, 128>(q, k, v, o, qs, ks, vs, os, B, S, H, KV, D, causal, scale, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}
