// Decode attention (one query token against a KV cache) for Hopper (sm_90a),
// plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel `_decode_kernel` / `decode_attention_bhd`
// (src/repro/kernels/decode_attention.py): softmax(q k^T / sqrt(D)) v over
// the first cache_len[b] positions of each batch row, GQA through kv head
// h / (H / KV), accumulated in fp32, output in the input type.
//
// Bound on the H100: every valid cache position is read once per kv head
// (2 * sum_b cache_len[b] * KV * D elements) for 4 FLOP per element and
// query head, so the kernel is bound by bytes: about 6 us at 3.35 TB/s for
// 4 slots, about 2400 valid positions, KV=16, D=128 in bf16.
//
// Design: split-KV flash-decoding in one launch. One CTA of 128 threads per
// (split of the sequence, b, kv head) serves all H / KV query heads of its
// kv head, so each K and V row is read from device memory once. At its
// start it issues every load of its split (at most `split` positions below
// cache_len[b]; it never touches the positions past it): the K rows into
// shared memory by 16-byte cp.async, and each thread's 16-byte pieces of V
// straight into registers, so that a CTA needs about 37 KB of shared memory
// and a whole serving-shape grid fits the card at once. The scores of the
// whole split are computed in parallel (16 lanes per key, 16-byte
// shared-memory reads, a 4-step shuffle sum, four keys per lane group in
// flight), then one max and one exp pass per head, then P V from the
// registers, the keys spread over 8 groups summed through shared memory.
// A split writes its (max, sum, acc[D]) partial; the last CTA of each
// (b, kv head) to finish, found through an atomic ticket that it resets,
// merges the splits by their log-sum-exp and writes the output. A row whose
// cache fits one split writes its output directly. A row with no valid
// position gives zeros (the Pallas kernel's finite -1e30 mask averages all
// of V there; the model always has at least one position). The wrapper picks
// the split length (`decode_attention.split_size`, or the caller's `split`,
// the autotuner's knob) and allocates the scratch; the kernel allocates
// nothing.
//
// Partial softmax (`lse` given): the instances with LSE write o in fp32, not
// rounded to the input type, and each row's log-sum-exp lse = m + log(l) of
// its scaled scores over the valid positions, -inf for a row with none (whose
// o is zeros). A rank that holds one shard of a sequence-sharded cache
// attends over its shard so, and the ranks merge their (o, lse) pieces
// (`sharding/spmd.merge_partials`). Each of the three places that writes a
// row's o (the empty row, a row of one active split, the merging CTA) writes
// its lse too. Without `lse` the instances are today's, unchanged.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int THREADS = 128;
constexpr int LPK = 16;                  // lanes per key in the score pass
constexpr int KGROUPS = THREADS / LPK;   // keys in flight per pass: 8
constexpr int DMAX = 128;
constexpr int GMAX = 32;                 // query heads per kv head
constexpr int V_CHUNKS = 16;             // 16-byte V pieces a thread holds
constexpr int SMEM_CAP = 96 * 1024;      // dynamic shared memory a CTA may ask

// cudaFuncSetAttribute holds only for the device that is current when it is
// called, so each kernel sets its shared-memory limit once per device (two
// threads racing here both set it, which is harmless).
constexpr int MAX_DEVICES = 64;
cudaError_t allow_smem(const void* kernel, int bytes,
                       std::atomic<bool> (&done)[MAX_DEVICES]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && done[dev].load(std::memory_order_acquire))
    return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < MAX_DEVICES)
    done[dev].store(true, std::memory_order_release);
  return err;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T> __device__ __forceinline__ void unpack16(uint4 v, float* x);
template <> __device__ __forceinline__ void unpack16<float>(uint4 v, float* x) {
  x[0] = __uint_as_float(v.x); x[1] = __uint_as_float(v.y);
  x[2] = __uint_as_float(v.z); x[3] = __uint_as_float(v.w);
}
// A bf16 value is the top half of its fp32 value: shifts and masks, so that
// no word of v needs an address (which would put it in local memory).
template <> __device__ __forceinline__ void unpack16<__nv_bfloat16>(uint4 v, float* x) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// 16 bytes of shared memory as floats: 4 fp32 or 8 bf16 values.
__device__ __forceinline__ void load16(const float* p, float* x) {
  unpack16<float>(*reinterpret_cast<const uint4*>(p), x);
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* x) {
  unpack16<__nv_bfloat16>(*reinterpret_cast<const uint4*>(p), x);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                  "l"(src) : "memory");
}

struct Args {
  long long q_sb, q_sh;               // q (B, H, D)
  long long k_sb, k_ss, k_sh;         // caches (B, S, KV, D) through strides
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_sh;
  int S, H, KV, D, split, nsplit;
  float scale;
};

size_t smem_bytes(int split, int D, int G, size_t elem) {
  // K rows, q (G x DMAX), scores (G x split), P V partials (8 x DMAX)
  return (size_t)split * D * elem +
         sizeof(float) * ((size_t)G * DMAX + (size_t)G * split + KGROUPS * DMAX);
}

// T: the inputs' type; TO: o's (T, or float with LSE); LSE: write lse (B, H)
template <typename T, typename TO, bool LSE>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ cache_len,
              TO* __restrict__ o, float* __restrict__ lse,
              float* __restrict__ part_acc, float* __restrict__ part_ml,
              int* __restrict__ tickets, Args a) {
  constexpr int EPC = 16 / sizeof(T);                    // values per 16 bytes
  constexpr int CPT = (DMAX / EPC + LPK - 1) / LPK;      // chunks per lane
  constexpr int VKEYS = V_CHUNKS / CPT;                  // V rows per thread
  const int split = blockIdx.x;
  const int b = blockIdx.y / a.KV, kvh = blockIdx.y % a.KV;
  const int G = a.H / a.KV;
  const int len = max(0, min(cache_len[b], a.S));
  const int n_act = (len + a.split - 1) / a.split;       // splits with keys
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  TO* ob = o + b * a.o_sb + (long long)kvh * G * a.o_sh;
  float* lb = LSE ? lse + (long long)b * a.H + kvh * G : nullptr;

  if (n_act == 0) {                                      // empty row: zeros
    if (split == 0) {
      for (int i = tid; i < G * a.D; i += THREADS)
        ob[(i / a.D) * a.o_sh + i % a.D] = from_f32<TO>(0.f);
      if constexpr (LSE)
        for (int g = tid; g < G; g += THREADS) lb[g] = -INFINITY;
    }
    return;
  }
  if (split >= n_act) return;
  const int start = split * a.split;
  const int n = min(a.split, len - start);               // this split's keys
  const int nch = a.D / EPC;                             // 16-byte chunks a row
  const int kg = tid / LPK, li = tid % LPK;              // key group, lane in it

  extern __shared__ float4 smem4[];
  T* ks = reinterpret_cast<T*>(smem4);
  float* q_s = reinterpret_cast<float*>(ks + a.split * a.D);
  float* sc = q_s + G * DMAX;
  float* red = sc + G * a.split;
  __shared__ float m_s[GMAX], l_s[GMAX];
  __shared__ int is_last;

  // 1. all loads at once: K rows into shared memory by cp.async, and each
  // thread's V pieces (rows kg + 8 i, chunks li + 16 cc) into registers
  const T* kb = k + b * a.k_sb + kvh * a.k_sh + start * a.k_ss;
  const T* vb = v + b * a.v_sb + kvh * a.v_sh + start * a.v_ss;
  for (int i = tid; i < n * nch; i += THREADS)
    cp_async16(ks + (i / nch) * a.D + (i % nch) * EPC,
               kb + (i / nch) * a.k_ss + (i % nch) * EPC);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  uint4 vr[VKEYS][CPT];
#pragma unroll
  for (int i = 0; i < VKEYS; ++i)
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) {
      const int r = kg + KGROUPS * i, c = li + LPK * cc;
      vr[i][cc] = r < n && c < nch
                      ? __ldcs(reinterpret_cast<const uint4*>(
                            vb + r * a.v_ss + c * EPC))
                      : make_uint4(0, 0, 0, 0);
    }
  const T* qb = q + b * a.q_sb + (long long)kvh * G * a.q_sh;
  for (int i = tid; i < G * DMAX; i += THREADS) {
    const int g = i / DMAX, d = i % DMAX;
    q_s[i] = d < a.D ? to_f32(qb[g * a.q_sh + d]) * a.scale : 0.f;
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  // 2. scores: 16 lanes per key, 8 key groups, 4 keys per group in flight
  for (int g = 0; g < G; ++g) {
    float qv[CPT][EPC];
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc)
#pragma unroll
      for (int e = 0; e < EPC; ++e) {
        const int c = li + LPK * cc;
        qv[cc][e] = c < nch ? q_s[g * DMAX + c * EPC + e] : 0.f;
      }
    for (int r0 = 0; r0 < n; r0 += 4 * KGROUPS) {         // uniform trip count
      float s[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int r = r0 + kg + KGROUPS * u;
        s[u] = 0.f;
#pragma unroll
        for (int cc = 0; cc < CPT; ++cc) {
          const int c = li + LPK * cc;
          if (r < n && c < nch) {
            float x[EPC];
            load16(ks + r * a.D + c * EPC, x);
#pragma unroll
            for (int e = 0; e < EPC; ++e) s[u] = fmaf(qv[cc][e], x[e], s[u]);
          }
        }
      }
#pragma unroll
      for (int off = LPK / 2; off > 0; off >>= 1)
#pragma unroll
        for (int u = 0; u < 4; ++u) s[u] += __shfl_xor_sync(0xffffffffu, s[u], off);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int r = r0 + kg + KGROUPS * u;
        if (r < n && li == 0) sc[g * a.split + r] = s[u];
      }
    }
  }
  __syncthreads();

  // 3. one max and one exp pass per head (warp w takes heads w, w + 4, ...)
  for (int g = warp; g < G; g += THREADS / 32) {
    float* row = sc + g * a.split;
    float mx = -INFINITY;
    for (int r = lane; r < n; r += 32) mx = fmaxf(mx, row[r]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int r = lane; r < n; r += 32) {
      const float p = expf(row[r] - mx);
      row[r] = p;
      sum += p;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      m_s[g] = mx;
      l_s[g] = sum;
    }
  }
  __syncthreads();

  // 4. P V from the registers; the 8 key groups summed through shared
  const int h0 = kvh * G;
  for (int g = 0; g < G; ++g) {
    float acc[CPT][EPC];
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc)
#pragma unroll
      for (int e = 0; e < EPC; ++e) acc[cc][e] = 0.f;
#pragma unroll
    for (int i = 0; i < VKEYS; ++i) {
      const int r = kg + KGROUPS * i;
      if (r < n) {
        const float p = sc[g * a.split + r];
#pragma unroll
        for (int cc = 0; cc < CPT; ++cc) {
          // unpacked anew for each head: hoisting all of V's unpacked floats
          // out of the head loop would cost 128 registers and spill
          uint4 w = vr[i][cc];
          asm volatile("" : "+r"(w.x), "+r"(w.y), "+r"(w.z), "+r"(w.w));
          float x[EPC];
          unpack16<T>(w, x);
#pragma unroll
          for (int e = 0; e < EPC; ++e) acc[cc][e] = fmaf(p, x[e], acc[cc][e]);
        }
      }
    }
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) {
      const int c = li + LPK * cc;
      if (c < nch)
#pragma unroll
        for (int e = 0; e < EPC; ++e) red[kg * DMAX + c * EPC + e] = acc[cc][e];
    }
    __syncthreads();
    const long long part = ((long long)b * a.H + h0 + g) * a.nsplit + split;
    for (int d = tid; d < a.D; d += THREADS) {
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < KGROUPS; ++j) sum += red[j * DMAX + d];
      if (n_act == 1)
        ob[g * a.o_sh + d] = from_f32<TO>(sum / l_s[g]);
      else
        part_acc[part * a.D + d] = sum;
    }
    if (tid == 0 && n_act > 1) {
      part_ml[2 * part] = m_s[g];
      part_ml[2 * part + 1] = l_s[g];
    }
    if constexpr (LSE)
      if (tid == 0 && n_act == 1) lb[g] = m_s[g] + logf(l_s[g]);
    __syncthreads();
  }
  if (n_act == 1) return;

  // 5. the last split of (b, kv head) to finish merges all of them
  __threadfence();
  __syncthreads();
  if (tid == 0)
    is_last = atomicAdd(&tickets[blockIdx.y], 1) == n_act - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  // each head's largest split max and its sum, one warp per head, the
  // splits' loads issued together across the lanes
  for (int g = warp; g < G; g += THREADS / 32) {
    const float* ml = part_ml + 2 * ((long long)b * a.H + h0 + g) * a.nsplit;
    float mx = -INFINITY;
    for (int s = lane; s < n_act; s += 32) mx = fmaxf(mx, __ldcg(&ml[2 * s]));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float l = 0.f;
    for (int s = lane; s < n_act; s += 32)
      l += __ldcg(&ml[2 * s + 1]) * expf(__ldcg(&ml[2 * s]) - mx);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      l += __shfl_xor_sync(0xffffffffu, l, off);
    if (lane == 0) {
      m_s[g] = mx;
      l_s[g] = l;
      if constexpr (LSE) lb[g] = mx + logf(l);
    }
  }
  __syncthreads();
  for (int i = tid; i < G * a.D; i += THREADS) {
    const int g = i / a.D, d = i % a.D;
    const long long base = ((long long)b * a.H + h0 + g) * a.nsplit;
    float acc = 0.f;
#pragma unroll 4
    for (int s = 0; s < n_act; ++s)
      acc += __ldcg(&part_acc[(base + s) * a.D + d]) *
             expf(__ldcg(&part_ml[2 * (base + s)]) - m_s[g]);
    ob[g * a.o_sh + d] = from_f32<TO>(acc / l_s[g]);
  }
  if (tid == 0) atomicExch(&tickets[blockIdx.y], 0);     // ready for the next call
}

template <typename T, typename TO, bool LSE>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* cache_len, void* o, float* lse, float* part_acc,
                   float* part_ml, int* tickets, int B, const Args& a,
                   cudaStream_t stream) {
  static std::atomic<bool> smem_set[MAX_DEVICES];
  const cudaError_t attr = allow_smem(
      reinterpret_cast<const void*>(decode_kernel<T, TO, LSE>), SMEM_CAP,
      smem_set);
  if (attr != cudaSuccess) return attr;
  // a thread holds V_CHUNKS 16-byte pieces of V: 8 key groups of
  // V_CHUNKS / (pieces per lane) rows, so 128 (bf16) or 64 (fp32) positions
  constexpr int max_split =
      KGROUPS * V_CHUNKS / ((DMAX * (int)sizeof(T) / 16 + LPK - 1) / LPK);
  if (a.split > max_split) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(a.split, a.D, a.H / a.KV, sizeof(T));
  if (smem > (size_t)SMEM_CAP) return cudaErrorInvalidValue;
  dim3 grid(a.nsplit, B * a.KV);
  decode_kernel<T, TO, LSE><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), cache_len, static_cast<TO*>(o), lse,
      part_acc, part_ml, tickets, a);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. cache_len is int32 on the device. lse:
// null, or B*H floats (row b, head h at b*H + h) for each row's log-sum-exp,
// and then o is float32 whatever dtype is. split is the positions per CTA;
// part_acc holds B*H*nsplit*D floats, part_ml B*H*nsplit*2 floats, tickets
// B*KV int32 zeros (left zero after the call), nsplit = ceil(S / split). The
// caches' base and position and head strides must be 16-byte aligned and
// D * elem a multiple of 16 bytes. Returns a cudaError_t as int (0 =
// launched).
extern "C" int decode_attention_fwd(
    const void* q, const void* k, const void* v, const void* cache_len, void* o,
    void* lse, void* part_acc, void* part_ml, void* tickets, int dtype, int B,
    int S, int H, int KV, int D, int split, long long q_sb, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long o_sb, long long o_sh,
    float scale, int device, void* stream) {
  if (B < 1 || S < 1 || H < 1 || KV < 1 || H % KV != 0 || D < 1 || D > DMAX ||
      H / KV > GMAX || split < 1 || B * KV > 65535 ||
      (S + split - 1) / split > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Args a{q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_sh,
               S, H, KV, D, split, (S + split - 1) / split, scale};
  const int* lens = static_cast<const int*>(cache_len);
  float* pa = static_cast<float*>(part_acc);
  float* pml = static_cast<float*>(part_ml);
  int* tk = static_cast<int*>(tickets);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ls = static_cast<float*>(lse);
  if (dtype == 0 && !ls)
    err = launch<float, float, false>(q, k, v, lens, o, ls, pa, pml, tk, B, a,
                                      st);
  else if (dtype == 1 && !ls)
    err = launch<__nv_bfloat16, __nv_bfloat16, false>(q, k, v, lens, o, ls, pa,
                                                      pml, tk, B, a, st);
  else if (dtype == 0)
    err = launch<float, float, true>(q, k, v, lens, o, ls, pa, pml, tk, B, a,
                                     st);
  else if (dtype == 1)
    err = launch<__nv_bfloat16, float, true>(q, k, v, lens, o, ls, pa, pml, tk,
                                             B, a, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)err;
}
