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
// bytes (40 us at 3.35 TB/s). Only the tensor cores' wgmma reaches that rate.
//
// bf16 design (`flash_wgmma_kernel`). One CTA of 288 threads per (128-query
// tile, b*h): two consumer warpgroups own 64 query rows each, and one
// producer warp issues TMA loads. CTAs run in groups of (b, h) pairs whose
// K and V fit the L2 cache together (each K/V tile is read once per query
// tile, so a wave spread over all heads would stream them from device
// memory; `default_group`, or the caller's `group`, the autotuner's knob);
// inside a group the longest causal rows go first. Q is loaded
// once; K and V tiles of 128 keys flow through a 2-stage ring in shared
// memory guarded by full/empty mbarriers. All tiles are 64-column chunks of
// 128-byte rows in TMA's 128-byte swizzle. S = Q K^T is a wgmma with both
// operands in shared memory; the online softmax runs in registers in
// wgmma's accumulator layout (row max and sum over the four threads of a
// quad, exp2 with scale*log2(e) folded in), masking only the first tile
// walked (the KV walk goes from the last tile down, so that is the tile on
// the diagonal or past the ragged end); tiles above the diagonal are never
// loaded. P is rounded to bf16 in
// registers and O += P V is a wgmma with A from registers and V read
// through the transpose bit. The output tile goes back through the Q buffer
// and a TMA store. q, k, v and o are read in place through 4-D tensor maps
// over (D, H, S, B) with the model's strides, so TMA's out-of-bounds zero
// fill masks a ragged S and a head dim below the 64/112/128 instantiation
// width; the wrapper refuses layouts TMA cannot take (a base or stride that
// is not 16-byte aligned, a head dim that is not contiguous).
//
// fp32 inputs keep the scalar kernel (`flash_fwd_kernel`): one block of 256
// threads per (64 queries, b*h), fp32 FMA from shared memory. TF32 tensor
// cores would not hold the fp32 parity gates (1e-3 of the logits' range at
// full width), and the serving paths run bf16.
#include <cuda.h>            // CUtensorMap and its enums; the encoder is
#include <cuda_runtime.h>    // fetched at run time, so no -lcuda
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>

namespace {

struct Strides {
  long long b, s, h;          // element strides; the head dim is contiguous
};

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

// ---------------------------------------------------------------------------
// fp32: the scalar kernel
// ---------------------------------------------------------------------------

constexpr int BM = 64;        // query rows per block
constexpr int BN = 64;        // keys per KV tile
constexpr int THREADS = 256;
constexpr int RPT = BM / (THREADS / 16);   // rows per thread: 4

template <int DMAX>
constexpr size_t smem_bytes() {
  // Q (BM x DMAX+4), K (BN x DMAX+1), V (BN x DMAX), P (BM x BN+1), m, l, corr
  return sizeof(float) * (BM * (DMAX + 4) + BN * (DMAX + 1) + BN * DMAX +
                          BM * (BN + 1) + 3 * BM);
}

template <int DMAX>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
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
  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + kvh * ks.h;
  const float* vb = v + b * vs.b + kvh * vs.h;
  float* ob = o + b * os.b + h * os.h;

  // Q tile, pre-scaled; rows past S and columns past D are zero
  for (int i = tid; i < BM * DMAX; i += THREADS) {
    const int r = i / DMAX, c = i % DMAX;
    const int qi = q0 + r;
    float x = 0.f;
    if (qi < S && c < D) x = qb[qi * qs.s + c] * scale;
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
        kx = kb[kj * ks.s + c];
        vx = vb[kj * vs.s + c];
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
      if (c < D) ob[qi * os.s + c] = acc[i][j] * inv;
    }
  }
}

template <int DMAX>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       Strides qs, Strides ks, Strides vs, Strides os, int B,
                       int S, int H, int KV, int D, int causal, float scale,
                       cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DMAX>();
  static std::atomic<bool> smem_set[MAX_DEVICES];
  const cudaError_t attr = allow_smem(
      reinterpret_cast<const void*>(flash_fwd_kernel<DMAX>), (int)smem,
      smem_set);
  if (attr != cudaSuccess) return attr;
  if (B * H > 65535) return cudaErrorInvalidValue;
  dim3 grid((S + BM - 1) / BM, B * H);
  flash_fwd_kernel<DMAX><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), qs, ks, vs, os, S,
      H, KV, D, causal, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: TMA + wgmma
// ---------------------------------------------------------------------------

namespace wg {

constexpr int BM = 128;            // query rows per CTA, 64 per consumer warpgroup
constexpr int BN = 128;            // keys per KV tile
constexpr int STAGES = 2;          // K/V ring depth
constexpr int CONSUMERS = 256;     // two warpgroups
constexpr int THREADS = CONSUMERS + 32;   // and one producer warp
constexpr int CHUNK = 64;          // bf16 columns in one 128-byte swizzled row
constexpr int ROW_BYTES = 128;

template <int DP, int NCH = (DP + CHUNK - 1) / CHUNK>
struct Smem {                      // every tile: NCH chunks of [rows][64]
  __nv_bfloat16 q[NCH][BM * CHUNK];
  __nv_bfloat16 k[STAGES][NCH][BN * CHUNK];
  __nv_bfloat16 v[STAGES][NCH][BN * CHUNK];
  uint64_t q_full, full[STAGES], empty[STAGES];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// Waits until the barrier's phase of the given parity has completed. A
// phase that never completes (a lost TMA transaction) traps after about
// 2^24 polls, so a fault ends the launch with an error instead of hanging
// the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    if (done) return;
    if (polls == (1u << 24)) __trap();
  }
}

// A 4-D map over (D, H, S, B), or (D, S, H, B) when `swap` (the map's dim
// order follows the strides); coordinates are given as (d, h, s, b).
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int d, int h, int s,
                                         int b, bool swap) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(smem_u32(dst)), "l"(map), "r"(d), "r"(swap ? s : h),
         "r"(swap ? h : s), "r"(b), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int d, int h,
                                          int s, int b, bool swap) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n"
      :: "l"(map), "r"(smem_u32(src)), "r"(d), "r"(swap ? s : h),
         "r"(swap ? h : s), "r"(b)
      : "memory");
}

// wgmma shared-memory descriptor for a 128-byte-swizzled tile. For a K-major
// operand (Q, K) the stride between 8-row groups is 1024 bytes and the
// leading offset is unused; for the MN-major V the leading offset is the
// stride between 64-column chunks and the stride offset that between groups
// of 8 keys.
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving accumulator reads or writes across a
// wgmma issue or wait.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

__device__ __forceinline__ void wgmma_ss_m64n128(float* d, uint64_t da,
                                                  uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs_m64n64(float* d, const uint32_t* a,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_m64n128(float* d, const uint32_t* a,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_m64n112(float* d, const uint32_t* a,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55}, "
      "{%56, %57, %58, %59}, %60, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db) {
  if constexpr (N == 64) wgmma_rs_m64n64(d, a, db);
  else if constexpr (N == 112) wgmma_rs_m64n112(d, a, db);
  else wgmma_rs_m64n128(d, a, db);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// DP: head dims up to DP (64, 112 or 128) are padded to DP by TMA's zero
// fill; the tiles hold DP rounded up to whole 64-column chunks.
template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const __grid_constant__ CUtensorMap omap, int S, int H,
                   int KV, int causal, float scale_log2, int swaps,
                   int group) {
  constexpr int NCH = (DP + CHUNK - 1) / CHUNK;  // 64-column chunks
  constexpr int S_REGS = BN / 2;                 // m64n128 fp32 accumulator
  constexpr int O_REGS = DP / 2;
  extern __shared__ unsigned char smem_raw[];
  Smem<DP>& sm = *reinterpret_cast<Smem<DP>*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  // CTAs go in groups of `group` (b, h) pairs whose K and V fit the L2
  // cache together; inside a group the query tiles with the longest causal
  // rows go first
  const int m_tiles = (S + BM - 1) / BM;
  const int g0 = blockIdx.x / (group * m_tiles) * group;   // group's first bh
  const int gsize = min(group, (int)(gridDim.x / m_tiles) - g0);
  const int r = blockIdx.x - g0 * m_tiles;
  const int bh = g0 + r % gsize;
  const int m_tile = m_tiles - 1 - r / gsize;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = m_tile * BM;
  const int n_tiles = causal ? m_tile + 1 : (S + BN - 1) / BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&sm.full[st], 1);
      mbar_init(&sm.empty[st], CONSUMERS / 32);   // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMERS / 32) {
    // ---- producer: one thread keeps the K/V ring full -------------------
    if (lane == 0) {
      mbar_expect_tx(&sm.q_full, BM * NCH * CHUNK * 2);
      for (int c = 0; c < NCH; ++c)
        tma_load(sm.q[c], &qmap, &sm.q_full, c * CHUNK, h, q0, b, swaps & 1);
      for (int it = 0; it < n_tiles; ++it) {
        const int j = n_tiles - 1 - it;            // the masked tile first
        const int st = it % STAGES;
        if (it >= STAGES) mbar_wait(&sm.empty[st], ((it / STAGES) - 1) & 1);
        mbar_expect_tx(&sm.full[st], 2 * BN * NCH * CHUNK * 2);
        for (int c = 0; c < NCH; ++c) {
          tma_load(sm.k[st][c], &kmap, &sm.full[st], c * CHUNK, kvh, j * BN, b,
                   swaps & 2);
          tma_load(sm.v[st][c], &vmap, &sm.full[st], c * CHUNK, kvh, j * BN, b,
                   swaps & 4);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63 -------
  const int wg = warp / 4;
  const int t = threadIdx.x % 128;
  const int row = 16 * (t / 32) + lane / 4;       // and row + 8, within 64
  const int col = 2 * (lane % 4);                 // and col + 1, per 8 columns
  const int qi0 = q0 + 64 * wg + row, qi1 = qi0 + 8;

  float o[O_REGS];
#pragma unroll
  for (int i = 0; i < O_REGS; ++i) o[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  mbar_wait(&sm.q_full, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int j = n_tiles - 1 - it;
    const int st = it % STAGES;
    mbar_wait(&sm.full[st], (it / STAGES) & 1);

    // S = Q K^T over DP / 16 steps of 16 columns
    float s[S_REGS];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const int c = kk / 4, off = (kk % 4) * 16;        // elements into the chunk
      wgmma_ss_m64n128(
          s, desc_sw128(&sm.q[c][64 * wg * CHUNK + off], 16, 8 * ROW_BYTES),
          desc_sw128(&sm.k[st][c][off], 16, 8 * ROW_BYTES), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<S_REGS>(s);

    if (it == 0) {            // the diagonal tile, or the one past S
#pragma unroll
      for (int nb = 0; nb < BN / 8; ++nb) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kj = j * BN + 8 * nb + col + e;
          if (kj >= S || (causal && kj > qi0)) s[4 * nb + e] = -INFINITY;
          if (kj >= S || (causal && kj > qi1)) s[4 * nb + 2 + e] = -INFINITY;
        }
      }
    }

    // online softmax on rows row (s[4nb], s[4nb+1]) and row + 8 (+2, +3)
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int nb = 0; nb < BN / 8; ++nb) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * nb], s[4 * nb + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * nb + 2], s[4 * nb + 3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    // a row with every key masked so far keeps base 0 (no inf - inf)
    const float base0 = mx0 == -INFINITY ? 0.f : mx0 * scale_log2;
    const float base1 = mx1 == -INFINITY ? 0.f : mx1 * scale_log2;
    const float corr0 = exp2f(m0 * scale_log2 - base0);
    const float corr1 = exp2f(m1 * scale_log2 - base1);
    m0 = mx0;
    m1 = mx1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nb = 0; nb < BN / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[4 * nb + e] = exp2f(s[4 * nb + e] * scale_log2 - base0);
        s[4 * nb + 2 + e] = exp2f(s[4 * nb + 2 + e] * scale_log2 - base1);
        sum0 += s[4 * nb + e];
        sum1 += s[4 * nb + 2 + e];
      }
    }
    l0 = l0 * corr0 + sum0;        // this thread's share; quad-summed at the end
    l1 = l1 * corr1 + sum1;
#pragma unroll
    for (int nb = 0; nb < DP / 8; ++nb) {
      o[4 * nb] *= corr0;
      o[4 * nb + 1] *= corr0;
      o[4 * nb + 2] *= corr1;
      o[4 * nb + 3] *= corr1;
    }

    // P in bf16 as wgmma A fragments: keys 16 kt .. 16 kt + 15
    uint32_t p[BN / 16][4];
#pragma unroll
    for (int kt = 0; kt < BN / 16; ++kt) {
      p[kt][0] = pack_bf16(s[8 * kt], s[8 * kt + 1]);
      p[kt][1] = pack_bf16(s[8 * kt + 2], s[8 * kt + 3]);
      p[kt][2] = pack_bf16(s[8 * kt + 4], s[8 * kt + 5]);
      p[kt][3] = pack_bf16(s[8 * kt + 6], s[8 * kt + 7]);
    }

    // O += P V: V is MN-major (keys are rows, head dims contiguous)
    fence_regs<O_REGS>(o);
    wgmma_fence();
#pragma unroll
    for (int kt = 0; kt < BN / 16; ++kt)
      wgmma_rs<DP>(o, p[kt],
                   desc_sw128(&sm.v[st][0][16 * kt * CHUNK],
                              BN * ROW_BYTES, 8 * ROW_BYTES));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<O_REGS>(o);
    if (lane == 0) mbar_arrive(&sm.empty[st]);      // K and V of this stage are free
  }

  // ---- epilogue: O / l in bf16, swizzled into this warpgroup's Q rows, then
  // one TMA store (which drops rows past S and columns past D)
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  unsigned char* qbytes = reinterpret_cast<unsigned char*>(sm.q);
#pragma unroll
  for (int nb = 0; nb < DP / 8; ++nb) {
    const int cc = 8 * nb + col;
    const int c = cc / CHUNK, g = (cc % CHUNK) / 8;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = 64 * wg + row + 8 * half;
      const float inv = half ? inv1 : inv0;
      const size_t at = (size_t)c * BM * ROW_BYTES + (size_t)r * ROW_BYTES +
                        ((g ^ (r % 8)) * 16) + (cc % 8) * 2;
      *reinterpret_cast<uint32_t*>(qbytes + at) =
          pack_bf16(o[4 * nb + 2 * half] * inv, o[4 * nb + 2 * half + 1] * inv);
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");  // warpgroup
  if (t == 0) {
    for (int c = 0; c < NCH; ++c)
      tma_store(&omap, &sm.q[c][64 * wg * CHUNK], c * CHUNK, h, q0 + 64 * wg,
                b, swaps & 8);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

}  // namespace wg

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A bf16 map over (D, H, S, B) with a box of 64 head dims by `rows`
// positions, or over (D, S, H, B) when the head stride exceeds the sequence
// stride (sets *swap), so that the map's strides ascend.
bool make_map(CUtensorMap* map, const void* base, int D, int nh, int S, int B,
              Strides st, int rows, bool* swap) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  *swap = st.h > st.s;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)(*swap ? S : nh),
                              (cuuint64_t)(*swap ? nh : S), (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)(*swap ? st.s : st.h) * 2,
                                 (cuuint64_t)(*swap ? st.h : st.s) * 2,
                                 (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {(cuuint32_t)wg::CHUNK, *swap ? (cuuint32_t)rows : 1u,
                             *swap ? 1u : (cuuint32_t)rows, 1u};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// (b, h) pairs a CTA group of the bf16 kernel when the caller gives none:
// their K and V (padded to 128 dims) within 16 MB of the 50 MB L2, counting
// the H / KV query heads of a kv head once, at most B * H
// (flash_attention.default_group mirrors it)
int default_group(int B, int S, int H, int KV) {
  const long long kv_bytes = 4LL * S * 128;
  return (int)std::min<long long>(
      (long long)B * H,
      std::max<long long>(1, (16LL << 20) / kv_bytes * (H / KV)));
}

template <int DP>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        Strides qs, Strides ks, Strides vs, Strides os, int B,
                        int S, int H, int KV, int D, int causal, float scale,
                        int group, cudaStream_t stream) {
  constexpr size_t smem = sizeof(wg::Smem<DP>) + 1024;   // + alignment slack
  static std::atomic<bool> smem_set[MAX_DEVICES];
  const cudaError_t attr = allow_smem(
      reinterpret_cast<const void*>(wg::flash_wgmma_kernel<DP>), (int)smem,
      smem_set);
  if (attr != cudaSuccess) return attr;
  CUtensorMap qm, km, vm, om;
  bool sq, sk, sv, so;
  if (!make_map(&qm, q, D, H, S, B, qs, wg::BM, &sq) ||
      !make_map(&km, k, D, KV, S, B, ks, wg::BN, &sk) ||
      !make_map(&vm, v, D, KV, S, B, vs, wg::BN, &sv) ||
      !make_map(&om, o, D, H, S, B, os, 64, &so))
    return cudaErrorInvalidValue;
  const long long ctas = (long long)B * H * ((S + wg::BM - 1) / wg::BM);
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (group == 0) group = default_group(B, S, H, KV);
  if (group < 1 || group > B * H) return cudaErrorInvalidValue;
  wg::flash_wgmma_kernel<DP><<<(unsigned)ctas, wg::THREADS, smem, stream>>>(
      qm, km, vm, om, S, H, KV, causal, scale * 1.4426950408889634f,
      (sq ? 1 : 0) | (sk ? 2 : 0) | (sv ? 4 : 0) | (so ? 8 : 0), group);
  return cudaGetLastError();
}

}  // namespace

// The bf16 kernel's (b, h) pairs a CTA group at group = 0.
extern "C" int flash_attention_group(int B, int S, int H, int KV) {
  return default_group(B, S, H, KV);
}

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements, ordered
// (batch, sequence, head). For bf16 the caller guarantees 16-byte aligned
// bases and strides (TMA); a map cuTensorMapEncodeTiled refuses gives
// cudaErrorInvalidValue. group (bf16 only): (b, h) pairs a CTA group, 1 to
// B * H, or 0 for flash_attention_group's rule; it orders the CTAs and
// leaves the output's bits as they are. Returns a cudaError_t as int
// (0 = launched).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int S, int H, int KV, int D, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long o_sb, long long o_ss,
    long long o_sh, int causal, float scale, int group, int device,
    void* stream) {
  if (B < 1 || S < 1 || H < 1 || KV < 1 || H % KV != 0 || D < 1 || D > 128 ||
      (dtype != 1 && group != 0))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh},
      os{o_sb, o_ss, o_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FLASH_ARGS q, k, v, o, qs, ks, vs, os, B, S, H, KV, D, causal, scale
  if (dtype == 0) {
    err = D <= 64 ? launch_f32<64>(FLASH_ARGS, st)
                  : launch_f32<128>(FLASH_ARGS, st);
  } else if (dtype == 1) {
    err = D <= 64    ? launch_bf16<64>(FLASH_ARGS, group, st)
          : D <= 112 ? launch_bf16<112>(FLASH_ARGS, group, st)
                     : launch_bf16<128>(FLASH_ARGS, group, st);
#undef FLASH_ARGS
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}
