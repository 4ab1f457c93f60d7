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
// 3.35 TB/s. Both kernels read every input once from device memory through
// the model's (B, S, H, K) strides, with no transposed copy, write y once,
// and keep the state on chip.
//
// The Pallas kernel's chunked matrix form carries the state across a
// sequential grid dimension in VMEM and factors the intra-chunk decay as
// exp(a) * exp(b) with half-shifted exponents, which overflows fp32 once a
// chunk's summed log-decay passes about -176 (and gives inf * 0 = NaN at the
// mask from -88 on). Hopper's blocks run in no order, so here a loop inside
// the block walks the chunks (or tokens) in time order, and no exponent is
// ever positive.
//
// bf16 design (`wkv6_chunk_kernel<VT>`). One CTA of 4 warps per (b, h, tile
// of VT value columns). VT is 64 unless the caller asks for 32 (the
// autotuner's `value_tile`; both are instances of the template): at 64,
// 256 CTAs at rwkv6-7b's shape, 2 per SM by shared memory (110,592 B each;
// 238 registers a thread, no spills): one wave; at 32, 512 CTAs of
// 98,304 B, each recomputing its (b, h)'s decays, still 2 per SM. It walks
// chunks of Q = 64
// tokens; chunk c+1's r, k, v and logw are in flight (cp.async, 16-byte
// copies of rows at the model's strides, zero-filled past S and K) while
// chunk c computes. The decay is per channel, so the intra-chunk decay does
// not factor into one Q x Q matrix as SSD's does; this is the two-level
// chunking of gated linear attention (Yang et al., 2023, arXiv:2312.06635),
// arranged so that every exponent is a non-positive difference. Per chunk,
// with cum the inclusive prefix sum of logw per channel (in log2 units),
// ce = cum - logw2 the exclusive one, and warp w owning the 16 tokens of
// sub-chunk w (b_w = 16 w - 1 the token before it, e_J = 16 J + 15 the last
// of sub-chunk J); every formula below needs cum only as differences, and
// those that cross sub-chunks only as sums of whole sub-chunks' totals, so
// each warp keeps cum within its own sub-chunk:
//   phase A (warp w, lane l channels 2l and 2l + 1): cum over sub-chunk w
//     by a sequential sum, kt_w = k 2^(cum_{e_w} - cum); v to fp16.
//   phase B (warp w): r_off = r 2^(ce - cum_{b_w}) in fp32, then
//     y  = (r_off 2^(cum_{b_w})) S_prev                      earlier chunks
//     y += ((r_off 2^(cum_{b_w} - cum_{e_J})) kt_J^T) v_J     sub-chunks J < w
//     y += A_ww v_w + (sum_c r u k) v                     own sub-chunk
//   where A_ww's pairs i > j are split by the highest bit in which their
//   positions in the sub-chunk differ (levels of 8, 4, 2 and 1 tokens): at a
//   level, the i side's r 2^(ce - cum_m) and the j side's k 2^(cum_m - cum)
//   meet at the boundary m between the two halves of their block, one
//   16 x 8 product per level, so A_ww needs 16 x 64 exponentials per level
//   rather than one per pair and channel (the 1-token level needs none).
//   Rows gr and gr + 8 of a lane's fragments hold tokens gr and 15 - gr,
//   which differ in every bit, so at each level exactly one of the two is
//   on the i side and no lane computes a row that the level masks out.
//   phase C (warp w, state rows 16 w .. 16 w + 15):
//     S = 2^(cum_{e_J} - cum_{e_{J-1}}) S + kt_J^T v_J  for J = 0 .. 3,
//   which ends at S = 2^tot S + (k 2^(tot - cum))^T v.
// Every product is mma.sync m16n8k16 with fp16 operands and fp32
// accumulation; the fp32 state is the warps' accumulator and S_prev its
// fp16 copy in shared memory. fp16, not bf16: a CPU mirror of these
// roundings (tests/test_torch_kernels.py) at S = 2048 missed the bf16
// tolerance of 2e-2 against the fp32 plain version with bf16 operands (by
// up to 1.7x, from every rounding site at once, the state's long memory
// carrying them) and holds it with fp16 operands (within 0.35 of it). r, k
// and v convert to fp16 exactly between 2^-14 and 65504 in magnitude
// (smaller ones lose low bits, far below the tolerance); an operand, a state
// entry or an attention entry beyond 65504 overflows to inf.
// Two barriers per chunk; S_prev is written at the top of the next chunk.
//
// fp32 design (`wkv6_fwd_kernel`, the scalar kernel). One block per (b, h)
// walks the recurrence itself in time order. Thread j owns column j of the
// state (K registers). Per token every exponent is a single logw_t <= 0.
// Tokens are staged TCH at a time in shared memory (each thread loads its
// own channel of r, k, v and logw, so the loads are coalesced and issued
// together); per staged token each thread does
//     y_j = sum_i r_i S_ij + v_j sum_i r_i u_i k_i,
//     S_ij = exp(logw_i) S_ij + k_i v_j,
// with the bonus sum taken once per token for the block. Any S >= 1 and any
// K <= 64 are handled by masking; no divisibility is assumed. The bf16
// kernel needs K a multiple of 8 and 16-byte aligned bases and strides of
// r, k, v, logw and y (the wrapper checks).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int TCH = 32;        // tokens staged in shared memory at a time
constexpr int KMAX = 64;

struct Args {
  long long r_sb, r_ss, r_sh;   // element strides (batch, sequence, head);
  long long k_sb, k_ss, k_sh;   // the K dim is contiguous
  long long v_sb, v_ss, v_sh;
  long long w_sb, w_ss, w_sh;
  long long y_sb, y_ss, y_sh;
  int S, H, K;
};

template <int KT>
__global__ void __launch_bounds__(KT)
wkv6_fwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ logw,
                const float* __restrict__ u, float* __restrict__ y, Args a) {
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

  const float* rb = r + b * a.r_sb + h * a.r_sh;
  const float* kb = k + b * a.k_sb + h * a.k_sh;
  const float* vb = v + b * a.v_sb + h * a.v_sh;
  const float* wb = logw + b * a.w_sb + h * a.w_sh;
  float* yb = y + b * a.y_sb + h * a.y_sh;
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
      const float rv = ok ? rb[ts * a.r_ss + j] : 0.f;
      const float kv = ok ? kb[ts * a.k_ss + j] : 0.f;
      const float vv = ok ? vb[ts * a.v_ss + j] : 0.f;
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
      if (live) yb[(long long)(t0 + t) * a.y_ss + j] = acc0 + acc1 + s_bonus[t] * vj;
    }
    __syncthreads();                          // before the next stage
  }
}

template <int KT>
cudaError_t launch_kt(const void* r, const void* k, const void* v,
                      const void* logw, const float* u, void* y, int B,
                      const Args& a, cudaStream_t stream) {
  wkv6_fwd_kernel<KT><<<B * a.H, KT, 0, stream>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(logw), u,
      static_cast<float*>(y), a);
  return cudaGetLastError();
}

cudaError_t launch_scalar(const void* r, const void* k, const void* v,
                          const void* logw, const float* u, void* y, int B,
                          const Args& a, cudaStream_t stream) {
  if (a.K <= 16) return launch_kt<16>(r, k, v, logw, u, y, B, a, stream);
  if (a.K <= 32) return launch_kt<32>(r, k, v, logw, u, y, B, a, stream);
  return launch_kt<64>(r, k, v, logw, u, y, B, a, stream);
}


// ---------------------------------------------------------------------------
// bf16: the chunked tensor-core scan
// ---------------------------------------------------------------------------

constexpr int CQ = 64;            // tokens per chunk
constexpr int CK = 64;            // channels in the tiles (K zero-padded)
constexpr int DEFAULT_VT = 64;    // value columns per CTA unless asked (the
                                  // template's VT: 32 or 64, K zero-padded)
constexpr int SUB = 16;           // tokens per warp's sub-chunk
constexpr int TC_THREADS = 128;   // 4 warps, one sub-chunk each
constexpr int PAD = 8;            // 16-bit elements of padding per tile row,
                                  // so that 8 rows' 16-byte pieces hit 8 banks
                                  // (rows of 72 or 40 elements both do)
constexpr int RLD = CK + PAD;     // row stride of the r, k and kt tiles
constexpr int WLD = CK + 8;       // row stride (floats) of the logw/cum tile:
                                  // 8 rows' float2 pieces hit 16 banks apart
constexpr int MAX_DEVICES = 64;
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

// Shared memory of one CTA, in bytes: two stages of (r, k, v, logw), the
// chunk's kt tile (fp16) and the fp16 copy of the state. The logw tile of a
// stage becomes that chunk's cum in place, and its v tile fp16 in place.
// VLD is the row stride of the v and state tiles. 110,592 B at VT = 64,
// 98,304 B at VT = 32.
template <int VT>
struct TcLayout {
  static constexpr int VLD = VT + PAD;
  static constexpr int R = CQ * RLD * 2;
  static constexpr int K = R;
  static constexpr int V = CQ * VLD * 2;
  static constexpr int W = CQ * WLD * 4;
  static constexpr int STAGE = R + K + V + W;
  static constexpr int KT = 2 * STAGE, ST = KT + CQ * RLD * 2;
  static constexpr int BYTES = ST + CK * VLD * 2;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; ok == false fills zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// four 8x8 16-bit matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8. trans: each matrix is read transposed.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)) : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)) : "memory");
}

// B fragments of the two 8-column tiles c0 .. c0 + 15 over rows k0 .. k0 + 15
// of a row-major [k][col] tile with row stride ld
__device__ __forceinline__ void ldsm_b_pair(uint32_t (&r)[4], const __half* t,
                                            int ld, int k0, int c0, int lane) {
  ldsm_x4_trans(r, t + (k0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * ld + c0 +
                       ((lane >> 4) << 3));
}

// d += a b: a 16x16 (row), b 16x8 (col), fp16 in, fp32 accumulate
__device__ __forceinline__ void mma_f16(float (&d)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^min(v, 0) in one MUFU.EX2, subnormal results flushed to 0: every decay
// is a non-positive difference, and the clamp keeps it so whatever the
// rounding of the difference. Its error (about 2^-22) is far below the
// fp16 rounding that follows.
__device__ __forceinline__ float ex2n(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(fminf(v, 0.f)));
  return r;
}

__device__ __forceinline__ uint32_t pack_f16(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// The j-side token of slot n (0..7) of the level whose blocks are 2 hs
// tokens long, and the boundary m = the last token of the first half of
// position p's block; positions are within a sub-chunk.
__device__ __forceinline__ int level_token(int n, int hs) {
  return (n / hs) * 2 * hs + n % hs;
}
__device__ __forceinline__ int level_boundary(int p, int hs) {
  return (p & ~(2 * hs - 1)) + hs - 1;
}

// Fragment layouts (PTX ISA, mma.m16n8k16): lane = 4 gr + tq. An fp32
// accumulator holds (row gr, cols 2tq, 2tq+1) and (row gr+8, the same
// cols); an A fragment holds rows gr and gr+8 at k = 2tq, 2tq+1 (regs 0, 1)
// and 2tq+8, 2tq+9 (regs 2, 3); a B fragment k = 2tq, 2tq+1 and 2tq+8,
// 2tq+9 at col gr. Warp w owns tokens (rows of y) 16 w .. 16 w + 15 in
// phase B, fragment rows gr and gr + 8 being tokens gr and 15 - gr, and
// state rows (channels) 16 w .. 16 w + 15 in phase C, in order.
template <int VT>
__global__ void __launch_bounds__(TC_THREADS, 2)
wkv6_chunk_kernel(const bf16* __restrict__ r, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const float* __restrict__ logw,
                  const float* __restrict__ u, bf16* __restrict__ y, Args a) {
  using Lay = TcLayout<VT>;
  constexpr int VLD = Lay::VLD;
  constexpr int NT = VT / 8;              // accumulator tiles of 8 columns
  constexpr int KCH = CK / 8;             // 16-byte pieces per r or k row
  constexpr int VCH = VT / 8;             // 16-byte pieces per v row
  constexpr int WCH = CK / 4;             // 16-byte pieces per logw row
  extern __shared__ __align__(16) unsigned char smem[];
  __half* s_kt = reinterpret_cast<__half*>(smem + Lay::KT);
  __half* s_st = reinterpret_cast<__half*>(smem + Lay::ST);

  const int ntiles = (a.K + VT - 1) / VT;
  const int bh = blockIdx.x / ntiles;     // a (b, h)'s tiles are adjacent
  const int p0 = (blockIdx.x % ntiles) * VT;
  const int b = bh / a.H, h = bh % a.H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tq = lane & 3;
  const int w16 = SUB * warp;

  const bf16* rb = r + b * a.r_sb + h * a.r_sh;
  const bf16* kb = k + b * a.k_sb + h * a.k_sh;
  const bf16* vb = v + b * a.v_sb + h * a.v_sh;
  const float* wb = logw + b * a.w_sb + h * a.w_sh;
  bf16* yb = y + b * a.y_sb + h * a.y_sh;

  // u at this lane's channels 16 kk + 2 tq + 8 hi + e
  float uf[4][2][2];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 16 * kk + 2 * tq + 8 * hi + e;
        uf[kk][hi][e] = c < a.K ? u[h * a.K + c] : 0.f;
      }

  auto stage = [&](int s) { return smem + s * Lay::STAGE; };
  auto issue = [&](int c) {               // chunk c's loads into its stage
    unsigned char* sg = stage(c & 1);
    bf16* sr = reinterpret_cast<bf16*>(sg);
    bf16* sk = reinterpret_cast<bf16*>(sg + Lay::R);
    bf16* sv = reinterpret_cast<bf16*>(sg + Lay::R + Lay::K);
    float* sw = reinterpret_cast<float*>(sg + Lay::R + Lay::K + Lay::V);
    const int t0 = c * CQ;
#pragma unroll
    for (int i = tid; i < CQ * KCH; i += TC_THREADS) {
      const int t = i / KCH, q = i % KCH;
      const bool ok = t0 + t < a.S && 8 * q < a.K;
      const long long ts = t0 + t;
      cp_async16(sr + t * RLD + 8 * q, ok ? rb + ts * a.r_ss + 8 * q : rb, ok);
      cp_async16(sk + t * RLD + 8 * q, ok ? kb + ts * a.k_ss + 8 * q : kb, ok);
    }
#pragma unroll
    for (int i = tid; i < CQ * VCH; i += TC_THREADS) {
      const int t = i / VCH, q = i % VCH, p = p0 + 8 * q;
      const bool ok = t0 + t < a.S && p < a.K;
      cp_async16(sv + t * VLD + 8 * q,
                 ok ? vb + (long long)(t0 + t) * a.v_ss + p : vb, ok);
    }
#pragma unroll
    for (int i = tid; i < CQ * WCH; i += TC_THREADS) {
      const int t = i / WCH, q = i % WCH;
      const bool ok = t0 + t < a.S && 4 * q < a.K;
      cp_async16(sw + t * WLD + 4 * q,
                 ok ? wb + (long long)(t0 + t) * a.w_ss + 4 * q : wb, ok);
    }
    cp_async_commit();
  };

  float st[NT][4];                        // state rows w16 + gr (+8)
#pragma unroll
  for (int i = 0; i < NT; ++i) st[i][0] = st[i][1] = st[i][2] = st[i][3] = 0.f;

  // this lane's state rows (channels) and y rows (tokens): rows gr and
  // gr + 8 of the fragments hold tokens gr and 15 - gr of the sub-chunk, so
  // that at every level of the diagonal block one of the two is on the i
  // side (the tokens differ in every bit)
  const int ca = w16 + gr, cb = ca + 8;
  const int ta = w16 + gr, tb = w16 + 15 - gr;
  const int nch = (a.S + CQ - 1) / CQ;
  issue(0);
  for (int c = 0; c < nch; ++c) {
    cp_async_wait_all();
    // chunk c is visible to all, and every warp is done with chunk c - 1
    __syncthreads();
    if (c + 1 < nch) issue(c + 1);
    unsigned char* sg = stage(c & 1);
    bf16* sr = reinterpret_cast<bf16*>(sg);
    const bf16* sk = reinterpret_cast<const bf16*>(sg + Lay::R);
    __half* sv = reinterpret_cast<__half*>(sg + Lay::R + Lay::K);
    float* cum = reinterpret_cast<float*>(sg + Lay::R + Lay::K + Lay::V);

    // S_prev: the fp16 copy of the state after chunk c - 1 (zeros at c = 0)
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      *reinterpret_cast<uint32_t*>(s_st + ca * VLD + 8 * i + 2 * tq) =
          pack_f16(st[i][0], st[i][1]);
      *reinterpret_cast<uint32_t*>(s_st + cb * VLD + 8 * i + 2 * tq) =
          pack_f16(st[i][2], st[i][3]);
    }

    // -- phase A: cum in place of logw, kt, v to fp16 ----------------------
    {
      // warp w scans its own sub-chunk; lane l takes channels 2l and 2l + 1
      const int c2 = 2 * lane;
      float2 cm[SUB];
      float2 run = make_float2(0.f, 0.f);
#pragma unroll
      for (int i = 0; i < SUB; ++i) {
        const float2 lw = *reinterpret_cast<const float2*>(cum + (w16 + i) * WLD + c2);
        run.x = fmaf(lw.x, LOG2E, run.x);
        run.y = fmaf(lw.y, LOG2E, run.y);
        cm[i] = run;
      }
#pragma unroll
      for (int i = 0; i < SUB; ++i) {     // run = cum_{e_w}, the sub-chunk's total
        *reinterpret_cast<float2*>(cum + (w16 + i) * WLD + c2) = cm[i];
        const float2 kv = unpack_bf16(
            *reinterpret_cast<const uint32_t*>(sk + (w16 + i) * RLD + c2));
        *reinterpret_cast<uint32_t*>(s_kt + (w16 + i) * RLD + c2) =
            pack_f16(kv.x * ex2n(run.x - cm[i].x), kv.y * ex2n(run.y - cm[i].y));
      }
#pragma unroll
      for (int i = tid; i < CQ * VCH; i += TC_THREADS) {
        uint4* p = reinterpret_cast<uint4*>(sv + (i / VCH) * VLD + 8 * (i % VCH));
        uint4 q = *p;
        uint32_t* w = &q.x;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = unpack_bf16(w[e]);
          w[e] = pack_f16(f.x, f.y);
        }
        *p = q;
      }
    }
    __syncthreads();      // cum, kt, fp16 v and S_prev complete

    // -- phase B: y of this warp's 16 tokens --------------------------------
    // raw r and k at this lane's A-fragment places (rows ta, tb)
    uint32_t rf[4][4];
    float ba = 0.f, bb = 0.f;             // the bonus sum_c r u k of rows ta, tb
    const int lrow = lane & 15;           // the fragment row this lane loads
    const int ltok = w16 + (lrow < 8 ? lrow : 23 - lrow);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int off = ltok * RLD + 16 * kk + ((lane >> 4) << 3);
      uint32_t kf[4];
      ldsm_x4(rf[kk], sr + off);
      ldsm_x4(kf, sk + off);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 rv = unpack_bf16(rf[kk][q]), kv = unpack_bf16(kf[q]);
        const float s = rv.x * uf[kk][q >> 1][0] * kv.x +
                        rv.y * uf[kk][q >> 1][1] * kv.y;
        if (q & 1) bb += s; else ba += s;
      }
    }
    ba += __shfl_xor_sync(FULL, ba, 1);
    ba += __shfl_xor_sync(FULL, ba, 2);
    bb += __shfl_xor_sync(FULL, bb, 1);
    bb += __shfl_xor_sync(FULL, bb, 2);
    // r_off = r 2^(ce - cum_{b_w}): ce within the sub-chunk (0 at its first
    // token); base = cum_{b_w} - cum_{-1}, the sum of the earlier
    // sub-chunks' totals
    float ro[4][4][2];
    float2 base[4][2];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int col = 16 * kk + 2 * tq + 8 * hi;
        float2 bs = make_float2(0.f, 0.f);
#pragma unroll
        for (int J = 0; J < 3; ++J) {
          if (J >= warp) break;
          const float2 t = *reinterpret_cast<const float2*>(
              cum + (SUB * J + SUB - 1) * WLD + col);
          bs.x += t.x;
          bs.y += t.y;
        }
        base[kk][hi] = bs;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int p = (q & 1) ? 15 - gr : gr;
        const int col = 16 * kk + 2 * tq + 8 * (q >> 1);
        const float2 ce = p > 0 ? *reinterpret_cast<const float2*>(
                                      cum + (w16 + p - 1) * WLD + col)
                                : make_float2(0.f, 0.f);
        const float2 rv = unpack_bf16(rf[kk][q]);
        ro[kk][q][0] = rv.x * ex2n(ce.x);
        ro[kk][q][1] = rv.y * ex2n(ce.y);
      }
    }

    // y = (r_off 2^(cum_{b_w})) S_prev
    float yacc[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i) yacc[i][0] = yacc[i][1] = yacc[i][2] = yacc[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t af[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 bs = base[kk][q >> 1];
        af[q] = pack_f16(ro[kk][q][0] * ex2n(bs.x), ro[kk][q][1] * ex2n(bs.y));
      }
#pragma unroll
      for (int pp = 0; pp < NT / 2; ++pp) {
        uint32_t bfr[4];
        ldsm_b_pair(bfr, s_st, VLD, 16 * kk, 16 * pp, lane);
        mma_f16(yacc[2 * pp], af, bfr[0], bfr[1]);
        mma_f16(yacc[2 * pp + 1], af, bfr[2], bfr[3]);
      }
    }

    // earlier sub-chunks J < w (warp-uniform): A = r_off 2^(cum_{b_w} -
    // cum_{e_J}) kt_J^T, then y += A v_J
#pragma unroll
    for (int J = 0; J < 3; ++J) {
      if (J >= warp) break;
      float sacc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t af[4];
        float2 sc[2] = {make_float2(1.f, 1.f), make_float2(1.f, 1.f)};
        if (J < warp - 1) {               // e_{w-1} = b_w: no scale
#pragma unroll
          for (int hi = 0; hi < 2; ++hi) {
            // cum_{b_w} - cum_{e_J}: the totals of sub-chunks J + 1 .. w - 1
            const int col = 16 * kk + 2 * tq + 8 * hi;
            float2 d = *reinterpret_cast<const float2*>(
                cum + (SUB * (J + 1) + SUB - 1) * WLD + col);
            if (J + 2 < warp) {
              const float2 t = *reinterpret_cast<const float2*>(
                  cum + (SUB * (J + 2) + SUB - 1) * WLD + col);
              d.x += t.x;
              d.y += t.y;
            }
            sc[hi] = make_float2(ex2n(d.x), ex2n(d.y));
          }
        }
#pragma unroll
        for (int q = 0; q < 4; ++q)
          af[q] = pack_f16(ro[kk][q][0] * sc[q >> 1].x, ro[kk][q][1] * sc[q >> 1].y);
        uint32_t bfr[4];
        ldsm_x4(bfr, s_kt + (SUB * J + (lane & 7) + ((lane >> 4) << 3)) * RLD +
                         16 * kk + (((lane >> 3) & 1) << 3));
        mma_f16(sacc[0], af, bfr[0], bfr[1]);
        mma_f16(sacc[1], af, bfr[2], bfr[3]);
      }
      const uint32_t pa[4] = {pack_f16(sacc[0][0], sacc[0][1]),
                              pack_f16(sacc[0][2], sacc[0][3]),
                              pack_f16(sacc[1][0], sacc[1][1]),
                              pack_f16(sacc[1][2], sacc[1][3])};
#pragma unroll
      for (int pp = 0; pp < NT / 2; ++pp) {
        uint32_t bfr[4];
        ldsm_b_pair(bfr, sv, VLD, SUB * J, 16 * pp, lane);
        mma_f16(yacc[2 * pp], pa, bfr[0], bfr[1]);
        mma_f16(yacc[2 * pp + 1], pa, bfr[2], bfr[3]);
      }
    }

    // own sub-chunk: the levels of 8, 4, 2 and 1 tokens, two per product
#pragma unroll
    for (int pair = 0; pair < 2; ++pair) {
      uint32_t pa[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int hs = 8 >> (2 * pair + half);
        float lacc[4] = {0.f, 0.f, 0.f, 0.f};
        const int jt = w16 + level_token(gr, hs);                 // B's token
        const int jm = w16 + level_boundary(level_token(gr, hs), hs);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          uint32_t af[4], bf2[2];
          // of rows ta and tb exactly one is on the i side (p); the other
          // row of the A fragment is zero
          const bool lo = (gr & hs) != 0;
          const int p = lo ? gr : 15 - gr;
#pragma unroll
          for (int hi = 0; hi < 2; ++hi) {
            const int col = 16 * kk + 2 * tq + 8 * hi;
            const float2 rv = unpack_bf16(lo ? rf[kk][2 * hi] : rf[kk][2 * hi + 1]);
            uint32_t val;
            if (hs == 1) {
              val = pack_f16(rv.x, rv.y);   // ce = cum_m: decay 1
            } else {
              const float2 ce = *reinterpret_cast<const float2*>(
                  cum + (w16 + p - 1) * WLD + col);
              const float2 cmb = *reinterpret_cast<const float2*>(
                  cum + (w16 + level_boundary(p, hs)) * WLD + col);
              val = pack_f16(rv.x * ex2n(ce.x - cmb.x), rv.y * ex2n(ce.y - cmb.y));
            }
            af[2 * hi] = lo ? val : 0u;
            af[2 * hi + 1] = lo ? 0u : val;
          }
#pragma unroll
          for (int hi = 0; hi < 2; ++hi) {
            const int col = 16 * kk + 2 * tq + 8 * hi;
            const float2 kv = unpack_bf16(
                *reinterpret_cast<const uint32_t*>(sk + jt * RLD + col));
            if (hs == 1) {
              bf2[hi] = pack_f16(kv.x, kv.y);
            } else {
              const float2 cj = *reinterpret_cast<const float2*>(cum + jt * WLD + col);
              const float2 cm = *reinterpret_cast<const float2*>(cum + jm * WLD + col);
              bf2[hi] = pack_f16(kv.x * ex2n(cm.x - cj.x), kv.y * ex2n(cm.y - cj.y));
            }
          }
          mma_f16(lacc, af, bf2[0], bf2[1]);
        }
        // keep pairs of one block: row p (i side) and slot n's token
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int p = (q >> 1) ? 15 - gr : gr;
          const int tok = level_token(2 * tq + (q & 1), hs);
          if (!(p & hs) || (p & ~(2 * hs - 1)) != (tok & ~(2 * hs - 1)))
            lacc[q] = 0.f;
        }
        pa[2 * half] = pack_f16(lacc[0], lacc[1]);
        pa[2 * half + 1] = pack_f16(lacc[2], lacc[3]);
      }
      // v rows of the two levels' j-side tokens, gathered by ldmatrix
      const int mi = lane >> 3, rr = lane & 7;
      const int hs = 8 >> (2 * pair + (mi & 1));
      const __half* vrow = sv + (w16 + level_token(rr, hs)) * VLD + 8 * (mi >> 1);
      // pa: regs 0, 1 from level 2 pair (k 0..7), regs 2, 3 from its
      // second level (k 8..15), in A-fragment order
      const uint32_t af[4] = {pa[0], pa[1], pa[2], pa[3]};
#pragma unroll
      for (int pp = 0; pp < NT / 2; ++pp) {
        uint32_t bfr[4];
        ldsm_x4_trans(bfr, vrow + 16 * pp);
        mma_f16(yacc[2 * pp], af, bfr[0], bfr[1]);
        mma_f16(yacc[2 * pp + 1], af, bfr[2], bfr[3]);
      }
    }

    // bonus: y_t += (sum_c r_tc u_c k_tc) v_t, rows ta and tb
    {
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        const float2 va = __half22float2(
            *reinterpret_cast<const __half2*>(sv + ta * VLD + 8 * i + 2 * tq));
        const float2 vb2 = __half22float2(
            *reinterpret_cast<const __half2*>(sv + tb * VLD + 8 * i + 2 * tq));
        yacc[i][0] = fmaf(ba, va.x, yacc[i][0]);
        yacc[i][1] = fmaf(ba, va.y, yacc[i][1]);
        yacc[i][2] = fmaf(bb, vb2.x, yacc[i][2]);
        yacc[i][3] = fmaf(bb, vb2.y, yacc[i][3]);
      }
    }

    // y in bf16 over this warp's own rows of the r tile (only this warp
    // reads them), then stored as rows
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      *reinterpret_cast<__nv_bfloat162*>(sr + ta * RLD + 8 * i + 2 * tq) =
          __floats2bfloat162_rn(yacc[i][0], yacc[i][1]);
      *reinterpret_cast<__nv_bfloat162*>(sr + tb * RLD + 8 * i + 2 * tq) =
          __floats2bfloat162_rn(yacc[i][2], yacc[i][3]);
    }
    __syncwarp();
    const int t0 = c * CQ;
#pragma unroll
    for (int i = lane; i < SUB * VCH; i += 32) {
      const int t = w16 + i / VCH, q = i % VCH, p = p0 + 8 * q;
      if (t0 + t < a.S && p < a.K)
        *reinterpret_cast<uint4*>(yb + (long long)(t0 + t) * a.y_ss + p) =
            *reinterpret_cast<const uint4*>(sr + t * RLD + 8 * q);
    }

    // -- phase C: S = 2^(cum_{e_J} - cum_{e_{J-1}}) S + kt_J^T v_J ----------
#pragma unroll
    for (int J = 0; J < CQ / SUB; ++J) {
      // cum_{e_J} - cum_{e_{J-1}}: sub-chunk J's total, at rows ca and cb
      const float fa = ex2n(cum[(SUB * J + SUB - 1) * WLD + ca]);
      const float fb = ex2n(cum[(SUB * J + SUB - 1) * WLD + cb]);
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        st[i][0] *= fa; st[i][1] *= fa; st[i][2] *= fb; st[i][3] *= fb;
      }
      uint32_t af[4];
      ldsm_x4_trans(af, s_kt + (SUB * J + (lane & 7) + ((lane >> 4) << 3)) * RLD +
                            w16 + (((lane >> 3) & 1) << 3));
#pragma unroll
      for (int pp = 0; pp < NT / 2; ++pp) {
        uint32_t bfr[4];
        ldsm_b_pair(bfr, sv, VLD, SUB * J, 16 * pp, lane);
        mma_f16(st[2 * pp], af, bfr[0], bfr[1]);
        mma_f16(st[2 * pp + 1], af, bfr[2], bfr[3]);
      }
    }
  }
}

// cudaFuncSetAttribute holds only for the device that is current when it is
// called, so each instance's shared-memory limit is set once per device (two
// threads racing here both set it, which is harmless).
template <int VT>
cudaError_t allow_smem() {
  static std::atomic<bool> done[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES || !done[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(wkv6_chunk_kernel<VT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               TcLayout<VT>::BYTES);
    if (err != cudaSuccess) return err;
    if (dev < MAX_DEVICES) done[dev].store(true, std::memory_order_release);
  }
  return cudaSuccess;
}

template <int VT>
cudaError_t launch_chunked(const void* r, const void* k, const void* v,
                           const void* logw, const float* u, void* y, int B,
                           const Args& a, cudaStream_t stream) {
  const cudaError_t err = allow_smem<VT>();
  if (err != cudaSuccess) return err;
  const int grid = B * a.H * ((a.K + VT - 1) / VT);
  wkv6_chunk_kernel<VT><<<grid, TC_THREADS, TcLayout<VT>::BYTES, stream>>>(
      static_cast<const bf16*>(r), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(logw), u,
      static_cast<bf16*>(y), a);
  return cudaGetLastError();
}

// registers and local bytes a thread, dynamic shared memory a CTA and CTAs
// per SM of one instance on the current device
template <int VT>
cudaError_t instance_info(int* info) {
  cudaError_t err = allow_smem<VT>();
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, wkv6_chunk_kernel<VT>);
  if (err != cudaSuccess) return err;
  info[0] = attr.numRegs;
  info[1] = (int)attr.localSizeBytes;
  info[2] = TcLayout<VT>::BYTES;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &info[3], wkv6_chunk_kernel<VT>, TC_THREADS, TcLayout<VT>::BYTES);
}

int check_args(int B, int S, int H, int K) {
  return (B < 1 || S < 1 || H < 1 || K < 1 || K > KMAX) ? 1 : 0;
}

}  // namespace

// float32 r, k, v, y (the scalar kernel). logw is float32 with a contiguous
// K dim; u is float32 (H, K), contiguous. Strides are in elements, ordered
// (batch, sequence, head). Returns a cudaError_t as int (0 = launched).
extern "C" int wkv6_fwd(
    const void* r, const void* k, const void* v, const void* logw,
    const void* u, void* y, int B, int S, int H, int K,
    long long r_sb, long long r_ss, long long r_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long w_sb, long long w_ss, long long w_sh,
    long long y_sb, long long y_ss, long long y_sh, int device, void* stream) {
  if (check_args(B, S, H, K)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Args a{r_sb, r_ss, r_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
               w_sb, w_ss, w_sh, y_sb, y_ss, y_sh, S, H, K};
  return (int)launch_scalar(r, k, v, logw, static_cast<const float*>(u), y, B,
                            a, static_cast<cudaStream_t>(stream));
}

// bfloat16 r, k, v, y (the chunked tensor-core kernel), with the arguments
// of wkv6_fwd and value_tile, the value columns a CTA: 32 or 64, or 0 for
// 64. It needs K a multiple of 8 and 16-byte aligned bases and strides of
// r, k, v, logw and y.
extern "C" int wkv6_chunk_fwd(
    const void* r, const void* k, const void* v, const void* logw,
    const void* u, void* y, int B, int S, int H, int K,
    long long r_sb, long long r_ss, long long r_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long w_sb, long long w_ss, long long w_sh,
    long long y_sb, long long y_ss, long long y_sh, int value_tile,
    int device, void* stream) {
  if (value_tile == 0) value_tile = DEFAULT_VT;
  if (check_args(B, S, H, K) || K % 8 != 0 ||
      (value_tile != 32 && value_tile != 64))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Args a{r_sb, r_ss, r_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
               w_sb, w_ss, w_sh, y_sb, y_ss, y_sh, S, H, K};
  const float* uf = static_cast<const float*>(u);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(value_tile == 32
                   ? launch_chunked<32>(r, k, v, logw, uf, y, B, a, st)
                   : launch_chunked<64>(r, k, v, logw, uf, y, B, a, st));
}

// The chunked kernel's instance for value_tile (32 or 64) on the current
// device: info[0] registers a thread, info[1] local (spilled) bytes a
// thread, info[2] dynamic shared memory a CTA, info[3] CTAs per SM.
extern "C" int wkv6_chunk_info(int value_tile, int* info) {
  if (value_tile == 32) return (int)instance_info<32>(info);
  if (value_tile == 64) return (int)instance_info<64>(info);
  return (int)cudaErrorInvalidValue;
}
