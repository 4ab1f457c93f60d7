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
// about 0.072 ms at 3.35 TB/s. The chunked form below does about 3e10 FLOP
// at chunk 64, about 30 us at the bf16 tensor-core rate, so the bytes bound
// it. Both kernels move x, dt and y once, through the model's (B, S, H, P)
// strides with no transposed copy; B and C are read once per head that
// shares their group (the L2 cache serves the repeats); the fp32 state
// never leaves the chip.
//
// The Pallas kernel's chunked matrix form carries the state across a
// sequential grid dimension in VMEM and factors the intra-chunk decay as
// exp(cum_t - tot/2) * exp(tot/2 - cum_j), which overflows fp32 once a
// chunk's summed log-decay passes about -176. Hopper's blocks run in no
// order, so here a loop inside the block walks the chunks (or tokens) in
// time order, and no exponent is ever positive.
//
// bf16 design (`ssd_chunk_kernel_64` and `_32`). One CTA of 4 warps per (b, h, tile
// of PT state columns); columns of the state and of y are independent, so a
// tile costs only a recomputed C B^T. PT is 64 unless the caller asks for
// 32 (the autotuner's `state_tile`; both are instances of the template). The CTA walks chunks of Q = 64 tokens;
// chunk c+1's x, B, C and dt are in flight (cp.async, 16-byte copies of
// rows at the model's strides, zero-filled past S, N and P) while chunk c
// computes. With cum the inclusive prefix sum of dt A over the chunk (a warp
// scan) and tot its last value, per chunk, on mma.sync m16n8k16 (bf16 in,
// fp32 accumulate), each warp owning 16 tokens and 16 state rows:
//     G = C B^T                                   (Q x Q, depth N)
//     L = G * exp(cum_t - cum_j) for t >= j, else 0   (a bf16 pair, in
//                                                       registers)
//     y = exp(cum_t) (C S_prev) + L xd + D x      (xd = dt x, bf16)
//     S = exp(tot) S + B^T xw                     (xw = dt exp(tot - cum_j) x)
// Every exponent is a masked, non-positive difference. L is held as a pair
// of bf16 values, hi + lo, and L xd runs as two products: a single bf16 L
// (8 bits) put some outputs past the 2e-2 tolerance of tests/test_kernels.py
// at zamba2-7b's prefill shape (4 x 2048 x 112 heads; G = C B^T sums N = 64
// products, so L reaches about 16 where y may be below 0.1). The state S
// is the fp32 mma accumulator of the warps; S_prev is its bf16 copy in
// shared memory. y goes back through the chunk's x tile as coalesced rows. Masked
// tokens get dt = 0 (decay 1, xd = 0), so they leave S unchanged. A chunk
// is a chain of dependent steps (scan, products, decays, barriers), so the
// walk is bound by their latency, not by the tensor cores; two CTAs share
// an SM at PT = 64 (84,480 B of shared memory each). At PT = 32 a CTA needs
// 64,000 B, so three share an SM (its launch bounds ask the compiler for
// registers that allow it).
//
// fp32 design (`ssd_fwd_kernel`, the scalar kernel). One block per (b, h)
// walks the recurrence in time order: thread p owns column p of the state
// (N registers). Per token the only exponent is dt_t A <= 0. Tokens are
// staged TCH at a time in shared memory (x by its own thread, B, C, dt and
// exp(dt A) by the whole block, all loads coalesced and issued together);
// per staged token each thread does
//     h_np = exp(dt A) h_np + B_n dt x_p,   y_p = sum_n C_n h_np + D x_p.
// Any S >= 1, P <= 128 and N <= 64 are handled by masking; no divisibility
// is assumed. The bf16 kernel needs P and N multiples of 8 and 16-byte
// aligned bases and strides (the wrapper checks).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int TCH = 32;        // tokens staged in shared memory at a time
constexpr int NMAX = 64;
constexpr int PMAX = 128;

struct Args {
  long long x_sb, x_ss, x_sh;     // element strides (batch, sequence, head);
  long long dt_sb, dt_ss, dt_sh;  // P and N dims are contiguous
  long long b_sb, b_ss, b_sg;
  long long c_sb, c_ss, c_sg;
  long long y_sb, y_ss, y_sh;
  int S, H, G, P, N;
};

template <int NT, int PT>
__global__ void __launch_bounds__(PT)
ssd_fwd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const float* __restrict__ Bm,
               const float* __restrict__ Cm, const float* __restrict__ D,
               float* __restrict__ y, Args a) {
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

  const float* xb = x + b * a.x_sb + h * a.x_sh;
  const float* db = dt + b * a.dt_sb + h * a.dt_sh;
  const float* bb = Bm + b * a.b_sb + g * a.b_sg;
  const float* cb = Cm + b * a.c_sb + g * a.c_sg;
  float* yb = y + b * a.y_sb + h * a.y_sh;
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
      s_x[t][p] = ok ? xb[(long long)(t0 + t) * a.x_ss + p] : 0.f;
    }
    for (int i = p; i < TCH * NT; i += PT) {
      const int t = i / NT, n = i % NT;
      const bool ok = t < cnt && n < a.N;
      const long long ts = t0 + t;
      s_B[t][n] = ok ? bb[ts * a.b_ss + n] : 0.f;
      s_C[t][n] = ok ? cb[ts * a.c_ss + n] : 0.f;
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
        yb[(long long)(t0 + t) * a.y_ss + p] = acc0 + acc1 + Dh * xv;
    }
    __syncthreads();                          // before the next stage
  }
}

template <int NT, int PT>
cudaError_t launch_t(const void* x, const void* dt, const float* A,
                     const void* Bm, const void* Cm, const float* D, void* y,
                     int B, const Args& a, cudaStream_t stream) {
  ssd_fwd_kernel<NT, PT><<<B * a.H, PT, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt), A,
      static_cast<const float*>(Bm), static_cast<const float*>(Cm), D,
      static_cast<float*>(y), a);
  return cudaGetLastError();
}

template <int NT>
cudaError_t launch_n(const void* x, const void* dt, const float* A,
                     const void* Bm, const void* Cm, const float* D, void* y,
                     int B, const Args& a, cudaStream_t stream) {
  if (a.P <= 32) return launch_t<NT, 32>(x, dt, A, Bm, Cm, D, y, B, a, stream);
  if (a.P <= 64) return launch_t<NT, 64>(x, dt, A, Bm, Cm, D, y, B, a, stream);
  return launch_t<NT, 128>(x, dt, A, Bm, Cm, D, y, B, a, stream);
}

cudaError_t launch_scalar(const void* x, const void* dt, const float* A,
                          const void* Bm, const void* Cm, const float* D,
                          void* y, int B, const Args& a, cudaStream_t stream) {
  if (a.N <= 16) return launch_n<16>(x, dt, A, Bm, Cm, D, y, B, a, stream);
  if (a.N <= 32) return launch_n<32>(x, dt, A, Bm, Cm, D, y, B, a, stream);
  return launch_n<64>(x, dt, A, Bm, Cm, D, y, B, a, stream);
}


// ---------------------------------------------------------------------------
// bf16: the chunked tensor-core scan
// ---------------------------------------------------------------------------

constexpr int CQ = 64;            // tokens per chunk
constexpr int CN = 64;            // state rows in the tiles (N zero-padded)
constexpr int DEFAULT_PT = 64;    // state columns per CTA unless asked (the
                                  // template's PT: 32 or 64, P zero-padded)
constexpr int TC_THREADS = 128;   // 4 warps: 16 tokens and 16 state rows each
constexpr int PAD = 8;            // bf16 elements of padding per tile row, so
                                  // that 8 rows' 16-byte pieces hit 8 banks
                                  // (rows of 72 or 40 elements both do)
constexpr int NLD = CN + PAD;     // row stride of the B and C tiles
constexpr int MAX_DEVICES = 64;
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

// Shared memory of one CTA, in bytes: two stages of (x, B, C, dt), then the
// xd and xw tiles, the bf16 state copy and one cum row per warp. XLD is the
// row stride of the x, xd, xw and state tiles. 84,480 B at PT = 64, 64,000 B
// at PT = 32.
template <int PT>
struct TcLayout {
  static constexpr int XLD = PT + PAD;
  static constexpr int X = CQ * XLD * 2;
  static constexpr int BC = CQ * NLD * 2;
  static constexpr int STAGE = X + 2 * BC + CQ * 4;
  static constexpr int XD = 2 * STAGE, XW = XD + X, SS = XW + X;
  static constexpr int CUM = SS + CN * XLD * 2;
  static constexpr int BYTES = CUM + (TC_THREADS / 32) * CQ * 4;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes global -> shared; ok == false fills zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// four 8x8 bf16 matrices from shared memory; lane l gives the address of
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
__device__ __forceinline__ void ldsm_b_pair(uint32_t (&r)[4], const bf16* t,
                                            int ld, int k0, int c0, int lane) {
  ldsm_x4_trans(r, t + (k0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * ld + c0 +
                       ((lane >> 4) << 3));
}

// d += a b: a 16x16 (row), b 16x8 (col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^v in one MUFU.EX2, subnormal results flushed to 0. The decays are
// rounded to a bf16 pair (16 bits) right after, so its error (about
// 2^-22) does not show;
// __expf compiled to a slower sequence here and took a third of the
// kernel's time (PERF.md).
__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// (a, b) as a bf16 pair: *h the rounded values, the return their residuals
__device__ __forceinline__ uint32_t pack_bf16_split(float a, float b,
                                                    uint32_t* h) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  *h = *reinterpret_cast<const uint32_t*>(&v);
  const float2 f = __bfloat1622float2(v);
  return pack_bf16(a - f.x, b - f.y);
}

// Fragment layouts (PTX ISA, mma.m16n8k16): lane = 4 gr + tq. An fp32
// accumulator holds (row gr, cols 2tq, 2tq+1) and (row gr+8, the same
// cols); an A fragment holds rows gr and gr+8 at k = 2tq, 2tq+1 and
// 2tq+8, 2tq+9; a B fragment k = 2tq, 2tq+1 and 2tq+8, 2tq+9 at col gr.
// Warp w owns tokens and state rows 16 w .. 16 w + 15. Every warp runs the
// same straight-line code: the causal tiles above the diagonal are formed
// and masked to zero rather than skipped, which keeps each phase one block
// of instructions the compiler can interleave. The body of both instances
// (ssd_chunk_kernel_64 and ssd_chunk_kernel_32 below).
template <int PT>
__device__ __forceinline__ void ssd_chunk(
    const bf16* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const bf16* __restrict__ Bm,
    const bf16* __restrict__ Cm, const float* __restrict__ D,
    bf16* __restrict__ y, const Args& a) {
  using Lay = TcLayout<PT>;
  constexpr int XLD = Lay::XLD;
  constexpr int PTILES = PT / 8;          // accumulator tiles of 8 columns
  constexpr int XCH = PT / 8;             // 16-byte pieces per x row
  constexpr int NCH = CN / 8;             // 16-byte pieces per B or C row
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s_xd = reinterpret_cast<bf16*>(smem + Lay::XD);
  bf16* s_xw = reinterpret_cast<bf16*>(smem + Lay::XW);
  bf16* s_st = reinterpret_cast<bf16*>(smem + Lay::SS);

  const int ntiles = (a.P + PT - 1) / PT;
  const int bh = blockIdx.x / ntiles;
  const int p0 = (blockIdx.x % ntiles) * PT;
  const int b = bh / a.H, h = bh % a.H;
  const int g = h / (a.H / a.G);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tq = lane & 3;
  float* s_cum = reinterpret_cast<float*>(smem + Lay::CUM) + warp * CQ;

  const bf16* xb = x + b * a.x_sb + h * a.x_sh;
  const float* db = dt + b * a.dt_sb + h * a.dt_sh;
  const bf16* bb = Bm + b * a.b_sb + g * a.b_sg;
  const bf16* cb = Cm + b * a.c_sb + g * a.c_sg;
  bf16* yb = y + b * a.y_sb + h * a.y_sh;
  const float Dh = D[h];
  const float A2 = A[h] * LOG2E;          // cum is kept in log2 units

  auto stage = [&](int s) { return smem + s * Lay::STAGE; };
  auto issue = [&](int c) {               // chunk c's loads into its stage
    unsigned char* st = stage(c & 1);
    bf16* sx = reinterpret_cast<bf16*>(st);
    bf16* sb = reinterpret_cast<bf16*>(st + Lay::X);
    bf16* sc = reinterpret_cast<bf16*>(st + Lay::X + Lay::BC);
    float* sdt = reinterpret_cast<float*>(st + Lay::X + 2 * Lay::BC);
    const int t0 = c * CQ;
#pragma unroll
    for (int i = tid; i < CQ * XCH; i += TC_THREADS) {
      const int t = i / XCH, k = i % XCH, p = p0 + 8 * k;
      const bool ok = t0 + t < a.S && p < a.P;
      cp_async16(sx + t * XLD + 8 * k,
                 ok ? xb + (long long)(t0 + t) * a.x_ss + p : xb, ok);
    }
#pragma unroll
    for (int i = tid; i < CQ * NCH; i += TC_THREADS) {
      const int t = i / NCH, k = i % NCH;
      const bool ok = t0 + t < a.S && 8 * k < a.N;
      const long long ts = t0 + t;
      cp_async16(sb + t * NLD + 8 * k, ok ? bb + ts * a.b_ss + 8 * k : bb, ok);
      cp_async16(sc + t * NLD + 8 * k, ok ? cb + ts * a.c_ss + 8 * k : cb, ok);
    }
    if (tid < CQ) {
      const bool ok = t0 + tid < a.S;
      cp_async4(sdt + tid, ok ? db + (long long)(t0 + tid) * a.dt_ss : db, ok);
    }
    cp_async_commit();
  };

  for (int i = tid; i < CN * XLD / 8; i += TC_THREADS)     // S_prev = 0
    reinterpret_cast<uint4*>(s_st)[i] = make_uint4(0, 0, 0, 0);

  float st[PTILES][4];                    // state rows 16 warp + gr (+8)
#pragma unroll
  for (int i = 0; i < PTILES; ++i)
    st[i][0] = st[i][1] = st[i][2] = st[i][3] = 0.f;

  const int ta = 16 * warp + gr, tb = ta + 8;   // this thread's rows
  const int nch = (a.S + CQ - 1) / CQ;
  issue(0);
  for (int c = 0; c < nch; ++c) {
    cp_async_wait_all();
    // chunk c is visible to all, and every warp is done with chunk c - 1
    __syncthreads();
    if (c + 1 < nch) issue(c + 1);
    unsigned char* stg = stage(c & 1);
    bf16* sx = reinterpret_cast<bf16*>(stg);
    const bf16* sb = reinterpret_cast<const bf16*>(stg + Lay::X);
    const bf16* sc = reinterpret_cast<const bf16*>(stg + Lay::X + Lay::BC);
    const float* sdt = reinterpret_cast<const float*>(stg + Lay::X + 2 * Lay::BC);

    // cum: inclusive prefix sum of dt A log2(e) (<= 0); lane l holds tokens
    // l and l + 32
    const float d0 = sdt[lane], d1 = sdt[lane + 32];
    float c0 = d0 * A2, c1 = d1 * A2;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float v0 = __shfl_up_sync(FULL, c0, o);
      const float v1 = __shfl_up_sync(FULL, c1, o);
      if (lane >= o) { c0 += v0; c1 += v1; }
    }
    c1 += __shfl_sync(FULL, c0, 31);
    const float tot = __shfl_sync(FULL, c1, 31);
    s_cum[lane] = c0;
    s_cum[lane + 32] = c1;
    __syncwarp();

    // C fragments of this warp's 16 tokens, k over the state rows
    uint32_t cf[CN / 16][4];
#pragma unroll
    for (int kk = 0; kk < CN / 16; ++kk)
      ldsm_x4(cf[kk], sc + (16 * warp + (lane & 15)) * NLD + 16 * kk +
                          ((lane >> 4) << 3));

    // G = C B^T over all 64 tokens j of the chunk
    float gacc[CQ / 8][4];
#pragma unroll
    for (int i = 0; i < CQ / 8; ++i)
      gacc[i][0] = gacc[i][1] = gacc[i][2] = gacc[i][3] = 0.f;
#pragma unroll
    for (int jp = 0; jp < CQ / 16; ++jp) {
#pragma unroll
      for (int kk = 0; kk < CN / 16; ++kk) {
        uint32_t bfr[4];
        ldsm_x4(bfr, sb + (16 * jp + (lane & 7) + ((lane >> 4) << 3)) * NLD +
                         16 * kk + (((lane >> 3) & 1) << 3));
        mma_bf16(gacc[2 * jp], cf[kk], bfr[0], bfr[1]);
        mma_bf16(gacc[2 * jp + 1], cf[kk], bfr[2], bfr[3]);
      }
    }

    // L = G 2^(cum_t - cum_j), masked to t >= j before the exponential; as
    // bf16 A fragments over k = j, hi (lf) and lo (lr)
    const float cta = s_cum[ta], ctb = s_cum[tb];
    uint32_t lf[CQ / 16][4], lr[CQ / 16][4];
#pragma unroll
    for (int jp = 0; jp < CQ / 16; ++jp) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int nt = 2 * jp + half, j = 8 * nt + 2 * tq;
        const float cj0 = s_cum[j], cj1 = s_cum[j + 1];
        const float* gv = gacc[nt];
        lr[jp][2 * half] = pack_bf16_split(
            j <= ta ? gv[0] * ex2(fminf(cta - cj0, 0.f)) : 0.f,
            j + 1 <= ta ? gv[1] * ex2(fminf(cta - cj1, 0.f)) : 0.f,
            &lf[jp][2 * half]);
        lr[jp][2 * half + 1] = pack_bf16_split(
            j <= tb ? gv[2] * ex2(fminf(ctb - cj0, 0.f)) : 0.f,
            j + 1 <= tb ? gv[3] * ex2(fminf(ctb - cj1, 0.f)) : 0.f,
            &lf[jp][2 * half + 1]);
      }
    }

    // y starts as C S_prev (S_prev written by every warp at the end of the
    // last chunk; all reads of it end at the barrier below)
    float yacc[PTILES][4];
#pragma unroll
    for (int i = 0; i < PTILES; ++i)
      yacc[i][0] = yacc[i][1] = yacc[i][2] = yacc[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < CN / 16; ++kk) {
#pragma unroll
      for (int pp = 0; pp < PTILES / 2; ++pp) {
        uint32_t bfr[4];
        ldsm_b_pair(bfr, s_st, XLD, 16 * kk, 16 * pp, lane);
        mma_bf16(yacc[2 * pp], cf[kk], bfr[0], bfr[1]);
        mma_bf16(yacc[2 * pp + 1], cf[kk], bfr[2], bfr[3]);
      }
    }

    // xd = dt x and xw = dt 2^(tot - cum_j) x as bf16 tiles: this thread
    // takes tokens lane and lane + 32 (whose dt and cum it holds) and the
    // warp's PT / 4 columns, PT / 32 pieces of 8 (one at PT = 32)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int j = lane + 32 * r;
      const float d = r ? d1 : d0;
      const float w = d * ex2(fminf(tot - (r ? c1 : c0), 0.f));
#pragma unroll
      for (int k = 0; k < PT / 32; ++k) {
        const int off = j * XLD + warp * (PT / 4) + 8 * k;
        const uint4 v = *reinterpret_cast<const uint4*>(sx + off);
        const __nv_bfloat162* v2 = reinterpret_cast<const __nv_bfloat162*>(&v);
        uint4 od, ow;
        uint32_t* pd = &od.x;
        uint32_t* pw = &ow.x;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(v2[e]);
          pd[e] = pack_bf16(f.x * d, f.y * d);
          pw[e] = pack_bf16(f.x * w, f.y * w);
        }
        *reinterpret_cast<uint4*>(s_xd + off) = od;
        *reinterpret_cast<uint4*>(s_xw + off) = ow;
      }
    }
    __syncthreads();      // xd and xw complete; S_prev no longer read

    // y = 2^cum_t C S_prev + L xd + D x
    const float eta = exp2f(cta), etb = exp2f(ctb);
#pragma unroll
    for (int i = 0; i < PTILES; ++i) {
      yacc[i][0] *= eta; yacc[i][1] *= eta;
      yacc[i][2] *= etb; yacc[i][3] *= etb;
    }
#pragma unroll
    for (int jp = 0; jp < CQ / 16; ++jp) {
#pragma unroll
      for (int pp = 0; pp < PTILES / 2; ++pp) {
        uint32_t bfr[4];
        ldsm_b_pair(bfr, s_xd, XLD, 16 * jp, 16 * pp, lane);
        mma_bf16(yacc[2 * pp], lf[jp], bfr[0], bfr[1]);
        mma_bf16(yacc[2 * pp + 1], lf[jp], bfr[2], bfr[3]);
        mma_bf16(yacc[2 * pp], lr[jp], bfr[0], bfr[1]);
        mma_bf16(yacc[2 * pp + 1], lr[jp], bfr[2], bfr[3]);
      }
    }
    // + D x, rounded once to bf16 over this warp's own rows of the x tile
    // (each thread reads then writes the same places), then stored as rows
#pragma unroll
    for (int i = 0; i < PTILES; ++i) {
      __nv_bfloat162* ra = reinterpret_cast<__nv_bfloat162*>(
          sx + ta * XLD + 8 * i + 2 * tq);
      __nv_bfloat162* rv = reinterpret_cast<__nv_bfloat162*>(
          sx + tb * XLD + 8 * i + 2 * tq);
      const float2 xa = __bfloat1622float2(*ra), xv = __bfloat1622float2(*rv);
      *ra = __floats2bfloat162_rn(yacc[i][0] + Dh * xa.x, yacc[i][1] + Dh * xa.y);
      *rv = __floats2bfloat162_rn(yacc[i][2] + Dh * xv.x, yacc[i][3] + Dh * xv.y);
    }
    __syncwarp();
    const int t0 = c * CQ;
#pragma unroll
    for (int i = lane; i < 16 * XCH; i += 32) {
      const int t = 16 * warp + i / XCH, k = i % XCH, p = p0 + 8 * k;
      if (t0 + t < a.S && p < a.P)
        *reinterpret_cast<uint4*>(yb + (long long)(t0 + t) * a.y_ss + p) =
            *reinterpret_cast<const uint4*>(sx + t * XLD + 8 * k);
    }

    // S = 2^tot S + B^T xw, this warp's 16 state rows, k over tokens
    const float et = exp2f(tot);
#pragma unroll
    for (int i = 0; i < PTILES; ++i) {
      st[i][0] *= et; st[i][1] *= et; st[i][2] *= et; st[i][3] *= et;
    }
#pragma unroll
    for (int kk = 0; kk < CQ / 16; ++kk) {
      uint32_t af[4];
      ldsm_x4_trans(af, sb + (16 * kk + (lane & 7) + ((lane >> 4) << 3)) * NLD +
                            16 * warp + (((lane >> 3) & 1) << 3));
#pragma unroll
      for (int pp = 0; pp < PTILES / 2; ++pp) {
        uint32_t bfr[4];
        ldsm_b_pair(bfr, s_xw, XLD, 16 * kk, 16 * pp, lane);
        mma_bf16(st[2 * pp], af, bfr[0], bfr[1]);
        mma_bf16(st[2 * pp + 1], af, bfr[2], bfr[3]);
      }
    }
    // its bf16 copy, read by every warp in the next chunk
#pragma unroll
    for (int i = 0; i < PTILES; ++i) {
      *reinterpret_cast<uint32_t*>(s_st + ta * XLD + 8 * i + 2 * tq) =
          pack_bf16(st[i][0], st[i][1]);
      *reinterpret_cast<uint32_t*>(s_st + tb * XLD + 8 * i + 2 * tq) =
          pack_bf16(st[i][2], st[i][3]);
    }
  }
}

// The 64-column instance keeps the launch bounds it has always had (181
// registers); the 32-column one asks for three CTAs an SM (at most 168
// registers), which its 64,000 B of shared memory allow. A minimum of one
// CTA an SM on the 64-column instance gave it 252 registers instead.
__global__ void __launch_bounds__(TC_THREADS)
ssd_chunk_kernel_64(const bf16* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const bf16* __restrict__ Bm,
                    const bf16* __restrict__ Cm, const float* __restrict__ D,
                    bf16* __restrict__ y, Args a) {
  ssd_chunk<64>(x, dt, A, Bm, Cm, D, y, a);
}

__global__ void __launch_bounds__(TC_THREADS, 3)
ssd_chunk_kernel_32(const bf16* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const bf16* __restrict__ Bm,
                    const bf16* __restrict__ Cm, const float* __restrict__ D,
                    bf16* __restrict__ y, Args a) {
  ssd_chunk<32>(x, dt, A, Bm, Cm, D, y, a);
}

template <int PT>
auto chunk_kernel() {
  if constexpr (PT == 32)
    return ssd_chunk_kernel_32;
  else
    return ssd_chunk_kernel_64;
}

// cudaFuncSetAttribute holds only for the device that is current when it is
// called, so each instance's shared-memory limit is set once per device (two
// threads racing here both set it, which is harmless).
template <int PT>
cudaError_t allow_smem() {
  static std::atomic<bool> done[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES || !done[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(chunk_kernel<PT>(),
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               TcLayout<PT>::BYTES);
    if (err != cudaSuccess) return err;
    if (dev < MAX_DEVICES) done[dev].store(true, std::memory_order_release);
  }
  return cudaSuccess;
}

template <int PT>
cudaError_t launch_chunked(const void* x, const void* dt, const float* A,
                           const void* Bm, const void* Cm, const float* D,
                           void* y, int B, const Args& a, cudaStream_t stream) {
  const cudaError_t err = allow_smem<PT>();
  if (err != cudaSuccess) return err;
  const int grid = B * a.H * ((a.P + PT - 1) / PT);
  const auto kernel = chunk_kernel<PT>();
  kernel<<<grid, TC_THREADS, TcLayout<PT>::BYTES, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(dt), A,
      static_cast<const bf16*>(Bm), static_cast<const bf16*>(Cm), D,
      static_cast<bf16*>(y), a);
  return cudaGetLastError();
}

// registers and local bytes a thread, dynamic shared memory a CTA and CTAs
// per SM of one instance on the current device
template <int PT>
cudaError_t instance_info(int* info) {
  cudaError_t err = allow_smem<PT>();
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, chunk_kernel<PT>());
  if (err != cudaSuccess) return err;
  info[0] = attr.numRegs;
  info[1] = (int)attr.localSizeBytes;
  info[2] = TcLayout<PT>::BYTES;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &info[3], chunk_kernel<PT>(), TC_THREADS, TcLayout<PT>::BYTES);
}

}  // namespace

// dtype (x, B, C, y): 0 = float32 (the scalar kernel), 1 = bfloat16 (the
// chunked tensor-core kernel, which needs P and N multiples of 8 and
// 16-byte aligned bases and strides). dt is float32; A and D are float32
// (H,), contiguous. Strides are in elements, ordered (batch, sequence, head
// or group). state_tile (bf16 only): the state columns a CTA, 32 or 64, or
// 0 for 64. Returns a cudaError_t as int (0 = launched).
extern "C" int ssd_fwd(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, const void* D, void* y, int dtype, int B, int S,
    int H, int G, int P, int N, long long x_sb, long long x_ss, long long x_sh,
    long long dt_sb, long long dt_ss, long long dt_sh, long long b_sb,
    long long b_ss, long long b_sg, long long c_sb, long long c_ss,
    long long c_sg, long long y_sb, long long y_ss, long long y_sh,
    int state_tile, int device, void* stream) {
  if (dtype == 1 && state_tile == 0) state_tile = DEFAULT_PT;
  if (B < 1 || S < 1 || H < 1 || G < 1 || H % G != 0 || P < 1 || P > PMAX ||
      N < 1 || N > NMAX || (dtype != 1 && state_tile != 0) ||
      (dtype == 1 && state_tile != 32 && state_tile != 64))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Args a{x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh, b_sb, b_ss, b_sg,
               c_sb, c_ss, c_sg, y_sb, y_ss, y_sh, S, H, G, P, N};
  const float* Af = static_cast<const float*>(A);
  const float* Df = static_cast<const float*>(D);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    err = launch_scalar(x, dt, Af, Bm, Cm, Df, y, B, a, st);
  } else if (dtype == 1) {
    if (P % 8 != 0 || N % 8 != 0) return (int)cudaErrorInvalidValue;
    err = state_tile == 32 ? launch_chunked<32>(x, dt, Af, Bm, Cm, Df, y, B, a, st)
                           : launch_chunked<64>(x, dt, Af, Bm, Cm, Df, y, B, a, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}

// The chunked kernel's instance for state_tile (32 or 64) on the current
// device: info[0] registers a thread, info[1] local (spilled) bytes a
// thread, info[2] dynamic shared memory a CTA, info[3] CTAs per SM.
extern "C" int ssd_chunk_info(int state_tile, int* info) {
  if (state_tile == 32) return (int)instance_info<32>(info);
  if (state_tile == 64) return (int)instance_info<64>(info);
  return (int)cudaErrorInvalidValue;
}
