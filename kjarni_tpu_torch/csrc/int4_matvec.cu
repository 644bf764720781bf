// y = x @ dequant(w4) over half-split packed int4 weights, for Hopper (sm_90a).
//
// Replaces kjarni_tpu/ops/pallas/int4_matvec.py::int4_matvec (body _kernel).
// Same function: x [M,K] bf16, w4 [K/2,N] int8 holding two nibbles per byte
// (low nibble = row r, high nibble = row r + K/2), scale [G,N] f32 over groups
// of g = K/G rows; the group scale multiplies the f32 partial of its group,
// not the weight. Output [M,N] bf16, or f32 where x came in f32: the Pallas
// kernel rounds x to bf16 in its body and writes x's dtype, so the kernels
// store their f32 sums as f32 (the store is a template on the output type).
// The decode GEMV also takes an f32 x itself and rounds each element to bf16
// where it loads it, as torch's .to(bfloat16) rounds (to nearest even), so
// a decoded f32 token pays no separate cast; the prefill GEMMs take bf16 x,
// cast by the wrapper (one M x K cast feeds an M x K x N product). G == 1
// (one scale per column) is taken as well as even G. Three kernels; the
// wrapper's launch_plan picks one by shape.
//
// Decode (M == 1): int4_gemv_kernel. Every packed byte is read once and used
// for 4 flops, so it is bound by device-memory bytes (K*N/2 weight bytes).
//   * a block owns 8 * col_threads columns and all of K: each thread owns 8
//     columns (one 8-byte load per packed row) and walks its share of K in
//     steps of 8 rows, the next step's weight and x loads issued before the
//     current step is used (x is small and stays in L1/L2; an f32 x is two
//     16-byte loads a step, rounded to bf16 in registers); the plan picks
//     col_threads so that even small N fills the card without splitting K
//     across blocks;
//   * nibbles are decoded in registers with bit operations: a nibble moved to
//     bits 16..19 and combined with 0x43080000 is the f32 136 + s (no int->float
//     conversion); the 136 * sum(x) this adds is subtracted once per group;
//   * FMA in f32 on the CUDA cores; the group scale is read once per group and
//     column, at the group's first step, and multiplies the f32 partial;
//   * the block sums its K lanes in a fixed tree (warp shuffles, then the
//     warps in order through shared memory). No atomics and no split across
//     blocks: two calls give bit-identical outputs.
//
// Prefill (M > 1): 2*M*K*N flops over K*N/2 + 2*M*K bytes. The packed
// weight is the larger read below M ~ 300 (the card's ~295 bf16 flops a
// byte), so small M is bound by the weight bytes and the tensor cores bound
// every prompt bucket (M >= 1024). Two GEMMs; launch_plan picks by shape:
//
// int4_gemm_kernel_sm90 (path 2; M >= 128 where TMA takes the shape and the
// plan's model times it faster: every prefill bucket and admission wave of
// the model zoo's projections). Its bound is the tensor cores, and the work
// that is not a product (decoding nibbles, scaling group partials) must hide
// behind them:
//   * one persistent block per SM walks 128 x 128 output tiles (128 rows of
//     x, 128 columns), n fastest, so the blocks in flight share their x rows
//     and the packed weight stays in L2;
//   * a producer warp keeps a 5-stage ring full with TMA: a stage is x's
//     [128][64] bf16 of each half (rows rs.. and K/2 + rs..), the packed
//     [64][128] bytes and the two group-scale rows, behind one mbarrier; the
//     tiles land 128-byte swizzled, so wgmma and the nibble loads read them
//     without bank conflicts, and past M, N and K/2 they read as zeros;
//   * two consumer warpgroups (setmaxnreg 232, the producer 40) each own 64
//     columns. Operands are swapped: the decoded weight is wgmma's A, from
//     registers, x's rows its B (m64n128k16), so no decoded weight touches
//     shared memory. A thread's two columns are neighbours, so one 16-bit
//     load a packed row brings both; byte_perm + lop3 + a bf16x2 subtraction
//     decode two nibbles, and the byte pairs of a stage serve both halves;
//   * a unit is two stages of one group: each half's products accumulate in
//     f32 (a stage's four k-steps decoded, then issued as one wgmma batch,
//     the next batch decoded while it runs), and at the half's end the
//     group's f32 scale multiplies the f32 partial into the f32 sum;
//   * K is never split: one block sums a tile in a fixed order, so two calls
//     give bit-identical outputs.
// Decoding and scaling in the consumers' instruction stream cost it ~20% of
// the products' time; ptxas serializes wgmma (C7513 / C7514) if A registers
// are redefined or a partial is read while products are in flight, hence the
// batches and the flush after the half's last product.
//
// int4_gemm_kernel (path 1; every other M > 1: the engine's decode step at
// M = 40, speculative verification, narrow shards where few tiles leave SMs
// idle, and shapes TMA does not take: N or K not a multiple of 16, groups
// that end inside a unit):
//   * 32, 64 or 128 x rows by 128 output columns per block (the plan takes the
//     smallest that holds M, so a short prompt feeds few zero rows to the
//     tensor cores), 8 warps, bf16 mma.sync m16n8k16 fed by ldmatrix;
//   * x, packed-weight and group-scale stages go through a 3-stage cp.async
//     ring, so the copies overlap the products;
//   * the packed [64, 128] weight bytes of a stage are decoded once into two
//     bf16 tiles (low rows, high rows) in shared memory (byte_perm + lop3 +
//     one bf16x2 subtraction per two nibbles) and serve all the block's rows
//     of x; the decoded tiles are double-buffered, so stage s+1 is decoded
//     while stage s is multiplied, with one barrier per stage;
//   * the group scale multiplies the f32 partial at each group's end; where
//     every stage lies inside one group (all of Llama's shapes) a stage's
//     products run without a branch and flush once per half;
//   * where the output tiles are too few to fill the card (short prompts,
//     narrow N), the plan splits K across up to 16 blocks per tile. They write
//     f32 partials, and the last to arrive, counted per tile, sums them in
//     split order in the same launch: bit-identical outputs, no float atomics.
// One block (8 warps) fits an SM, for its shared memory; the ldmatrix -> mma
// latency is poorly hidden, which holds it near a fifth of its bound.
#include <cuda.h>

#include <type_traits>

#include "mma.cuh"

namespace {

constexpr int kThreads = 256;

struct Int4Params {
  const void* x;               // [M, K]: bf16, or f32 in the GEMV (its XT)
  const uint8_t* w4;           // [K/2, N]
  const float* scale;          // [G, N]
  void* y;                     // [M, N], bf16 or f32 (the kernels' OutT)
  int M, K, N, G;
  float* ws;                   // prefill, split K: [splits, M, N] f32 partials
  int* counters;               // prefill, split K: arrivals per output tile
  int split_stages;            // prefill: K stages per split
  int col_threads;             // decode: threads across a block's columns
  int rows_per_lane;           // decode: packed rows per thread, a multiple of 8
  int vec_w;                   // decode: w4 rows load as 8-byte vectors
  int vec_s;                   // decode: scale rows load as float4
  int vec_x;                   // decode: x rows load as 16-byte vectors
};

// the output stores, by output type
__device__ __forceinline__ void store1(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16(v);
}
__device__ __forceinline__ void store1(float* dst, float v) { *dst = v; }
// two neighbouring columns, the first even
__device__ __forceinline__ void store2(__nv_bfloat16* dst, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
}
__device__ __forceinline__ void store2(float* dst, float v0, float v1) {
  *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
}
// four neighbouring columns, the first a multiple of 4
__device__ __forceinline__ void store4(__nv_bfloat16* dst, float4 v) {
  uint2 out;
  out.x = kj::pack_bf16(v.x, v.y);
  out.y = kj::pack_bf16(v.z, v.w);
  *reinterpret_cast<uint2*>(dst) = out;
}
__device__ __forceinline__ void store4(float* dst, float4 v) {
  *reinterpret_cast<float4*>(dst) = v;
}

// ---------------------------------------------------------------------------
// decode GEMV
// ---------------------------------------------------------------------------

constexpr int kV = 8;                             // columns (packed bytes) per thread
constexpr int kUnroll = 8;                        // packed rows (loads) per step
constexpr int kMaxColThreads = 32;

// the nibble at bits 16..19 of w -> 136 + s as an f32, s its signed value
__device__ __forceinline__ float biased(uint32_t w) {
  return __uint_as_float((w & 0x000F0000u) ^ 0x43080000u);
}

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xFFFF0000u); }

// kV bytes of one packed row; zeros past column N
__device__ __forceinline__ uint2 load_bytes(const uint8_t* src, int valid, bool vec) {
  if (vec && valid >= kV) return __ldg(reinterpret_cast<const uint2*>(src));
  uint32_t q[2] = {0u, 0u};
#pragma unroll
  for (int j = 0; j < kV; ++j)
    if (j < valid) q[j / 4] |= static_cast<uint32_t>(__ldg(src + j)) << (8 * (j % 4));
  return make_uint2(q[0], q[1]);
}

// kV scales of one group row; zeros past column N
__device__ __forceinline__ void load_scales(float (&s)[kV], const float* src, int valid,
                                            bool vec) {
  if (vec && valid >= kV) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(src));
    const float4 b = __ldg(reinterpret_cast<const float4*>(src) + 1);
    s[0] = a.x; s[1] = a.y; s[2] = a.z; s[3] = a.w;
    s[4] = b.x; s[5] = b.y; s[6] = b.z; s[7] = b.w;
  } else {
#pragma unroll
    for (int j = 0; j < kV; ++j) s[j] = j < valid ? __ldg(src + j) : 0.f;
  }
}

// x[m, r..r+7] as 8 raw bf16; zeros past r_end
__device__ __forceinline__ uint4 load_x8(const __nv_bfloat16* src, int r, int r_end,
                                         bool vec) {
  if (vec && r + kUnroll <= r_end) return __ldg(reinterpret_cast<const uint4*>(src));
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int u = 0; u < kUnroll; ++u)
    if (r + u < r_end)
      w[u / 2] |= static_cast<uint32_t>(__bfloat16_as_ushort(src[u])) << (16 * (u % 2));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// f32 x[m, r..r+7] rounded to 8 bf16 (to nearest even, as torch's
// .to(bfloat16)), packed as the bf16 version loads them; zeros past r_end
__device__ __forceinline__ uint4 load_x8(const float* src, int r, int r_end, bool vec) {
  if (vec && r + kUnroll <= r_end) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(src));
    const float4 b = __ldg(reinterpret_cast<const float4*>(src) + 1);
    return make_uint4(kj::pack_bf16(a.x, a.y), kj::pack_bf16(a.z, a.w),
                      kj::pack_bf16(b.x, b.y), kj::pack_bf16(b.z, b.w));
  }
  float f[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) f[u] = r + u < r_end ? __ldg(src + u) : 0.f;
  return make_uint4(kj::pack_bf16(f[0], f[1]), kj::pack_bf16(f[2], f[3]),
                    kj::pack_bf16(f[4], f[5]), kj::pack_bf16(f[6], f[7]));
}

// the weight bytes of rows r..r+7 and x's matching rows of both halves
template <typename XT>
__device__ __forceinline__ void load_step(const Int4Params& p, int r, int rb, int col0,
                                          int valid, uint2 (&q)[kUnroll], uint4 (&xv)[2]) {
  const int K2 = p.K / 2;
#pragma unroll
  for (int u = 0; u < kUnroll; ++u)
    q[u] = r + u < rb ? load_bytes(p.w4 + (int64_t)(r + u) * p.N + col0, valid, p.vec_w)
                      : make_uint2(0u, 0u);
  const XT* x = static_cast<const XT*>(p.x);
  xv[0] = load_x8(x + r, r, rb, p.vec_x);
  xv[1] = load_x8(x + K2 + r, r, rb, p.vec_x);
}

// one row of x; block = col_threads threads across 8 * col_threads columns x
// kThreads / col_threads threads down K, each over rows_per_lane packed rows.
// XT: x's type (bf16, or f32 rounded to bf16 where it is loaded).
template <typename XT, typename OutT>
__global__ void __launch_bounds__(kThreads, 2) int4_gemv_kernel(const Int4Params p) {
  constexpr int kWarps = kThreads / 32;
  __shared__ __align__(16) float red[kWarps][kV * kMaxColThreads];
  const int CT = p.col_threads;
  const int BN = kV * CT;
  const int K2 = p.K / 2;
  const int g = p.K / p.G;                 // rows per group (K when G == 1)
  const int ct = threadIdx.x % CT;
  const int kl = threadIdx.x / CT;
  const int col0 = blockIdx.x * BN + ct * kV;
  const int valid = p.N - col0;
  const int ra = min(K2, kl * p.rows_per_lane);
  const int rb = min(K2, ra + p.rows_per_lane);

  float acc[kV], plo[kV], phi[kV], slo[kV], shi[kV];
  float xlo_sum = 0.f, xhi_sum = 0.f;
#pragma unroll
  for (int v = 0; v < kV; ++v) acc[v] = plo[v] = phi[v] = 0.f;

  uint2 qn[kUnroll];
  uint4 xn[2];
  if (ra < rb) load_step<XT>(p, ra, rb, col0, valid, qn, xn);
  for (int r = ra; r < rb; r += kUnroll) {
    uint2 q[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) q[u] = qn[u];
    const uint4 xv[2] = {xn[0], xn[1]};
    if (r + kUnroll < rb) load_step<XT>(p, r + kUnroll, rb, col0, valid, qn, xn);
    if (r == ra || r % g == 0) {           // a group starts: its scales
      load_scales(slo, p.scale + (int64_t)(r / g) * p.N + col0, valid, p.vec_s);
      load_scales(shi, p.scale + (int64_t)((K2 + r) / g) * p.N + col0, valid, p.vec_s);
    }
    float xl[kUnroll], xh[kUnroll];
    const uint32_t a[4] = {xv[0].x, xv[0].y, xv[0].z, xv[0].w};
    const uint32_t b[4] = {xv[1].x, xv[1].y, xv[1].z, xv[1].w};
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      xl[u] = u % 2 ? bf16_hi(a[u / 2]) : bf16_lo(a[u / 2]);
      xh[u] = u % 2 ? bf16_hi(b[u / 2]) : bf16_lo(b[u / 2]);
      xlo_sum += xl[u];
      xhi_sum += xh[u];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        const uint32_t c = w ? q[u].y : q[u].x;   // columns 4w..4w+3 of the thread's 8
        const float lo[4] = {biased(c << 16), biased(c << 8), biased(c), biased(c >> 8)};
        const float hi[4] = {biased(c << 12), biased(c << 4), biased(c >> 4),
                             biased(c >> 12)};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          plo[4 * w + j] = fmaf(lo[j], xl[u], plo[4 * w + j]);
          phi[4 * w + j] = fmaf(hi[j], xh[u], phi[4 * w + j]);
        }
      }
    }
    // a step lies inside one group of each half (g % 16 == 0 when G > 1);
    // at the group's end its scale multiplies the f32 partial
    const int rn = r + kUnroll;
    if (rn >= rb || rn % g == 0) {
      const float blo = 136.f * xlo_sum, bhi = 136.f * xhi_sum;
#pragma unroll
      for (int v = 0; v < kV; ++v) {
        acc[v] = fmaf(plo[v] - blo, slo[v], acc[v]);
        acc[v] = fmaf(phi[v] - bhi, shi[v], acc[v]);
        plo[v] = phi[v] = 0.f;
      }
      xlo_sum = xhi_sum = 0.f;
    }
  }

  // sum the K lanes in a fixed tree: within the warp by shuffles (lanes
  // CT, 2CT, ... apart hold the same columns), then the warps in order
  for (int off = CT; off < 32; off *= 2) {
#pragma unroll
    for (int v = 0; v < kV; ++v) acc[v] += __shfl_xor_sync(0xFFFFFFFFu, acc[v], off);
  }
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 < CT) {
    float* dst = &red[warp][ct * kV];
    *reinterpret_cast<float4*>(dst) = make_float4(acc[0], acc[1], acc[2], acc[3]);
    *reinterpret_cast<float4*>(dst + 4) = make_float4(acc[4], acc[5], acc[6], acc[7]);
  }
  __syncthreads();
  for (int t = threadIdx.x; t < BN; t += kThreads) {
    const int col = blockIdx.x * BN + t;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w][t];
    if (col < p.N) store1(static_cast<OutT*>(p.y) + col, s);
  }
}

// ---------------------------------------------------------------------------
// prefill GEMM
// ---------------------------------------------------------------------------

constexpr int kBN = 128;                 // output columns per block
constexpr int kBKP = 64;                 // packed rows per stage
constexpr int kStages = 3;               // cp.async ring depth
constexpr int kXStride = kBKP + 8;       // bf16 per staged x row (ldmatrix without conflicts)
constexpr int kWStride = kBN + 8;        // bf16 per decoded weight row
constexpr int kW4Bytes = kBKP * kBN;
constexpr int kSBytes = 2 * kBN * 4;     // the stage's low and high group scales
constexpr int kWTile = kBKP * kWStride;  // bf16 of one decoded half
constexpr int kMaxSplits = 16;

// a block's x rows: 32 * kMI, each warp taking 16 * kMI of them (kMI = 1, 2, 4)
template <int kMI>
struct GemmTile {
  static constexpr int kBM = 32 * kMI;
  static constexpr int kXBytes = kBM * kXStride * 2;                   // one half of x
  static constexpr int kStageBytes = 2 * kXBytes + kW4Bytes + kSBytes;
  static constexpr int kSmem = kStages * kStageBytes + 4 * kWTile * 2;  // + 2 decoded buffers
};

// cp.async, shared with the flash kernel (mma.cuh)
using kj::cp_async16;
using kj::cp_async_commit;
using kj::cp_async_wait;
using kj::smem_addr;

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// one stage: x[m0.., rs..rs+kBKP) and x[m0.., K2+rs..) into Xlo / Xhi, the
// packed rows [rs, rs+kBKP) x columns [n0, n0+kBN) into W4, and the scale rows
// of the groups holding rows rs (low half) and K2 + rs (high half); zeros past
// the edges
template <int kMI, bool kAligned>
__device__ __forceinline__ void load_stage(const Int4Params& p, unsigned char* st,
                                           int m0, int n0, int rs, int K2, int g) {
  using T = GemmTile<kMI>;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(st);
  uint8_t* w4s = st + 2 * T::kXBytes;
  float* ss = reinterpret_cast<float*>(st + 2 * T::kXBytes + kW4Bytes);
  constexpr int kXChunks = T::kBM * kBKP / 8;    // 16-byte chunks per half
  for (int i = threadIdx.x; i < 2 * kXChunks; i += kThreads) {
    const int h = i / kXChunks, row = (i % kXChunks) / (kBKP / 8);
    const int c = (i % (kBKP / 8)) * 8;
    const int m = m0 + row, k = rs + c;
    __nv_bfloat16* dst = xs + h * (T::kBM * kXStride) + row * kXStride + c;
    const __nv_bfloat16* src =
        static_cast<const __nv_bfloat16*>(p.x) + (int64_t)m * p.K + h * K2 + k;
    if constexpr (kAligned) {
      const bool ok = m < p.M && k < K2;
      cp_async16(dst, ok ? src : p.x, ok);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        dst[j] = (m < p.M && k + j < K2) ? src[j] : __float2bfloat16(0.f);
    }
  }
  constexpr int kWChunks = kBKP * kBN / 16;
  for (int i = threadIdx.x; i < kWChunks; i += kThreads) {
    const int row = i / (kBN / 16), c = (i % (kBN / 16)) * 16;
    const int r = rs + row, n = n0 + c;
    uint8_t* dst = w4s + row * kBN + c;
    const uint8_t* src = p.w4 + (int64_t)r * p.N + n;
    if constexpr (kAligned) {
      const bool ok = r < K2 && n < p.N;
      cp_async16(dst, ok ? src : p.w4, ok);
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j) dst[j] = (r < K2 && n + j < p.N) ? src[j] : 0;
    }
  }
  for (int i = threadIdx.x; i < 2 * kBN / 4; i += kThreads) {
    const int h = i / (kBN / 4), c = (i % (kBN / 4)) * 4;
    const int n = n0 + c;
    float* dst = ss + h * kBN + c;
    const float* src = p.scale + (int64_t)((h * K2 + rs) / g) * p.N + n;
    if constexpr (kAligned) {
      cp_async16(dst, n < p.N ? src : p.scale, n < p.N);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) dst[j] = n + j < p.N ? src[j] : 0.f;
    }
  }
}

// nibbles at bits 0..3 and 16..19 -> two bf16 holding their signed values
__device__ __forceinline__ uint32_t nibble_pair(uint32_t t) {
  const uint32_t v = (t & 0x000F000Fu) ^ 0x43084308u;      // bf16x2 of 136 + s
  const __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v),
                                   __float2bfloat162_rn(136.f));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// one 16-byte chunk of the packed [kBKP, kBN] bytes -> bf16 in the low-row
// tile at wlo and the high-row tile kWTile further on
__device__ __forceinline__ void decode_chunk(const uint8_t* w4s, __nv_bfloat16* wlo, int i) {
  const int row = i / (kBN / 16), c = (i % (kBN / 16)) * 16;
  const uint4 q = *reinterpret_cast<const uint4*>(w4s + row * kBN + c);
  const uint32_t words[4] = {q.x, q.y, q.z, q.w};
  uint32_t lo[8], hi[8];
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    const uint32_t a = __byte_perm(words[w], 0, 0x4140);  // columns 4w, 4w+1
    const uint32_t b = __byte_perm(words[w], 0, 0x4342);  // columns 4w+2, 4w+3
    lo[2 * w] = nibble_pair(a);
    hi[2 * w] = nibble_pair(a >> 4);
    lo[2 * w + 1] = nibble_pair(b);
    hi[2 * w + 1] = nibble_pair(b >> 4);
  }
  uint4* dlo = reinterpret_cast<uint4*>(wlo + row * kWStride + c);
  uint4* dhi = reinterpret_cast<uint4*>(wlo + kWTile + row * kWStride + c);
  dlo[0] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  dlo[1] = make_uint4(lo[4], lo[5], lo[6], lo[7]);
  dhi[0] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
  dhi[1] = make_uint4(hi[4], hi[5], hi[6], hi[7]);
}

// each thread decodes kDecodeChunks chunks of a stage
constexpr int kDecodeChunks = kBKP * kBN / 16 / kThreads;
static_assert(kDecodeChunks == 2, "one chunk per half of a stage's products");

// d = a * b, the accumulator starting at zero
__device__ __forceinline__ void mma_bf16_first(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

// The last split's block: y[tile] = the splits' f32 partials summed in split
// order. Each thread owns kMI * 4 runs of 4 columns; all of a split's loads
// start before any is added, and nothing is stored until every split is
// read, so the loads stay in flight together.
template <int kMI, typename OutT>
__device__ __forceinline__ void sum_splits(const Int4Params& p, int m0, int n0, int splits) {
  OutT* y = static_cast<OutT*>(p.y);
  constexpr int kItems = 32 * kMI * (kBN / 4) / kThreads;   // = 4 * kMI
  const int64_t plane = (int64_t)p.M * p.N;
  if (p.N % 4 == 0) {
    float4 sum[kItems];
#pragma unroll
    for (int it = 0; it < kItems; ++it) sum[it] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int z = 0; z < splits; ++z) {
      float4 v[kItems];
#pragma unroll
      for (int it = 0; it < kItems; ++it) {
        const int t = threadIdx.x + it * kThreads;
        const int m = m0 + t / (kBN / 4), col = n0 + (t % (kBN / 4)) * 4;
        v[it] = m < p.M && col < p.N
                    ? __ldcg(reinterpret_cast<const float4*>(p.ws + z * plane +
                                                             (int64_t)m * p.N + col))
                    : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int it = 0; it < kItems; ++it) {
        sum[it].x += v[it].x; sum[it].y += v[it].y;
        sum[it].z += v[it].z; sum[it].w += v[it].w;
      }
    }
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      const int t = threadIdx.x + it * kThreads;
      const int m = m0 + t / (kBN / 4), col = n0 + (t % (kBN / 4)) * 4;
      if (m >= p.M || col >= p.N) continue;
      store4(y + (int64_t)m * p.N + col, sum[it]);
    }
    return;
  }
  for (int t = threadIdx.x; t < 32 * kMI * kBN; t += kThreads) {   // ragged N
    const int m = m0 + t / kBN, col = n0 + t % kBN;
    if (m >= p.M || col >= p.N) continue;
    const float* src = p.ws + (int64_t)m * p.N + col;
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += __ldcg(src + z * plane);
    store1(y + (int64_t)m * p.N + col, s);
  }
}

// kUniform: each stage's half lies inside one group (g % kBKP == 0, or G == 1),
// so the products of a stage run without a branch and its staged scales serve
// one flush per half; otherwise a group may end at any 16-row step.
// blockIdx.z is the block's split of K: stages [z * split_stages, ...).
template <int kMI, bool kAligned, bool kUniform, typename OutT>
__global__ void __launch_bounds__(kThreads, 1) int4_gemm_kernel(const Int4Params p) {
  using T = GemmTile<kMI>;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int last_split;
  const int K2 = p.K / 2;
  const int g = p.K / p.G;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * T::kBM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;     // the warp's 16 * kMI rows x 32 columns
  const int tig = lane % 4;
  // decoded tiles: buffer b holds low rows at wbuf + 2b * kWTile, high rows after
  __nv_bfloat16* wbuf = reinterpret_cast<__nv_bfloat16*>(smem + kStages * T::kStageBytes);

  float acc[kMI][4][4], part[kMI][4][4];
#pragma unroll
  for (int i = 0; i < kMI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = part[i][j][e] = 0.f;

  // the scale of group `grp` multiplies the partial, which starts again at 0;
  // `staged` holds the half's scales of the stage's first group
  auto flush = [&](int grp, bool in_stage, const float* staged) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = wn * 32 + j * 8 + 2 * tig;
      const int col = n0 + c;
      float s0, s1;
      if (in_stage) {
        const float2 t = *reinterpret_cast<const float2*>(staged + c);
        s0 = t.x; s1 = t.y;
      } else {
        const float* s = p.scale + (int64_t)grp * p.N + col;
        s0 = col < p.N ? __ldg(s) : 0.f;
        s1 = col + 1 < p.N ? __ldg(s + 1) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kMI; ++i) {
        acc[i][j][0] = fmaf(part[i][j][0], s0, acc[i][j][0]);
        acc[i][j][1] = fmaf(part[i][j][1], s1, acc[i][j][1]);
        acc[i][j][2] = fmaf(part[i][j][2], s0, acc[i][j][2]);
        acc[i][j][3] = fmaf(part[i][j][3], s1, acc[i][j][3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
      }
    }
  };

  // this block's stages [st0, st0 + nst); local stage i sits in ring slot
  // i % kStages and decoded buffer i % 2
  const int st0 = blockIdx.z * p.split_stages;
  const int nst = min((K2 + kBKP - 1) / kBKP - st0, p.split_stages);
  auto stage = [&](int i) { return smem + (i % kStages) * T::kStageBytes; };
  if (nst > 0) load_stage<kMI, kAligned>(p, stage(0), m0, n0, st0 * kBKP, K2, g);
  cp_async_commit();
  if (nst > 1) load_stage<kMI, kAligned>(p, stage(1), m0, n0, (st0 + 1) * kBKP, K2, g);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  if (nst > 0) {
#pragma unroll
    for (int c = 0; c < kDecodeChunks; ++c)
      decode_chunk(stage(0) + 2 * T::kXBytes, wbuf, threadIdx.x + c * kThreads);
  }
  for (int i = 0; i < nst; ++i) {
    cp_async_wait<0>();
    __syncthreads();     // stage i+1 landed, stage i decoded, stage i-1 consumed
    if (i + 2 < nst)
      load_stage<kMI, kAligned>(p, stage(i + 2), m0, n0, (st0 + i + 2) * kBKP, K2, g);
    cp_async_commit();
    // stage i+1 is decoded a chunk at a time between this stage's products
    const uint8_t* next_w4 = stage(i + 1) + 2 * T::kXBytes;
    __nv_bfloat16* next_w = wbuf + ((i + 1) % 2) * 2 * kWTile;
    unsigned char* cur = stage(i);
    const float* staged = reinterpret_cast<const float*>(cur + 2 * T::kXBytes + kW4Bytes);
    const int rs = (st0 + i) * kBKP;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const __nv_bfloat16* xs =
          reinterpret_cast<const __nv_bfloat16*>(cur) + h * (T::kBM * kXStride);
      const __nv_bfloat16* ws = wbuf + ((i % 2) * 2 + h) * kWTile;
      const int base = h ? K2 : 0;
#pragma unroll
      for (int ks = 0; ks < kBKP; ks += 16) {
        const int r = rs + ks;
        if (!kUniform && r >= K2) break;   // (rows past K2 are zeros)
        uint32_t a[kMI][4], b[4][2];
#pragma unroll
        for (int mi = 0; mi < kMI; ++mi)
          ldmatrix_x4(a[mi], xs + (wm * 16 * kMI + mi * 16 + lane % 16) * kXStride + ks +
                                 (lane / 16) * 8);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          uint32_t t[4];
          ldmatrix_x4_trans(t, ws + (ks + lane % 16) * kWStride + wn * 32 + j * 16 +
                                   (lane / 16) * 8);
          b[2 * j][0] = t[0]; b[2 * j][1] = t[1];
          b[2 * j + 1][0] = t[2]; b[2 * j + 1][1] = t[3];
        }
#pragma unroll
        for (int mi = 0; mi < kMI; ++mi) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (kUniform && ks == 0) mma_bf16_first(part[mi][j], a[mi], b[j][0], b[j][1]);
            else kj::mma_bf16(part[mi][j], a[mi], b[j][0], b[j][1]);
          }
        }
        if (ks == 16 && i + 1 < nst)
          decode_chunk(next_w4, next_w, threadIdx.x + h * kThreads);
        if constexpr (!kUniform) {
          const int rn = r + 16;
          if (ks + 16 == kBKP || rn >= K2 || rn % g == 0) {
            const int grp = (base + r) / g;
            flush(grp, grp == (base + rs) / g, staged + h * kBN);
          }
        }
      }
      if constexpr (kUniform) flush(0, true, staged + h * kBN);
    }
  }
  cp_async_wait<0>();

  // one split: the tile goes straight to y. Several: each block writes its f32
  // partial; the last to arrive (counted per output tile) sums them in split
  // order and resets the count, so the result is the same on every call.
  const bool split = gridDim.z > 1;
  float* part_out = p.ws + (int64_t)blockIdx.z * p.M * p.N;
  const int gid = lane / 4;
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + wn * 32 + j * 8 + 2 * tig;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int m = m0 + wm * 16 * kMI + mi * 16 + gid + 8 * hr;
        if (m >= p.M) continue;
        const float v0 = acc[mi][j][2 * hr], v1 = acc[mi][j][2 * hr + 1];
        if (split) {
          float* dst = part_out + (int64_t)m * p.N + col;
          if (col < p.N) dst[0] = v0;
          if (col + 1 < p.N) dst[1] = v1;
          continue;
        }
        OutT* dst = static_cast<OutT*>(p.y) + (int64_t)m * p.N + col;
        if (col + 1 < p.N && p.N % 2 == 0) {
          store2(dst, v0, v1);
        } else {
          if (col < p.N) store1(dst, v0);
          if (col + 1 < p.N) store1(dst + 1, v1);
        }
      }
    }
  }
  if (!split) return;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    int* count = p.counters + blockIdx.y * gridDim.x + blockIdx.x;
    last_split = atomicAdd(count, 1) == static_cast<int>(gridDim.z) - 1;
    if (last_split) *count = 0;
  }
  __syncthreads();
  if (!last_split) return;
  __threadfence();
  sum_splits<kMI, OutT>(p, m0, n0, gridDim.z);
}

// ---------------------------------------------------------------------------
// prefill GEMM at compute-bound M: TMA-fed, warp-specialised wgmma
// ---------------------------------------------------------------------------

// The tile of one block's turn: 128 rows of x (the wgmma width) by 128 output
// columns, 64 to each of two consumer warpgroups; a stage holds 64 packed rows.
struct Sm90 {
  static constexpr int kBT = 128;                // x rows (tokens) per tile
  static constexpr int kCols = 128;              // output columns per tile
  static constexpr int kRows = 64;               // packed rows per stage
  static constexpr int kUnit = 2;                // stages of one group: one f32 partial
  static constexpr int kConsumers = 2;           // consumer warpgroups; a producer after them
  static constexpr int kThreads = 128 * (kConsumers + 1);
  static constexpr int kXBytes = kBT * kRows * 2;        // one half of x: [kBT][64] bf16
  static constexpr int kWBytes = kRows * kCols;          // the packed bytes: [64][128]
  static constexpr int kScaleBytes = kCols * 4;          // one group-scale row
  static constexpr int kWOff = 2 * kXBytes;
  static constexpr int kSOff = kWOff + kWBytes;
  static constexpr int kStageBytes = kSOff + 2 * kScaleBytes;
  static constexpr int kRing = (227 * 1024 - 2048) / kStageBytes;   // TMA ring depth: 5
  static constexpr int kSmem = kRing * kStageBytes + 2 * kRing * 8 + 1024;  // + barriers, alignment
  static_assert(kStageBytes % 1024 == 0, "swizzled tiles start on 1024-byte boundaries");
};

struct Sm90Params {
  CUtensorMap x_map;     // x as [M][2][K/2] bf16: box {64, 1, kBT}, 128B swizzle
  CUtensorMap w_map;     // w4 [K/2][N] bytes: box {128, 64}, 128B swizzle
  CUtensorMap s_map;     // scale [G][N] f32: box {kCols, 1}
  void* y;
  int M, K, N, G;
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                       int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_addr(bar))
      : "memory");
}
__device__ __forceinline__ void tma_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                       int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// accumulators that in-flight wgmmas write: read only after the wait that
// completes them (this point)
template <int R>
__device__ __forceinline__ void hold(float (&d)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[i][e])::"memory");
  }
}
// matrix descriptor of a K-major tile in 128-byte-swizzled rows: 8-row groups
// 1024 bytes apart (the flash kernel's form)
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

// d[64 x 128] (+)= a[64 x 16] (registers, each warp's 16 rows in the mma.sync
// A layout) * B[16 x 128] (K-major through desc_b); accumulate = 0 overwrites d
__device__ __forceinline__ void wgmma_rs(float (&d)[16][4], const uint32_t (&a)[4],
                                         uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// byte j of w0 at bits 0..7 and byte j of w1 at bits 16..23
__device__ __forceinline__ uint32_t byte_pair(uint32_t w0, uint32_t w1, int j) {
  return __byte_perm(w0, w1, j | (j << 4) | ((j + 4) << 8) | ((j + 4) << 12));
}

// One tile of y is 128 rows of x by 128 columns. Swapped operands: the
// decoded weights are wgmma's A (64 output columns a product, from
// registers), x's rows its N. Thread (gid, tig) of warp w in consumer c holds
// A rows gid and gid + 8, which are the neighbouring columns col, col + 1
// (col = 64 c + 16 w + 2 gid): byte 0 of the thread's 16-bit word of a packed
// row is row gid, byte 1 row gid + 8, so one shared-memory load a row brings
// both.
template <typename OutT>
__global__ void __launch_bounds__(Sm90::kThreads, 1)
    int4_gemm_kernel_sm90(const __grid_constant__ Sm90Params p) {
  using T = Sm90;
  constexpr int kBT = T::kBT, kRows = T::kRows, kRing = T::kRing, kU = T::kUnit;
  constexpr int kSteps = kRows / 16;             // k-steps a stage
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kRing * T::kStageBytes);
  uint64_t* empty = full + kRing;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kRing; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], T::kConsumers * 4);   // each consumer warp releases a stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int K2 = p.K / 2;
  const int g = p.K / p.G;
  const int nst = (K2 + kRows - 1) / kRows;
  const int tiles_n = (p.N + T::kCols - 1) / T::kCols;
  const int tiles = tiles_n * ((p.M + kBT - 1) / kBT);
  const int wg = threadIdx.x / 128;

  if (wg == T::kConsumers) {
    // the producer: one thread keeps the ring full, tile after tile
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x % 128 != 0) return;
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int n0 = (tile % tiles_n) * T::kCols, m0 = (tile / tiles_n) * kBT;
      for (int s = 0; s < nst; ++s, ++it) {
        const int slot = it % kRing;
        mbar_wait(&empty[slot], ((it / kRing) & 1) ^ 1);
        unsigned char* st = smem + slot * T::kStageBytes;
        uint64_t* bar = &full[slot];
        mbar_expect_tx(bar, T::kStageBytes);
        const int rs = s * kRows;
        tma_3d(st, &p.x_map, bar, rs, 0, m0);
        tma_3d(st + T::kXBytes, &p.x_map, bar, rs, 1, m0);
        tma_2d(st + T::kWOff, &p.w_map, bar, n0, rs);
        tma_2d(st + T::kSOff, &p.s_map, bar, n0, rs / g);
        tma_2d(st + T::kSOff + T::kScaleBytes, &p.s_map, bar, n0, (K2 + rs) / g);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
  const int gid = lane / 4, tig = lane % 4;
  // the thread's first column in the tile, and its bytes in the swizzled
  // [64][128] block: rows 16 ks + 2 tig (+ 8) at `even`, 16 ks + 2 tig + 1 (+ 8) at `odd`
  const int col = wg * 64 + warp * 16 + 2 * gid;
  const int even = T::kWOff + 2 * tig * 128 + (((col / 16) ^ (2 * tig)) * 16) + col % 16;
  const int odd = T::kWOff + (2 * tig + 1) * 128 + (((col / 16) ^ (2 * tig + 1)) * 16) +
                  col % 16;

  // part: the f32 partial of one half of a unit (one group), scaled into acc
  // at the half's end
  float acc[kBT / 8][4], part[kBT / 8][4];
  // acc += part * the scales of half h at the unit starting at stage s
  auto flush = [&](int s, int h) {
    const float2 sc = *reinterpret_cast<const float2*>(
        smem + (s % kRing) * T::kStageBytes + T::kSOff + h * T::kScaleBytes + col * 4);
#pragma unroll
    for (int j = 0; j < kBT / 8; ++j) {
      acc[j][0] = fmaf(part[j][0], sc.x, acc[j][0]);
      acc[j][1] = fmaf(part[j][1], sc.x, acc[j][1]);
      acc[j][2] = fmaf(part[j][2], sc.y, acc[j][2]);
      acc[j][3] = fmaf(part[j][3], sc.y, acc[j][3]);
    }
  };
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int n0 = (tile % tiles_n) * T::kCols, m0 = (tile / tiles_n) * kBT;
#pragma unroll
    for (int j = 0; j < kBT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

    for (int s0 = 0; s0 < nst; s0 += kU) {
      const int nu = min(kU, nst - s0);
      uint32_t q[kU][kSteps][4];             // the unit's byte pairs: both halves' nibbles
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          if (u >= nu) break;
          const int slot = (it + s0 + u) % kRing;
          const unsigned char* st = smem + slot * T::kStageBytes;
          if (h == 0) {
            mbar_wait(&full[slot], ((it + s0 + u) / kRing) & 1);
#pragma unroll
            for (int ks = 0; ks < kSteps; ++ks) {
              const unsigned char* wr = st + ks * 16 * 128;
              const uint32_t w0 = *reinterpret_cast<const uint16_t*>(wr + even);
              const uint32_t w1 = *reinterpret_cast<const uint16_t*>(wr + odd);
              const uint32_t w2 = *reinterpret_cast<const uint16_t*>(wr + 8 * 128 + even);
              const uint32_t w3 = *reinterpret_cast<const uint16_t*>(wr + 8 * 128 + odd);
              q[u][ks][0] = byte_pair(w0, w1, 0);
              q[u][ks][1] = byte_pair(w0, w1, 1);
              q[u][ks][2] = byte_pair(w2, w3, 0);
              q[u][ks][3] = byte_pair(w2, w3, 1);
            }
          }
          // the stage's k-steps decoded, then issued as one batch
          uint32_t a[kSteps][4];
#pragma unroll
          for (int ks = 0; ks < kSteps; ++ks)
#pragma unroll
            for (int r = 0; r < 4; ++r)
              a[ks][r] = nibble_pair(h ? q[u][ks][r] >> 4 : q[u][ks][r]);
          wg_fence();
          const uint32_t xb = smem_addr(st + h * T::kXBytes);
#pragma unroll
          for (int ks = 0; ks < kSteps; ++ks)
            wgmma_rs(part, a[ks], gmma_desc(xb + ks * 32), u > 0 || ks > 0);
          wg_commit();
          wg_wait<1>();                          // the batch before is done
        }
        wg_wait<0>();
        hold(part);
        flush(it + s0, h);
      }
      // every warp is done with the unit's stages: hand them back
      __syncwarp();
      if (lane == 0) {
        for (int u = 0; u < nu; ++u) mbar_arrive(&empty[(it + s0 + u) % kRing]);
      }
    }
    it += nst;

    // row m, columns n and n + 1: A rows gid and gid + 8
    OutT* y = static_cast<OutT*>(p.y);
    const int n = n0 + col;
    if (n < p.N) {
#pragma unroll
      for (int j = 0; j < kBT / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = m0 + 8 * j + 2 * tig + e;
          if (m < p.M) store2(y + (int64_t)m * p.N + n, acc[j][e], acc[j][e + 2]);
        }
      }
    }
  }
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no -lcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// a tensor map over `base`: dims and box innermost first, strides in bytes
// of every dimension but the first; out-of-bounds elements read as zeros
bool tensor_map(CUtensorMap* map, CUtensorMapDataType type, int rank, const void* base,
                const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box,
                CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  const cuuint32_t ones[3] = {1, 1, 1};
  return encode != nullptr &&
         encode(map, type, rank, const_cast<void*>(base), dims, strides, box, ones,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// shapes the TMA path takes: 16-byte rows and bases, groups of whole units
bool sm90_takes(const Int4Params& p) {
  return p.K % 16 == 0 && p.N % 16 == 0 && reinterpret_cast<uintptr_t>(p.x) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(p.w4) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(p.scale) % 16 == 0 &&
         (p.G == 1 || (p.K / p.G) % (Sm90::kUnit * Sm90::kRows) == 0);
}

// the tensor maps and one launch: a persistent block on each SM, or one a tile
template <typename OutT>
cudaError_t launch_sm90(const Int4Params& p, cudaStream_t st) {
  using T = Sm90;
  if (!sm90_takes(p)) return cudaErrorInvalidValue;
  Sm90Params q;
  const cuuint64_t K2 = p.K / 2, M = p.M, N = p.N, G = p.G;
  const cuuint64_t x_dims[3] = {K2, 2, M}, x_strides[2] = {K2 * 2, K2 * 4};
  const cuuint32_t x_box[3] = {T::kRows, 1, T::kBT};
  const cuuint64_t w_dims[2] = {N, K2}, w_strides[1] = {N};
  const cuuint32_t w_box[2] = {T::kCols, T::kRows};
  const cuuint64_t s_dims[2] = {N, G}, s_strides[1] = {N * 4};
  const cuuint32_t s_box[2] = {T::kCols, 1};
  if (!tensor_map(&q.x_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, p.x, x_dims, x_strides,
                  x_box, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map(&q.w_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, p.w4, w_dims, w_strides, w_box,
                  CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map(&q.s_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, p.scale, s_dims, s_strides,
                  s_box, CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  q.y = p.y;
  q.M = p.M; q.K = p.K; q.N = p.N; q.G = p.G;
  static const cudaError_t attr = cudaFuncSetAttribute(
      int4_gemm_kernel_sm90<OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (attr != cudaSuccess) return attr;
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const int tiles = (p.N + T::kCols - 1) / T::kCols * ((p.M + T::kBT - 1) / T::kBT);
  int4_gemm_kernel_sm90<OutT><<<tiles < sms ? tiles : sms, T::kThreads, T::kSmem, st>>>(q);
  return cudaGetLastError();
}

template <typename XT, typename OutT>
cudaError_t launch_gemv(const Int4Params& p, cudaStream_t st) {
  const int BN = kV * p.col_threads;
  int4_gemv_kernel<XT, OutT><<<(p.N + BN - 1) / BN, kThreads, 0, st>>>(p);
  return cudaGetLastError();
}

template <int kMI, bool kAligned, bool kUniform, typename OutT>
cudaError_t launch_gemm(const Int4Params& p, int splits, cudaStream_t st) {
  using T = GemmTile<kMI>;
  // above 48 KB a kernel's dynamic shared memory must be allowed, once
  static bool allowed = false;
  if (!allowed) {
    const cudaError_t err =
        cudaFuncSetAttribute(int4_gemm_kernel<kMI, kAligned, kUniform, OutT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
    if (err != cudaSuccess) return err;
    allowed = true;
  }
  const dim3 grid((p.N + kBN - 1) / kBN, (p.M + T::kBM - 1) / T::kBM, splits);
  int4_gemm_kernel<kMI, kAligned, kUniform, OutT><<<grid, kThreads, T::kSmem, st>>>(p);
  return cudaGetLastError();
}

template <int kMI, typename OutT>
cudaError_t launch_gemm_tile(const Int4Params& p, int splits, cudaStream_t st) {
  const bool aligned = p.K % 16 == 0 && p.N % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(p.x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(p.w4) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(p.scale) % 16 == 0;
  const bool uniform = p.G == 1 || (p.K / p.G) % kBKP == 0;
  return aligned ? (uniform ? launch_gemm<kMI, true, true, OutT>(p, splits, st)
                            : launch_gemm<kMI, true, false, OutT>(p, splits, st))
                 : (uniform ? launch_gemm<kMI, false, true, OutT>(p, splits, st)
                            : launch_gemm<kMI, false, false, OutT>(p, splits, st));
}

// path 0: decode GEMV (M == 1), `col_threads` in {2, 4, 8, 16, 32} threads
// across each block's columns, `rows_per_lane` packed rows per thread (a
// multiple of 8, covering K/2 with the block's kThreads / col_threads lanes).
// path 1: prefill GEMM (any M), `row_tile` in {32, 64, 128} x rows per block,
// K split across `splits` blocks per output tile (1..16, none of them empty).
// With splits > 1, `ws` holds splits * M * N floats and `counters` one int per
// output tile, all zero; the kernel leaves them zero. Returns a cudaError_t;
// 0 means the launch was accepted.
// path 2: the TMA / wgmma GEMM (any M; K and N multiples of 16, 16-byte
// aligned bases, G == 1 or groups a multiple of 64 rows), one persistent
// block per SM at most; the tile arguments are not read.
// XT, x's type: bf16 on the GEMMs, bf16 or f32 on the GEMV.
template <typename XT, typename OutT>
int run(const void* x, const void* w4, const void* scale, void* y, void* ws, void* counters,
        int M, int K, int N, int G, int path, int col_threads, int rows_per_lane,
        int row_tile, int splits, void* stream) {
  Int4Params p;
  p.x = x;
  p.w4 = static_cast<const uint8_t*>(w4);
  p.scale = static_cast<const float*>(scale);
  p.y = y;
  p.ws = static_cast<float*>(ws);
  p.counters = static_cast<int*>(counters);
  p.M = M; p.K = K; p.N = N; p.G = G;
  p.col_threads = col_threads;
  p.rows_per_lane = rows_per_lane;
  p.vec_w = N % kV == 0 && reinterpret_cast<uintptr_t>(w4) % 8 == 0;
  p.vec_s = N % 4 == 0 && reinterpret_cast<uintptr_t>(scale) % 16 == 0;
  p.vec_x = K % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (path == 2) {     // the TMA / wgmma GEMM reads bf16 x
    if constexpr (!std::is_same_v<XT, __nv_bfloat16>) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(launch_sm90<OutT>(p, st));
  }
  if (path == 1) {
    if constexpr (!std::is_same_v<XT, __nv_bfloat16>)   // the GEMM reads bf16 x
      return static_cast<int>(cudaErrorInvalidValue);
    const int nst = (K / 2 + kBKP - 1) / kBKP;
    p.split_stages = splits > 0 ? (nst + splits - 1) / splits : 0;
    if (splits < 1 || splits > kMaxSplits || (splits - 1) * p.split_stages >= nst ||
        (splits > 1 && (ws == nullptr || counters == nullptr)))
      return static_cast<int>(cudaErrorInvalidValue);
    switch (row_tile) {
      case 32: return static_cast<int>(launch_gemm_tile<1, OutT>(p, splits, st));
      case 64: return static_cast<int>(launch_gemm_tile<2, OutT>(p, splits, st));
      case 128: return static_cast<int>(launch_gemm_tile<4, OutT>(p, splits, st));
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const int lanes = col_threads > 0 ? kThreads / col_threads : 0;
  if (path != 0 || M != 1 || col_threads < 2 || col_threads > kMaxColThreads ||
      (col_threads & (col_threads - 1)) != 0 ||
      rows_per_lane % kUnroll != 0 || (int64_t)lanes * rows_per_lane < K / 2)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_gemv<XT, OutT>(p, st));
}

}  // namespace

// y bf16 (x bf16)
extern "C" int kj_int4_matvec_bf16(const void* x, const void* w4, const void* scale,
                                   void* y, void* ws, void* counters, int M, int K, int N,
                                   int G, int path, int col_threads, int rows_per_lane,
                                   int row_tile, int splits, void* stream) {
  return run<__nv_bfloat16, __nv_bfloat16>(x, w4, scale, y, ws, counters, M, K, N, G, path,
                                           col_threads, rows_per_lane, row_tile, splits,
                                           stream);
}

// y f32 (x bf16, an f32 input rounded by the wrapper: the prefill GEMM)
extern "C" int kj_int4_matvec_bf16_f32(const void* x, const void* w4, const void* scale,
                                       void* y, void* ws, void* counters, int M, int K,
                                       int N, int G, int path, int col_threads,
                                       int rows_per_lane, int row_tile, int splits,
                                       void* stream) {
  return run<__nv_bfloat16, float>(x, w4, scale, y, ws, counters, M, K, N, G, path,
                                   col_threads, rows_per_lane, row_tile, splits, stream);
}

// y f32 (x f32, rounded to bf16 in the kernel's loads): the decode GEMV only
// (path 0); path 1 is refused. Bit-identical to kj_int4_matvec_bf16_f32 on
// x.to(bfloat16).
extern "C" int kj_int4_matvec_f32(const void* x, const void* w4, const void* scale, void* y,
                                  void* ws, void* counters, int M, int K, int N, int G,
                                  int path, int col_threads, int rows_per_lane, int row_tile,
                                  int splits, void* stream) {
  return run<float, float>(x, w4, scale, y, ws, counters, M, K, N, G, path, col_threads,
                           rows_per_lane, row_tile, splits, stream);
}
