// y = x @ dequant(w4) over half-split packed int4 weights, for Hopper (sm_90a).
//
// Replaces kjarni_tpu/ops/pallas/int4_matvec.py::int4_matvec (body _kernel).
// Same function: x [M,K] bf16, w4 [K/2,N] int8 holding two nibbles per byte
// (low nibble = row r, high nibble = row r + K/2), scale [G,N] f32 over groups
// of g = K/G rows; the group scale multiplies the f32 partial of its group,
// not the weight tile. Output [M,N] bf16.
//
// What bounds it on the H100: at decode (M = 1) every packed byte is read once
// and used for 4 flops, so it is bound by device-memory bytes (K*N/2 weight
// bytes + 4*G*N scale bytes). The design:
//   * the nibbles are sign-extended in registers and fed to bf16 mma.sync
//     (nibble values are exact in bf16), accumulating in f32 -- the weight is
//     never dequantized into memory;
//   * a block owns 128 output columns and 16 rows of x; weight tiles of 64
//     packed rows x 128 columns go through shared memory with 16-byte loads;
//   * any M: rows past M are zero-filled in the kernel (the Pallas kernel
//     padded x to 8 rows for Mosaic; nothing is padded here), and prefill
//     (M = bucket) runs the same code with more row tiles;
//   * small decode grids are split along K (`splits` blocks per column tile)
//     so the card has enough blocks in flight; each split writes f32 partials
//     and a second small kernel sums them in a fixed order (deterministic);
//   * G == 1 (one scale per column) is taken as well as even G.
// Not yet done (later work): cp.async/TMA pipelining, larger M tiles for prefill.
#include "mma.cuh"

namespace {

constexpr int kBN = 128;       // output columns per block: 4 warps x 32
constexpr int kBM = 16;        // x rows per block (one mma row tile)
constexpr int kBKP = 64;       // packed weight rows per shared-memory stage
constexpr int kThreads = 128;

struct Int4Params {
  const __nv_bfloat16* x;      // [M, K]
  const int8_t* w4;            // [K/2, N]
  const float* scale;          // [G, N]
  float* partial;              // [splits, M, N] when splits > 1
  __nv_bfloat16* y;            // [M, N]
  int M, K, N, G;
  int rows_per_split;          // packed rows per K split, a multiple of kBKP
  int vec_w;                   // w4 rows are 16-byte aligned (N % 16 == 0)
};

__device__ __forceinline__ float lo_nibble(int b) { return (float)(((b & 0xF) ^ 8) - 8); }
__device__ __forceinline__ float hi_nibble(int b) { return (float)((((b >> 4) & 0xF) ^ 8) - 8); }

__global__ void __launch_bounds__(kThreads) int4_mm_kernel(const Int4Params p) {
  __shared__ __align__(16) int8_t Ws[kBKP][kBN + 16];
  __shared__ __align__(16) __nv_bfloat16 Xlo[kBM][kBKP + 8];
  __shared__ __align__(16) __nv_bfloat16 Xhi[kBM][kBKP + 8];

  const int K2 = p.K / 2;
  const int g = p.K / p.G;               // rows per group (K when G == 1)
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int r_begin = blockIdx.z * p.rows_per_split;
  const int r_end = min(K2, r_begin + p.rows_per_split);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gid = lane / 4;
  const int tig = lane % 4;

  float acc[4][4], part_lo[4][4], part_hi[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = part_lo[j][e] = part_hi[j][e] = 0.f;
  }

  for (int rs = r_begin; rs < r_end; rs += kBKP) {
    // weight stage: kBKP packed rows x kBN columns, zeros past the edges
    for (int idx = threadIdx.x; idx < kBKP * (kBN / 16); idx += kThreads) {
      const int rr = idx / (kBN / 16);
      const int cc = (idx % (kBN / 16)) * 16;
      const int r = rs + rr;
      const int n = n0 + cc;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r < r_end) {
        const int8_t* src = p.w4 + (int64_t)r * p.N + n;
        if (p.vec_w && n + 16 <= p.N) {
          val = *reinterpret_cast<const uint4*>(src);
        } else {
          __align__(16) uint8_t bytes[16];
#pragma unroll
          for (int i = 0; i < 16; ++i) bytes[i] = (n + i < p.N) ? (uint8_t)src[i] : 0;
          val = *reinterpret_cast<uint4*>(bytes);
        }
      }
      *reinterpret_cast<uint4*>(&Ws[rr][cc]) = val;
    }
    // x stage: the matching columns of both halves of x
    for (int idx = threadIdx.x; idx < kBM * kBKP; idx += kThreads) {
      const int mm = idx / kBKP;
      const int c = idx % kBKP;
      const int m = m0 + mm;
      const int r = rs + c;
      __nv_bfloat16 lo = __float2bfloat16(0.f), hi = lo;
      if (m < p.M && r < r_end) {
        lo = p.x[(int64_t)m * p.K + r];
        hi = p.x[(int64_t)m * p.K + K2 + r];
      }
      Xlo[mm][c] = lo;
      Xhi[mm][c] = hi;
    }
    __syncthreads();

    for (int ks = 0; ks < kBKP; ks += 16) {
      const int r = rs + ks;
      if (r >= r_end) break;
      uint32_t alo[4], ahi[4];
      alo[0] = *reinterpret_cast<const uint32_t*>(&Xlo[gid][ks + 2 * tig]);
      alo[1] = *reinterpret_cast<const uint32_t*>(&Xlo[gid + 8][ks + 2 * tig]);
      alo[2] = *reinterpret_cast<const uint32_t*>(&Xlo[gid][ks + 2 * tig + 8]);
      alo[3] = *reinterpret_cast<const uint32_t*>(&Xlo[gid + 8][ks + 2 * tig + 8]);
      ahi[0] = *reinterpret_cast<const uint32_t*>(&Xhi[gid][ks + 2 * tig]);
      ahi[1] = *reinterpret_cast<const uint32_t*>(&Xhi[gid + 8][ks + 2 * tig]);
      ahi[2] = *reinterpret_cast<const uint32_t*>(&Xhi[gid][ks + 2 * tig + 8]);
      ahi[3] = *reinterpret_cast<const uint32_t*>(&Xhi[gid + 8][ks + 2 * tig + 8]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = warp * 32 + j * 8 + gid;
        const int w0 = Ws[ks + 2 * tig][c];
        const int w1 = Ws[ks + 2 * tig + 1][c];
        const int w2 = Ws[ks + 2 * tig + 8][c];
        const int w3 = Ws[ks + 2 * tig + 9][c];
        kj::mma_bf16(part_lo[j], alo, kj::pack_bf16(lo_nibble(w0), lo_nibble(w1)),
                     kj::pack_bf16(lo_nibble(w2), lo_nibble(w3)));
        kj::mma_bf16(part_hi[j], ahi, kj::pack_bf16(hi_nibble(w0), hi_nibble(w1)),
                     kj::pack_bf16(hi_nibble(w2), hi_nibble(w3)));
      }
      // a 16-row step lies inside one group on each half; at the group's
      // end its scale multiplies the f32 partial
      const int rn = r + 16;
      const int glo = r / g;
      const int ghi = (K2 + r) / g;
      if (rn >= r_end || rn / g != glo || (K2 + rn) / g != ghi) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = n0 + warp * 32 + j * 8 + 2 * tig + (e & 1);
            const float slo = col < p.N ? p.scale[(int64_t)glo * p.N + col] : 0.f;
            const float shi = col < p.N ? p.scale[(int64_t)ghi * p.N + col] : 0.f;
            acc[j][e] += part_lo[j][e] * slo + part_hi[j][e] * shi;
            part_lo[j][e] = 0.f;
            part_hi[j][e] = 0.f;
          }
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = m0 + gid + 8 * (e >> 1);
      const int col = n0 + warp * 32 + j * 8 + 2 * tig + (e & 1);
      if (m >= p.M || col >= p.N) continue;
      if (gridDim.z == 1) {
        p.y[(int64_t)m * p.N + col] = __float2bfloat16(acc[j][e]);
      } else {
        p.partial[((int64_t)blockIdx.z * p.M + m) * p.N + col] = acc[j][e];
      }
    }
  }
}

// y = sum over splits of the partials, in split order
__global__ void sum_splits_kernel(const float* partial, __nv_bfloat16* y, int64_t MN,
                                  int splits) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= MN) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += partial[z * MN + i];
  y[i] = __float2bfloat16(s);
}

}  // namespace

// Returns a cudaError_t; 0 means both launches were accepted. `partial` holds
// splits * M * N floats and is only used when splits > 1.
extern "C" int kj_int4_matvec_bf16(const void* x, const void* w4, const void* scale,
                                   void* partial, void* y, int M, int K, int N, int G,
                                   int splits, int rows_per_split, void* stream) {
  Int4Params p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.w4 = static_cast<const int8_t*>(w4);
  p.scale = static_cast<const float*>(scale);
  p.partial = static_cast<float*>(partial);
  p.y = static_cast<__nv_bfloat16*>(y);
  p.M = M; p.K = K; p.N = N; p.G = G;
  p.rows_per_split = rows_per_split;
  p.vec_w = (N % 16 == 0) && (reinterpret_cast<uintptr_t>(w4) % 16 == 0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, splits);
  int4_mm_kernel<<<grid, kThreads, 0, st>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const int64_t MN = (int64_t)M * N;
  sum_splits_kernel<<<(unsigned)((MN + 255) / 256), 256, 0, st>>>(p.partial, p.y, MN,
                                                                  splits);
  return static_cast<int>(cudaGetLastError());
}
