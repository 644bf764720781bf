// Flash attention forward for Hopper (sm_90a): bf16 q/k/v/o, f32 softmax state.
//
// Replaces kjarni_tpu/ops/pallas/flash_attention.py::flash_attention (body
// _flash_kernel). Same function: online-softmax attention of q [B,H,S,D] over
// k/v [B,Hkv,T,D], optional causal mask and sliding window, queries at absolute
// positions q_offset.. over the K/V prefix kv_len; masked scores are -1e30 as
// in the Pallas kernel.
//
// What bounds it on the H100: at a long prefill the work is 4*S*T*D*H flops
// (halved by the causal band) against (q,k,v,o) bytes read once, ~410 flops per
// byte at S=T=1024, D=64 -- above the card's ~295 bf16 flops/byte ridge, so
// the tensor cores are the limit. The design keeps the [S,T] scores out of
// device memory and feeds the tensor cores with mma.sync:
//   * one block = 4 warps = 64 query rows; each warp owns 16 rows and keeps
//     its running max m, sum l and the [16, D] accumulator in registers
//     (the Pallas kernel's (block_q, 128) VMEM scratch follows TPU tiling and
//     has no counterpart here);
//   * GQA is folded into the rows: the G query heads of one KV head are rows
//     s*G + g (position-major), so one K/V tile in shared memory serves all G
//     heads and K/V are never repeated;
//   * the block loops over 64-key K/V tiles itself, from the left edge of the
//     window to the causal diagonal / kv_len, and skips the rest;
//   * the ragged edge (rows past G*S, keys past kv_len or T) is masked in the
//     kernel: loads past the edge are zero-filled, nothing is padded in memory.
// Not yet done (later work): TMA/wgmma, double-buffered K/V, larger tiles.
#include "mma.cuh"

namespace {

constexpr int kBQ = 64;        // query rows per block: 4 warps x 16
constexpr int kBK = 64;        // keys per K/V tile
constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct FlashParams {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  int64_t q_sb, q_sh, q_ss;    // element strides; the D stride is 1
  int64_t k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss;
  int64_t o_sb, o_sh, o_ss;
  int H, Hkv, S, T;
  int q_offset, kv_len;
  int causal, window;          // window <= 0: no sliding window
  float scale_log2;            // softmax scale * log2(e)
};

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const FlashParams p) {
  constexpr int KS = D / 16;   // k-steps of Q K^T
  constexpr int NT = D / 8;    // n-tiles of the output
  constexpr int LD = D + 8;    // shared row stride: +16 bytes against bank conflicts
  __shared__ __align__(16) __nv_bfloat16 Ks[kBK * LD];
  __shared__ __align__(16) __nv_bfloat16 Vs[kBK * LD];

  const int G = p.H / p.Hkv;
  const int rows = G * p.S;
  const int r0 = blockIdx.x * kBQ;
  const int b = blockIdx.y / p.Hkv;
  const int hkv = blockIdx.y % p.Hkv;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gid = lane / 4;
  const int tig = lane % 4;

  // this thread's two rows (gid and gid + 8 of the warp's 16)
  bool valid[2];
  int pos[2];
  int64_t qoff[2], ooff[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + warp * 16 + gid + 8 * i;
    valid[i] = r < rows;
    const int s = valid[i] ? r / G : 0;
    const int h = hkv * G + (valid[i] ? r % G : 0);
    pos[i] = p.q_offset + s;
    qoff[i] = b * p.q_sb + h * p.q_sh + s * p.q_ss;
    ooff[i] = b * p.o_sb + h * p.o_sh + s * p.o_ss;
  }

  // Q fragments stay in registers for the whole K/V loop
  uint32_t qa[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int col = kk * 16 + half * 8 + 2 * tig;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        qa[kk][i + 2 * half] =
            valid[i] ? *reinterpret_cast<const uint32_t*>(p.q + qoff[i] + col) : 0u;
      }
    }
  }

  // the K/V range this tile needs: left edge of the window to the causal
  // diagonal of its last row, bounded by kv_len and T
  const int kv_end = min(p.kv_len, p.T);
  const int last_row = min(r0 + kBQ, rows) - 1;
  const int pos_lo = p.q_offset + r0 / G;
  const int pos_hi = p.q_offset + last_row / G;
  int k_hi = kv_end;
  if (p.causal) k_hi = min(k_hi, pos_hi + 1);
  int k_lo = 0;
  if (p.window > 0) k_lo = max(0, pos_lo - p.window + 1);
  k_lo = (k_lo / kBK) * kBK;

  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  }

  const __nv_bfloat16* kbase = p.k + b * p.k_sb + hkv * p.k_sh;
  const __nv_bfloat16* vbase = p.v + b * p.v_sb + hkv * p.v_sh;

  for (int k0 = k_lo; k0 < k_hi; k0 += kBK) {
    // K and V tiles into shared memory, 16-byte vectors, zeros past kv_end
    constexpr int VPR = D / 8;
    for (int idx = threadIdx.x; idx < kBK * VPR; idx += kThreads) {
      const int rr = idx / VPR;
      const int cc = (idx % VPR) * 8;
      const int key = k0 + rr;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u);
      uint4 vv = make_uint4(0u, 0u, 0u, 0u);
      if (key < kv_end) {
        kv = *reinterpret_cast<const uint4*>(kbase + key * p.k_ss + cc);
        vv = *reinterpret_cast<const uint4*>(vbase + key * p.v_ss + cc);
      }
      *reinterpret_cast<uint4*>(&Ks[rr * LD + cc]) = kv;
      *reinterpret_cast<uint4*>(&Vs[rr * LD + cc]) = vv;
    }
    __syncthreads();

    // scores for this warp's 16 rows x 64 keys
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const __nv_bfloat16* kr = &Ks[(j * 8 + gid) * LD + kk * 16 + 2 * tig];
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kr + 8);
        kj::mma_bf16(s[j], qa[kk], b0, b1);
      }
    }

    // scale and mask, then the online-softmax update (in log2 units)
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int key = k0 + j * 8 + 2 * tig + (e & 1);
        bool keep = valid[i] && key < kv_end;
        if (p.causal) keep = keep && key <= pos[i];
        if (p.window > 0) keep = keep && key > pos[i] - p.window;
        const float x = keep ? s[j][e] * p.scale_log2 : kNegInf;
        s[j][e] = x;
        mx[i] = fmaxf(mx[i], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      corr[i] = exp2f(m[i] - mx[i]);
      m[i] = mx[i];
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = exp2f(s[j][e] - m[e >> 1]);
        s[j][e] = pe;
        rs[e >> 1] += pe;
      }
    }
    // l stays a per-thread partial sum; the quad is reduced once at the end
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + rs[i];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    // acc += P V: the score C fragments of two n-tiles form one A fragment
#pragma unroll
    for (int kt = 0; kt < 4; ++kt) {
      uint32_t pa[4];
      pa[0] = kj::pack_bf16(s[2 * kt][0], s[2 * kt][1]);
      pa[1] = kj::pack_bf16(s[2 * kt][2], s[2 * kt][3]);
      pa[2] = kj::pack_bf16(s[2 * kt + 1][0], s[2 * kt + 1][1]);
      pa[3] = kj::pack_bf16(s[2 * kt + 1][2], s[2 * kt + 1][3]);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const __nv_bfloat16* vr = &Vs[(kt * 16 + 2 * tig) * LD + n * 8 + gid];
        const uint32_t b0 = kj::pack_raw(vr[0], vr[LD]);
        const uint32_t b1 = kj::pack_raw(vr[8 * LD], vr[9 * LD]);
        kj::mma_bf16(acc[n], pa, b0, b1);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!valid[i]) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-20f);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = n * 8 + 2 * tig;
      *reinterpret_cast<uint32_t*>(p.o + ooff[i] + col) =
          kj::pack_bf16(acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
    }
  }
}

template <int D>
cudaError_t launch(const FlashParams& p, int B, cudaStream_t stream) {
  const int rows = (p.H / p.Hkv) * p.S;
  const dim3 grid((rows + kBQ - 1) / kBQ, B * p.Hkv);
  flash_fwd_kernel<D><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// strides: 12 int64 element strides (b, h, s) of q, k, v, o in that order.
// Returns a cudaError_t; 0 means the launch was accepted.
extern "C" int kj_flash_attention_bf16(const void* q, const void* k, const void* v,
                                       void* o, const int64_t* strides, int B, int H,
                                       int Hkv, int S, int T, int D, int q_offset,
                                       int kv_len, int causal, int window, float scale,
                                       void* stream) {
  FlashParams p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.q_sb = strides[0]; p.q_sh = strides[1]; p.q_ss = strides[2];
  p.k_sb = strides[3]; p.k_sh = strides[4]; p.k_ss = strides[5];
  p.v_sb = strides[6]; p.v_sh = strides[7]; p.v_ss = strides[8];
  p.o_sb = strides[9]; p.o_sh = strides[10]; p.o_ss = strides[11];
  p.H = H; p.Hkv = Hkv; p.S = S; p.T = T;
  p.q_offset = q_offset; p.kv_len = kv_len;
  p.causal = causal; p.window = window;
  p.scale_log2 = scale * kLog2e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch<32>(p, B, st);
    case 64: return launch<64>(p, B, st);
    case 128: return launch<128>(p, B, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
