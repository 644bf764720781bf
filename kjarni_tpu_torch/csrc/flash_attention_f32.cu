// Flash attention forward for Hopper (sm_90a) in f32: f32 q/k/v/o, f32
// softmax state, FFMA on the CUDA cores (no tensor cores, no TF32).
//
// Replaces kjarni_tpu/ops/pallas/flash_attention.py::flash_attention (body
// _flash_kernel) at the other dtype the Pallas kernel takes: f32 in, f32 out.
// Same function as csrc/flash_attention.cu (the bf16 kernel): online-softmax
// attention of q [B,H,S,D] over k/v [B,Hkv,T,D], optional causal mask and
// sliding window, queries at absolute positions q_offset.. over the K/V
// prefix kv_len; masked scores are -1e30 as in the Pallas kernel. D is 32,
// 64, 96 or 128. f32 is the port's parity mode, so every product and sum is
// a full f32 FFMA: TF32 would round q, k, p and v to 10-bit mantissas.
//
// What bounds it on the H100: at a long prefill the work is 4*S*T*D*H flops
// (halved by the causal band) against (q,k,v,o) bytes read once, ~205 flops
// per f32 byte at S=T=1024, D=64 -- far above the ~20 flops per byte at which
// the 67 TFLOP/s of f32 FFMA meet 3.35 TB/s, so the FFMA rate (and the shared
// memory reads that feed it) is the limit. The design keeps the [S,T] scores
// out of device memory and gives each thread a register tile:
//   * one block = 128 threads over 64 query rows, with GQA folded into the
//     rows as in the bf16 kernel (rows s*G + g of one KV head), so one K/V
//     tile in shared memory serves all G query heads;
//   * the Q tile stays in shared memory for the whole loop; 64-key K/V tiles
//     go through a 2-stage cp.async ring (tile j+1 in flight while tile j is
//     used), zero-filled past kv_len;
//   * thread (ty, tx), ty in 0..15 and tx in 0..7, owns rows ty + 16 i
//     (i < 4) and, for the scores, keys tx + 8 j (j < 8); for the output,
//     columns tx + 8 j (j < D/8). A score tile is 32 FFMA per 12 shared loads
//     and P V 4 D/8 FFMA per 4 + D/8. Rows are padded to D + 4 floats, so
//     the loads meet no bank conflicts and rows stay 16-byte aligned;
//   * a row's 8 threads are 8 neighbouring lanes of one warp: its max is 3
//     shuffles, and P passes through a per-warp band of shared memory with
//     no block barrier;
//   * the softmax scale is folded into the exp2 argument (one FFMA per
//     score), and the row sum stays a per-thread partial until the end;
//   * under causal the row blocks run heaviest first.
// Rows whose every key is masked (none on the generation path) give zeros,
// as in the bf16 kernel.
#include "mma.cuh"

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kThreads = 128;  // 16 row groups x 8 lanes
constexpr int kBK = 64;        // keys per K/V tile
constexpr int kStages = 2;     // K/V ring depth
constexpr int kRows = 4;       // rows per thread: ty + 16 i
constexpr int kKeys = 8;       // keys per thread per tile: tx + 8 j
constexpr int kPStride = kBK + 4;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct FlashParams {
  const float* q;
  const float* k;
  const float* v;
  float* o;
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
struct Smem {
  static constexpr int kStride = D + 4;             // floats per row
  static constexpr int kTile = kBK * kStride;       // one K or V tile
  static constexpr int kQ = kBQ * kStride;
  static constexpr int kP = kBQ * kPStride;
  static constexpr int kBytes = (kQ + kStages * 2 * kTile + kP) * 4;
};

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_f32_kernel(const FlashParams p) {
  constexpr int kStride = Smem<D>::kStride;
  constexpr int kTile = Smem<D>::kTile;
  constexpr int kCols = D / 8;     // output columns per thread
  constexpr int kVec = D / 4;      // 16-byte chunks per row
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                                   // [kBQ][kStride]
  float* Ks = Qs + Smem<D>::kQ;                       // [kStages][kBK][kStride]
  float* Vs = Ks + kStages * kTile;
  float* Ps = Vs + kStages * kTile;                   // [kBQ][kPStride]

  const int G = p.H / p.Hkv;
  const int rows = G * p.S;
  const int rb = p.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int r0 = rb * kBQ;
  const int b = blockIdx.x / p.Hkv;
  const int hkv = blockIdx.x % p.Hkv;
  const int ty = threadIdx.x / 8;
  const int tx = threadIdx.x % 8;

  // the K/V range the block needs, as in the bf16 kernel
  const int kv_end = min(p.kv_len, p.T);
  const int last_row = min(r0 + kBQ, rows) - 1;
  int k_hi = kv_end;
  if (p.causal) k_hi = min(k_hi, p.q_offset + last_row / G + 1);
  int k_lo = 0;
  if (p.window > 0) k_lo = max(0, p.q_offset + r0 / G - p.window + 1);
  k_lo = (k_lo / kBK) * kBK;
  const int ntiles = k_hi > k_lo ? (k_hi - k_lo + kBK - 1) / kBK : 0;

  const float* kbase = p.k + b * p.k_sb + hkv * p.k_sh;
  const float* vbase = p.v + b * p.v_sb + hkv * p.v_sh;
  // tile t into ring stage `stage`: 16-byte copies, keys past kv_end
  // zero-filled from a valid address (key 0)
  auto load_tile = [&](int t, int stage) {
    static_assert(kBK * kVec % kThreads == 0, "whole copies per thread");
    const int k0 = k_lo + t * kBK;
    float* ks = Ks + stage * kTile;
    float* vs = Vs + stage * kTile;
#pragma unroll
    for (int it = 0; it < kBK * kVec / kThreads; ++it) {
      const int idx = it * kThreads + threadIdx.x;
      const int rr = idx / kVec;
      const int cc = (idx % kVec) * 4;
      const bool in = k0 + rr < kv_end;
      const int64_t key = in ? k0 + rr : 0;
      kj::cp_async16(ks + rr * kStride + cc, kbase + key * p.k_ss + cc, in);
      kj::cp_async16(vs + rr * kStride + cc, vbase + key * p.v_ss + cc, in);
    }
  };
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < ntiles) load_tile(st, st);
    kj::cp_async_commit();
  }

  // the Q tile, rows past the end as zeros
  for (int idx = threadIdx.x; idx < kBQ * kVec; idx += kThreads) {
    const int rr = idx / kVec;
    const int cc = (idx % kVec) * 4;
    const int r = r0 + rr;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows) {
      const int s = r / G;
      const int h = hkv * G + r % G;
      val = *reinterpret_cast<const float4*>(p.q + b * p.q_sb + h * p.q_sh + s * p.q_ss + cc);
    }
    *reinterpret_cast<float4*>(Qs + rr * kStride + cc) = val;
  }

  int pos[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) pos[i] = p.q_offset + (r0 + ty + 16 * i) / G;

  float m[kRows], l[kRows], acc[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  for (int t = 0; t < ntiles; ++t) {
    // tile t has landed for every thread (and Q, at t = 0), and every warp
    // is done with the stage that tile t + kStages - 1 overwrites
    kj::cp_async_wait<kStages - 2>();
    __syncthreads();
    if (t + kStages - 1 < ntiles) load_tile(t + kStages - 1, (t + kStages - 1) % kStages);
    kj::cp_async_commit();

    const float* ks = Ks + (t % kStages) * kTile;
    const float* vs = Vs + (t % kStages) * kTile;
    const int k0 = k_lo + t * kBK;

    // S = Q K^T for this thread's 4 rows x 8 keys
    float s[kRows][kKeys];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
#pragma unroll
      for (int j = 0; j < kKeys; ++j) s[i][j] = 0.f;
    }
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[kRows], kv[kKeys];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = Qs[(ty + 16 * i) * kStride + d];
#pragma unroll
      for (int j = 0; j < kKeys; ++j) kv[j] = ks[(tx + 8 * j) * kStride + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
#pragma unroll
        for (int j = 0; j < kKeys; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
    }

    // mask, then the online-softmax update in log2 units:
    // p = 2^(s * scale_log2 - m * scale_log2), m the running max of raw scores
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const int key = k0 + tx + 8 * j;
        bool keep = key < kv_end;
        if (p.causal) keep = keep && key <= pos[i];
        if (p.window > 0) keep = keep && key > pos[i] - p.window;
        if (!keep) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float corr = exp2f((m[i] - mx) * p.scale_log2);
      m[i] = mx;
      // a row with every key so far masked keeps its sum at 0
      const float msc = mx == kNegInf ? 0.f : mx * p.scale_log2;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const float pe = exp2f(fmaf(s[i][j], p.scale_log2, -msc));
        rs += pe;
        Ps[(ty + 16 * i) * kPStride + tx + 8 * j] = pe;
      }
      l[i] = l[i] * corr + rs;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= corr;
    }
    // a row's P is written and read by the 8 lanes of one warp
    __syncwarp();

    // acc += P V for this thread's 4 rows x D/8 columns
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[kRows], vv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = Ps[(ty + 16 * i) * kPStride + kk];
#pragma unroll
      for (int c = 0; c < kCols; ++c) vv[c] = vs[kk * kStride + tx + 8 * c];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
      }
    }
    __syncwarp();   // P is read before the next tile overwrites it
  }
  kj::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 4);
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= rows) continue;
    const int s = r / G;
    const int h = hkv * G + r % G;
    float* dst = p.o + b * p.o_sb + h * p.o_sh + s * p.o_ss;
    const float inv = 1.f / fmaxf(l[i], 1e-20f);
#pragma unroll
    for (int c = 0; c < kCols; ++c) dst[tx + 8 * c] = acc[i][c] * inv;
  }
}

template <int D>
cudaError_t launch(const FlashParams& p, int B, cudaStream_t stream) {
  constexpr int kSmem = Smem<D>::kBytes;
  // above 48 KB a block's dynamic shared memory must be asked for, once
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return attr;
  const int rows = (p.H / p.Hkv) * p.S;
  const dim3 grid(B * p.Hkv, (rows + kBQ - 1) / kBQ);
  flash_f32_kernel<D><<<grid, kThreads, kSmem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// strides: 12 int64 element strides (b, h, s) of q, k, v, o in that order.
// The same interface as kj_flash_attention_bf16. Returns a cudaError_t; 0
// means the launch was accepted.
extern "C" int kj_flash_attention_f32(const void* q, const void* k, const void* v,
                                      void* o, const int64_t* strides, int B, int H,
                                      int Hkv, int S, int T, int D, int q_offset,
                                      int kv_len, int causal, int window, float scale,
                                      void* stream) {
  FlashParams p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.o = static_cast<float*>(o);
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
    case 96: return launch<96>(p, B, st);
    case 128: return launch<128>(p, B, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
