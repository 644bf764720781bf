// Flash attention forward for Hopper (sm_90a): bf16 q/k/v/o, f32 softmax state.
//
// Replaces kjarni_tpu/ops/pallas/flash_attention.py::flash_attention (body
// _flash_kernel). Same function: online-softmax attention of q [B,H,S,D] over
// k/v [B,Hkv,T,D], optional causal mask and sliding window, queries at absolute
// positions q_offset.. over the K/V prefix kv_len; masked scores are -1e30 as
// in the Pallas kernel. D is 32, 64, 96 or 128.
//
// What bounds it on the H100: at a long prefill the work is 4*S*T*D*H flops
// (halved by the causal band) against (q,k,v,o) bytes read once, ~410 flops per
// byte at S=T=1024, D=64 -- above the card's ~295 bf16 flops/byte ridge, so
// the tensor cores (and the exp2 unit beside them) are the limit. The design
// keeps the [S,T] scores out of device memory and keeps the tensor cores fed:
//   * one block = one warpgroup (4 warps) of 64 query rows, 16 per warp; each
//     warp keeps its running max m, sum l and the [16, D] accumulator in
//     registers, and its Q fragments for the whole loop. 2-3 blocks share an
//     SM (96-217 registers by D; 4 blocks at D <= 64 under a 128-register cap
//     spilled and lost at the Llama shapes);
//   * GQA is folded into the rows: the G query heads of one KV head are rows
//     s*G + g (position-major), so one K/V tile in shared memory serves all G
//     heads, K/V are never repeated, and a block's causal band stays narrow;
//   * 64-key K/V tiles go through a 2-stage ring in dynamic shared memory fed
//     by cp.async: tile j+1 is in flight while tile j is in the tensor cores,
//     behind one barrier per tile. Keys past kv_len (or T) are zero-filled by
//     the copy, so nothing is padded in memory;
//   * the warpgroup issues S = Q K^T and acc += P V as wgmma products, with Q
//     and P as register operands and K/V read through descriptors from tiles
//     stored in 128-byte-swizzled blocks of 64 columns, without bank
//     conflicts;
//   * each warp sorts its tiles into interior ones (every row keeps every key:
//     no mask at all) and edge ones (the per-element causal / window / kv_len
//     mask). The softmax scale is folded into the exp2 argument: one FFMA per
//     score;
//   * under causal the row blocks run heaviest first (the last rows, which
//     attend the most keys), so the light blocks fill the tail.
// Rows whose every key is masked (none on the generation path) give zeros.
#include "mma.cuh"

namespace {

constexpr int kBQ = 64;        // query rows per block: one warpgroup, 16 per warp
constexpr int kThreads = 128;
constexpr int kBK = 64;        // keys per K/V tile
constexpr int kStages = 2;     // K/V ring depth
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

// A K or V tile in shared memory: 128-byte swizzled column blocks of 64 bf16
// (D rounded up to 64), each [kBK rows][64], with the 16-byte chunk c of row r
// stored at chunk c ^ (r % 8), as wgmma's 128B swizzle mode reads it
template <int D>
struct Tile {
  static constexpr int kCols = (D + 63) / 64 * 64;
  static constexpr int kElems = kBK * kCols;
  static constexpr int kSmem = kStages * 2 * kElems * 2;
};

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ---- wgmma (warpgroup products, A from registers, B from shared memory) ----

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep reads of wgmma accumulators after the wait that completes them
template <int M>
__device__ __forceinline__ void fence_regs(float (&d)[M][4]) {
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[i][e])::"memory");
  }
}
// cp.async's writes to shared memory, made visible to wgmma's (async proxy) reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// matrix descriptor, 128-byte swizzle: start address; lbo, the byte offset
// between 64-column blocks (N-major B); sbo, between 8-row groups (1024)
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

// d[64 x N] (+)= a[64 x 16] * B[16 x N]: a in registers, each warp's 16 rows in
// the mma.sync A layout; B through its descriptor (kTransB: B is N-major);
// accumulate = 0 overwrites d, whose per-warp layout is mma.sync's C fragments
template <int kTransB>
__device__ __forceinline__ void wgmma_n32(float (&d)[4][4], const uint32_t (&a)[4],
                                      uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate),
        "n"(kTransB));
}

template <int kTransB>
__device__ __forceinline__ void wgmma_n64(float (&d)[8][4], const uint32_t (&a)[4],
                                      uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate),
        "n"(kTransB));
}

template <int kTransB>
__device__ __forceinline__ void wgmma_n96(float (&d)[12][4], const uint32_t (&a)[4],
                                      uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, %54;\n}\n"
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
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate),
        "n"(kTransB));
}

template <int kTransB>
__device__ __forceinline__ void wgmma_n128(float (&d)[16][4], const uint32_t (&a)[4],
                                      uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate),
        "n"(kTransB));
}

template <int N, int kTransB>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 8][4], const uint32_t (&a)[4],
                                           uint64_t desc_b, int accumulate) {
  if constexpr (N == 32) wgmma_n32<kTransB>(d, a, desc_b, accumulate);
  else if constexpr (N == 64) wgmma_n64<kTransB>(d, a, desc_b, accumulate);
  else if constexpr (N == 96) wgmma_n96<kTransB>(d, a, desc_b, accumulate);
  else wgmma_n128<kTransB>(d, a, desc_b, accumulate);
}

// The per-element causal / window / kv_len mask of one warp's scores.
template <int NJ>
__device__ __forceinline__ void mask_scores(float (&s)[NJ][4], int k0, const int (&pos)[2],
                                            int kv_end, int causal, int window, int tig) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1;
      const int key = k0 + j * 8 + 2 * tig + (e & 1);
      bool keep = key < kv_end;
      if (causal) keep = keep && key <= pos[i];
      if (window > 0) keep = keep && key > pos[i] - window;
      if (!keep) s[j][e] = kNegInf;
    }
  }
}

// The online-softmax update of one warp's 16 rows in log2 units,
// p = 2^(s * scale_log2 - m * scale_log2): m is the running max of the raw
// scores, l a per-thread partial sum, acc rescaled; returns P as the A
// fragments of P V (the score C fragments of two n-tiles form one).
template <int NJ, int NT>
__device__ __forceinline__ void softmax_step(float (&s)[NJ][4], float (&m)[2], float (&l)[2],
                                             float (&acc)[NT][4], float scale_log2,
                                             uint32_t (&pa)[NJ / 2][4]) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
  }
  float corr[2], msc[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    corr[i] = exp2_approx((m[i] - mx[i]) * scale_log2);
    m[i] = mx[i];
    // a row with every key so far masked keeps its sum at 0 (-1e30 * scale
    // cannot be cancelled exactly inside one FFMA)
    msc[i] = mx[i] == kNegInf ? 0.f : mx[i] * scale_log2;
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float pe = exp2_approx(fmaf(s[j][e], scale_log2, -msc[e >> 1]));
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
#pragma unroll
  for (int kt = 0; kt < NJ / 2; ++kt) {
    pa[kt][0] = kj::pack_bf16(s[2 * kt][0], s[2 * kt][1]);
    pa[kt][1] = kj::pack_bf16(s[2 * kt][2], s[2 * kt][3]);
    pa[kt][2] = kj::pack_bf16(s[2 * kt + 1][0], s[2 * kt + 1][1]);
    pa[kt][3] = kj::pack_bf16(s[2 * kt + 1][2], s[2 * kt + 1][3]);
  }
}

// One tile [k0, k0 + kBK) of K/V in shared memory against the warpgroup's 64
// rows: S = Q K^T as D/16 products of m64n64k16 (K k-major), the warp's mask
// (edge tiles only), the softmax update, then acc += P V as kBK/16 products of
// m64nDk16 (V n-major).
template <int D>
__device__ __forceinline__ void attend_tile(const __nv_bfloat16* ks, const __nv_bfloat16* vs,
                                            const uint32_t (&qa)[D / 16][4],
                                            float (&acc)[D / 8][4], float (&m)[2],
                                            float (&l)[2], bool mask, int k0,
                                            const int (&pos)[2], int kv_end, int causal,
                                            int window, float scale_log2, int tig) {
  constexpr int NJ = kBK / 8;
  const uint32_t kb = kj::smem_addr(ks);
  const uint32_t vb = kj::smem_addr(vs);
  float s[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  }
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    // k-step kk: 32 bytes of column block kk / 4 (the swizzle is applied to
    // the address, so the start moves by whole chunks)
    wgmma_bf16<kBK, 0>(s, qa[kk], gmma_desc(kb + (kk / 4) * kBK * 128 + (kk % 4) * 32, 16,
                                            1024), kk);
  }
  wg_commit_wait();
  fence_regs(s);
  if (mask) mask_scores(s, k0, pos, kv_end, causal, window, tig);
  uint32_t pa[NJ / 2][4];
  softmax_step(s, m, l, acc, scale_log2, pa);
  fence_regs(acc);
  wg_fence();
#pragma unroll
  for (int kt = 0; kt < kBK / 16; ++kt) {
    // keys 16 kt .. 16 kt + 15: two 8-row groups of every column block
    wgmma_bf16<D, 1>(acc, pa[kt], gmma_desc(vb + kt * 2048, kBK * 128, 1024), 1);
  }
  wg_commit_wait();
  fence_regs(acc);
}

// at D = 96 the register cap (<= 170) lets a third block share the SM
template <int D>
__global__ void __launch_bounds__(kThreads, D == 96 ? 3 : 1)
    flash_fwd_kernel(const FlashParams p) {
  constexpr int KS = D / 16;         // k-steps of Q K^T
  constexpr int NT = D / 8;          // n-tiles of the output
  constexpr int kElems = Tile<D>::kElems;
  extern __shared__ __align__(1024) unsigned char smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);   // [kStages][kElems]
  __nv_bfloat16* Vs = Ks + kStages * kElems;

  const int G = p.H / p.Hkv;
  const int rows = G * p.S;
  // heaviest first: under causal the last row blocks attend the most keys
  const int rb = p.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int r0 = rb * kBQ;
  const int b = blockIdx.x / p.Hkv;
  const int hkv = blockIdx.x % p.Hkv;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gid = lane / 4;
  const int tig = lane % 4;

  // the K/V range the block needs: left edge of the window to the causal
  // diagonal of its last row, bounded by kv_len and T
  const int kv_end = min(p.kv_len, p.T);
  const int last_row = min(r0 + kBQ, rows) - 1;
  int k_hi = kv_end;
  if (p.causal) k_hi = min(k_hi, p.q_offset + last_row / G + 1);
  int k_lo = 0;
  if (p.window > 0) k_lo = max(0, p.q_offset + r0 / G - p.window + 1);
  k_lo = (k_lo / kBK) * kBK;
  const int ntiles = k_hi > k_lo ? (k_hi - k_lo + kBK - 1) / kBK : 0;

  const __nv_bfloat16* kbase = p.k + b * p.k_sb + hkv * p.k_sh;
  const __nv_bfloat16* vbase = p.v + b * p.v_sb + hkv * p.v_sh;
  const int64_t k_ss = p.k_ss, v_ss = p.v_ss;
  // tile t of the range into ring stage `stage`, 16-byte copies to their
  // swizzled places; keys past kv_end are zero-filled from a valid address
  // (row 0)
  auto load_tile = [&](int t, int stage) {
    constexpr int VPR = D / 8;
    static_assert(kBK * VPR % kThreads == 0, "whole copies per thread");
    const int k0 = k_lo + t * kBK;
    __nv_bfloat16* ks = Ks + stage * kElems;
    __nv_bfloat16* vs = Vs + stage * kElems;
#pragma unroll
    for (int it = 0; it < kBK * VPR / kThreads; ++it) {
      const int idx = it * kThreads + threadIdx.x;
      const int rr = idx / VPR;
      const int cc = (idx % VPR) * 8;
      const int dst = (cc / 64) * kBK * 64 + rr * 64 + (((cc % 64) / 8) ^ (rr % 8)) * 8;
      const bool in = k0 + rr < kv_end;
      const int64_t key = in ? k0 + rr : 0;
      kj::cp_async16(ks + dst, kbase + key * k_ss + cc, in);
      kj::cp_async16(vs + dst, vbase + key * v_ss + cc, in);
    }
  };
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < ntiles) load_tile(st, st);
    kj::cp_async_commit();
  }

  // this thread's two rows (gid and gid + 8 of the warp's 16)
  const int wr0 = r0 + warp * 16;
  bool valid[2];
  int pos[2];
  int64_t qoff[2], ooff[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = wr0 + gid + 8 * i;
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

  // the keys every row of this warp keeps: [full_lo, full_hi)
  const int wpos_lo = p.q_offset + wr0 / G;
  const int wpos_hi = p.q_offset + (min(wr0 + 16, rows) - 1) / G;
  int full_hi = kv_end;
  if (p.causal) full_hi = min(full_hi, wpos_lo + 1);
  const int full_lo = p.window > 0 ? wpos_hi - p.window + 1 : 0;

  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  }

  for (int t = 0; t < ntiles; ++t) {
    // tile t has landed for every thread, and every warp is done with the
    // stage that tile t + kStages - 1 overwrites
    kj::cp_async_wait<kStages - 2>();
    fence_proxy_async();
    __syncthreads();
    if (t + kStages - 1 < ntiles) load_tile(t + kStages - 1, (t + kStages - 1) % kStages);
    kj::cp_async_commit();

    // the warpgroup's products take every warp, whatever its own rows need
    const int k0 = k_lo + t * kBK;
    const bool interior = k0 >= full_lo && k0 + kBK <= full_hi;
    attend_tile<D>(Ks + (t % kStages) * kElems, Vs + (t % kStages) * kElems, qa, acc, m, l,
                   !interior, k0, pos, kv_end, p.causal, p.window, p.scale_log2, tig);
  }
  kj::cp_async_wait<0>();

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
  constexpr int kSmem = Tile<D>::kSmem;
  // above 48 KB a block's dynamic shared memory must be asked for, once
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return attr;
  const int rows = (p.H / p.Hkv) * p.S;
  const dim3 grid(B * p.Hkv, (rows + kBQ - 1) / kBQ);
  flash_fwd_kernel<D><<<grid, kThreads, kSmem, stream>>>(p);
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
    case 96: return launch<96>(p, B, st);
    case 128: return launch<128>(p, B, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
