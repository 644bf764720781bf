// Flash attention forward for Hopper (sm_90a) in f32: f32 q/k/v/o, f32
// softmax state, both products on the tensor cores as 3xTF32 wgmma.
//
// Replaces kjarni_tpu/ops/pallas/flash_attention.py::flash_attention (body
// _flash_kernel) at the other dtype the Pallas kernel takes: f32 in, f32 out.
// Same function as csrc/flash_attention.cu (the bf16 kernel): online-softmax
// attention of q [B,H,S,D] over k/v [B,Hkv,T,D], optional causal mask and
// sliding window, queries at absolute positions q_offset.. over the K/V
// prefix kv_len; masked scores are -1e30 as in the Pallas kernel. D is 32,
// 64, 96 or 128.
//
// f32 accuracy from TF32 products. f32 is the port's parity mode, so the
// output must stay within 1e-5 of the largest output of the plain f32
// version. One TF32 product keeps 11 significant bits of each operand and
// misses that by ~40x. Each f32 operand x is split as big = tf32_rna(x) and
// small = tf32_rna(x - big) (x - big is exact in f32, |small| <= 2^-12 |x|),
// and a product is summed as small*big + big*small + big*big in the f32
// accumulators, the small terms first: what is dropped (small*small and the
// rounding of small) is ~2^-22 of |a||b|, against f32's 2^-24. P V sums one
// tile per tensor-core chain and adds it to the output accumulator in f32
// (see attend_tile). On the H100 the kernel stays within 0.25 of the bound
// at chip_smoke.py's f32 shapes; the same kernel with the small parts zeroed
// (kj_flash_attention_f32_tf32only, a control for the tests) falls 35-55x
// outside it, as tests/test_torch_tf32_split.py's emulation predicts. The
// split is the kernel's own, so torch.backends.cuda.matmul.allow_tf32 does
// not reach it and its accuracy does not depend on it.
//
// What bounds it on the H100: at a long prefill the work is 4*S*T*D*H flops
// (halved by the causal band) against (q,k,v,o) bytes read once, ~205 flops
// per f32 byte at S=T=1024, D=64. Three TF32 products at 495 TFLOP/s give a
// bound 2.5x below the 66.9 TFLOP/s of f32 FFMA (0.026 against 0.064 ms at
// the Llama-1B prefill); the tensor cores, shared memory (the split copies,
// the wgmma operand reads) and the exp2 unit share the rest. The design:
//   * one block = one warpgroup (4 warps) of 64 query rows, 16 per warp,
//     with GQA folded into the rows (rows s*G + g of one KV head) as in the
//     bf16 kernel, so one K/V tile serves all G query heads; under causal
//     the row blocks run heaviest first;
//   * S = Q K^T and acc += P V as wgmma m64nNk8 .tf32 products. Q is split
//     once into big and small A fragments kept in registers (D <= 96), or in
//     swizzled shared memory at D = 128, where its registers would spill;
//   * K/V tiles (64 keys at D <= 64, 32 above, to fit shared memory) land
//     raw through cp.async, tile j+1 in flight while tile j is multiplied.
//     All 128 threads then split each landed tile once: K into big and small
//     copies in the 128-byte-swizzled K-major layout that wgmma reads; V, as
//     tf32 has no transposed B operand, into V^T big and small copies (keys
//     contiguous), 16-byte loads and conflict-free 4-byte stores;
//   * P never leaves registers: the f32 score accumulator holds keys
//     {2t, 2t+1} of each group of 8 where a TF32 A fragment wants {t, t+4},
//     so V^T stores key k of each group at position k/2 + 4(k%2) and P's
//     fragments are the score registers as they are, split in place;
//   * each warp sorts its tiles into interior ones (no mask) and edge ones
//     (the per-element causal / window / kv_len mask); the softmax scale is
//     folded into the exp2 argument.
// A grid of fewer blocks than the card's block places (B * Hkv * row blocks
// below 132 SMs x blocks per SM) leaves SMs idle: the port's f32 callers
// launch none such (the Llama prefill takes flash at 512 keys and more), so
// the kernel has no split of the key range.
// Rows whose every key is masked (none on the generation path) give zeros,
// as in the bf16 kernel.
#include "mma.cuh"

namespace {

constexpr int kBQ = 64;        // query rows per block: one warpgroup, 16 per warp
constexpr int kThreads = 128;
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
struct Cfg {
  static constexpr int kBK = D <= 64 ? 64 : 32;   // keys per K/V tile
  static constexpr bool kQSmem = D == 128;        // Q's halves in shared memory
  static constexpr int kTile = kBK * D;           // floats of one K or V tile
  static constexpr int kVStride = D + 4;          // floats per raw V row
  static constexpr int kQ = kQSmem ? kBQ * D : 0;
  // K big, K small, V^T big, V^T small, raw K (swizzled; 1024-byte
  // multiples), Q big and small (D = 128), raw V [kBK][kVStride]
  static constexpr int kSmem = (5 * kTile + 2 * kQ + kBK * kVStride) * 4;
};

// float offset of (r, c) in a K-major tile of R rows: column blocks of 32
// floats (128 bytes), each [R][32], the 16-byte chunk j of row r stored at
// chunk j ^ (r % 8), as wgmma's 128-byte swizzle mode reads it
template <int R>
__device__ __forceinline__ int swz(int r, int c) {
  return (c / 32) * R * 32 + r * 32 + ((((c % 32) / 4) ^ (r % 8)) * 4) + (c % 4);
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(y) : "f"(x));
  return y;
}
// x = big + small to ~2^-22 of |x|; x - big is exact in f32. kThree false:
// small = 0, so every product below runs as big * big alone (the TF32-only
// control, through the same code as the kernel)
template <bool kThree>
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = tf32_rna(x);
  small = kThree ? tf32_rna(x - __uint_as_float(big)) : 0u;
}

// ---- wgmma (warpgroup products, B from shared memory) ----

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
// the threads' writes to shared memory, made visible to wgmma's (async proxy) reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// matrix descriptor, 128-byte swizzle, K-major: start address; sbo, the
// byte offset between 8-row groups (1024); lbo is not read in this mode
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(16 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// d[64 x N] (+)= a[64 x 8] * B[8 x N] in TF32: a in registers, each warp's 16
// rows as a0 = (g, t), a1 = (g+8, t), a2 = (g, t+4), a3 = (g+8, t+4) with
// g = lane / 4, t = lane % 4; B K-major through its descriptor; accumulate
// = 0 overwrites d, whose per-warp layout is mma.sync's C fragments
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[4][4], const uint32_t (&a)[4],
                                              uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[8][4], const uint32_t (&a)[4],
                                              uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs_n96(float (&d)[12][4], const uint32_t (&a)[4],
                                              uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[16][4], const uint32_t (&a)[4],
                                              uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
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

// the same with A through its descriptor too (Q at D = 128), K-major
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[4][4], uint64_t desc_a,
                                              uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 8][4], const uint32_t (&a)[4],
                                         uint64_t desc_b, int accumulate) {
  if constexpr (N == 32) wgmma_rs_n32(d, a, desc_b, accumulate);
  else if constexpr (N == 64) wgmma_rs_n64(d, a, desc_b, accumulate);
  else if constexpr (N == 96) wgmma_rs_n96(d, a, desc_b, accumulate);
  else wgmma_rs_n128(d, a, desc_b, accumulate);
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
// scores, l a per-thread partial sum, acc rescaled; s becomes p.
template <int NJ, int NT>
__device__ __forceinline__ void softmax_step(float (&s)[NJ][4], float (&m)[2], float (&l)[2],
                                             float (&acc)[NT][4], float scale_log2) {
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
    corr[i] = exp2f((m[i] - mx[i]) * scale_log2);
    m[i] = mx[i];
    // a row with every key so far masked keeps its sum at 0
    msc[i] = mx[i] == kNegInf ? 0.f : mx[i] * scale_log2;
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float pe = exp2f(fmaf(s[j][e], scale_log2, -msc[e >> 1]));
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
}

// Q's A operand for S = Q K^T: split fragments in registers (D <= 96), or
// descriptors of its swizzled big and small copies in shared memory (D = 128)
template <int D>
struct QOperand {
  static constexpr int kFrags = Cfg<D>::kQSmem ? 1 : D / 8;
  uint32_t big[kFrags][4], small[kFrags][4];
  uint32_t big_addr, small_addr;
};

// The descriptor of the tile at shared address `addr`, computed where it is
// used: the address is made opaque first, so the compiler cannot hoist a
// tile's 24-96 descriptors (two registers each) out of the K/V loop, where
// they would stay live beside Q, the accumulators and P.
__device__ __forceinline__ uint64_t desc_at(uint32_t addr) {
  asm volatile("" : "+r"(addr));
  return gmma_desc(addr);
}

// One tile [k0, k0 + kBK) of split K / V^T in shared memory against the
// warpgroup's 64 rows: S = Q K^T as D/8 k-steps of m64n(kBK)k8 per product,
// the warp's mask (edge tiles only), the softmax update, then P V as kBK/8
// k-steps of m64nDk8 per product into a fresh accumulator, added to acc in
// f32. The tensor cores' f32 sums are less exact than FFMA's: on the H100
// one chain across every tile of a long key range drifted toward the 1e-5
// bound at the follow-up's cache-reuse shape (28 tiles); with a chain per
// tile chip_smoke.py reads 0.14 of it there.
// The three products of the split run small terms first; under !kThree (the
// control) P's small part is zero like the others'.
template <int D, bool kThree>
__device__ __forceinline__ void attend_tile(uint32_t kb, uint32_t ks, uint32_t vb,
                                            uint32_t vs, const QOperand<D>& q,
                                            float (&acc)[D / 8][4], float (&m)[2],
                                            float (&l)[2], bool mask, int k0,
                                            const int (&pos)[2], int kv_end, int causal,
                                            int window, float scale_log2, int tig) {
  constexpr int BK = Cfg<D>::kBK;
  constexpr int NJ = BK / 8;
  constexpr int KS = D / 8;
  constexpr int NT = D / 8;
  // k-step kk of K (d = 8kk..8kk+7) and of Q: 32 bytes of column block kk / 4
  auto kdesc = [](uint32_t base, int kk) {
    return desc_at(base + (kk / 4) * BK * 128 + (kk % 4) * 32);
  };
  auto qdesc = [](uint32_t base, int kk) {
    return desc_at(base + (kk / 4) * kBQ * 128 + (kk % 4) * 32);
  };
  // k-step kt of V^T (keys 8kt..8kt+7): column block kt / 4 of D rows
  auto vdesc = [](uint32_t base, int kt) {
    return desc_at(base + (kt / 4) * D * 128 + (kt % 4) * 32);
  };
  float s[NJ][4];
  wg_fence();
  if constexpr (Cfg<D>::kQSmem) {
    static_assert(BK == 32, "the shared-memory Q operand is instantiated at n32");
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) wgmma_ss_n32(s, qdesc(q.small_addr, kk), kdesc(kb, kk), kk);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) wgmma_ss_n32(s, qdesc(q.big_addr, kk), kdesc(ks, kk), 1);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) wgmma_ss_n32(s, qdesc(q.big_addr, kk), kdesc(kb, kk), 1);
  } else {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) wgmma_rs<BK>(s, q.small[kk], kdesc(kb, kk), kk);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) wgmma_rs<BK>(s, q.big[kk], kdesc(ks, kk), 1);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) wgmma_rs<BK>(s, q.big[kk], kdesc(kb, kk), 1);
  }
  wg_commit_wait();
  fence_regs(s);
  if (mask) mask_scores(s, k0, pos, kv_end, causal, window, tig);
  softmax_step(s, m, l, acc, scale_log2);
  // P's A fragments of key step j are its score registers as they stand:
  // (row g, key 2t) at k position t, (row g, key 2t+1) at t + 4, which is
  // where V^T holds those keys
  uint32_t pb[NJ][4], ps[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int a = (e >> 1) | ((e & 1) << 1);    // e = 0, 1, 2, 3 -> a0, a2, a1, a3
      split_tf32<kThree>(s[j][e], pb[j][a], ps[j][a]);
    }
  }
  float o[NT][4];
  wg_fence();
#pragma unroll
  for (int kt = 0; kt < NJ; ++kt) wgmma_rs<D>(o, ps[kt], vdesc(vb, kt), kt);
#pragma unroll
  for (int kt = 0; kt < NJ; ++kt) wgmma_rs<D>(o, pb[kt], vdesc(vs, kt), 1);
#pragma unroll
  for (int kt = 0; kt < NJ; ++kt) wgmma_rs<D>(o, pb[kt], vdesc(vb, kt), 1);
  wg_commit_wait();
  fence_regs(o);
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += o[n][e];
  }
}

// at D = 128 Q's halves take 64 KB of shared memory: one block per SM
template <int D, bool kThree>
__global__ void __launch_bounds__(kThreads, D == 128 ? 1 : 2)
    flash_f32_kernel(const FlashParams p) {
  using C = Cfg<D>;
  constexpr int BK = C::kBK;
  constexpr int NT = D / 8;          // n-tiles of the output
  constexpr int VEC = D / 4;         // 16-byte chunks per row
  extern __shared__ __align__(1024) unsigned char smem[];
  float* Kb = reinterpret_cast<float*>(smem);
  float* Ks = Kb + C::kTile;
  float* Vb = Ks + C::kTile;
  float* Vs = Vb + C::kTile;
  float* Kraw = Vs + C::kTile;
  float* Qb = Kraw + C::kTile;
  float* Qs = Qb + C::kQ;
  float* Vraw = Qs + C::kQ;

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

  // the K/V range the row block needs: left edge of the window to the causal
  // diagonal of its last row, bounded by kv_len and T
  const int kv_end = min(p.kv_len, p.T);
  const int last_row = min(r0 + kBQ, rows) - 1;
  int k_hi = kv_end;
  if (p.causal) k_hi = min(k_hi, p.q_offset + last_row / G + 1);
  int k_lo = 0;
  if (p.window > 0) k_lo = max(0, p.q_offset + r0 / G - p.window + 1);
  k_lo = (k_lo / BK) * BK;
  const int ntiles = k_hi > k_lo ? (k_hi - k_lo + BK - 1) / BK : 0;

  const float* kbase = p.k + b * p.k_sb + hkv * p.k_sh;
  const float* vbase = p.v + b * p.v_sb + hkv * p.v_sh;
  // Each thread's places in a tile's copies and splits are the same for
  // every tile, and each step of a loop below moves them by a constant: they
  // are a few bases plus immediates, not dozens of offsets that the compiler
  // would hoist out of the K/V loop into registers (where they spilled at
  // D = 64).
  //   copies: 16-byte chunk column lcol of rows lrow + it * kLoadRows, the
  //   rows a step moves a power of two (at D = 96, 96 of the 128 threads copy);
  constexpr int kLoadRows = kThreads / VEC >= 16 ? 16 : kThreads / VEC >= 8 ? 8 : 4;
  constexpr int kLoadSteps = BK / kLoadRows;
  const int lrow = threadIdx.x / VEC;
  const int lcol = (threadIdx.x % VEC) * 4;
  const bool loader = threadIdx.x < kLoadRows * VEC;
  //   the V split: key vkey, V^T rows vrow + e + it * kVRows;
  static_assert(kThreads % BK == 0 && 4 * (kThreads / BK) % 8 == 0,
                "a V split step keeps each row's swizzle phase");
  constexpr int kVRows = 4 * (kThreads / BK);         // V^T rows a step moves down
  const int vkey = threadIdx.x % BK;
  const int vrow = 4 * (threadIdx.x / BK);
  const int vraw = vkey * C::kVStride + vrow;
  int vt[4];
  {
    // key k of a group of 8 goes to position k / 2 + 4 (k % 2)
    const int c = (vkey & ~7) | ((vkey & 7) >> 1) | ((vkey & 1) << 2);
#pragma unroll
    for (int e = 0; e < 4; ++e) vt[e] = swz<D>(vrow + e, c);
  }
  // tile t's raw copies: K to its swizzled places, V to padded rows; keys
  // past kv_end are zero-filled from a valid address (key 0)
  auto load_tile = [&](int t) {
    const int k0 = k_lo + t * BK + lrow;
    const float* ksrc = kbase + (int64_t)k0 * p.k_ss + lcol;
    const float* vsrc = vbase + (int64_t)k0 * p.v_ss + lcol;
#pragma unroll
    for (int it = 0; it < kLoadSteps; ++it) {
      const int rr = lrow + it * kLoadRows;
      if (!loader) continue;
      const bool in = k0 + it * kLoadRows < kv_end;
      const int64_t step = (int64_t)it * kLoadRows;
      kj::cp_async16(Kraw + swz<BK>(rr, lcol), in ? ksrc + step * p.k_ss : kbase, in);
      kj::cp_async16(Vraw + rr * C::kVStride + lcol, in ? vsrc + step * p.v_ss : vbase, in);
    }
  };
  if (ntiles > 0) load_tile(0);
  kj::cp_async_commit();

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

  // Q, split once for the whole K/V loop; rows past the end as zeros
  QOperand<D> q;
  if constexpr (C::kQSmem) {
    for (int idx = threadIdx.x; idx < kBQ * VEC; idx += kThreads) {
      const int rr = idx / VEC;
      const int cc = (idx % VEC) * 4;
      const int r = r0 + rr;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < rows) {
        const int s = r / G;
        const int h = hkv * G + r % G;
        x = *reinterpret_cast<const float4*>(p.q + b * p.q_sb + h * p.q_sh + s * p.q_ss + cc);
      }
      uint4 hi, lo;
      split_tf32<kThree>(x.x, hi.x, lo.x);
      split_tf32<kThree>(x.y, hi.y, lo.y);
      split_tf32<kThree>(x.z, hi.z, lo.z);
      split_tf32<kThree>(x.w, hi.w, lo.w);
      *reinterpret_cast<uint4*>(Qb + swz<kBQ>(rr, cc)) = hi;
      *reinterpret_cast<uint4*>(Qs + swz<kBQ>(rr, cc)) = lo;
    }
    // made visible to wgmma by the loop's first proxy fence and barrier
    q.big_addr = kj::smem_addr(Qb);
    q.small_addr = kj::smem_addr(Qs);
  } else {
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float x = valid[i] ? p.q[qoff[i] + kk * 8 + tig + 4 * half] : 0.f;
          split_tf32<kThree>(x, q.big[kk][i + 2 * half], q.small[kk][i + 2 * half]);
        }
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

  const uint32_t kb = kj::smem_addr(Kb), ks = kj::smem_addr(Ks);
  const uint32_t vb = kj::smem_addr(Vb), vs = kj::smem_addr(Vs);
  for (int t = 0; t < ntiles; ++t) {
    // tile t has landed for every thread, and every warp is done with the
    // split copies of tile t - 1
    kj::cp_async_wait<0>();
    __syncthreads();
    // split K into big and small copies in raw K's own swizzled layout:
    // 16-byte loads and stores
#pragma unroll
    for (int it = 0; it < C::kTile / 4 / kThreads; ++it) {
      const int off = (it * kThreads + threadIdx.x) * 4;
      const float4 x = *reinterpret_cast<const float4*>(Kraw + off);
      uint4 hi, lo;
      split_tf32<kThree>(x.x, hi.x, lo.x);
      split_tf32<kThree>(x.y, hi.y, lo.y);
      split_tf32<kThree>(x.z, hi.z, lo.z);
      split_tf32<kThree>(x.w, hi.w, lo.w);
      *reinterpret_cast<uint4*>(Kb + off) = hi;
      *reinterpret_cast<uint4*>(Ks + off) = lo;
    }
    // split V into V^T: a warp takes 32 consecutive keys of one 4-column
    // chunk, so each of its stores fills one 128-byte row of V^T
#pragma unroll
    for (int it = 0; it < D / kVRows; ++it) {
      const float4 x = *reinterpret_cast<const float4*>(Vraw + vraw + it * kVRows);
      const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int off = vt[e] + it * kVRows * 32;
        uint32_t hi, lo;
        split_tf32<kThree>(xs[e], hi, lo);
        reinterpret_cast<uint32_t*>(Vb)[off] = hi;
        reinterpret_cast<uint32_t*>(Vs)[off] = lo;
      }
    }
    fence_proxy_async();
    __syncthreads();
    // the raw buffers are free: tile t + 1 lands while tile t is multiplied
    if (t + 1 < ntiles) load_tile(t + 1);
    kj::cp_async_commit();

    // the warpgroup's products take every warp, whatever its own rows need
    const int k0 = k_lo + t * BK;
    const bool interior = k0 >= full_lo && k0 + BK <= full_hi;
    attend_tile<D, kThree>(kb, ks, vb, vs, q, acc, m, l, !interior, k0, pos, kv_end,
                           p.causal, p.window, p.scale_log2, tig);
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
      *reinterpret_cast<float2*>(p.o + ooff[i] + n * 8 + 2 * tig) =
          make_float2(acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
    }
  }
}

template <int D, bool kThree>
cudaError_t launch(FlashParams p, int B, cudaStream_t stream) {
  constexpr int kSmem = Cfg<D>::kSmem;
  // above 48 KB a block's dynamic shared memory must be asked for, once
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_f32_kernel<D, kThree>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return attr;
  const int rows = (p.H / p.Hkv) * p.S;
  const int row_blocks = (rows + kBQ - 1) / kBQ;
  flash_f32_kernel<D, kThree><<<dim3(B * p.Hkv, row_blocks), kThreads, kSmem, stream>>>(p);
  return cudaGetLastError();
}

template <bool kThree>
int run(const void* q, const void* k, const void* v, void* o, const int64_t* strides, int B,
        int H, int Hkv, int S, int T, int D, int q_offset, int kv_len, int causal, int window,
        float scale, void* stream) {
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
    case 32: return launch<32, kThree>(p, B, st);
    case 64: return launch<64, kThree>(p, B, st);
    case 96: return launch<96, kThree>(p, B, st);
    case 128: return launch<128, kThree>(p, B, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// strides: 12 int64 element strides (b, h, s) of q, k, v, o in that order.
// Returns a cudaError_t; 0 means the launch was accepted.
extern "C" int kj_flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                                      const int64_t* strides, int B, int H, int Hkv, int S,
                                      int T, int D, int q_offset, int kv_len, int causal,
                                      int window, float scale, void* stream) {
  return run<true>(q, k, v, o, strides, B, H, Hkv, S, T, D, q_offset, kv_len, causal, window,
                   scale, stream);
}

// The same kernel with the small terms dropped: one TF32 product each. A
// control for the tests and chip_smoke.py, which must fall outside the f32
// kernel's bound; nothing else calls it.
extern "C" int kj_flash_attention_f32_tf32only(const void* q, const void* k, const void* v,
                                               void* o, const int64_t* strides, int B,
                                               int H, int Hkv, int S, int T, int D,
                                               int q_offset, int kv_len, int causal,
                                               int window, float scale, void* stream) {
  return run<false>(q, k, v, o, strides, B, H, Hkv, S, T, D, q_offset, kv_len, causal,
                    window, scale, stream);
}
