// Warp-level bf16 tensor-core and cp.async helpers shared by the port's kernels.
//
// mma.sync m16n8k16 (bf16 in, f32 accumulate). Fragment layout, with
// gid = lane / 4 and tig = lane % 4 (PTX ISA, "Matrix Fragments for mma.m16n8k16"):
//   A (16x16, row-major): a0 = A[gid][2tig..2tig+1]     a1 = A[gid+8][2tig..2tig+1]
//                         a2 = A[gid][2tig+8..2tig+9]   a3 = A[gid+8][2tig+8..2tig+9]
//   B (16x8, "col"):      b0 = B[2tig..2tig+1][gid]     b1 = B[2tig+8..2tig+9][gid]
//   C (16x8, f32):        c0,c1 = C[gid][2tig..2tig+1]  c2,c3 = C[gid+8][2tig..2tig+1]
// Each 32-bit register holds two bf16, the lower index in the low half.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace kj {

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> two bf16 (round to nearest even), `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !pred (src is then not read,
// but must still be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace kj

// Each kernel source is its own shared library and includes this header once.
extern "C" const char* kj_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
