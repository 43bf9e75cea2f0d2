// Building blocks of the bf16 tensor-core kernels (nin_head.cu's K2 and
// nin_head_bwd.cu's K3), sm_90a: mma.sync m16n8k16 (bf16 in, fp32
// accumulate), ldmatrix, cp.async, bf16 packing, and 16-byte row stores
// from shared memory.
//
// Fragment layouts (mma.sync.m16n8k16.row.col): A (16x16) is 4 registers:
// (row lane/4, columns 2(lane%4)+{0,1}), then row+8, then column+8, then
// both; B (16x8, column-major) is 2 registers: (k 2(lane%4)+{0,1}, n
// lane/4), then k+8; C/D is 4 floats: (row lane/4, column 2(lane%4)+{0,1}),
// then row+8. Every ldmatrix row address must be 16-byte aligned: shared
// rows are padded to 16n+8 bf16, which also keeps ldmatrix's 8 row
// addresses in 8 distinct banks.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ssdn_tc {

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// ldmatrix: lanes 8i..8i+7 give the row addresses of 8x8 matrix i; thread t
// receives row t/4, columns 2(t%4), 2(t%4)+1 of each (with .trans: column
// t/4, rows 2(t%4), 2(t%4)+1).
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)) : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)) : "memory");
}
__device__ __forceinline__ void ldsm_x2(unsigned (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(smem_u32(p)) : "memory");
}
__device__ __forceinline__ void ldsm_x2_t(unsigned (&r)[2], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1]) : "r"(smem_u32(p)) : "memory");
}

// d += a b: a the 16x16 row-major A fragment, b the 16x8 column-major B
// fragment, d the 16x8 fp32 tile (d[2h+e] at row lane/4 + 8h, column
// 2(lane%4) + e).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_u32(smem)), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void zero16(void* smem) {
  *reinterpret_cast<uint4*>(smem) = make_uint4(0u, 0u, 0u, 0u);
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  bf162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}
__device__ __forceinline__ float2 unpack_bf16(unsigned v) {
  return __bfloat1622float2(*reinterpret_cast<bf162*>(&v));
}

// rows r0.. of a (., width) array <- the first `rows` rows of a shared tile
// with row stride ld, in 16-byte pieces (width a multiple of 8)
__device__ __forceinline__ void store_rows(bf16* dst, int width,
                                           const bf16* src, int ld, int rows,
                                           long long r0) {
  const int w8 = width / 8;
  for (int e = threadIdx.x; e < rows * w8; e += blockDim.x) {
    const int r = e / w8, c8 = e - r * w8;
    *reinterpret_cast<uint4*>(dst + (r0 + r) * width + c8 * 8) =
        *reinterpret_cast<const uint4*>(src + r * ld + c8 * 8);
  }
}

}  // namespace ssdn_tc
