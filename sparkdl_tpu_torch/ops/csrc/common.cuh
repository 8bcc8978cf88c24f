// Device helpers shared by the port's Hopper kernels (sepconv.cu,
// sepconv_tiled.cu, mbconv.cu): bf16 packing and ReLU, the epilogues' quad
// transpose, 16-byte cp.async copies, ldmatrix and the m16n8k16 bf16
// tensor-core product (wgmma.cuh holds
// Hopper's warpgroup product).  Each kernel file is
// compiled into its own library, so everything here has internal linkage.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_SMEM = 232448;  // shared memory a block may use on sm_90

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16x2(uint32_t w) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}

__device__ __forceinline__ uint32_t relu_bf16x2(uint32_t w) {
  __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&w);
  v = __hmax2(v, __float2bfloat162_rn(0.f));
  return *reinterpret_cast<uint32_t*>(&v);
}

// The epilogues' quad transpose.  In the m16n8 accumulator layout the four
// lanes of a quad (t4 = lane % 4) hold two columns each of an 8-column
// block of a row.  Given this lane's bf16 pairs of four consecutive blocks
// (v[j]: block j), returns all eight columns of block t4 (three shuffles
// within the quad), so each lane stores 16 bytes: in round r lane t4 sends
// its pair of block t4^r and gets lane t4^r's pair of block t4.
__device__ __forceinline__ uint4 quad_transpose(const uint32_t (&v)[4],
                                                int t4) {
  auto pick = [](const uint32_t (&a)[4], int i) {
    return i == 0 ? a[0] : i == 1 ? a[1] : i == 2 ? a[2] : a[3];
  };
  uint32_t u[4];
  u[0] = pick(v, t4);
#pragma unroll
  for (int r = 1; r < 4; ++r)
    u[r] = __shfl_xor_sync(0xffffffffu, pick(v, t4 ^ r), r);
  return make_uint4(pick(u, t4), pick(u, t4 ^ 1), pick(u, t4 ^ 2),
                    pick(u, t4 ^ 3));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Waits until at most PENDING of this thread's committed groups are in flight.
template <int PENDING>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// Two 16(k) x 8(n) B tiles (n and n+8) from a row-major [k][n] tile.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// One 16(k) x 8(n) B tile from a row-major [k][n] tile; lanes 0-15 give
// the row addresses (k = lane), the others are ignored.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t* r,
                                                  const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(s));
}

__device__ __forceinline__ void mma_16816(float* d, const uint32_t* a,
                                          const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

}  // namespace
