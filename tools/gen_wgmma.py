"""Write ``sparkdl_tpu_torch/ops/csrc/wgmma.cuh``: Hopper's warpgroup
matrix product (``wgmma.mma_async``) with A and B from shared memory,
for the N widths the port's kernels instantiate.

    python3 tools/gen_wgmma.py

One ``wgmma.mma_async`` names every accumulator register of the
warpgroup's 64xN tile (N/2 floats a thread), so each N is its own inline
assembly; this script writes them out.  Edit the widths here, not the
header.
"""

from pathlib import Path

WIDTHS = (64, 96, 128)  # wgmma N (a multiple of 8, at most 256)
OUT = (Path(__file__).resolve().parents[1] / "sparkdl_tpu_torch" / "ops"
       / "csrc" / "wgmma.cuh")

HEAD = """\
// Hopper warpgroup matrix product (wgmma) for the port's kernels.
// Generated by tools/gen_wgmma.py; edit that script, not this file.
//
// wgmma_ss<N>(d, desc_a, desc_b, accumulate): D[64 x N] (+)= A[64 x 16] *
// B[16 x N], bf16 inputs, f32 accumulators, issued by the four warps of a
// warpgroup, both operands from shared memory through descriptors
// (wgmma_desc), no swizzle, in 8x8 core matrices of 128 contiguous bytes:
//   * A K-major (K contiguous): a core matrix is 8 rows (m) of 8 k, one
//     16-byte row per m;
//   * B MN-major (N contiguous, as a [K][N] weight is): a core matrix is
//     8 rows (k) of 8 n, one 16-byte row per k;
//   * d[4j + {0,1,2,3}] = D(row g, col 8j+2t{,+1}), D(row g+8, ...), with
//     g = lane / 4, t = lane % 4, rows counted from 16 * (warp % 4): the
//     m16n8k16 accumulator layout repeated over the N/8 column blocks.
// The product runs asynchronously: fence_proxy_async_shared() and a
// barrier after the shared-memory writes it reads, wgmma_fence() before
// the first product of a group, wgmma_commit() after it, wgmma_wait<0>()
// before the accumulators are touched again or its operands' memory is
// rewritten, then wgmma_fence_operand(d) so the compiler keeps its own
// reads of d after the wait.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\\n" ::"n"(PENDING) : "memory");
}

// Makes shared-memory writes of this thread (st.shared, cp.async once
// waited for) visible to the async proxy that wgmma reads through.
__device__ __forceinline__ void fence_proxy_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");
}

template <int R>
__device__ __forceinline__ void wgmma_fence_operand(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor, no swizzle: start address, the byte
// distance between core matrices adjacent along K (lbo) and along M/N (sbo).
__device__ __forceinline__ uint64_t wgmma_desc(const void* smem, uint32_t lbo,
                                               uint32_t sbo) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  uint64_t d = 0;
  d |= static_cast<uint64_t>((addr & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;
  return d;  // base offset 0, layout type 0 (no swizzle)
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a,
                                         uint64_t desc_b, int accumulate);
"""

TAIL = """
}  // namespace
"""


def _lines(items, per_line, indent):
    rows = [", ".join(items[i:i + per_line])
            for i in range(0, len(items), per_line)]
    return (",\n" + indent).join(rows)


def specialization(n: int) -> str:
    r = n // 2
    regs = _lines([f"%{i}" for i in range(r)], 12, '      "')
    regs = regs.replace(",\n", ", \"\n")
    outs = _lines([f'"+f"(d[{i}])' for i in range(r)], 6, "        ")
    a0 = r
    # scale-d p, scale-a 1, scale-b 1, trans-a 0 (K-major), trans-b 1
    # (MN-major)
    return f"""
template <>
__device__ __forceinline__ void wgmma_ss<{n}>(float (&d)[{r}], uint64_t desc_a,
                                          uint64_t desc_b, int accumulate) {{
  asm volatile(
      "{{\\n"
      ".reg .pred p;\\n"
      "setp.ne.b32 p, %{a0 + 2}, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 {{"
      "{regs}}}, "
      "%{a0}, %{a0 + 1}, p, 1, 1, 0, 1;\\n"
      "}}\\n"
      : {outs}
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}}
"""


def main():
    for n in WIDTHS:
        assert n % 8 == 0 and 8 <= n <= 256, n
    OUT.write_text(HEAD + "".join(specialization(n) for n in WIDTHS) + TAIL)
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
