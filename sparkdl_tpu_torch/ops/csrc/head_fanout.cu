// Kernel H1: the head fan-out's dense head pass, batch-invariant.
//
//   out[r, c] = bias[idx[r], c] + sum_d feats[r, d] * kernel[idx[r], d, c]
//
// feats (n, D) f32, idx (n,) int32, kernel (cap, D, C) f32, bias (cap, C)
// f32, out (n, C) f32, all contiguous.  Each row r takes the head its tenant
// index names out of the stacked bank (ops/head.py::head_pass).
//
// Not a port of a TPU kernel: the JAX package runs this head through XLA
// (sparkdl_tpu/parallel/engine.py::dense_head_row, vmapped by
// build_head_fanout_jit).  It exists for the fan-out's contract: a tenant's
// row out of a mixed-tenant batch is bit-identical to the same row through
// the head alone.  A library reduction splits D by how many outputs there
// are, so a row's sum order moves with n; here it depends on D only:
//
//   * D is cut into P = the largest of 16, 8, 4, 2, 1 that divides D
//     partial ranges of L = D / P consecutive d.  Partial p sums its range
//     in order d = p*L, p*L+1, ... from +0.0;
//   * the partials are added in order p = 0, 1, ..., P-1, then the bias;
//   * every product and every addition is rounded on its own (__fmul_rn,
//     __fadd_rn: no FMA contraction).
//
// ops/head.py::head_pass_reference does the same operations in the same
// order in PyTorch, so the two agree bit for bit on the card and the plain
// version on the CPU gives the card's bits.
//
// What bounds it on an H100: bytes.  A pass must read the D x C kernel of
// every distinct head its rows name and does only 2 n D C f32 operations:
// 32 rows over 24 distinct heads of 2048 x 100 read 19.7 MB (5.9 us at
// 3.35 TB/s) for 13 MFLOP (0.2 us at 67 TFLOP/s f32).
// Design, simple first: a block is one row and 32 classes, P warps, one
// per partial; lane c reads kernel[idx[r], d, c0 + c] for its warp's d, so a
// warp reads 128 contiguous bytes a step.  Rows that share a head read it
// again (from L2 when it fits).  The partials meet in shared memory and
// warp 0 adds them.  Grid (n, ceil(C / 32)).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 32;
constexpr int MAX_PARTIALS = 16;

__global__ void __launch_bounds__(LANES * MAX_PARTIALS)
head_fanout_kernel(const float* __restrict__ feats,
                   const int* __restrict__ idx,
                   const float* __restrict__ kernel,
                   const float* __restrict__ bias, float* __restrict__ out,
                   int cap, int D, int C, int L) {
  __shared__ float part[MAX_PARTIALS][LANES];
  const int r = blockIdx.x;
  const int c = blockIdx.y * LANES + threadIdx.x;
  const int p = threadIdx.y;
  const int P = blockDim.y;
  const int h = idx[r];
  const bool head_ok = h >= 0 && h < cap;
  float acc = 0.f;
  if (head_ok && c < C) {
    const float* f = feats + static_cast<size_t>(r) * D +
                     static_cast<size_t>(p) * L;
    const float* w = kernel +
                     (static_cast<size_t>(h) * D + static_cast<size_t>(p) * L) *
                         C +
                     c;
#pragma unroll 8
    for (int j = 0; j < L; ++j)
      acc = __fadd_rn(acc, __fmul_rn(__ldg(f + j),
                                     __ldg(w + static_cast<size_t>(j) * C)));
  }
  part[p][threadIdx.x] = acc;
  __syncthreads();
  if (p != 0 || c >= C) return;
  float y;
  if (!head_ok) {
    y = __int_as_float(0x7fc00000);  // a tenant index outside the bank: NaN
  } else {
    y = part[0][threadIdx.x];
    for (int q = 1; q < P; ++q) y = __fadd_rn(y, part[q][threadIdx.x]);
    y = __fadd_rn(y, bias[static_cast<size_t>(h) * C + c]);
  }
  out[static_cast<size_t>(r) * C + c] = y;
}

}  // namespace

extern "C" {

// Launches H1 on `stream` with P partials (ops/head.py::head_partials(D))
// and returns the launch's CUDA error (0 = launched).  P must divide D and
// be 1, 2, 4, 8 or 16; n >= 1, C >= 1.
int head_fanout_launch(const void* feats, const void* idx, const void* kernel,
                       const void* bias, void* out, int n, int cap, int D,
                       int C, int P, void* stream) {
  const bool ok = n >= 1 && C >= 1 && D >= 0 && cap >= 1 &&
                  (P == 1 || P == 2 || P == 4 || P == 8 || P == 16) &&
                  D % P == 0 && (C + LANES - 1) / LANES <= 65535;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(n),
                  static_cast<unsigned>((C + LANES - 1) / LANES));
  const dim3 block(LANES, static_cast<unsigned>(P));
  head_fanout_kernel<<<grid, block, 0,
                       reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(feats), static_cast<const int*>(idx),
      static_cast<const float*>(kernel), static_cast<const float*>(bias),
      static_cast<float*>(out), cap, D, C, D / P);
  return static_cast<int>(cudaGetLastError());
}

const char* head_fanout_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
